"""k2_roofline.train: K2 (csrc/nb1d_train.cu forward pair and its sum), its
3xTF32 bound per training forward times the forwards counted, over its
device time, in %. Source: device trace."""
from benchmark import readers


def read(rec):
    return readers.pair_roofline(rec, "K2", "fwd")
