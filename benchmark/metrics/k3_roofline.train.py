"""k3_roofline.train: K3 (csrc/nb1d_train.cu backward kinds and their sum),
its 3xTF32 bound per backward times the backwards counted, over its device
time, in %. Source: device trace."""
from benchmark import readers


def read(rec):
    return readers.pair_roofline(rec, "K3", "bwd")
