"""k1_roofline.train: K1 (csrc/nb1d_infer.cu), its 3xTF32 bound for the eval
forwards counted by the port's launch counter over its device time, in %.
Source: device trace."""
from benchmark import readers


def read(rec):
    return readers.k1_roofline(rec, "train")
