"""cudnn_ms.train: device ms per batch of cuDNN's convs, transposed convs and
their backward (the family table's "cuDNN conv and its backward"). Source:
device trace."""
from benchmark import readers, roofline


def read(rec):
    return readers.family_ms(rec, roofline.CUDNN_FAMILY, "train")
