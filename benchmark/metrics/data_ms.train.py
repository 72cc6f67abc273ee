"""data_ms.train: device ms per batch launched from data/transforms and the
benchmark's take from the device set (the family table's "data take and
augment"). Source: device trace."""
from benchmark import readers, roofline


def read(rec):
    return readers.family_ms(rec, roofline.DATA_FAMILY, "train")
