"""glue_roofline.train: the training glue (ops/nb1d_train.Nb1dTrain,
ops/norm, ops/dropout), its byte bound over the device time of its family,
in %. Source: device trace."""
from benchmark import readers


def read(rec):
    return readers.glue_roofline(rec)
