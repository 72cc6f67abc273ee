"""mfu.eval: model FLOPs of the window's batches over (their wall time x the
card's peak for the dtype, float32 as 3xTF32), in %. Source: host clock."""
from benchmark import readers


def read(rec):
    return readers.mfu(rec, "eval")
