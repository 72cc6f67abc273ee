"""device_idle.eval: % of the profiled batches in which no device
operation ran (1 - union of device intervals / their span), traced with the
device's activity alone. Layer: host dispatch. Source: device trace."""
from benchmark import readers


def read(rec):
    return readers.device_idle(rec, "eval")
