"""Model modules of the port: ERFNet-RAP, the multi-head baselines and the
single-task ERFNet."""
from .erfnet import ERFNet
from .erfnet_multihead import ERFNetMultiHead
from .erfnet_rap import ERFNetRAP

__all__ = ["ERFNet", "ERFNetMultiHead", "ERFNetRAP"]
