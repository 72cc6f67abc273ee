"""Model modules of the port: ERFNet-RAP, its four ablation models, the
multi-head baselines and the single-task ERFNet."""
from .erfnet import ERFNet
from .erfnet_ablations import ERFNetAblation
from .erfnet_multihead import ERFNetMultiHead
from .erfnet_rap import ERFNetRAP

__all__ = ["ERFNet", "ERFNetAblation", "ERFNetMultiHead", "ERFNetRAP"]
