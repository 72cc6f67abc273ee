"""Model modules of the port: ERFNet-RAP, its four ablation models, the
multi-head baselines, the single-task ERFNet and SegFormer with the
incremental rule of ERFNet-RAP."""
from .erfnet import ERFNet
from .erfnet_ablations import ERFNetAblation
from .erfnet_multihead import ERFNetMultiHead
from .erfnet_rap import ERFNetRAP
from .segformer_rap import SegFormerRAP

__all__ = ["ERFNet", "ERFNetAblation", "ERFNetMultiHead", "ERFNetRAP", "SegFormerRAP"]
