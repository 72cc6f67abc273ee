"""Model modules of the port (ERFNet-RAP in this slice)."""
from .erfnet_rap import ERFNetRAP

__all__ = ["ERFNetRAP"]
