"""Vanilla single-task ERFNet (port of mdilss_tpu/models/erfnet.py; reference
models/erfnet.py:140-149): the plain encoder and one decoder named `decoder`."""
from __future__ import annotations

from .erfnet_multihead import ERFNetMultiHead


class ERFNet(ERFNetMultiHead):
    """`ERFNet(20)`: one head; `forward(x, 0)` as the multi-head models'."""

    def __init__(self, num_classes: int = 20, device=None):
        super().__init__([num_classes], kind="erfnet", device=device)
