"""Plain shared encoder and one decoder head per domain (port of
mdilss_tpu/models/erfnet_multihead.py).

One module covers the reference's three multi-head baselines and the
single-task ERFNet; they differ only in how their heads are named, which is
the state-dict grammar of each kind (mdilss_tpu/ckpt/pth_converter.py:202-213):

  multi_task  `decoder.{t}` (a ModuleList; erfnet_multi_task.py:146-160)
  erfnet      `decoder` (one head; erfnet.py:140-149)
  ftp1        `decoder_old`, `decoder_new` (erfnet_ftp1.py:139-141)
  ftp2        `decoder_old1`, `decoder_old2`, `decoder_new` (erfnet_ftp2.py:139-143)

The head is a plain int argument of `forward` in task order (the FT
baselines' flags map old=0 [old2=1], new=last), with ERFNetRAP's signature,
so the train and eval steps run either model. The encoder's BN is shared.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from .. import resolve_device
from .erfnet_rap import grad_off, head_output
from .topology import Decoder, Encoder

KINDS = ("multi_task", "erfnet", "ftp1", "ftp2")
_NAMED_HEADS = {
    "erfnet": ("decoder",),
    "ftp1": ("decoder_old", "decoder_new"),
    "ftp2": ("decoder_old1", "decoder_old2", "decoder_new"),
}


def head_prefixes(kind: str, nb_heads: int) -> list[str]:
    """State-dict prefix of each head of a `kind` model, in task order (the
    RAP model's heads are `decoder.{t}` too)."""
    if kind in ("multi_task", "rap"):
        return [f"decoder.{t}" for t in range(nb_heads)]
    if kind not in _NAMED_HEADS:
        raise ValueError(f"unknown model kind {kind!r}: one of {KINDS + ('rap',)}")
    names = _NAMED_HEADS[kind]
    if nb_heads != len(names):
        raise ValueError(f"kind {kind!r} has {len(names)} heads, not {nb_heads}")
    return list(names)


class ERFNetMultiHead(nn.Module):
    """`ERFNetMultiHead([20, 20, 27], kind="multi_task")` on the CUDA card
    (`device="cpu"` to build it on the CPU). Weights are torch's default
    initialisation from the global RNG, made on the CPU; the model starts in
    eval mode, as ERFNetRAP."""

    def __init__(self, num_classes: Sequence[int], kind: str = "multi_task", device=None):
        super().__init__()
        self.kind = kind
        self.head_prefixes = head_prefixes(kind, len(num_classes))
        dev = resolve_device(device)
        self.encoder = Encoder(None)
        if kind == "multi_task":
            self.decoder = nn.ModuleList([Decoder(nc) for nc in num_classes])
        else:
            for name, nc in zip(self.head_prefixes, num_classes):
                self.add_module(name, Decoder(nc))
        self.to(dev)
        self.eval()

    @property
    def heads(self) -> list[nn.Module]:
        return list(self.decoder) if self.kind == "multi_task" else [
            getattr(self, name) for name in self.head_prefixes]

    def forward(self, x_nhwc: torch.Tensor, task: int, drop_masks: dict | None = None,
                return_features: bool = False):
        """x [N, H, W, 3] -> logits [N, H, W, num_classes[task]] in x's type;
        `drop_masks` and `return_features` as ERFNetRAP.forward's."""
        heads = self.heads
        if not 0 <= task < len(heads):
            raise IndexError(f"task {task} out of range for {len(heads)} heads")
        if self.training:
            return self._forward(x_nhwc, heads[task], drop_masks, return_features)
        with grad_off():
            return self._forward(x_nhwc, heads[task], None, return_features)

    def _forward(self, x_nhwc: torch.Tensor, head: nn.Module, drop_masks: dict | None,
                 return_features: bool):
        x = x_nhwc.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        return head_output(head, self.encoder(x, None, drop_masks), return_features)
