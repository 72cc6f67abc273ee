"""The four ablation models of ERFNet-RAP (port of
mdilss_tpu/models/erfnet_ablations.py): the reference step-1 trainer's model
factory names them (train_RAPFT_step1.py:451-460), and the JAX package
reconstructs them from the reference's freeze rules, since their model files
are absent upstream.

  erfnet_bn          variant "bn":      shared convs, per-task BN
  erfnet_onlyRAP     variant "onlyrap": per-task parallel 1x1 adapters, shared BN
  erfnet_RA_series   variant "ras":     per-task series 1x1 adapters, per-task BN
  erfnet_RCM         variant "rcm":     per-task C x C matrices, per-task BN

Every variant keeps one decoder per task, as ERFNet-RAP, and the forward
contract of `ERFNetRAP.forward`. The encoder's blocks are
`blocks.NonBottleneck1dAblation` (plain PyTorch); the decoders' nb1d blocks
run the kernels on the card, as ERFNet-RAP's do.

No reference checkpoint or state-dict grammar exists for these models, so
this is the port's own, in the reference's naming, so that the substrings
of the reference's freeze rules (mdilss_tpu/models/blocks.py:252-270) match
the domain-specific entries:

  encoder.initial_block.conv, encoder.layers.{i}.conv       (downsamplers)
  encoder.initial_block.bn_ini.{t}, encoder.layers.{i}.bn_ini.{t}
                                           (bn / ras / rcm; onlyrap: `.bn`)
  encoder.layers.{i}.conv3x1_1 / conv1x3_1 / conv3x1_2 / conv1x3_2
  encoder.layers.{i}.bns_1.{t} / bns_2.{t}  (bn / ras / rcm)
  encoder.layers.{i}.bn1 / bn2              (onlyrap, shared)
  encoder.layers.{i}.parallel_conv_{1,2}.{t}   (onlyrap, 1x1 conv)
  encoder.layers.{i}.series_conv_{1,2}.{t}     (ras, 1x1 conv)
  encoder.layers.{i}.Wt_{1,2}.{t}              (rcm, [C_in, C_out] parameter)
  decoder.{t}.*                             (as ERFNet-RAP's)

The port's checkpoint directories carry it; `ckpt.from_jax` writes it from
the JAX package's pytree.
"""
from __future__ import annotations

from typing import Sequence

from torch import nn

from .blocks import ABLATION_VARIANTS
from .erfnet_rap import ERFNetRAP

# the reference's --model values -> the variant keys
REFERENCE_NAMES = {
    "erfnet_bn": "bn",
    "erfnet_onlyRAP": "onlyrap",
    "erfnet_RA_series": "ras",
    "erfnet_RCM": "rcm",
}


class ERFNetAblation(ERFNetRAP):
    """`ERFNetAblation([20, 20], 2, "rcm")` on the CUDA card (`device="cpu"`
    for the CPU); torch's default initialisation from the global RNG (RCM's
    matrices the identity), made on the CPU; starts in eval mode."""

    def __init__(self, num_classes: Sequence[int], nb_tasks: int, variant: str, device=None):
        if variant not in ABLATION_VARIANTS:
            raise ValueError(f"unknown ablation variant {variant!r}: one of {ABLATION_VARIANTS}")
        nn.Module.__init__(self)
        self.variant = variant
        self._assemble(num_classes, nb_tasks, variant, device)
