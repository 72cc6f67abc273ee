"""mdilss_tpu_torch: the PyTorch/CUDA port of mdilss_tpu for NVIDIA Hopper.

The JAX package `mdilss_tpu` stays the reference; this package imports
nothing of it and nothing of JAX. Its entry points run on the CUDA card
unless the caller passes `device="cpu"` explicitly; with no card and no
explicit CPU request they raise (there is no silent CPU fallback). On the
CPU every kernel wrapper takes its plain PyTorch version.

Layout convention: public functions take and return NHWC (images
[N,H,W,3], logits [N,H,W,C], labels [N,H,W]) like the JAX package; inside
the model activations are logical NCHW in `torch.channels_last` memory
format, which is physical NHWC, so cuDNN and the hand-written kernels share
buffers without permute copies.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None` -> the CUDA card (raises if there is none); `"cpu"` only when
    asked for explicitly."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the plain "
                "PyTorch versions on the CPU explicitly"
            )
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but CUDA is not available")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: cuda or cpu")
    return dev
