"""float32 convolutions and matmuls in full float32 on the card.

PyTorch runs a float32 convolution through cuDNN in TF32 by default
(`torch.backends.cudnn.allow_tf32` is True), which keeps about three decimal
digits; the JAX package, the reference, computes its float32 convs in
float32. `no_tf32()` turns TF32 off for cuDNN's convs and cuBLAS's matmuls
for its block, whatever the process's flags are, and puts them back after.
The package's float32 steps, eval forwards and serving forwards run under it;
a bfloat16 forward is unaffected (the flags govern float32 only).
"""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def no_tf32():
    """Context manager (and decorator): TF32 off for float32 convs and matmuls."""
    conv, matmul = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = conv, matmul
