"""Eval-mode nb1d / nb1d_RAP block: operands, plain version and kernel wrapper.

Port of mdilss_tpu/ops/pallas/nb1d.py `nb1d_fused_infer`. The block

    relu(3x1 + b) -> 1x3 (+ RAP 1x1 on x) -> folded BN -> relu = m
    relu(3x1 dil d + b) -> 1x3 dil d (+ RAP 1x1 on m) -> folded BN + x -> relu

runs on CUDA tensors as two launches of a hand-written conv-pair kernel in
`csrc/nb1d_infer.cu` (see the note there), both on the tensor cores: float32
as 3xTF32 `mma.sync` on the training pair's mainloop (`csrc/tf32_pair.cuh`),
bfloat16 with bf16 `mma.sync`. On CPU tensors it
runs as `nb1d_infer_plain`, an F.conv2d chain computing the same function.
The block is the torch.library custom op `mdilss::nb1d_infer` (below), whose
dispatcher picks by the tensors' device only; a CUDA tensor the kernel does
not take raises, it never falls back to the plain version or to the other
kernel.

On a spatial mesh (`ops.norm.synced` with S > 1: this rank holds a slab of
each image's rows) `nb1d_infer` takes 1 + d rows of its neighbours above
and below once (`parallel.halo.exchange`), runs the same op on the padded
slab and keeps the slab's rows: the halo's m, recomputed, covers the
dilated pair's reach, and where the image ends the kernel zero-pads as on
the whole image.

`LAUNCHES` counts kernel launches (two per block), `LAUNCHES_BF16` the
bfloat16 ones among them.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import _build
from ..parallel.halo import exchange, spatial_of
from .norm import fold_bn, sync_mesh

LAUNCHES = 0
LAUNCHES_BF16 = 0
LAUNCHES_PER_BLOCK = 2
SUPPORTED_CHANNELS = (16, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


class Nb1dOperands(NamedTuple):
    """Kernel operands of one block for one task and activation type.

    Tap-stacked weights are [3C, C] in the activation type with row
    k*C + ci, column co = torch weight[co, ci, tap k]; RAP matrices are
    [C, C] ([ci, co]) or None for a plain block; the 3x1 biases and the
    folded BN (a, b) are float32 [C].
    """

    w31a: torch.Tensor
    b31a: torch.Tensor
    w13a: torch.Tensor
    rap1: torch.Tensor | None
    a1: torch.Tensor
    b1: torch.Tensor
    w31b: torch.Tensor
    b31b: torch.Tensor
    w13b: torch.Tensor
    rap2: torch.Tensor | None
    a2: torch.Tensor
    b2: torch.Tensor


def stack_taps(w: torch.Tensor, dtype) -> torch.Tensor:
    """torch [Co, Ci, 3, 1] or [Co, Ci, 1, 3] conv weight -> [3*Ci, Co]."""
    co = w.shape[0]
    return w.flatten(2).permute(2, 1, 0).reshape(-1, co).to(dtype).contiguous()


def unstack_taps(ws: torch.Tensor, row: bool) -> torch.Tensor:
    """[3C, C] tap-stacked matrix -> torch conv weight [C, C, 3, 1] (row) or
    [C, C, 1, 3] (column)."""
    c = ws.shape[1]
    w = ws.view(3, c, c).permute(2, 1, 0)  # [co, ci, tap]
    return w.unsqueeze(-1) if row else w.unsqueeze(2)


def check_not_ablation(block) -> None:
    """An ablation block (models/blocks.py `NonBottleneck1dAblation`) runs its
    own forward: onlyrap's carries `parallel_conv_k` beside a shared BN and
    must not pass for a RAP block here."""
    if getattr(block, "variant", None) is not None:
        raise ValueError(f"a {block.variant!r} ablation block has no nb1d kernel operands: "
                         f"it runs its own forward")


def prepare_operands(block, task: int | None, dtype) -> Nb1dOperands:
    """Operands of a block module in the reference grammar: conv3x1_1,
    conv1x3_1, conv3x1_2, conv1x3_2 plus either bn1/bn2 (plain) or
    parallel_conv_{1,2}[task] and bns_{1,2}[task] (RAP), as
    mdilss_tpu/ops/pallas/nb1d.py:155-184 selects them; detached. (No grad-mode
    switch of its own: the eval forward runs with grad off, and torch.export
    records every switch.)"""
    check_not_ablation(block)
    rap = hasattr(block, "parallel_conv_1")
    if rap:
        if task is None:
            raise ValueError("a RAP block needs a task")
        bn1, bn2 = block.bns_1[task], block.bns_2[task]
        p1, p2 = block.parallel_conv_1[task], block.parallel_conv_2[task]
        rap1 = p1.weight[:, :, 0, 0].t().to(dtype).contiguous()
        rap2 = p2.weight[:, :, 0, 0].t().to(dtype).contiguous()
        pre1 = block.conv1x3_1.bias + p1.bias
        pre2 = block.conv1x3_2.bias + p2.bias
    else:
        bn1, bn2 = block.bn1, block.bn2
        rap1 = rap2 = None
        pre1, pre2 = block.conv1x3_1.bias, block.conv1x3_2.bias
    # float32 (float64 for a float64 forward, which only the plain version runs)
    f32 = torch.promote_types(dtype, torch.float32)
    a1, b1 = fold_bn(bn1.weight, bn1.bias, bn1.running_mean, bn1.running_var, pre1, bn1.eps, f32)
    a2, b2 = fold_bn(bn2.weight, bn2.bias, bn2.running_mean, bn2.running_var, pre2, bn2.eps, f32)
    ops = Nb1dOperands(
        w31a=stack_taps(block.conv3x1_1.weight, dtype),
        b31a=block.conv3x1_1.bias.to(f32).contiguous(),
        w13a=stack_taps(block.conv1x3_1.weight, dtype),
        rap1=rap1, a1=a1.contiguous(), b1=b1.contiguous(),
        w31b=stack_taps(block.conv3x1_2.weight, dtype),
        b31b=block.conv3x1_2.bias.to(f32).contiguous(),
        w13b=stack_taps(block.conv1x3_2.weight, dtype),
        rap2=rap2, a2=a2.contiguous(), b2=b2.contiguous(),
    )
    # a float32 bias passes through .to/.contiguous as the Parameter itself
    return Nb1dOperands(*(None if t is None else t.detach() for t in ops))


def nb1d_infer_plain(x: torch.Tensor, ops: Nb1dOperands, dilated: int) -> torch.Tensor:
    """Plain PyTorch version: x [N,C,H,W] -> same shape and type. Convs run
    in x's type; the folded BN, residual and relu in float32 (float64 for a
    float64 x)."""
    acc = torch.promote_types(x.dtype, torch.float32)

    def pair(u, w31, b31, w13, rap, d):
        c = F.relu(F.conv2d(u, unstack_taps(w31, True), b31.to(u.dtype),
                            padding=(d, 0), dilation=(d, 1)))
        y = F.conv2d(c, unstack_taps(w13, False), padding=(0, d), dilation=(1, d))
        if rap is not None:
            y = y + F.conv2d(u, rap.t()[:, :, None, None])
        return y.to(acc)

    def affine(y, a, b):
        return y * a.view(1, -1, 1, 1) + b.view(1, -1, 1, 1)

    m = F.relu(affine(pair(x, ops.w31a, ops.b31a, ops.w13a, ops.rap1, 1), ops.a1, ops.b1))
    m = m.to(x.dtype)
    z = affine(pair(m, ops.w31b, ops.b31b, ops.w13b, ops.rap2, dilated), ops.a2, ops.b2)
    return F.relu(z + x.to(acc)).to(x.dtype)


def nb1d_infer(x: torch.Tensor, ops: Nb1dOperands, dilated: int) -> torch.Tensor:
    """The block on x [N,C,H,W]: CPU tensor -> plain version; CUDA tensor ->
    the kernel of its type (channels_last, float32 or bfloat16, C in
    16/64/128) or raise. Goes through the custom op `mdilss::nb1d_infer`, so
    eager forwards and programs exported with torch.export take one route.
    Another device raises (the op's fake implementation would serve a meta
    tensor). On a spatial mesh, the op runs on x with 1 + `dilated` halo
    rows each side (the module docstring)."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"nb1d_infer: unsupported device {x.device}")
    sp = spatial_of(sync_mesh())
    if sp is None:
        return torch.ops.mdilss.nb1d_infer(x, *ops, dilated)
    xp, up, _ = exchange(x, 1 + dilated, 1 + dilated, sp)
    out = torch.ops.mdilss.nb1d_infer(xp, *ops, dilated)
    return out[:, :, up:up + x.shape[2]].contiguous(memory_format=torch.channels_last)


# The block as a torch.library custom op: its CPU implementation is the plain
# version, its CUDA one the kernel (two launches), and its fake one the output's
# shape and strides, which are the kernel's (`_launch_pair` allocates
# channels_last), so torch.export traces a forward without running either.
# The operands come one by one; a plain block's RAP matrices are None.
_SCHEMA = ("(Tensor x, Tensor w31a, Tensor b31a, Tensor w13a, Tensor? rap1, Tensor a1, "
           "Tensor b1, Tensor w31b, Tensor b31b, Tensor w13b, Tensor? rap2, Tensor a2, "
           "Tensor b2, int dilated) -> Tensor")


@torch.library.custom_op("mdilss::nb1d_infer", mutates_args=(), device_types="cpu",
                         schema=_SCHEMA)
def _nb1d_infer_cpu(x, w31a, b31a, w13a, rap1, a1, b1, w31b, b31b, w13b, rap2, a2, b2,
                    dilated):
    ops = Nb1dOperands(w31a, b31a, w13a, rap1, a1, b1, w31b, b31b, w13b, rap2, a2, b2)
    return nb1d_infer_plain(x, ops, dilated).contiguous(memory_format=torch.channels_last)


@_nb1d_infer_cpu.register_kernel("cuda")
def _nb1d_infer_cuda(x, w31a, b31a, w13a, rap1, a1, b1, w31b, b31b, w13b, rap2, a2, b2,
                     dilated):
    ops = Nb1dOperands(w31a, b31a, w13a, rap1, a1, b1, w31b, b31b, w13b, rap2, a2, b2)
    _check(x, ops, dilated)
    m = _launch_pair(x, w31a, b31a, w13a, rap1, a1, b1, None, 1)
    return _launch_pair(m, w31b, b31b, w13b, rap2, a2, b2, x, dilated)


@_nb1d_infer_cpu.register_fake
def _nb1d_infer_fake(x, *operands_and_dilation):
    return torch.empty_like(x, memory_format=torch.channels_last)


def _check(x: torch.Tensor, ops: Nb1dOperands, dilated: int) -> None:
    if x.dim() != 4:
        raise ValueError(f"nb1d_infer: x must be [N,C,H,W], got {tuple(x.shape)}")
    n, c, h, w = x.shape
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"nb1d_infer: kernel takes float32 or bfloat16, not {x.dtype}")
    if c not in SUPPORTED_CHANNELS:
        raise ValueError(f"nb1d_infer: kernel takes C in {SUPPORTED_CHANNELS}, not {c}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("nb1d_infer: x must be contiguous in torch.channels_last")
    if not (1 <= dilated and n <= 65535 and h <= 65535):
        raise ValueError(f"nb1d_infer: unsupported dilation {dilated} or shape {tuple(x.shape)}")
    if x.data_ptr() % 16:
        raise ValueError("nb1d_infer: x must be 16-byte aligned")
    mats = {"w31a": (3 * c, c), "w13a": (3 * c, c), "w31b": (3 * c, c), "w13b": (3 * c, c),
            "rap1": (c, c), "rap2": (c, c)}
    for name, t in ops._asdict().items():
        if t is None:
            if name in ("rap1", "rap2"):
                continue
            raise ValueError(f"nb1d_infer: operand {name} is missing")
        want_dtype = x.dtype if name in mats else torch.float32
        want_shape = mats.get(name, (c,))
        if (t.device != x.device or t.dtype != want_dtype or tuple(t.shape) != want_shape
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(
                f"nb1d_infer: operand {name} must be a contiguous, 16-byte aligned "
                f"{want_dtype} {want_shape} tensor on {x.device}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}"
            )


def _library() -> ctypes.CDLL:
    lib = _build.load("nb1d_infer")
    if lib.nb1d_pair.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.nb1d_pair.argtypes = [i, i, p, p, p, p, p, p, p, p, p, i, i, i, i, p]
        lib.nb1d_pair.restype = i
        lib.nb1d_error_string.argtypes = [i]
        lib.nb1d_error_string.restype = ctypes.c_char_p
    return lib


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _launch_pair(u, w31, b31, w13, rap, a, b, res, d: int) -> torch.Tensor:
    global LAUNCHES, LAUNCHES_BF16
    lib = _library()
    n, c, h, w = u.shape
    out = torch.empty_like(u, memory_format=torch.channels_last)
    stream = torch.cuda.current_stream(u.device).cuda_stream
    with torch.cuda.device(u.device):
        rc = lib.nb1d_pair(
            _DTYPE_CODE[u.dtype], c, _ptr(u), _ptr(w31), _ptr(b31), _ptr(w13), _ptr(rap),
            _ptr(a), _ptr(b), _ptr(res), _ptr(out), n, h, w, d, stream,
        )
    if rc != 0:
        msg = lib.nb1d_error_string(rc).decode()
        raise RuntimeError(
            f"nb1d_pair launch failed ({msg}, code {rc}) for u {tuple(u.shape)} "
            f"{u.dtype}, dilation {d}"
        )
    LAUNCHES += 1
    if u.dtype == torch.bfloat16:
        LAUNCHES_BF16 += 1
    return out
