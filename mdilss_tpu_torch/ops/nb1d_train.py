"""Training-mode nb1d / nb1d_RAP block: conv-pair kernels, plain versions and autograd.

Port of mdilss_tpu/ops/pallas/nb1d_train.py and of the block wrapper
mdilss_tpu/models/blocks.py `nb1d_fused_train_apply`. The block splits at each
batch-statistics BN into two conv pairs:

    pair 1:  y1 = colconv(relu(rowconv(x) + b31a)) [+ x @ rap1]          -> y1, sum/sumsq
    (glue)   batch stats of y1 -> per-channel affine (a1, b1)
    pair 2:  m = relu(a1*y1 + b1);  y2 = colconv_d(relu(rowconv_d(m) + b31b)) [+ m @ rap2]
    (glue)   stats of y2 -> (a2, b2);  out = relu(mask * (a2*y2 + b2) + x)

`fwd_pair` (K2) and `bwd_pair` (K3) run on CUDA tensors as the hand-written
kernels of `csrc/nb1d_train.cu` and on CPU tensors as `fwd_pair_plain` /
`bwd_pair_plain` (an F.conv2d chain and its autograd). They choose by the
tensor's device only; a CUDA tensor the kernel does not take raises. The glue
(stats, affine, BN backward) is plain torch, as it was XLA in JAX; `Nb1dTrain`
(K4) is the block's autograd.Function. K2-K4 are the names ROADMAP.md gives
the JAX package's TPU kernels that these replace.

The pre-BN biases (conv1x3_k.bias and the RAP bias) are per-channel constants
that the batch mean absorbs exactly, so the pairs leave them out: the output
is unchanged, they get no gradient (zero in JAX), and only the recorded
running mean adds them back (`nb1d_train_apply`).

Weights are torch conv weights (w31 [C, C, 3, 1], w13 [C, C, 1, 3]); a RAP
matrix is [C_in, C_out] (`x @ rap`); activations are NCHW float32 in
torch.channels_last memory. `LAUNCHES_FWD` / `LAUNCHES_BWD` count kernel
calls of `fwd_pair` / `bwd_pair`.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build
from .dropout import drop_scale
from .nb1d_infer import check_not_ablation, stack_taps, unstack_taps
from .norm import BN_EPS, update_running_stats

LAUNCHES_FWD = 0
LAUNCHES_BWD = 0
SUPPORTED_CHANNELS = (16, 64, 128)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _pre(x: torch.Tensor, pre) -> torch.Tensor:
    if pre is None:
        return x
    a, b = pre
    return F.relu(x * a.view(1, -1, 1, 1) + b.view(1, -1, 1, 1))


def _pair(u, w31, b31, w13, rap, d: int) -> torch.Tensor:
    c = F.relu(F.conv2d(u, w31, b31, padding=(d, 0), dilation=(d, 1)))
    y = F.conv2d(c, w13, padding=(0, d), dilation=(1, d))
    if rap is not None:
        y = y + F.conv2d(u, rap.t()[:, :, None, None])
    return y


def fwd_pair_plain(x, w31, b31, w13, rap, pre, d: int):
    """(y, stats [2, C] = sum and sum of squares of y over N, H, W)."""
    y = _pair(_pre(x, pre), w31, b31, w13, rap, d)
    return y, torch.stack([y.sum((0, 2, 3)), y.square().sum((0, 2, 3))])


def bwd_pair_plain(raw, gy, w31, b31, w13, rap, pre, d: int):
    """Gradient of sum(y * gy) for y = the pair of u = pre(raw): (du, dw31,
    db31, dw13, drap or None), du with respect to u (after the pre-stage)."""
    with torch.enable_grad():
        u = _pre(raw.detach(), pre).detach().requires_grad_()
        ws = [t.detach().requires_grad_() for t in (w31, b31, w13)]
        rp = None if rap is None else rap.detach().requires_grad_()
        y = _pair(u, *ws, rp, d)
        grads = torch.autograd.grad(y, [u, *ws] + ([rp] if rp is not None else []), gy)
    return (*grads, None) if rap is None else tuple(grads)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _library() -> ctypes.CDLL:
    lib = _build.load("nb1d_train")
    if lib.nb1d_train_fwd.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.nb1d_train_fwd.argtypes = [i, p, p, p, p, p, p, p, p, p, p, i, i, i, i, p]
        lib.nb1d_train_fwd.restype = i
        lib.nb1d_train_bwd.argtypes = [i, p, p, p, p, p, p, p, p, p, p, p, p, i, i, i, i, p]
        lib.nb1d_train_bwd.restype = i
        lib.nb1d_train_fwd_scratch.argtypes = [i, i, i, i]
        lib.nb1d_train_fwd_scratch.restype = ll
        lib.nb1d_train_bwd_scratch.argtypes = [i, i, i, i, i]
        lib.nb1d_train_bwd_scratch.restype = ll
        lib.nb1d_train_grad_len.argtypes = [i, i]
        lib.nb1d_train_grad_len.restype = ll
        lib.nb1d_train_error_string.argtypes = [i]
        lib.nb1d_train_error_string.restype = ctypes.c_char_p
    return lib


def _check_act(name: str, t: torch.Tensor, like: torch.Tensor | None = None) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got one on {t.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: the kernel takes float32, not {t.dtype}")
    if t.dim() != 4 or t.shape[1] not in SUPPORTED_CHANNELS:
        raise ValueError(f"{name} must be [N,C,H,W] with C in {SUPPORTED_CHANNELS}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"{name} must be contiguous in torch.channels_last")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")
    n, _, h, w = t.shape
    if n > 65535 or h > 65535:
        raise ValueError(f"{name}: unsupported shape {tuple(t.shape)}")
    if like is not None and (t.shape != like.shape or t.device != like.device):
        raise ValueError(f"{name} {tuple(t.shape)} on {t.device} does not match "
                         f"{tuple(like.shape)} on {like.device}")


def _operand(name: str, t: torch.Tensor, shape, device) -> torch.Tensor:
    """A weight or per-channel vector as a contiguous, 16-byte aligned float32
    tensor of `shape` on `device`, or raise."""
    if t.device != device or t.dtype != torch.float32 or tuple(t.shape) != tuple(shape):
        raise ValueError(f"operand {name} must be a float32 {tuple(shape)} tensor on {device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    t = t.detach().contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _stack_t(ws: torch.Tensor) -> torch.Tensor:
    """Tap-stacked [3C, C] (row k*C + ci, column co) -> the transposed, tap-reversed
    stack of the transposed conv (row k*C + co, column ci = ws[(2-k)*C + ci, co])."""
    c = ws.shape[1]
    return ws.view(3, c, c).flip(0).transpose(1, 2).reshape(3 * c, c).contiguous()


def _kernel_operands(x, w31, b31, w13, rap, pre):
    c, dev = x.shape[1], x.device
    w31s = stack_taps(_operand("w31", w31, (c, c, 3, 1), dev), torch.float32)
    w13s = stack_taps(_operand("w13", w13, (c, c, 1, 3), dev), torch.float32)
    b31v = _operand("b31", b31, (c,), dev)
    rapm = None if rap is None else _operand("rap", rap, (c, c), dev)
    pa = pb = None
    if pre is not None:
        pa, pb = (_operand(f"pre[{i}]", t, (c,), dev) for i, t in enumerate(pre))
    return w31s, b31v, w13s, rapm, pa, pb


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _raise_on(lib, rc: int, what: str, x: torch.Tensor, d: int) -> None:
    if rc != 0:
        msg = lib.nb1d_train_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed ({msg}, code {rc}) for {tuple(x.shape)}, "
                           f"dilation {d}")


def fwd_pair(x, w31, b31, w13, rap, pre, d: int):
    """K2: (y [N,C,H,W], stats [2, C] float32) of the pair on u = pre(x)
    (`pre` = (a, b) per-channel, or None). CPU tensor -> plain version; CUDA
    tensor -> the kernel or raise."""
    global LAUNCHES_FWD
    if x.device.type == "cpu":
        return fwd_pair_plain(x, w31, b31, w13, rap, pre, d)
    _check_act("x", x)
    if d < 1:
        raise ValueError(f"dilation {d} < 1")
    w31s, b31v, w13s, rapm, pa, pb = _kernel_operands(x, w31, b31, w13, rap, pre)
    lib = _library()
    n, c, h, w = x.shape
    y = torch.empty_like(x, memory_format=torch.channels_last)
    stats = torch.empty(2, c, dtype=torch.float32, device=x.device)
    scratch = torch.empty(lib.nb1d_train_fwd_scratch(c, n, h, w), dtype=torch.float32,
                          device=x.device)
    with torch.cuda.device(x.device):
        rc = lib.nb1d_train_fwd(
            c, _ptr(x), _ptr(w31s), _ptr(b31v), _ptr(w13s), _ptr(rapm), _ptr(pa), _ptr(pb),
            _ptr(y), _ptr(stats), _ptr(scratch), n, h, w, d,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _raise_on(lib, rc, "nb1d_train_fwd", x, d)
    LAUNCHES_FWD += 1
    return y, stats


def bwd_pair(raw, gy, w31, b31, w13, rap, pre, d: int):
    """K3: (du, dw31, db31, dw13, drap or None) of sum(y * gy) for y =
    fwd_pair(raw, ...)[0]; du is with respect to the pair's input after the
    pre-stage (the pre-stage's own backward needs batch reductions and is the
    caller's). Weight gradients in the weights' shapes, float32. CPU tensor ->
    plain version; CUDA tensor -> the kernel or raise."""
    global LAUNCHES_BWD
    if raw.device.type == "cpu":
        return bwd_pair_plain(raw, gy, w31, b31, w13, rap, pre, d)
    _check_act("raw", raw)
    _check_act("gy", gy, like=raw)
    if d < 1:
        raise ValueError(f"dilation {d} < 1")
    w31s, b31v, w13s, rapm, pa, pb = _kernel_operands(raw, w31, b31, w13, rap, pre)
    w13t, w31t = _stack_t(w13s), _stack_t(w31s)
    rapt = None if rapm is None else rapm.t().contiguous()
    lib = _library()
    n, c, h, w = raw.shape
    has_rap = int(rapm is not None)
    du = torch.empty_like(raw, memory_format=torch.channels_last)
    grads = torch.empty(lib.nb1d_train_grad_len(c, has_rap), dtype=torch.float32,
                        device=raw.device)
    scratch = torch.empty(lib.nb1d_train_bwd_scratch(c, n, h, w, has_rap), dtype=torch.float32,
                          device=raw.device)
    with torch.cuda.device(raw.device):
        rc = lib.nb1d_train_bwd(
            c, _ptr(raw), _ptr(gy), _ptr(w31s), _ptr(b31v), _ptr(w13t), _ptr(w31t), _ptr(rapt),
            _ptr(pa), _ptr(pb), _ptr(du), _ptr(grads), _ptr(scratch), n, h, w, d,
            torch.cuda.current_stream(raw.device).cuda_stream,
        )
    _raise_on(lib, rc, "nb1d_train_bwd", raw, d)
    LAUNCHES_BWD += 1
    cc = c * c
    dw31 = unstack_taps(grads[: 3 * cc].view(3 * c, c), True).contiguous()
    dw13 = unstack_taps(grads[3 * cc: 6 * cc].view(3 * c, c), False).contiguous()
    db31 = grads[6 * cc: 6 * cc + c]
    drap = grads[6 * cc + c:].view(c, c) if has_rap else None
    return du, dw31, db31, dw13, drap


# ---------------------------------------------------------------------------
# K4: the training block
# ---------------------------------------------------------------------------

def _batch_stats(st: torch.Tensor, count: int):
    """(mean, biased var) from [2, C] sums, var = E[y^2] - E[y]^2 clamped at 0
    (nb1d_train.py:444-447)."""
    mu = st[0] / count
    return mu, torch.clamp(st[1] / count - mu * mu, min=0.0)


def _col(v: torch.Tensor) -> torch.Tensor:
    return v.view(1, -1, 1, 1)


def _bn_backward(g_z, yhat, scale_inv, count: int):
    """Batch-statistics BN backward: (g_y, d_scale, d_bias) for z = scale*yhat + bias."""
    dbias = g_z.sum((0, 2, 3))
    dscale = (g_z * yhat).sum((0, 2, 3))
    g_y = _col(scale_inv) * (g_z - _col(dbias / count) - yhat * _col(dscale / count))
    return g_y.contiguous(memory_format=torch.channels_last), dscale, dbias


class Nb1dTrain(torch.autograd.Function):
    """The training block as one autograd node (port of nb1d_train.py:429-535):

        apply(x, w31a, b31a, w13a, rap1, g1, be1, w31b, b31b, w13b, rap2, g2, be2,
              mask_scaled, d, eps, pairs) -> (out, mu1, var1, mu2, var2)

    rap1/rap2 are [C, C] or None (plain block); mask_scaled is the [N, C, 1, 1]
    dropout multiplier or None; mu/var are the batch statistics of the pre-BN
    activations without the absorbed biases (not differentiable). `pairs` is
    (fwd, bwd): `(fwd_pair, bwd_pair)` for the block itself, or the plain pair
    functions to build the same block from plain versions on any device (a
    yardstick for the kernels).
    """

    @staticmethod
    def forward(ctx, x, w31a, b31a, w13a, rap1, g1, be1, w31b, b31b, w13b, rap2, g2, be2,
                mask_scaled, d, eps, pairs):
        fwd = pairs[0]
        n, c, h, w = x.shape
        count = n * h * w
        y1, st1 = fwd(x, w31a, b31a, w13a, rap1, None, 1)
        mu1, var1 = _batch_stats(st1, count)
        inv1 = torch.rsqrt(var1 + eps)
        a1 = g1 * inv1
        b1 = be1 - mu1 * g1 * inv1
        y2, st2 = fwd(y1, w31b, b31b, w13b, rap2, (a1, b1), d)
        mu2, var2 = _batch_stats(st2, count)
        inv2 = torch.rsqrt(var2 + eps)
        z2 = y2 * _col(g2 * inv2) + _col(be2 - mu2 * g2 * inv2)
        if mask_scaled is not None:
            z2 = z2 * mask_scaled
        out = F.relu(z2 + x)
        ctx.save_for_backward(x, y1, y2, out, mu1, inv1, a1, b1, mu2, inv2,
                              w31a, b31a, w13a, rap1, g1, w31b, b31b, w13b, rap2, g2, mask_scaled)
        ctx.d, ctx.pairs = d, pairs
        ctx.mark_non_differentiable(mu1, var1, mu2, var2)
        return out, mu1, var1, mu2, var2

    @staticmethod
    def backward(ctx, g_out, *_):
        (x, y1, y2, out, mu1, inv1, a1, b1, mu2, inv2,
         w31a, b31a, w13a, rap1, g1, w31b, b31b, w13b, rap2, g2, mask_scaled) = ctx.saved_tensors
        bwd = ctx.pairs[1]
        n, c, h, w = x.shape
        count = n * h * w
        g_f = torch.where(out > 0, g_out, torch.zeros((), dtype=g_out.dtype, device=g_out.device))
        g_z2 = g_f if mask_scaled is None else g_f * mask_scaled
        g_y2, dg2, dbe2 = _bn_backward(g_z2, (y2 - _col(mu2)) * _col(inv2), g2 * inv2, count)
        dm, dw31b, db31b, dw13b, drap2 = bwd(y1, g_y2, w31b, b31b, w13b, rap2, (a1, b1), ctx.d)
        z1 = y1 * _col(a1) + _col(b1)
        g_z1 = torch.where(z1 > 0, dm, torch.zeros((), dtype=dm.dtype, device=dm.device))
        g_y1, dg1, dbe1 = _bn_backward(g_z1, (y1 - _col(mu1)) * _col(inv1), g1 * inv1, count)
        dx_c, dw31a, db31a, dw13a, drap1 = bwd(x, g_y1, w31a, b31a, w13a, rap1, None, 1)
        dx = g_f + dx_c
        return (dx, dw31a, db31a, dw13a, drap1, dg1, dbe1,
                dw31b, db31b, dw13b, drap2, dg2, dbe2, None, None, None, None)


KERNEL_PAIRS = (fwd_pair, bwd_pair)
PLAIN_PAIRS = (fwd_pair_plain, bwd_pair_plain)


def nb1d_train_apply(block, x: torch.Tensor, task: int | None, dropprob: float = 0.0,
                     drop_mask: torch.Tensor | None = None, pairs=KERNEL_PAIRS) -> torch.Tensor:
    """Training forward of an nb1d / nb1d_RAP block module (reference grammar)
    on x [N,C,H,W]; updates the block's (task's) BN running stats in place.
    Port of mdilss_tpu/models/blocks.py:364-439: `drop_mask` [N, C] bool keep-
    mask (required when dropprob > 0), the RAP/BN slices of `task`, and the
    running-stat update with the absorbed pre-BN biases added back to the mean
    and the unbiased variance."""
    check_not_ablation(block)
    if dropprob > 0.0 and drop_mask is None:
        raise ValueError("nb1d_train_apply needs a host drop_mask when dropprob > 0 "
                         "(models/topology.py make_dropout_masks)")
    x = x.contiguous(memory_format=torch.channels_last)
    n, _, h, w = x.shape
    mask_scaled = None if dropprob == 0.0 else drop_scale(drop_mask, dropprob, x.dtype)
    if hasattr(block, "parallel_conv_1"):
        if task is None:
            raise ValueError("a RAP block needs a task")
        bn1, bn2 = block.bns_1[task], block.bns_2[task]
        p1, p2 = block.parallel_conv_1[task], block.parallel_conv_2[task]
        rap1, rap2 = p1.weight[:, :, 0, 0].t(), p2.weight[:, :, 0, 0].t()
        bias1 = block.conv1x3_1.bias + p1.bias
        bias2 = block.conv1x3_2.bias + p2.bias
    else:
        bn1, bn2 = block.bn1, block.bn2
        rap1 = rap2 = None
        bias1, bias2 = block.conv1x3_1.bias, block.conv1x3_2.bias
    out, mu1, var1, mu2, var2 = Nb1dTrain.apply(
        x, block.conv3x1_1.weight, block.conv3x1_1.bias, block.conv1x3_1.weight, rap1,
        bn1.weight, bn1.bias, block.conv3x1_2.weight, block.conv3x1_2.bias,
        block.conv1x3_2.weight, rap2, bn2.weight, bn2.bias, mask_scaled, block.dilated,
        BN_EPS, pairs,
    )
    with torch.no_grad():
        update_running_stats(bn1, mu1 + bias1, var1, n * h * w)
        update_running_stats(bn2, mu2 + bias2, var2, n * h * w)
    return out
