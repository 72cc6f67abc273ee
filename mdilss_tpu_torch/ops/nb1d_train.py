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
matrix is [C_in, C_out] (`x @ rap`); activations are NCHW float32 or bfloat16
in torch.channels_last memory. In bfloat16 (the Trainer's
`compute_dtype="bfloat16"`) the pairs take and return bf16 activations and
run the weights rounded to bf16, with fp32 accumulation, and round at the
kernels' points only: u after the pre-stage, c after bias and relu, y, dc
and du; the stats and the weight gradients are float32, and the glue of
`Nb1dTrain` computes in float32 and casts back to the activation type where
the JAX block does (nb1d_train.py:461-464, :496-520). `LAUNCHES_FWD` /
`LAUNCHES_BWD` count kernel calls of `fwd_pair` / `bwd_pair` of every type,
`LAUNCHES_FWD_BF16` / `LAUNCHES_BWD_BF16` the bfloat16 ones among them.

Under `ops.norm.synced(mesh)` (sharded training) the glue computes the
global batch's BN over every rank of the mesh: the forward all-reduces K2's
[2, C] sums before it forms each BN's statistics (so the pre-stage K2's
second launch reads is global too), and the backward all-reduces the
[2, C] sums over the batch that form each BN's input gradient, one
collective per BN. The BN parameters' gradients it returns stay this
rank's, as the conv weights' gradients from K3 do:
`parallel.all_reduce_grads` sums them all once. The kernels are the same on
every rank; the collectives sit between launches.

On a spatial mesh (S > 1, this rank a slab of h rows of each image) each
pair runs on its slab with its neighbours' rows around it
(`parallel.halo.exchange`): 1 row for the first pair, d for the dilated
one, the halo rows' c and y recomputed, and its y cropped to the slab. K2's
stats count the slab's rows only (its stats window, `rows`), never the
halo's. K3 runs unchanged on the padded input with gy zero on the halo
rows: its weight gradients are then this rank's partials, and the halo rows
of du go back to their owners (`exchange_adjoint`).
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build
from .dropout import drop_scale
from .nb1d_infer import check_not_ablation, stack_taps, unstack_taps
from ..parallel.halo import exchange, exchange_adjoint, spatial_of
from ..parallel.mesh import all_reduce_
from .norm import BN_EPS, sync_mesh, update_running_stats

LAUNCHES_FWD = 0
LAUNCHES_BWD = 0
LAUNCHES_FWD_BF16 = 0
LAUNCHES_BWD_BF16 = 0
SUPPORTED_CHANNELS = (16, 64, 128)
# the kernels' activation types -> the suffix of their C entries
_ENTRY = {torch.float32: "", torch.bfloat16: "_bf16"}


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _pre(x: torch.Tensor, pre) -> torch.Tensor:
    if pre is None:
        return x
    a, b = pre
    return F.relu(x * a.view(1, -1, 1, 1) + b.view(1, -1, 1, 1))


def _acc(dt: torch.dtype) -> torch.dtype:
    """The type the plain pairs compute in for activations of type `dt`:
    float32 for bfloat16 and float32, float64 for float64."""
    return torch.promote_types(dt, torch.float32)


def _pair(u, w31, b31, w13, rap, d: int, dt: torch.dtype) -> torch.Tensor:
    """y in the compute type from u in it, c rounded to the activation type
    `dt` (a no-op unless dt is bfloat16). In autograd the rounding of c also
    rounds the gradient reaching c, so dc is rounded as the kernel rounds it."""
    acc = u.dtype
    c = F.relu(F.conv2d(u, w31, b31, padding=(d, 0), dilation=(d, 1))).to(dt).to(acc)
    y = F.conv2d(c, w13, padding=(0, d), dilation=(1, d))
    if rap is not None:
        y = y + F.conv2d(u, rap.t()[:, :, None, None])
    return y


def _plain_operands(x, w31, b31, w13, rap, pre):
    """The pair's operands in the compute type of x: the weight matrices
    rounded to x's type first (the kernels take them in it), b31 and the
    pre-stage as they are (float32 in the kernels)."""
    dt, acc = x.dtype, _acc(x.dtype)
    rw = lambda t: None if t is None else t.detach().to(dt).to(acc)  # noqa: E731
    pre = None if pre is None else tuple(t.detach().to(acc) for t in pre)
    return rw(w31), b31.detach().to(acc), rw(w13), rw(rap), pre


def fwd_pair_plain(x, w31, b31, w13, rap, pre, d: int, rows: tuple[int, int] | None = None):
    """(y in x's type, stats [2, C] = sum and sum of squares of y over N, H,
    W in the compute type; over the rows rows[0] .. rows[1] - 1 of H only
    with `rows`, the stats window). bfloat16 x: float32 arithmetic on the
    bf16 values, u, c and y rounded to bf16 where the kernel rounds them, the
    stats from the rounded y."""
    dt, acc = x.dtype, _acc(x.dtype)
    w31, b31, w13, rap, pre = _plain_operands(x, w31, b31, w13, rap, pre)
    u = _pre(x.to(acc), pre).to(dt).to(acc)
    y = _pair(u, w31, b31, w13, rap, d, dt).to(dt)
    yf = y.to(acc) if rows is None else y[:, :, rows[0]:rows[1]].to(acc)
    return y, torch.stack([yf.sum((0, 2, 3)), yf.square().sum((0, 2, 3))])


def bwd_pair_plain(raw, gy, w31, b31, w13, rap, pre, d: int):
    """Gradient of sum(y * gy) for y = the pair of u = pre(raw): (du, dw31,
    db31, dw13, drap or None), du with respect to u (after the pre-stage), in
    raw's type; the weight gradients in the compute type (float32 for
    bfloat16 raw, where dc and du are rounded to bf16 as the kernel rounds
    them)."""
    dt, acc = raw.dtype, _acc(raw.dtype)
    w31, b31, w13, rap, pre = _plain_operands(raw, w31, b31, w13, rap, pre)
    with torch.enable_grad():
        u = _pre(raw.detach().to(acc), pre).to(dt).to(acc).requires_grad_()
        ws = [t.requires_grad_() for t in (w31, b31, w13)]
        rp = None if rap is None else rap.requires_grad_()
        y = _pair(u, *ws, rp, d, dt)
        grads = torch.autograd.grad(y, [u, *ws] + ([rp] if rp is not None else []),
                                    gy.to(acc))
    grads = (grads[0].to(dt), *grads[1:])
    return (*grads, None) if rap is None else tuple(grads)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _library() -> ctypes.CDLL:
    lib = _build.load("nb1d_train")
    if lib.nb1d_train_fwd.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        for sfx in _ENTRY.values():
            fwd, bwd = getattr(lib, "nb1d_train_fwd" + sfx), getattr(lib, "nb1d_train_bwd" + sfx)
            fwd.argtypes = [i, p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, p]
            fwd.restype = i
            bwd.argtypes = [i, p, p, p, p, p, p, p, p, p, p, p, p, i, i, i, i, p]
            bwd.restype = i
            fwd_scratch = getattr(lib, f"nb1d_train_fwd{sfx}_scratch")
            fwd_scratch.argtypes = [i, i, i, i]
            fwd_scratch.restype = ll
            bwd_scratch = getattr(lib, f"nb1d_train_bwd{sfx}_scratch")
            bwd_scratch.argtypes = [i, i, i, i, i]
            bwd_scratch.restype = ll
        lib.nb1d_train_grad_len.argtypes = [i, i]
        lib.nb1d_train_grad_len.restype = ll
        lib.nb1d_train_error_string.argtypes = [i]
        lib.nb1d_train_error_string.restype = ctypes.c_char_p
    return lib


def _check_act(name: str, t: torch.Tensor, like: torch.Tensor | None = None) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got one on {t.device}")
    if t.dtype not in _ENTRY:
        raise TypeError(f"{name}: the kernels take float32 or bfloat16, not {t.dtype}")
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
    if like is not None and (t.shape != like.shape or t.device != like.device
                             or t.dtype != like.dtype):
        raise ValueError(f"{name} {t.dtype} {tuple(t.shape)} on {t.device} does not match "
                         f"{like.dtype} {tuple(like.shape)} on {like.device}")


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
    """The kernels' operands from float32 weights: the weight matrices
    stacked in x's type, b31 and the pre-stage float32."""
    c, dev, dt = x.shape[1], x.device, x.dtype
    w31s = stack_taps(_operand("w31", w31, (c, c, 3, 1), dev), dt)
    w13s = stack_taps(_operand("w13", w13, (c, c, 1, 3), dev), dt)
    b31v = _operand("b31", b31, (c,), dev)
    rapm = None if rap is None else _operand("rap", rap, (c, c), dev).to(dt).contiguous()
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


def fwd_pair(x, w31, b31, w13, rap, pre, d: int, rows: tuple[int, int] | None = None):
    """K2: (y [N,C,H,W] in x's type, stats [2, C] float32) of the pair on u =
    pre(x) (`pre` = (a, b) per-channel, or None); the stats over the rows
    rows[0] .. rows[1] - 1 of H with `rows` (a slab between its halo rows),
    else over all. CPU tensor -> plain version; CUDA tensor -> the kernel of
    its type (float32 or bfloat16) or raise."""
    global LAUNCHES_FWD, LAUNCHES_FWD_BF16
    if x.device.type == "cpu":
        return fwd_pair_plain(x, w31, b31, w13, rap, pre, d, rows)
    _check_act("x", x)
    if d < 1:
        raise ValueError(f"dilation {d} < 1")
    row0, row1 = (0, x.shape[2]) if rows is None else rows
    if not 0 <= row0 <= row1 <= x.shape[2]:
        raise ValueError(f"stats rows {rows} outside the {x.shape[2]} rows of x")
    w31s, b31v, w13s, rapm, pa, pb = _kernel_operands(x, w31, b31, w13, rap, pre)
    lib = _library()
    n, c, h, w = x.shape
    y = torch.empty_like(x, memory_format=torch.channels_last)
    stats = torch.empty(2, c, dtype=torch.float32, device=x.device)
    sfx = _ENTRY[x.dtype]
    scratch = torch.empty(getattr(lib, f"nb1d_train_fwd{sfx}_scratch")(c, n, h, w),
                          dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = getattr(lib, "nb1d_train_fwd" + sfx)(
            c, _ptr(x), _ptr(w31s), _ptr(b31v), _ptr(w13s), _ptr(rapm), _ptr(pa), _ptr(pb),
            _ptr(y), _ptr(stats), _ptr(scratch), n, h, w, d, row0, row1,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _raise_on(lib, rc, "nb1d_train_fwd" + sfx, x, d)
    LAUNCHES_FWD += 1
    if x.dtype == torch.bfloat16:
        LAUNCHES_FWD_BF16 += 1
    return y, stats


def bwd_pair(raw, gy, w31, b31, w13, rap, pre, d: int):
    """K3: (du, dw31, db31, dw13, drap or None) of sum(y * gy) for y =
    fwd_pair(raw, ...)[0]; du is with respect to the pair's input after the
    pre-stage (the pre-stage's own backward needs batch reductions and is the
    caller's); du in raw's type, the weight gradients in the weights' shapes,
    float32. CPU tensor -> plain version; CUDA tensor -> the kernel of its
    type (float32 or bfloat16) or raise."""
    global LAUNCHES_BWD, LAUNCHES_BWD_BF16
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
    sfx = _ENTRY[raw.dtype]
    scratch = torch.empty(getattr(lib, f"nb1d_train_bwd{sfx}_scratch")(c, n, h, w, has_rap),
                          dtype=torch.float32, device=raw.device)
    with torch.cuda.device(raw.device):
        rc = getattr(lib, "nb1d_train_bwd" + sfx)(
            c, _ptr(raw), _ptr(gy), _ptr(w31s), _ptr(b31v), _ptr(w13t), _ptr(w31t), _ptr(rapt),
            _ptr(pa), _ptr(pb), _ptr(du), _ptr(grads), _ptr(scratch), n, h, w, d,
            torch.cuda.current_stream(raw.device).cuda_stream,
        )
    _raise_on(lib, rc, "nb1d_train_bwd" + sfx, raw, d)
    LAUNCHES_BWD += 1
    if raw.dtype == torch.bfloat16:
        LAUNCHES_BWD_BF16 += 1
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


def _slab(t: torch.Tensor, top: int, h: int) -> torch.Tensor:
    """The h rows of t after its `top` halo rows, channels_last."""
    return t[:, :, top:top + h].contiguous(memory_format=torch.channels_last)


def _zero_halo(g: torch.Tensor, top: int, bottom: int) -> torch.Tensor:
    """g with `top` zero rows above and `bottom` below, channels_last."""
    return F.pad(g, (0, 0, top, bottom)).contiguous(memory_format=torch.channels_last)


def _bn_backward(g_z, yhat, scale_inv, count: int, dt: torch.dtype, mesh=None):
    """Batch-statistics BN backward: (g_y in the activation type `dt`, d_scale,
    d_bias) for z = scale*yhat + bias, computed in g_z's type. With `mesh`
    the statistics are the global batch's (`count` its pixels): g_y takes the
    sums over the mesh, while d_scale and d_bias stay this rank's."""
    dbias = g_z.sum((0, 2, 3))
    dscale = (g_z * yhat).sum((0, 2, 3))
    sums = (dbias, dscale) if mesh is None else all_reduce_(torch.stack([dbias, dscale]), mesh)
    g_y = _col(scale_inv) * (g_z - _col(sums[0] / count) - yhat * _col(sums[1] / count))
    return g_y.to(dt).contiguous(memory_format=torch.channels_last), dscale, dbias


class Nb1dTrain(torch.autograd.Function):
    """The training block as one autograd node (port of nb1d_train.py:429-535):

        apply(x, w31a, b31a, w13a, rap1, g1, be1, w31b, b31b, w13b, rap2, g2, be2,
              mask_scaled, d, eps, pairs) -> (out, mu1, var1, mu2, var2)

    rap1/rap2 are [C, C] or None (plain block); mask_scaled is the [N, C, 1, 1]
    dropout multiplier (in the compute type) or None; mu/var are the batch
    statistics of the pre-BN activations without the absorbed biases (not
    differentiable), of the global batch under `ops.norm.synced` (with the
    row halos of a spatial mesh). x, out and the pairs' y1, y2 and du are in x's type
    (float32 or bfloat16, float64 for a plain yardstick); the glue computes in
    at least float32 and rounds out, g_y1, g_y2 and dx back to x's type, as
    nb1d_train.py:461-464, :496-520 do. `pairs` is
    (fwd, bwd): `(fwd_pair, bwd_pair)` for the block itself, or the plain pair
    functions to build the same block from plain versions on any device (a
    yardstick for the kernels).
    """

    @staticmethod
    def forward(ctx, x, w31a, b31a, w13a, rap1, g1, be1, w31b, b31b, w13b, rap2, g2, be2,
                mask_scaled, d, eps, pairs):
        fwd = pairs[0]
        mesh = sync_mesh()
        sp = spatial_of(mesh)
        n, c, h, w = x.shape
        count = n * h * w * (1 if mesh is None else mesh.size)
        if sp is None:
            xp, halos = x, None
            y1, st1 = fwd(x, w31a, b31a, w13a, rap1, None, 1)
        else:  # the pairs on the slab and its halo rows, the stats over the slab
            xp, u1, d1 = exchange(x, 1, 1, sp)
            y1p, st1 = fwd(xp, w31a, b31a, w13a, rap1, None, 1, (u1, u1 + h))
            y1 = _slab(y1p, u1, h)
            del y1p
        mu1, var1 = _batch_stats(all_reduce_(st1, mesh), count)
        inv1 = torch.rsqrt(var1 + eps)
        a1 = g1 * inv1
        b1 = be1 - mu1 * g1 * inv1
        if sp is None:
            y1h = y1
            y2, st2 = fwd(y1, w31b, b31b, w13b, rap2, (a1, b1), d)
        else:
            y1h, u2, d2 = exchange(y1, d, d, sp)
            halos = (u1, d1, u2, d2)
            y2p, st2 = fwd(y1h, w31b, b31b, w13b, rap2, (a1, b1), d, (u2, u2 + h))
            y2 = _slab(y2p, u2, h)
            del y1, y2p
        mu2, var2 = _batch_stats(all_reduce_(st2, mesh), count)
        inv2 = torch.rsqrt(var2 + eps)
        z2 = y2 * _col(g2 * inv2) + _col(be2 - mu2 * g2 * inv2)
        if mask_scaled is not None:
            z2 = z2 * mask_scaled
        out = F.relu(z2 + x).to(x.dtype)
        # on a spatial mesh the pairs' padded inputs, which K3 reruns on
        ctx.save_for_backward(xp, y1h, y2, out, mu1, inv1, a1, b1, mu2, inv2,
                              w31a, b31a, w13a, rap1, g1, w31b, b31b, w13b, rap2, g2, mask_scaled)
        ctx.d, ctx.pairs, ctx.mesh, ctx.count = d, pairs, mesh, count
        ctx.sp, ctx.halos, ctx.h = sp, halos, h
        ctx.mark_non_differentiable(mu1, var1, mu2, var2)
        return out, mu1, var1, mu2, var2

    @staticmethod
    def backward(ctx, g_out, *_):
        (xp, y1h, y2, out, mu1, inv1, a1, b1, mu2, inv2,
         w31a, b31a, w13a, rap1, g1, w31b, b31b, w13b, rap2, g2, mask_scaled) = ctx.saved_tensors
        bwd, mesh, count, sp, h = ctx.pairs[1], ctx.mesh, ctx.count, ctx.sp, ctx.h
        u1, d1, u2, d2 = (0, 0, 0, 0) if sp is None else ctx.halos
        dt, acc = xp.dtype, _acc(xp.dtype)
        zero = torch.zeros((), dtype=acc, device=xp.device)
        g_f = torch.where(out > 0, g_out.to(acc), zero)
        g_z2 = g_f if mask_scaled is None else g_f * mask_scaled
        g_y2, dg2, dbe2 = _bn_backward(g_z2, (y2 - _col(mu2)) * _col(inv2), g2 * inv2, count,
                                       dt, mesh)
        if sp is not None:
            g_y2 = _zero_halo(g_y2, u2, d2)
        dm, dw31b, db31b, dw13b, drap2 = bwd(y1h, g_y2, w31b, b31b, w13b, rap2, (a1, b1), ctx.d)
        if sp is None:
            y1 = y1h
        else:
            dm, y1 = exchange_adjoint(dm, h, ctx.d, ctx.d, sp), _slab(y1h, u2, h)
        z1 = y1 * _col(a1) + _col(b1)
        g_z1 = torch.where(z1 > 0, dm.to(acc), zero)
        g_y1, dg1, dbe1 = _bn_backward(g_z1, (y1 - _col(mu1)) * _col(inv1), g1 * inv1, count,
                                       dt, mesh)
        if sp is not None:
            g_y1 = _zero_halo(g_y1, u1, d1)
        dx_c, dw31a, db31a, dw13a, drap1 = bwd(xp, g_y1, w31a, b31a, w13a, rap1, None, 1)
        if sp is not None:
            dx_c = exchange_adjoint(dx_c, h, 1, 1, sp)
        dx = (g_f + dx_c.to(acc)).to(dt)
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
    and the unbiased variance. x is float32 or bfloat16 (float64 with plain
    `pairs`); the output has x's type, and the dropout multiplier is in the
    compute type (float32 for a bf16 x, as blocks.py:388 makes it). Under
    `ops.norm.synced` the statistics, and the count the running variance is
    unbiased with, are the global batch's (over data x spatial)."""
    check_not_ablation(block)
    if dropprob > 0.0 and drop_mask is None:
        raise ValueError("nb1d_train_apply needs a host drop_mask when dropprob > 0 "
                         "(models/topology.py make_dropout_masks)")
    x = x.contiguous(memory_format=torch.channels_last)
    n, _, h, w = x.shape
    mask_scaled = None if dropprob == 0.0 else drop_scale(drop_mask, dropprob, _acc(x.dtype))
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
    mesh = sync_mesh()
    count = n * h * w * (1 if mesh is None else mesh.size)
    with torch.no_grad():
        update_running_stats(bn1, mu1 + bias1, var1, count)
        update_running_stats(bn2, mu2 + bias2, var2, count)
    return out
