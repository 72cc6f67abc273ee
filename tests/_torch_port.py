"""Shared helpers of the PyTorch-port tests (tests/test_torch_*.py): JAX
models with randomised BatchNorm, moved into the port through the weight
bridge, so both packages run the same weights on the same inputs; and the
3xTF32 arithmetic of the port's fp32 kernels emulated on the CPU (`tf32_rna`,
`split`, the conv pair in its kernels' order)."""
import numpy as np
import torch

import jax.numpy as jnp

from mdilss_tpu.ops.norm import BNState


def randomize_bn(params, state, rng):
    """Replace every BN scale/bias and running mean/var by random values
    (scale, var in [0.5, 1.5]; bias, mean ~ N(0, 0.1)), so eval-mode BN and
    its fold are exercised instead of the identity init."""
    def uni(a):
        return jnp.asarray(rng.uniform(0.5, 1.5, np.shape(a)).astype(np.float32))

    def nrm(a):
        return jnp.asarray(rng.normal(0.0, 0.1, np.shape(a)).astype(np.float32))

    def walk_p(t):
        if isinstance(t, dict):
            if set(t) == {"scale", "bias"}:
                return {"scale": uni(t["scale"]), "bias": nrm(t["bias"])}
            return {k: walk_p(v) for k, v in t.items()}
        if isinstance(t, list):
            return [walk_p(v) for v in t]
        return t

    def walk_s(t):
        if isinstance(t, BNState):
            return BNState(mean=nrm(t.mean), var=uni(t.var))
        if isinstance(t, dict):
            return {k: walk_s(v) for k, v in t.items()}
        if isinstance(t, list):
            return [walk_s(v) for v in t]
        return t

    return walk_p(params), walk_s(state)


def to_nchw(x_nhwc: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x_nhwc)).permute(0, 3, 1, 2)


def rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def cm_near_ties(got_cm, want_cm, jax_logits, port_logits, labels, tie: float = 1e-4) -> int:
    """Hold the port's confusion matrix to JAX's where their argmaxes are
    decided, and return the number of near-tie pixels. The two packages'
    logits differ in the last bits (and, after an Adam step, by its sign
    noise), so an argmax may flip where JAX's top-2 gap is within
    max(`tie`, 4x the RMS logit difference); each flip moves two entries by
    one, so the matrices agree to within 2 per near-tie pixel, exactly when
    there are none."""
    jax_logits, port_logits = np.asarray(jax_logits), np.asarray(port_logits)
    got, want = np.asarray(got_cm, np.int64), np.asarray(want_cm, np.int64)
    top2 = np.sort(jax_logits, axis=-1)[..., -2:]
    noise = float(np.sqrt(np.mean((port_logits.astype(np.float64) - jax_logits) ** 2)))
    ties = int((top2[..., 1] - top2[..., 0] <= max(tie, 4 * noise)).sum())
    assert got.sum() == want.sum() == np.asarray(labels).size
    assert np.abs(got - want).sum() <= 2 * ties, (got, want, ties)
    return ties


def port_train_logits(model, x: np.ndarray, task: int, masks) -> np.ndarray:
    """The port's training-mode logits of head `task` on a copy of `model`
    (the model's BN running statistics stay as they are)."""
    import copy

    twin = copy.deepcopy(model).train()
    with torch.no_grad():
        return twin(torch.from_numpy(x), task, masks).numpy()


# ---- the fp32 kernels' arithmetic (csrc/tf32_pair.cuh) --------------------------------------
# TF32 keeps float32's exponent and 10 mantissa bits. `tf32_rna` emulates cvt.rna.tf32.f32
# (round to nearest, ties away from zero) on the float32 bits, with the integer rounding the
# kernels use. Each operand splits as hi = rna(x), lo = rna(x - hi); a product of TF32 values is
# exact in float32 (11 x 11 significant bits), so float32 matmuls of the split operands give the
# tensor cores' products, summed in float32.

def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (ties away from zero), as float32."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def pair_emulated(x, w31s, b31, w13s, rap, pre, d: int, one_pass: bool = False):
    """The conv pair of K2 and of K1's fp32 kernel (tf32_pair.cuh's mainloop) in their order:
    y [N, H, W, C] and K2's stats [2, C] (float64) on x [N, H, W, C] float32.

    Every operand split hi/lo with tf32_rna, each K chunk of 32 input channels (16 at C = 16)
    summed in a fresh float32 accumulator and added to a running float32 sum; stage A
    (c = relu(rowconv_d(u) + b31), kept in float32) over the row taps, stage B (y = colconv_d(c))
    over the column taps, then RAP on u; the stats as float32 sums over one CTA tile (TM = 256 /
    128 columns at C = 16 / 64: here one per image row) added in float64. `one_pass`: one TF32
    product (hi x hi) in place of three."""
    import torch.nn.functional as F

    n, h, w, c = x.shape
    kc = min(c, 32)

    def gemm(blocks):
        acc = torch.zeros(n, h, w, c)
        for a, b in blocks:
            for i in range(0, c, kc):
                (ah, al), (bh, bl) = split(a[..., i:i + kc].contiguous()), split(b[i:i + kc])
                acc = acc + (ah @ bh if one_pass else al @ bh + ah @ bl + ah @ bh)
        return acc

    u = x if pre is None else torch.relu(x * pre[0] + pre[1])
    up = F.pad(u, (0, 0, 0, 0, d, d))  # zero rows above and below
    cc = torch.relu(gemm([(up[:, k * d:k * d + h], w31s[k * c:(k + 1) * c]) for k in range(3)])
                    + b31)
    cp = F.pad(cc, (0, 0, d, d))  # zero columns left and right
    blocks = [(cp[:, :, k * d:k * d + w], w13s[k * c:(k + 1) * c]) for k in range(3)]
    y = gemm(blocks + ([(u, rap)] if rap is not None else []))
    part = torch.stack([y.sum(2), y.square().sum(2)])  # [2, N, H, C]: one sum per CTA, float32
    return y, part.double().sum((1, 2))


def nb1d_fp32_emulated(x, ops, dilated: int, one_pass: bool = False) -> torch.Tensor:
    """K1's fp32 block (two launches of nb1d_pair_tf32_kernel) in its order on x [N, H, W, C]
    float32: each pair through `pair_emulated` with no pre-stage, the epilogue relu(fma(a, y,
    b) [+ res]) in float32 (the fma rounded once, through float64), m kept in float32."""
    def epilogue(y, a, b, res=None):
        z = (a.double() * y.double() + b.double()).float()
        return torch.relu(z if res is None else z + res)

    y1, _ = pair_emulated(x, ops.w31a, ops.b31a, ops.w13a, ops.rap1, None, 1, one_pass)
    m = epilogue(y1, ops.a1, ops.b1)
    y2, _ = pair_emulated(m, ops.w31b, ops.b31b, ops.w13b, ops.rap2, None, dilated, one_pass)
    return epilogue(y2, ops.a2, ops.b2, x)
