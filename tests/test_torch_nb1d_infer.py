"""Port of the fused nb1d inference block (mdilss_tpu_torch/ops/nb1d_infer.py)
against the JAX package: the plain PyTorch version, on the same weights and
inputs, equals the Pallas kernel in interpret mode and the unfused XLA
block. Tolerance as tests/test_pallas_nb1d.py: fp32, atol 2e-5, rtol 1e-4.
In bf16 the plain version is held to the Pallas kernel in relative L2 (see
`TOL_BF16_VS_JAX`); on the card the bf16 kernel is held to the plain version
(tests/test_torch_cuda.py), which chains the kernel to the JAX package."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_port import nb1d_fp32_emulated, randomize_bn, rel_l2, to_nchw
from mdilss_tpu.models import blocks as B
from mdilss_tpu.ops.pallas.nb1d import _fold_bn, nb1d_fused_infer
from mdilss_tpu_torch.ckpt.convert import nb_block_state_dict
from mdilss_tpu_torch.models.blocks import NonBottleneck1d, NonBottleneck1dRAP
from mdilss_tpu_torch.ops import nb1d_infer as K
from mdilss_tpu_torch.ops.norm import fold_bn

torch.set_num_threads(1)

NB_TASKS = 3
# (C, dilation, rap, task): every task of a 3-task RAP block
CASES = [(16, 1, False, None)] + [
    (c, d, True, t) for c, d in ((64, 1), (64, 16), (128, 2)) for t in range(NB_TASKS)
]
# bf16 plain version vs the Pallas kernel, relative L2. bf16 keeps 8 bits
# (unit roundoff 2^-9 ~ 2e-3), and the two round at different places: the
# Pallas kernel rounds each tap's partial product and their running sum to
# bf16 (nb1d.py:37-44, :64-74), the plain version each whole conv and the
# RAP sum; c and m are rounded to bf16 by both. That is about one bf16
# rounding per element, 1.0e-3 to 2.4e-3 over CASES; the gate leaves 2.5x of
# room and stays well below the card's kernel-vs-plain 2e-2.
TOL_BF16_VS_JAX = 6e-3


def _block(c, d, rap, seed):
    rng = np.random.default_rng(seed)
    if rap:
        p, s = B.nb1d_rap_init(jax.random.key(seed), c, d, nb_tasks=NB_TASKS)
        blk = NonBottleneck1dRAP(c, d, NB_TASKS)
    else:
        p, s = B.nb1d_init(jax.random.key(seed), c, d)
        blk = NonBottleneck1d(c, d)
    p, s = randomize_bn(p, s, rng)
    blk.load_state_dict(nb_block_state_dict(p, s), strict=True)
    x = rng.standard_normal((1, 16, 32, c), dtype=np.float32)
    return p, s, blk, x


@pytest.mark.parametrize("c,d,rap,task", CASES)
def test_plain_matches_jax_kernel_and_xla_block(c, d, rap, task):
    p, s, blk, x = _block(c, d, rap, seed=c + d)
    xj = jnp.asarray(x)
    if rap:
        ref, _ = B.nb1d_rap_apply(p, s, xj, task=task, dilated=d, dropprob=0.0, training=False)
        fused = nb1d_fused_infer(xj, p, s["bns1"], s["bns2"], dilated=d, task=task,
                                 interpret=True)
    else:
        ref, _ = B.nb1d_apply(p, s, xj, dilated=d, dropprob=0.0, training=False)
        fused = nb1d_fused_infer(xj, p, s["bn1"], s["bn2"], dilated=d, interpret=True)
    ops = K.prepare_operands(blk, task, torch.float32)
    got = K.nb1d_infer_plain(to_nchw(x), ops, d).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, np.asarray(fused), atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(got, np.asarray(ref), atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("c,d,rap,task", CASES)
def test_plain_bf16_matches_jax_kernel(c, d, rap, task):
    p, s, blk, x = _block(c, d, rap, seed=c + d)
    xj = jnp.asarray(x, jnp.bfloat16)
    if rap:
        fused = nb1d_fused_infer(xj, p, s["bns1"], s["bns2"], dilated=d, task=task,
                                 interpret=True)
    else:
        fused = nb1d_fused_infer(xj, p, s["bn1"], s["bn2"], dilated=d, interpret=True)
    assert fused.dtype == jnp.bfloat16
    want = np.array(fused.astype(jnp.float32))
    ops = K.prepare_operands(blk, task, torch.bfloat16)
    xt = to_nchw(np.array(xj.astype(jnp.float32))).to(torch.bfloat16)
    got = K.nb1d_infer_plain(xt, ops, d)
    assert got.dtype == torch.bfloat16
    got = got.float().permute(0, 2, 3, 1).numpy()
    err = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert err <= TOL_BF16_VS_JAX, err


@pytest.mark.parametrize("rap", [False, True], ids=["plain", "rap"])
@pytest.mark.parametrize("c,d", [(16, 1), (16, 2), (64, 1), (64, 2)])
def test_fp32_kernel_order_matches_jax_kernel(c, d, rap):
    """K1's fp32 kernel (nb1d_pair_tf32_kernel: K2's 3xTF32 pair mainloop, no
    pre-stage, the folded-BN epilogue, m in float32) emulated in its order on
    the CPU: equal to the Pallas kernel at the fp32 tolerance above and within
    1e-6 relative L2 of the block in float64; one TF32 pass misses 1e-5."""
    task = 1 if rap else None
    p, s, blk, x = _block(c, d, rap, seed=3 * c + d)
    xj = jnp.asarray(x)
    bn = (s["bns1"], s["bns2"]) if rap else (s["bn1"], s["bn2"])
    fused = np.asarray(nb1d_fused_infer(xj, p, *bn, dilated=d, task=task, interpret=True))
    ops = K.prepare_operands(blk, task, torch.float32)
    got = nb1d_fp32_emulated(torch.from_numpy(x), ops, d)
    np.testing.assert_allclose(got.numpy(), fused, atol=2e-5, rtol=1e-4)
    ops64 = K.Nb1dOperands(*(None if t is None else t.double() for t in ops))
    want = K.nb1d_infer_plain(to_nchw(x).double(), ops64, d).permute(0, 2, 3, 1).numpy()
    assert rel_l2(got, want) <= 1e-6, rel_l2(got, want)
    one = nb1d_fp32_emulated(torch.from_numpy(x), ops, d, one_pass=True)
    assert rel_l2(one, want) > 1e-5, rel_l2(one, want)


def test_fold_bn_matches_jax_fold():
    rng = np.random.default_rng(0)
    scale, bias, mean, pre = (rng.standard_normal(64).astype(np.float32) for _ in range(4))
    var = rng.uniform(0.5, 1.5, 64).astype(np.float32)
    want = _fold_bn(*(jnp.asarray(a) for a in (scale, bias, mean, var, pre)))
    got = fold_bn(*(torch.from_numpy(a) for a in (scale, bias, mean, var, pre)))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        # XLA may contract b's multiply-subtract into one FMA: 1-ulp slack
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)


def test_operands_layout_and_dtype():
    """Tap-stacked [3C, C] weights in the activation type, float32 vectors,
    RAP matrices only for RAP blocks; nothing tracks gradients."""
    blk = NonBottleneck1dRAP(16, 2, NB_TASKS)
    ops = K.prepare_operands(blk, 1, torch.bfloat16)
    assert ops.w31a.shape == (48, 16) and ops.w31a.dtype == torch.bfloat16
    assert ops.rap2.shape == (16, 16) and ops.a2.dtype == torch.float32
    w = blk.conv1x3_2.weight  # [co, ci, 1, 3]
    assert torch.equal(ops.w13b.float(), w.detach().to(torch.bfloat16).float()[:, :, 0, :]
                       .permute(2, 1, 0).reshape(48, 16))
    assert all(t is None or not t.requires_grad for t in ops)
    plain = K.prepare_operands(NonBottleneck1d(16, 1), None, torch.float32)
    assert plain.rap1 is None and plain.rap2 is None
    with pytest.raises(ValueError, match="needs a task"):
        K.prepare_operands(blk, None, torch.float32)


def test_dispatcher_rejects_other_devices():
    blk = NonBottleneck1d(16, 1)
    ops = K.prepare_operands(blk, None, torch.float32)
    with pytest.raises(ValueError, match="unsupported device"):
        K.nb1d_infer(torch.empty(1, 16, 4, 4, device="meta"), ops, 1)
