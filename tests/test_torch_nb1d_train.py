"""Port of the nb1d training kernels and block (mdilss_tpu_torch/ops/nb1d_train.py)
against the JAX package, on the CPU: the plain conv pairs equal the Pallas
kernels in interpret mode (fwd_pair / bwd_pair), and the training block
(Nb1dTrain through nb1d_train_apply) equals the XLA training block
(nb1d_rap_apply / nb1d_apply with training=True) in value, gradients and
updated running statistics. Tolerances as tests/test_pallas_train.py:50-82
(pairs) and :108-122 (block)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_port import randomize_bn, to_nchw
from mdilss_tpu.models import blocks as B
from mdilss_tpu.ops.pallas.nb1d_train import bwd_pair, fwd_pair
from mdilss_tpu_torch.ckpt.convert import nb_block_state_dict
from mdilss_tpu_torch.models.blocks import NonBottleneck1d, NonBottleneck1dRAP
from mdilss_tpu_torch.ops import nb1d_train as T

torch.set_num_threads(1)

N, H, W, C = 2, 16, 32, 16
PAIR_CASES = [(d, rap, pre) for d in (1, 4, 16) for rap, pre in ((False, False), (True, True),
                                                                  (True, False), (False, True))]


def _pair_inputs(seed, rap, pre):
    """numpy weights in the JAX layouts: w31 [3,1,C,C], w13 [1,3,C,C] (HWIO),
    rap [C,C] ([ci, co]), pre (a, b)."""
    rng = np.random.default_rng(seed)
    mk = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return (mk(N, H, W, C), mk(N, H, W, C), mk(3, 1, C, C) * 0.2, mk(C), mk(1, 3, C, C) * 0.2,
            mk(C, C) * 0.2 if rap else None, (mk(C), mk(C)) if pre else None)


def _torch_w(w_hwio):
    """HWIO -> torch OIHW."""
    return torch.from_numpy(np.ascontiguousarray(w_hwio.transpose(3, 2, 0, 1)))


def _torch_args(w31, b31, w13, rap, pre):
    t = torch.from_numpy
    return (_torch_w(w31), t(b31), _torch_w(w13), None if rap is None else t(rap),
            None if pre is None else (t(pre[0]), t(pre[1])))


def _jnp(a):
    return None if a is None else jnp.asarray(a)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("d,rap,pre", PAIR_CASES)
def test_fwd_pair_plain_matches_jax_kernel(d, rap, pre):
    x, _, w31, b31, w13, rapw, pr = _pair_inputs(d * 10 + 2 * rap + pre, rap, pre)
    y_j, st_j = fwd_pair(jnp.asarray(x), jnp.asarray(w31), jnp.asarray(b31), jnp.asarray(w13),
                         _jnp(rapw), None if pr is None else tuple(map(jnp.asarray, pr)),
                         d=d, interpret=True)
    y, st = T.fwd_pair(to_nchw(x).contiguous(memory_format=torch.channels_last),
                       *_torch_args(w31, b31, w13, rapw, pr), d)
    np.testing.assert_allclose(_nhwc(y), np.asarray(y_j), atol=1e-5)
    np.testing.assert_allclose(st.numpy(), np.asarray(st_j), rtol=1e-5, atol=1e-2)


@pytest.mark.parametrize("d,rap,pre", PAIR_CASES)
def test_bwd_pair_plain_matches_jax_kernel(d, rap, pre):
    x, gy, w31, b31, w13, rapw, pr = _pair_inputs(d * 10 + 2 * rap + pre + 100, rap, pre)
    got = T.bwd_pair(to_nchw(x).contiguous(memory_format=torch.channels_last),
                     to_nchw(gy).contiguous(memory_format=torch.channels_last),
                     *_torch_args(w31, b31, w13, rapw, pr), d)
    want = bwd_pair(jnp.asarray(x), jnp.asarray(gy), jnp.asarray(w31), jnp.asarray(b31),
                    jnp.asarray(w13), _jnp(rapw),
                    None if pr is None else tuple(map(jnp.asarray, pr)), d=d, interpret=True)
    du, dw31, db31, dw13, drap = got
    np.testing.assert_allclose(_nhwc(du), np.asarray(want[0]), atol=1e-5)
    # torch OIHW -> HWIO, as the JAX kernel returns them
    np.testing.assert_allclose(dw31.numpy().transpose(2, 3, 1, 0), np.asarray(want[1]), atol=5e-4)
    np.testing.assert_allclose(db31.numpy(), np.asarray(want[2]), atol=5e-4)
    np.testing.assert_allclose(dw13.numpy().transpose(2, 3, 1, 0), np.asarray(want[3]), atol=5e-4)
    if rap:
        np.testing.assert_allclose(drap.numpy(), np.asarray(want[4]), atol=5e-4)
    else:
        assert drap is None and want[4] is None


BLOCK_CASES = [(1, True, 0.03), (2, True, 0.3), (16, True, 0.3), (1, False, 0.0)]


@pytest.mark.parametrize("d,rap,drop", BLOCK_CASES)
def test_train_block_matches_jax_xla_block(d, rap, drop):
    rng = np.random.default_rng(d + 10 * rap)
    if rap:
        p, s = B.nb1d_rap_init(jax.random.key(3), C, d, 2)
        blk, task = NonBottleneck1dRAP(C, d, 2, drop), 1
    else:
        p, s = B.nb1d_init(jax.random.key(3), C, d)
        blk, task = NonBottleneck1d(C, d, drop), None
    p, s = randomize_bn(p, s, rng)
    blk.load_state_dict(nb_block_state_dict(p, s), strict=True)
    blk.train()
    x = rng.normal(size=(N, H, W, C)).astype(np.float32)
    mask = rng.random((N, 1, 1, C)) < (1 - drop)
    cot = rng.normal(size=(N, H, W, C)).astype(np.float32)

    def ref(pp, xx):
        if rap:
            return B.nb1d_rap_apply(pp, s, xx, task=task, dilated=d, dropprob=drop,
                                    training=True, drop_mask=jnp.asarray(mask))
        return B.nb1d_apply(pp, s, xx, dilated=d, dropprob=drop, training=True,
                            drop_mask=jnp.asarray(mask))

    out_j, s_j = ref(p, jnp.asarray(x))
    gp_j, gx_j = jax.grad(lambda pp, xx: jnp.sum(ref(pp, xx)[0] * cot), argnums=(0, 1))(
        p, jnp.asarray(x))

    xt = to_nchw(x).contiguous(memory_format=torch.channels_last).requires_grad_()
    out = T.nb1d_train_apply(blk, xt, task, drop, torch.from_numpy(mask.reshape(N, C)))
    names = [k for k, _ in blk.named_parameters()]
    grads = torch.autograd.grad((out * to_nchw(cot)).sum(), [xt] + list(blk.parameters()),
                                allow_unused=True)

    np.testing.assert_allclose(_nhwc(out.detach()), np.asarray(out_j), atol=1e-4)
    np.testing.assert_allclose(_nhwc(grads[0]), np.asarray(gx_j), atol=2e-3)
    want_state = nb_block_state_dict(p, s_j)
    for k, v in blk.state_dict().items():
        if "running" in k:
            np.testing.assert_allclose(v.numpy(), want_state[k].numpy(), atol=1e-5, err_msg=k)
    want_grads = nb_block_state_dict(gp_j, None)
    for k, g in zip(names, grads[1:]):
        # the absorbed pre-BN biases get no gradient (None, zero in JAX)
        g = np.zeros_like(want_grads[k].numpy()) if g is None else g.numpy()
        np.testing.assert_allclose(g, want_grads[k].numpy(), atol=2e-3, err_msg=k)
