"""The hand-written CUDA kernels against their plain PyTorch versions, on the
card (marker `cuda`; skips without one): the nb1d inference kernel (K1), the
training conv pairs (K2 fwd_pair, K3 bwd_pair) and the training block built on
them, and the launches of one train step. Run on a machine with an H100:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Tolerances: float32 relative L2 1e-5 with TF32 off in the plain version
(cuDNN would otherwise run the float32 convs in TF32); bfloat16 relative L2
2e-2: both round c to bfloat16, but the plain version also rounds each conv
output (the 1x3 conv's y, the RAP term and their sum) to bfloat16 and sums in
cuDNN's order, while the kernel keeps y in float32 up to its epilogue. K2/K3 (float32 only) at relative L2
1e-5, and both (3xTF32 on the tensor cores) at their tile edges against
float64 (K2's batch mean and variance at 1e-4); K1's fp32 kernel runs K2's
mainloop and is held to K2's y bit for bit; the training block's
gradients at 1e-4 (the BN backward divides by the batch std).
"""
import numpy as np
import pytest
import torch

from mdilss_tpu_torch.models import ERFNetRAP
from mdilss_tpu_torch.models.blocks import NonBottleneck1d, NonBottleneck1dRAP
from mdilss_tpu_torch.ops import nb1d_infer as K
from mdilss_tpu_torch.ops import nb1d_train as T

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    old = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = old


def _randomize_bn(module, gen):
    """Random BN affine and running stats, drawn on the CPU from `gen`."""
    with torch.no_grad():
        for bn in (m for m in module.modules() if isinstance(m, torch.nn.BatchNorm2d)):
            c = bn.num_features
            bn.weight.copy_(torch.empty(c).uniform_(0.5, 1.5, generator=gen))
            bn.bias.copy_(torch.empty(c).normal_(0.0, 0.1, generator=gen))
            bn.running_mean.copy_(torch.empty(c).normal_(0.0, 0.1, generator=gen))
            bn.running_var.copy_(torch.empty(c).uniform_(0.5, 1.5, generator=gen))


# Both K1 kernels tile a row by 64 / 128 / 256 output columns (C = 128 / 64 / 16) and compute c
# for d more columns on each side, in passes of 96 / 192 / 384 columns: W below one tile or a
# multiple of none, H <= 2d (a row's taps skipped at both ends), a d that takes two passes,
# batch 1 and 6
K1_EDGE_SHAPES = [  # c, d, n, h, w
    (128, 16, 1, 20, 45),
    (128, 4, 6, 9, 150),
    (128, 40, 1, 5, 90),
    (64, 1, 6, 5, 300),
    (64, 16, 1, 7, 40),
    (64, 40, 1, 4, 100),
    (16, 1, 6, 8, 300),
    (16, 2, 1, 3, 50),
    (16, 70, 1, 4, 90),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("c,d,rap,n,h,w", [
    (64, 1, True, 2, 16, 48),
    (128, 2, True, 1, 16, 64),
    (128, 16, True, 2, 13, 37),   # ragged: H, W multiples of no tile
    (64, 1, False, 1, 24, 200),
    (16, 1, False, 2, 16, 300),
    *[(c, d, rap, n, h, w) for c, d, n, h, w in K1_EDGE_SHAPES for rap in (True, False)],
])
def test_kernel_matches_plain(cuda, dtype, c, d, rap, n, h, w):
    gen = torch.Generator().manual_seed(c * 100 + d)
    blk = NonBottleneck1dRAP(c, d, 3) if rap else NonBottleneck1d(c, d)
    _randomize_bn(blk, gen)
    blk = blk.to(cuda)
    x = torch.randn(n, c, h, w, generator=gen).to(cuda, dtype).contiguous(
        memory_format=torch.channels_last)
    ops = K.prepare_operands(blk, 1 if rap else None, dtype)
    before = K.LAUNCHES
    got = K.nb1d_infer(x, ops, d)
    torch.cuda.synchronize()
    assert K.LAUNCHES == before + K.LAUNCHES_PER_BLOCK
    want = K.nb1d_infer_plain(x, ops, d)
    assert got.shape == x.shape and got.dtype == dtype
    assert got.is_contiguous(memory_format=torch.channels_last)
    err = float((got.float() - want.float()).norm() / want.float().norm())
    assert err <= TOL[dtype], err


def test_kernel_rejects_what_it_does_not_take(cuda):
    blk = NonBottleneck1d(16, 1).to(cuda)
    ops = K.prepare_operands(blk, None, torch.float32)
    x = torch.randn(1, 16, 8, 8, device=cuda)  # NCHW-contiguous, not channels_last
    with pytest.raises(ValueError, match="channels_last"):
        K.nb1d_infer(x, ops, 1)
    x = x.contiguous(memory_format=torch.channels_last)
    with pytest.raises(ValueError, match="operand"):
        K.nb1d_infer(x.to(torch.bfloat16), ops, 1)  # float32 weights for bf16 x


def _random_block(c, d, rap, seed, dev):
    gen = torch.Generator().manual_seed(seed)
    blk = NonBottleneck1dRAP(c, d, 3) if rap else NonBottleneck1d(c, d)
    _randomize_bn(blk, gen)
    return blk.to(dev), gen


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("c,d", [(128, 8), (64, 1), (16, 1)])
def test_kernel_bitwise_repeatable(cuda, c, d, dtype):
    blk, gen = _random_block(c, d, c != 16, c + d, cuda)
    x = torch.randn(6, c, 16, 100, generator=gen).to(cuda, dtype).contiguous(
        memory_format=torch.channels_last)
    ops = K.prepare_operands(blk, 0 if c != 16 else None, dtype)
    assert torch.equal(K.nb1d_infer(x, ops, d), K.nb1d_infer(x, ops, d))


def test_kernels_raise_where_they_cannot_launch(cuda):
    """No fallback: a dilation whose halo does not fit in shared memory makes
    the launch fail and the wrapper raise, in either type."""
    for dtype in (torch.bfloat16, torch.float32):
        blk, gen = _random_block(128, 1, False, 3, cuda)
        x = torch.randn(1, 128, 4, 8, generator=gen).to(cuda, dtype).contiguous(
            memory_format=torch.channels_last)
        ops = K.prepare_operands(blk, None, dtype)
        before = K.LAUNCHES
        with pytest.raises(RuntimeError, match="launch failed"):
            K.nb1d_infer(x, ops, 1000)
        assert K.LAUNCHES == before + 1  # pair 1 (dilation 1) ran, pair 2 did not


def test_forward_launches_kernel_for_every_block(cuda):
    torch.manual_seed(0)
    model = ERFNetRAP([5, 7], 2, device=cuda)
    _randomize_bn(model, torch.Generator().manual_seed(1))
    x = torch.rand(1, 64, 128, 3, device=cuda)
    before = K.LAUNCHES
    logits = model(x, 1)
    torch.cuda.synchronize()
    assert K.LAUNCHES - before == 17 * K.LAUNCHES_PER_BLOCK
    ref = ERFNetRAP([5, 7], 2, device="cpu")
    ref.load_state_dict(model.state_dict())
    want = ref(x.cpu(), 1)
    err = float((logits.cpu() - want).norm() / want.norm())
    assert logits.shape == (1, 64, 128, 7) and err <= 1e-4, err
    assert np.isfinite(logits.cpu().numpy()).all()


# ---- training kernels K2 / K3 and the block K4 (ops/nb1d_train.py) ----------------------------
TRAIN_SHAPES = [  # c, d, n, h, w
    (64, 1, 2, 16, 48),
    (128, 2, 1, 16, 64),
    (128, 16, 2, 13, 37),   # ragged, and a halo larger than the image
    (16, 1, 2, 16, 300),
]


def _rel(got, want):
    got, want = got.detach().double(), want.detach().double()
    return float((got - want).norm() / want.norm())


def _pair_args(gen, c, use_rap, use_pre, dev):
    mk = lambda *s: (torch.randn(*s, generator=gen) * 0.2).to(dev)  # noqa: E731
    pre = ((1.0 + mk(c)).abs(), mk(c)) if use_pre else None
    return mk(c, c, 3, 1), mk(c), mk(c, c, 1, 3), mk(c, c) if use_rap else None, pre


@pytest.mark.parametrize("use_rap,use_pre", [(False, False), (True, True), (True, False),
                                             (False, True)])
@pytest.mark.parametrize("c,d,n,h,w", TRAIN_SHAPES)
def test_train_pairs_match_plain(cuda, c, d, n, h, w, use_rap, use_pre):
    gen = torch.Generator().manual_seed(c + d + h)
    w31, b31, w13, rap, pre = _pair_args(gen, c, use_rap, use_pre, cuda)
    x = torch.randn(n, c, h, w, generator=gen).to(cuda).contiguous(memory_format=torch.channels_last)
    gy = torch.randn(n, c, h, w, generator=gen).to(cuda).contiguous(memory_format=torch.channels_last)
    before = T.LAUNCHES_FWD, T.LAUNCHES_BWD
    y, st = T.fwd_pair(x, w31, b31, w13, rap, pre, d)
    got = T.bwd_pair(x, gy, w31, b31, w13, rap, pre, d)
    torch.cuda.synchronize()
    assert (T.LAUNCHES_FWD, T.LAUNCHES_BWD) == (before[0] + 1, before[1] + 1)
    y_p, st_p = T.fwd_pair_plain(x, w31, b31, w13, rap, pre, d)
    want = T.bwd_pair_plain(x, gy, w31, b31, w13, rap, pre, d)
    assert y.is_contiguous(memory_format=torch.channels_last) and st.shape == (2, c)
    assert _rel(y, y_p) <= 1e-5 and _rel(st, st_p) <= 1e-5
    for name, g, g_p in zip(("du", "dw31", "db31", "dw13", "drap"), got, want):
        if g_p is None:
            assert g is None
            continue
        assert g.shape == g_p.shape, name
        assert _rel(g, g_p) <= 1e-5, (name, _rel(g, g_p))


# K3 on the tensor cores tiles its conv launches by 64 / 128 / 256 pixels of a row (C = 128 / 64
# / 16) and its weight gradients by 32 / 32 / 128 pixels of a row: each W is a multiple of
# neither, or below one conv tile
K3_EDGE_SHAPES = [  # c, d, n, h, w
    (128, 2, 1, 5, 71),
    (64, 1, 1, 3, 135),
    (16, 1, 1, 3, 263),
    (16, 4, 2, 7, 37),
]


@pytest.mark.parametrize("use_rap,use_pre", [(True, True), (False, False)])
@pytest.mark.parametrize("c,d,n,h,w", K3_EDGE_SHAPES)
def test_bwd_pair_tile_edges_match_float64(cuda, c, d, n, h, w, use_rap, use_pre):
    gen = torch.Generator().manual_seed(3 * c + w)
    args = _pair_args(gen, c, use_rap, use_pre, cuda)
    x = torch.randn(n, c, h, w, generator=gen).to(cuda).contiguous(memory_format=torch.channels_last)
    gy = torch.randn(n, c, h, w, generator=gen).to(cuda).contiguous(memory_format=torch.channels_last)
    got = T.bwd_pair(x, gy, *args, d)
    w31, b31, w13, rap, pre = args
    want = T.bwd_pair_plain(x.double(), gy.double(), w31.double(), b31.double(), w13.double(),
                            None if rap is None else rap.double(),
                            None if pre is None else tuple(t.double() for t in pre), d)
    for name, g, g_p in zip(("du", "dw31", "db31", "dw13", "drap"), got, want):
        if g_p is None:
            assert g is None
            continue
        assert g.shape == g_p.shape and g.dtype == torch.float32, name
        assert _rel(g, g_p) <= 1e-5, (name, _rel(g, g_p))


# K2 on the tensor cores tiles a row by 64 / 128 / 256 output columns (C = 128 / 64 / 16) and
# computes c for d more columns on each side in stage-A passes of 96 / 192 / 384 columns: W below
# one tile or a multiple of none, d >= TM (d = 40 and 70, two or three passes), H < 2d (both row
# taps skipped), batch 1 and 6
K2_EDGE_SHAPES = [  # c, d, n, h, w
    (128, 1, 1, 5, 71),
    (128, 40, 2, 9, 150),
    (128, 70, 1, 5, 90),
    (64, 1, 1, 3, 135),
    (64, 2, 6, 7, 300),
    (64, 40, 1, 4, 100),
    (16, 1, 1, 3, 263),
    (16, 4, 2, 7, 37),
    (16, 70, 1, 4, 90),
]


def _f64(t):
    return None if t is None else (tuple(x.double() for x in t) if isinstance(t, tuple)
                                   else t.double())


@pytest.mark.parametrize("use_rap,use_pre", [(True, True), (False, False), (True, False),
                                             (False, True)])
@pytest.mark.parametrize("c,d,n,h,w", K2_EDGE_SHAPES)
def test_fwd_pair_tile_edges_match_float64(cuda, c, d, n, h, w, use_rap, use_pre):
    """y at 1e-5 relative L2 against the plain pair in float64; the batch mean
    and variance from the stats at 1e-4 against a float64 two-pass over y."""
    gen = torch.Generator().manual_seed(5 * c + d + w)
    args = _pair_args(gen, c, use_rap, use_pre, cuda)
    x = torch.randn(n, c, h, w, generator=gen).to(cuda).contiguous(memory_format=torch.channels_last)
    y, st = T.fwd_pair(x, *args, d)
    y64, _ = T.fwd_pair_plain(x.double(), *(_f64(a) for a in args), d)
    assert y.shape == x.shape and y.is_contiguous(memory_format=torch.channels_last)
    assert _rel(y, y64) <= 1e-5, _rel(y, y64)
    count = n * h * w
    yd = y.double()
    m64 = yd.mean((0, 2, 3))
    v64 = (yd - m64.view(1, -1, 1, 1)).square().mean((0, 2, 3))
    mu = st[0].double() / count
    var = torch.clamp(st[1].double() / count - mu * mu, min=0.0)
    assert float((mu - m64).norm() / v64.sqrt().norm()) <= 1e-4
    assert float((var - v64).norm() / v64.norm()) <= 1e-4


def _tf32_rna(v: torch.Tensor) -> torch.Tensor:
    return ((v.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def test_fwd_and_bwd_compute_the_same_c(cuda):
    """K2's stage A and K3's bwd_dc_kernel compute c with the same code in the
    same order. With w13 the identity at its centre tap and no RAP, K2's y is
    3xTF32 of c x 1, which is hi(c) + lo(c) exactly; so y must equal hi + lo
    of the c that K3 writes to its scratch, bit for bit."""
    c, d, n, h, w = 64, 2, 2, 9, 150
    gen = torch.Generator().manual_seed(11)
    w31, b31, _, _, pre = _pair_args(gen, c, False, True, cuda)
    w13 = torch.zeros(c, c, 1, 3, device=cuda)
    w13[:, :, 0, 1] = torch.eye(c, device=cuda)
    x = torch.randn(n, c, h, w, generator=gen).to(cuda).contiguous(memory_format=torch.channels_last)
    gy = torch.randn(n, c, h, w, generator=gen).to(cuda).contiguous(memory_format=torch.channels_last)
    y, _ = T.fwd_pair(x, w31, b31, w13, None, pre, d)
    lib = T._library()
    w31s, b31v, w13s, _, pa, pb = T._kernel_operands(x, w31, b31, w13, None, pre)
    scratch = torch.empty(lib.nb1d_train_bwd_scratch(c, n, h, w, 0), device=cuda)
    du = torch.empty_like(x)
    grads = torch.empty(lib.nb1d_train_grad_len(c, 0), device=cuda)
    rc = lib.nb1d_train_bwd(c, x.data_ptr(), gy.data_ptr(), w31s.data_ptr(), b31v.data_ptr(),
                            T._stack_t(w13s).data_ptr(), T._stack_t(w31s).data_ptr(), None,
                            pa.data_ptr(), pb.data_ptr(), du.data_ptr(), grads.data_ptr(),
                            scratch.data_ptr(), n, h, w, d, torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert rc == 0
    c_k3 = scratch[: n * h * w * c].view(n, h, w, c)  # K3's c, NHWC
    hi = _tf32_rna(c_k3)
    want = hi + _tf32_rna(c_k3 - hi)
    got = y.permute(0, 2, 3, 1)
    assert int((c_k3 > 0).sum()) > 0
    assert torch.equal(got, want), int((got != want).sum())


@pytest.mark.parametrize("rap", [True, False], ids=["rap", "plain"])
@pytest.mark.parametrize("d", [1, 16])
@pytest.mark.parametrize("c", [16, 64, 128])
def test_k1_fp32_and_k2_compute_the_same_y(cuda, c, d, rap):
    """K1's fp32 kernel and K2 run the same pair mainloop (csrc/tf32_pair.cuh).
    One K1 pair with a = 1, b = 0 and no residual writes relu(fma(1, y, 0)) =
    relu(y), so it must equal relu of K2's y (no pre-stage) bit for bit; W
    spans several column tiles and ends in a ragged one."""
    gen = torch.Generator().manual_seed(7 * c + d + rap)
    w31, b31, w13, rapw, _ = _pair_args(gen, c, rap, False, cuda)
    n, h, w = 2, 9, 300
    x = torch.randn(n, c, h, w, generator=gen).to(cuda).contiguous(memory_format=torch.channels_last)
    y, _ = T.fwd_pair(x, w31, b31, w13, rapw, None, d)
    w31s, b31v, w13s, rapm, _, _ = T._kernel_operands(x, w31, b31, w13, rapw, None)
    ones = torch.ones(c, device=cuda)
    before = K.LAUNCHES
    got = K._launch_pair(x, w31s, b31v, w13s, rapm, ones, torch.zeros_like(ones), None, d)
    torch.cuda.synchronize()
    assert K.LAUNCHES == before + 1
    assert int((y > 0).sum()) > 0 and int((y < 0).sum()) > 0
    assert torch.equal(got, torch.relu(y)), int((got != torch.relu(y)).sum())


def test_fwd_pair_raises_where_its_halo_does_not_fit(cuda):
    """No fallback: c for TM + 2d columns past the shared memory of a block
    makes the launch fail and the wrapper raise."""
    gen = torch.Generator().manual_seed(2)
    for c in (128, 16):
        args = _pair_args(gen, c, False, False, cuda)
        x = torch.randn(1, c, 4, 8, generator=gen).to(cuda).contiguous(
            memory_format=torch.channels_last)
        before = T.LAUNCHES_FWD
        with pytest.raises(RuntimeError, match="launch failed"):
            T.fwd_pair(x, *args, 1000)
        assert T.LAUNCHES_FWD == before


def test_train_pairs_bitwise_repeatable(cuda):
    gen = torch.Generator().manual_seed(7)
    c, d, n, h, w = 128, 4, 2, 16, 64
    w31, b31, w13, rap, pre = _pair_args(gen, c, True, True, cuda)
    x = torch.randn(n, c, h, w, generator=gen).to(cuda).contiguous(memory_format=torch.channels_last)
    gy = torch.randn(n, c, h, w, generator=gen).to(cuda).contiguous(memory_format=torch.channels_last)
    first = (*T.fwd_pair(x, w31, b31, w13, rap, pre, d), *T.bwd_pair(x, gy, w31, b31, w13, rap, pre, d))
    second = (*T.fwd_pair(x, w31, b31, w13, rap, pre, d), *T.bwd_pair(x, gy, w31, b31, w13, rap, pre, d))
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("c,d,rap", [(64, 1, True), (128, 16, True), (16, 1, False)])
def test_train_block_matches_plain_pairs(cuda, c, d, rap):
    gen = torch.Generator().manual_seed(c * 10 + d)
    torch.manual_seed(c + d)
    blocks = [NonBottleneck1dRAP(c, d, 2, 0.3) if rap else NonBottleneck1d(c, d) for _ in range(2)]
    blocks[1].load_state_dict(blocks[0].state_dict())
    for blk in blocks:
        blk.to(cuda).train()
    x = torch.randn(2, c, 16, 40, generator=gen).to(cuda).contiguous(memory_format=torch.channels_last)
    mask = (torch.rand(2, c, generator=gen) < 0.7).to(cuda) if rap else None
    cot = torch.randn(2, c, 16, 40, generator=gen).to(cuda)
    results = []
    for blk, pairs in zip(blocks, (T.KERNEL_PAIRS, T.PLAIN_PAIRS)):
        xi = x.clone().requires_grad_()
        out = T.nb1d_train_apply(blk, xi, 1 if rap else None, 0.3 if rap else 0.0, mask, pairs)
        params = [p for _, p in blk.named_parameters()]
        grads = torch.autograd.grad((out * cot).sum(), [xi] + params, allow_unused=True)
        results.append((out, grads, [b.clone() for b in blk.buffers()]))
    (out_k, g_k, b_k), (out_p, g_p, b_p) = results
    assert _rel(out_k, out_p) <= 1e-5
    for a, b in zip(g_k, g_p):
        assert (a is None) == (b is None)
        if a is not None and b.norm() > 0:
            assert _rel(a, b) <= 1e-4
    for a, b in zip(b_k, b_p):  # running stats; the other task's stay as they were
        if a.is_floating_point() and b.norm() > 0:
            assert _rel(a, b) <= 1e-5
        else:
            assert torch.equal(a, b)


def test_train_wrappers_reject_what_the_kernel_does_not_take(cuda):
    gen = torch.Generator().manual_seed(1)
    w31, b31, w13, rap, pre = _pair_args(gen, 64, True, True, cuda)
    x = torch.randn(1, 64, 8, 8, device=cuda)  # NCHW-contiguous
    with pytest.raises(ValueError, match="channels_last"):
        T.fwd_pair(x, w31, b31, w13, rap, pre, 1)
    x = x.contiguous(memory_format=torch.channels_last)
    with pytest.raises(TypeError, match="float32"):
        T.fwd_pair(x.to(torch.bfloat16), w31, b31, w13, rap, pre, 1)
    with pytest.raises(ValueError, match="operand w13"):
        T.bwd_pair(x, x, w31, b31, w13[:32], rap, pre, 1)
    x32 = torch.randn(1, 32, 8, 8, device=cuda).contiguous(memory_format=torch.channels_last)
    with pytest.raises(ValueError, match="C in"):
        T.fwd_pair(x32, w31[:32, :32], b31[:32], w13[:32, :32], None, None, 1)


def test_train_step_launches_every_kernel(cuda):
    from mdilss_tpu_torch.models.topology import make_dropout_masks
    from mdilss_tpu_torch.train import steps
    from mdilss_tpu_torch.train.masks import rap_lr_tree

    torch.manual_seed(0)
    student, teacher = ERFNetRAP([5, 5], 2, device=cuda), ERFNetRAP([5], 1, device=cuda)
    lr = rap_lr_tree(student, current_task=1, shared_lr=5e-6, ds_lr=5e-4)
    step = steps.make_distill_step(current_task=1, prev_tasks=(0,),
                                   class_weight=np.ones(5, np.float32), lr_tree=lr, num_epochs=150)
    ts = steps.init_train_state(student)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.random((2, 64, 128, 3), dtype=np.float32)).to(cuda)
    y = torch.from_numpy(rng.integers(0, 5, (2, 64, 128))).to(cuda)
    masks = [make_dropout_masks(rng, 2) for _ in range(2)]
    before = K.LAUNCHES, T.LAUNCHES_FWD, T.LAUNCHES_BWD
    ts, metrics = step(ts, teacher, x, y, masks, 1)
    torch.cuda.synchronize()
    # K1: the teacher's 17 blocks; K2/K3: 2 student forwards x 17 blocks x 2 pairs
    assert (K.LAUNCHES - before[0], T.LAUNCHES_FWD - before[1],
            T.LAUNCHES_BWD - before[2]) == (34, 68, 68)
    assert all(np.isfinite(float(v)) for v in metrics.values())


def _step3_setup(cuda, seed: int = 0):
    """Student [5, 5, 6] at task 2 with previous tasks (1, 0), teacher [5, 5],
    a 2x64x128 batch and the three student forwards' dropout masks."""
    from mdilss_tpu_torch.models.topology import make_dropout_masks

    torch.manual_seed(seed)
    student, teacher = ERFNetRAP([5, 5, 6], 3, device=cuda), ERFNetRAP([5, 5], 2, device=cuda)
    gen = torch.Generator().manual_seed(seed + 1)
    _randomize_bn(student, gen)
    _randomize_bn(teacher, gen)
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.random((2, 64, 128, 3), dtype=np.float32)).to(cuda)
    y = torch.from_numpy(rng.integers(0, 6, (2, 64, 128))).to(cuda)
    masks = [make_dropout_masks(rng, 2) for _ in range(5)]
    return student, teacher, x, y, masks


def _step3(student, **kw):
    from mdilss_tpu_torch.train import steps
    from mdilss_tpu_torch.train.masks import rap_lr_tree

    lr = rap_lr_tree(student, current_task=2, shared_lr=5e-6, ds_lr=5e-4)
    return steps.make_two_phase_distill_step(current_task=2, prev_tasks=(1, 0),
                                             class_weight=np.ones(6, np.float32), lr_tree=lr,
                                             num_epochs=150, iou_train=True, **kw)


def _launches():
    return K.LAUNCHES, T.LAUNCHES_FWD, T.LAUNCHES_BWD


@pytest.mark.parametrize("mode,want", [
    # K2: 3 student + 2 train-mode teacher forwards x 34; K3: 3 student backwards x 34
    ("train_teacher", (0, 170, 102)),
    ("teacher_dropout", (0, 170, 102)),
    # the eval-mode teacher runs K1: 2 forwards x 34
    ("eval_teacher", (68, 102, 102)),
])
def test_two_phase_step_launches_and_leaves_the_teacher_as_it_was(cuda, mode, want):
    from mdilss_tpu_torch.train import steps

    kw = {"train_teacher": {}, "teacher_dropout": {"teacher_dropout": True},
          "eval_teacher": {"teacher_training": False}}[mode]
    student, teacher, x, y, masks = _step3_setup(cuda)
    n_masks = 5 if mode == "teacher_dropout" else 3
    before_state = {k: v.clone() for k, v in teacher.state_dict().items()}
    step = _step3(student, **kw)
    ts = steps.init_train_state(student)
    for _ in range(2):
        before = _launches()
        count = ts.opt.count
        ts, m = step(ts, teacher, x, y, masks[:n_masks], 1)
        torch.cuda.synchronize()
        assert tuple(a - b for a, b in zip(_launches(), before)) == want
        assert ts.opt.count == count + 2
        assert all(np.isfinite(float(m[k])) for k in ("loss", "ce", "kld"))
        assert int(m["cm"].sum()) == y.numel()
        assert all(torch.equal(v, before_state[k]) for k, v in teacher.state_dict().items())
        assert not teacher.training


def test_two_phase_step_is_bitwise_repeatable(cuda):
    """Two runs of a step-3 batch from the same state give bitwise-equal
    parameters, running statistics and losses. K2, K3, the BN glue and Adam
    are deterministic; cuDNN's transposed convolutions (the upsamplers) are
    not bit-reproducible between runs with its default algorithms, so the
    test pins cuDNN to its deterministic ones."""
    import copy

    from mdilss_tpu_torch.train import steps

    student, teacher, x, y, masks = _step3_setup(cuda, seed=3)
    twin = copy.deepcopy(student)
    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        out = []
        for s in (student, twin):
            _, m = _step3(s)(steps.init_train_state(s), teacher, x, y, masks[:3], 1)
            out.append(m)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = old
    for k in ("loss", "ce", "kld", "cm"):
        assert torch.equal(out[0][k], out[1][k]), k
    a, b = student.state_dict(), twin.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_ce_and_eval_steps_launch_their_kernels(cuda):
    from mdilss_tpu_torch.models.topology import make_dropout_masks
    from mdilss_tpu_torch.train import steps
    from mdilss_tpu_torch.train.masks import rap_lr_tree

    student, _, x, y, _ = _step3_setup(cuda)
    ev = steps.make_eval_step(task=2, class_weight=np.ones(6, np.float32), num_classes=6)
    before = _launches()
    loss, cm = ev(student, x, y)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(_launches(), before)) == (34, 0, 0)
    assert np.isfinite(float(loss)) and int(cm.sum()) == y.numel() and cm.device == x.device

    torch.manual_seed(1)
    model = ERFNetRAP([6], 1, device=cuda)
    lr = rap_lr_tree(model, current_task=0, shared_lr=5e-4, ds_lr=5e-4)
    ce = steps.make_ce_step(task=0, class_weight=np.ones(6, np.float32), lr_tree=lr,
                            num_epochs=150, iou_train=True)
    before = _launches()
    ts, m = ce(steps.init_train_state(model), x, y, make_dropout_masks(np.random.default_rng(1), 2),
               1)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(_launches(), before)) == (0, 34, 34)
    assert np.isfinite(float(m["loss"])) and int(m["cm"].sum()) == y.numel() and ts.opt.count == 1
