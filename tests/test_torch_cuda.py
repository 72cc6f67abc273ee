"""The hand-written CUDA kernels against their plain PyTorch versions, on the
card (marker `cuda`; skips without one): the nb1d inference kernel (K1), the
training conv pairs (K2 fwd_pair, K3 bwd_pair) and the training block built on
them, and the launches of one train step; the steps, the data path and the
trainer on the card; (slice 10) the fp32 steps with TF32 at PyTorch's
defaults, an exported head running K1, and extract_features; and the four
ablation models' step-2 step against the CPU and their decoder-only launches;
(bf16 training) K2/K3's bf16 kernels against their plain bf16 versions at
each channel count, bitwise reruns, the bf16 c and y shared with K1 bf16,
the types the kernels refuse, and a bf16 training forward and backward; K3
bf16 and K2 bf16 at the edges of their tiles against float64 and the plain
bf16 pair, bitwise reruns there, and K2 bf16's c and y against K3's and K1's
there; (remat) a block, a model's training forward and backward and the
step-2 and step-3 steps with their remat regions, K2 rerun in the backward,
bit for bit as without regions, the running statistics updated once; (the
spatial axis) K2's stats window, and K1, K2 and K3 on padded slabs of the
encoder's 1/8 maps against the whole calls (`chip_smoke.padded_slab_case`).
Run on a machine with an H100:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Tolerances: float32 relative L2 1e-5 with TF32 off in the plain version
(cuDNN would otherwise run the float32 convs in TF32); bfloat16 relative L2
2e-2: both round c to bfloat16, but the plain version also rounds each conv
output (the 1x3 conv's y, the RAP term and their sum) to bfloat16 and sums in
cuDNN's order, while the kernel keeps y in float32 up to its epilogue. K2/K3 (float32 only) at relative L2
1e-5, and both (3xTF32 on the tensor cores) at their tile edges against
float64 (K2's batch mean and variance at 1e-4); K1's fp32 kernel runs K2's
mainloop and is held to K2's y bit for bit; the training block's
gradients at 1e-4 (the BN backward divides by the batch std). K2/K3 in
bfloat16 at relative L2 1e-2 against their plain bf16 versions, which round
at the same points (chip_smoke.py's TOL_BF16_PAIR).
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
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        T.fwd_pair(x.to(torch.float16), w31, b31, w13, rap, pre, 1)
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


# ---- the data path and the trainer on the card ----------------------------------------------

def _synthetic_loader(n=7, batch=3, h=16, w=24, shuffle=True):
    from mdilss_tpu_torch.data.loader import Loader, SyntheticSource

    return Loader(SyntheticSource(6, n=n, height=h, width=w, seed=2), batch_size=batch,
                  height=h, width=w, shuffle=shuffle, seed=3, num_threads=2)


def test_augment_batch_on_the_card_equals_the_cpu(cuda):
    from mdilss_tpu_torch.data.transforms import augment_batch, draw_augment

    rng = np.random.default_rng(0)
    imgs = torch.from_numpy(rng.integers(0, 256, (8, 32, 48, 3), dtype=np.uint8))
    lbls = torch.from_numpy(rng.integers(0, 20, (8, 32, 48)).astype(np.uint8))
    lbls[:, 5] = 255
    for seed in range(3):
        draws = draw_augment(torch.Generator().manual_seed(seed), 8)
        want = augment_batch(imgs, lbls, *draws, num_classes=20)
        got = augment_batch(imgs.to(cuda), lbls.to(cuda), *draws, num_classes=20)
        for g, w in zip(got, want):
            assert g.device.type == "cuda" and g.dtype == w.dtype
            assert torch.equal(g.cpu(), w)


def test_device_caches_on_the_card_hold_the_host_rows(cuda):
    from mdilss_tpu_torch.data.device_cache import DeviceCache, HybridCache

    ld = _synthetic_loader()
    full, hybrid = DeviceCache(ld, device=cuda), HybridCache(ld, 4, device=cuda)
    assert full.images.device.type == "cuda" and full.images.dtype == torch.uint8
    idx = np.array([6, 0, 4])
    imgs, lbls = full.take(idx)
    for row, i in enumerate(idx):
        img, lbl = ld.source.decode(int(i), ld.height, ld.width)
        assert torch.equal(imgs[row].cpu(), torch.from_numpy(img))
        assert torch.equal(lbls[row].cpu(), torch.from_numpy(lbl))
    for epoch in (0, 1):
        ld.set_epoch(epoch)
        stream = list(ld)
        for cache in (full, hybrid):
            got = list(cache.epoch_batches(epoch))
            assert len(got) == len(stream) == 2
            for (gi, gl, gv), (si, sl, sv) in zip(got, stream):
                assert gi.device.type == "cuda" and np.array_equal(gv, sv)
                assert torch.equal(gi.cpu(), torch.from_numpy(si))
                assert torch.equal(gl.cpu(), torch.from_numpy(sl))


def test_device_prefetch_under_a_busy_stream(cuda):
    """The current stream is kept busy (a sleep kernel) before each batch is
    read and its tensors are dropped at once: a batch read before its copy
    landed, or memory handed to the next copy while a queued kernel still
    reads it, would show as a batch unequal to the host's."""
    from mdilss_tpu_torch.data.loader import device_prefetch

    ld = _synthetic_loader(n=24, batch=2, h=64, w=96, shuffle=False)
    host = list(ld)
    copies = []
    for imgs, lbls, valid in device_prefetch(ld, depth=2, device=cuda):
        torch.cuda._sleep(2_000_000)
        copies.append((imgs.clone(), lbls.clone(), valid.clone()))
        del imgs, lbls, valid
    torch.cuda.synchronize()
    assert len(copies) == len(host) == 12
    for got, want in zip(copies, host):
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), torch.from_numpy(w))


def test_trainer_epoch_is_bitwise_repeatable(cuda, tmp_path):
    from mdilss_tpu_torch import config as C
    from mdilss_tpu_torch.train.loop import Trainer

    kw = dict(num_epochs=1, synthetic=True, synthetic_size=4, batch_size=2, height=64,
              width=128, num_workers=2, iou_train=True)
    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        states = []
        for name in ("a", "b"):
            torch.manual_seed(3)
            teacher = ERFNetRAP([20], 1, device=cuda)
            tr = Trainer(C.step2(savedir=str(tmp_path / name), **kw), teacher=teacher,
                         device=cuda)
            assert tr.device.type == "cuda"
            before = _launches()
            row = tr.fit()
            assert all(a > b for a, b in zip(_launches(), before))
            states.append((row, tr.ts.model.state_dict(), tr.ts.opt))
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = old
    (ra, sa, oa), (rb, sb, ob) = states
    assert {k: v for k, v in ra.items() if k != "epoch_seconds"} == {
        k: v for k, v in rb.items() if k != "epoch_seconds"}
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert torch.equal(oa.m, ob.m) and torch.equal(oa.v, ob.v) and oa.count == ob.count == 2


def test_evaluate_checkpoint_raises_on_float64_on_the_card(cuda, tmp_path):
    from mdilss_tpu_torch.ckpt import torch_io
    from mdilss_tpu_torch.evaluate import evaluate_checkpoint
    from mdilss_tpu_torch.train import steps

    model = ERFNetRAP([6], 1, device=cuda)
    torch_io.save(str(tmp_path / "ck"), 1, steps.init_train_state(model), best_acc=0.0,
                  aug_state=torch.Generator().get_state())
    for device in (None, "cuda"):
        with pytest.raises(ValueError, match="float64"):
            evaluate_checkpoint(str(tmp_path / "ck"), kind="rap", datasets=["cityscapes"],
                                compute_dtype="float64", device=device)
    out = evaluate_checkpoint(str(tmp_path / "ck"), kind="rap", datasets=["cityscapes"],
                              height=64, width=128, synthetic=True)
    assert 0.0 <= out["cityscapes"] <= 1.0


@pytest.mark.parametrize("c,d,drop", [(64, 1, 0.03), (128, 8, 0.3)])
def test_plain_encoder_block_with_dropout_matches_float64(cuda, c, d, drop):
    """The plain encoder's training block (NonBottleneck1d with its Dropout2d
    rate, in the multi-head and single-task models) through K2/K3 against the
    same block from the plain pairs in float64, at chip_smoke.py phase 6's
    tolerances: output and running statistics 1e-5, gradients 2e-3 (relu
    kinks within float32 rounding flip between the two)."""
    gen = torch.Generator().manual_seed(c + d)
    torch.manual_seed(c * 3 + d)
    blk = NonBottleneck1d(c, d, drop)
    _randomize_bn(blk, gen)
    twin = NonBottleneck1d(c, d, drop).double()
    twin.load_state_dict(blk.state_dict())
    x = torch.randn(2, c, 32, 64, generator=gen).to(cuda)
    cot = torch.randn(2, c, 32, 64, generator=gen).to(cuda)
    mask = (torch.rand(2, c, generator=gen) < 1 - drop).to(cuda)
    assert not mask.all()
    res = []
    for b, pairs, dt in ((blk, T.KERNEL_PAIRS, torch.float32),
                         (twin, T.PLAIN_PAIRS, torch.float64)):
        b.to(cuda).train()
        xi = x.to(dt).contiguous(memory_format=torch.channels_last).requires_grad_()
        before = T.LAUNCHES_FWD, T.LAUNCHES_BWD
        out = T.nb1d_train_apply(b, xi, None, drop, mask, pairs)
        grads = torch.autograd.grad((out * cot.to(dt)).sum(), [xi] + list(b.parameters()),
                                    allow_unused=True)
        launched = (T.LAUNCHES_FWD - before[0], T.LAUNCHES_BWD - before[1])
        res.append((out, grads, [t.clone() for n, t in b.named_buffers() if "running" in n],
                    launched))
    (out_k, g_k, r_k, n_k), (out_p, g_p, r_p, n_p) = res
    assert n_k == (2, 2) and n_p == (0, 0)
    assert _rel(out_k, out_p) <= 1e-5
    for a, b in zip(g_k, g_p):
        assert (a is None) == (b is None)
        if a is not None and b.norm() > 0:
            assert _rel(a, b) <= 2e-3
    for a, b in zip(r_k, r_p):
        assert _rel(a, b) <= 1e-5


def test_step2_build_trainer_fit_on_the_card_equals_the_cpu(cuda, tmp_path):
    """build_trainer + fit of step 2 from a step-1 checkpoint directory at
    2x128x256 (one batch, one epoch) on the card and on the CPU: the batch's
    loss, ce and kld within 1e-5 relative and the student's running
    statistics within 1e-5 rel L2 (chip_smoke.py phase 11's card-vs-CPU
    tolerances; both come from the forward before the Adam step), every
    parameter within 2 lr (Adam's first step is lr * sign(g)), the frozen ones
    and the teacher bitwise as loaded; K1/K2/K3 launched on the card only."""
    from mdilss_tpu_torch import config as C
    from mdilss_tpu_torch.ckpt import torch_io
    from mdilss_tpu_torch.train import steps
    from mdilss_tpu_torch.train.protocols import build_trainer

    torch.manual_seed(7)
    prev = ERFNetRAP([20], 1, device="cpu")
    _randomize_bn(prev, torch.Generator().manual_seed(8))
    torch_io.save(str(tmp_path / "step1" / "best"), 1, steps.init_train_state(prev),
                  best_acc=0.0, aug_state=torch.Generator().get_state())
    kw = dict(num_epochs=1, synthetic=True, synthetic_size=2, batch_size=2, height=128,
              width=256, num_workers=1, state=str(tmp_path / "step1" / "best"))
    runs = {}
    for dev in ("cpu", cuda):
        name = torch.device(dev).type
        tr = build_trainer(C.step2(savedir=str(tmp_path / name), **kw), device=dev)
        before = _launches()
        row = tr.fit()
        runs[name] = (row, {k: v.cpu() for k, v in tr.ts.model.state_dict().items()},
                      {k: v.cpu() for k, v in tr.teacher.state_dict().items()},
                      tuple(a - b for a, b in zip(_launches(), before)), tr._lr_tree())
    (rc, sc, tc, nc, lr), (rg, sg, tg, ng, _) = runs["cpu"], runs["cuda"]
    assert nc == (0, 0, 0) and all(n > 0 for n in ng)
    for k in ("train_loss", "train_ce", "train_kld"):
        assert abs(rg[k] - rc[k]) <= 1e-5 * abs(rc[k]), (k, rg[k], rc[k])
    running = [k for k in sc if "running" in k]
    assert _rel(torch.cat([sg[k].reshape(-1) for k in running]),
                torch.cat([sc[k].reshape(-1) for k in running])) <= 1e-5
    loaded = torch_io.load_state(str(tmp_path / "step1" / "best"), "rap")
    for k, v in lr.items():
        assert (sg[k] - sc[k]).abs().max() <= 2 * v + 1e-6, k
        if v == 0.0:
            assert torch.equal(sg[k], loaded[k]) and torch.equal(sc[k], loaded[k]), k
    for k, v in loaded.items():
        assert torch.equal(tg[k], v) and torch.equal(tc[k], v), k


# ---- slice 10: TF32 at PyTorch's defaults, exported heads, extract_features ------------------

def test_fp32_steps_ignore_the_global_tf32_flags(cuda):
    """C4: with the global flags at PyTorch's defaults (cuDNN's fp32 convs in
    TF32), one step-2 step and one eval step at 2x128x256 on the card equal
    the CPU's to 1e-5 (loss, the student's running statistics, the eval
    loss), as chip_smoke.py phase 11 holds them: the package's steps turn
    TF32 off themselves, and put the flag back after."""
    from mdilss_tpu_torch.models.topology import make_dropout_masks
    from mdilss_tpu_torch.train import steps
    from mdilss_tpu_torch.train.masks import rap_lr_tree

    torch.backends.cudnn.allow_tf32 = True  # the fixture restores its own setting after
    torch.manual_seed(3)
    student, teacher = ERFNetRAP([20, 20], 2, device="cpu"), ERFNetRAP([20], 1, device="cpu")
    _randomize_bn(student, torch.Generator().manual_seed(4))
    _randomize_bn(teacher, torch.Generator().manual_seed(5))
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.random((2, 128, 256, 3), dtype=np.float32))
    y = torch.from_numpy(rng.integers(0, 20, (2, 128, 256)))
    masks = [make_dropout_masks(rng, 2) for _ in range(2)]
    out = {}
    for dev in ("cpu", cuda):
        s, t = ERFNetRAP([20, 20], 2, device=dev), ERFNetRAP([20], 1, device=dev)
        s.load_state_dict(student.state_dict())
        t.load_state_dict(teacher.state_dict())
        lr = rap_lr_tree(s, current_task=1, shared_lr=5e-6, ds_lr=5e-4)
        step = steps.make_distill_step(current_task=1, prev_tasks=(0,),
                                       class_weight=np.ones(20, np.float32), lr_tree=lr,
                                       num_epochs=150)
        _, m = step(steps.init_train_state(s), t, x.to(dev), y.to(dev), masks, 1)
        ev = steps.make_eval_step(task=0, class_weight=np.ones(20, np.float32), num_classes=20)
        loss, _ = ev(t, x.to(dev), y.to(dev))
        running = torch.cat([b.reshape(-1).cpu() for k, b in s.named_buffers() if "running" in k])
        out[torch.device(dev).type] = (float(m["loss"]), running, float(loss))
    assert torch.backends.cudnn.allow_tf32
    (lg, rg, eg), (lc, rc, ec) = out["cuda"], out["cpu"]
    assert abs(lg - lc) <= 1e-5 * abs(lc) and abs(eg - ec) <= 1e-5 * abs(ec), (lg, lc, eg, ec)
    assert _rel(rg, rc) <= 1e-5


def test_exported_head_runs_the_kernel(cuda, tmp_path):
    """export_checkpoint for the card and the CPU: the card's artifact runs
    exactly 34 K1 launches per forward (the custom op, not a decomposition)
    and equals the in-process forward (1e-6 rel L2 in fp32, labels equal);
    the CPU's artifact serves on the CPU; a symbolic batch serves 1 and 3."""
    from mdilss_tpu_torch import serving
    from mdilss_tpu_torch.ckpt import torch_io
    from mdilss_tpu_torch.train import steps

    torch.manual_seed(9)
    model = ERFNetRAP([5, 7], 2, device="cpu")
    _randomize_bn(model, torch.Generator().manual_seed(10))
    ckpt = str(tmp_path / "best")
    torch_io.save(ckpt, 1, steps.init_train_state(model), best_acc=0.0,
                  aug_state=torch.Generator().get_state())
    x = torch.rand(3, 64, 128, 3)
    for output, batch in (("logits", None), ("labels", 1)):
        out = str(tmp_path / output)
        serving.export_checkpoint(ckpt, kind="rap", out_dir=out, tasks=[1], height=64, width=128,
                                  batch_size=batch, output=output, compute_dtype="float32",
                                  platforms=("cuda", "cpu"))
        fn = serving.load_head(out, 1)
        want = serving.build_infer_fn(model.to(cuda), 1, output=output,
                                      compute_dtype=torch.float32)
        for n in ((1, 3) if batch is None else (1,)):
            before = K.LAUNCHES
            got = fn(x[:n].to(cuda))
            torch.cuda.synchronize()
            assert K.LAUNCHES - before == 17 * K.LAUNCHES_PER_BLOCK
            ref = want(x[:n])
            if output == "logits":
                assert _rel(got, ref) <= 1e-6
            else:
                assert torch.equal(got, ref)
        cpu = serving.load_head(out, 1, device="cpu")(x[:1])
        assert cpu.device.type == "cpu" and cpu.shape == got[:1].shape


def test_extract_features_card_equals_cpu(cuda):
    """tsne's device half: the encoder and penultimate features of the first
    image on the card against the CPU's plain path, fp32, 1e-5 rel L2."""
    from mdilss_tpu_torch.analysis.tsne import extract_features
    from mdilss_tpu_torch.data.loader import SyntheticSource

    torch.manual_seed(11)
    model = ERFNetRAP([5, 7], 2, device="cpu")
    _randomize_bn(model, torch.Generator().manual_seed(12))
    source = SyntheticSource(7, n=2, height=128, width=256)
    for which in ("encoder", "penultimate"):
        kw = dict(task=1, num_classes=7, which=which, height=128, width=256,
                  select=lambda labels, n: True)
        want, _, _ = extract_features(model, source, device="cpu", **kw)
        before = K.LAUNCHES
        got, _, name = extract_features(model, source, device=cuda, **kw)
        assert K.LAUNCHES - before == 17 * K.LAUNCHES_PER_BLOCK and name == "index0"
        model.to("cpu")
        assert got.shape == want.shape
        assert _rel(torch.from_numpy(got), torch.from_numpy(want)) <= 1e-5


# ---- the ablation models: plain encoder blocks, the kernels in the decoders' 4 nb1d blocks ----

ABLATION_MODELS = ("erfnet_bn", "erfnet_onlyRAP", "erfnet_RA_series", "erfnet_RCM")


def _ablation_model(name, classes, seed, device):
    """Random BN and, for RCM, random non-symmetric matrices Wt."""
    from mdilss_tpu_torch.models import ERFNetAblation
    from mdilss_tpu_torch.models.erfnet_ablations import REFERENCE_NAMES

    torch.manual_seed(seed)
    model = ERFNetAblation(classes, len(classes), REFERENCE_NAMES[name], device="cpu")
    gen = torch.Generator().manual_seed(seed + 1)
    _randomize_bn(model, gen)
    with torch.no_grad():
        for k, p in model.named_parameters():
            if ".Wt_" in k:
                p.add_(0.3 / p.shape[0] ** 0.5 * torch.randn(p.shape, generator=gen))
    return model.to(device)


@pytest.mark.parametrize("name", ABLATION_MODELS)
def test_ablation_step2_card_equals_cpu(cuda, name):
    """One step-2 step ([20, 20] student at task 1, eval-mode [20] teacher,
    2x128x256) on the card and on the CPU from the same weights, masks and
    batch: loss, ce, kld and the student's running statistics within 1e-5;
    the step launches exactly 8 K1 (the teacher's decoder), 16 K2 and 16 K3
    (two student forwards and backwards through the decoder's 4 blocks)."""
    from mdilss_tpu_torch.models.erfnet_ablations import REFERENCE_NAMES
    from mdilss_tpu_torch.models.topology import make_dropout_masks
    from mdilss_tpu_torch.train import steps
    from mdilss_tpu_torch.train.masks import ablation_lr_tree

    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.random((2, 128, 256, 3), dtype=np.float32))
    y = torch.from_numpy(rng.integers(0, 20, (2, 128, 256)))
    masks = [make_dropout_masks(rng, 2) for _ in range(2)]
    out = {}
    for dev in (cuda, torch.device("cpu")):
        student = _ablation_model(name, [20, 20], 4, dev)
        teacher = _ablation_model(name, [20], 6, dev)
        lr = ablation_lr_tree(student, variant=REFERENCE_NAMES[name], current_task=1,
                              shared_lr=5e-6, ds_lr=5e-4)
        step = steps.make_distill_step(current_task=1, prev_tasks=(0,), lr_tree=lr,
                                       class_weight=np.ones(20, np.float32), num_epochs=150)
        before = _launches()
        _, m = step(steps.init_train_state(student), teacher, x.to(dev), y.to(dev), masks, 1)
        vals = {k: float(v) for k, v in m.items()}
        launched = tuple(a - b for a, b in zip(_launches(), before))
        running = torch.cat([b.reshape(-1).cpu() for k, b in student.named_buffers()
                             if "running" in k])
        out[dev.type] = (vals, running, launched)
    (g, r_g, launched), (c, r_c, _) = out["cuda"], out["cpu"]
    assert launched == (8, 16, 16)
    for k in ("loss", "ce", "kld"):
        assert abs(g[k] - c[k]) <= 1e-5 * abs(c[k]), (k, g[k], c[k])
    assert _rel(r_g, r_c) <= 1e-5


@pytest.mark.parametrize("name", ABLATION_MODELS)
def test_ablation_eval_forward_and_ce_step_launch_the_decoder_kernels(cuda, name):
    """An eval forward launches exactly 8 K1 (the decoder's 4 nb1d blocks;
    the encoder's ablation blocks run cuDNN) and its logits equal the CPU's
    within 1e-5; a CE step launches exactly 8 K2 and 8 K3."""
    from mdilss_tpu_torch.models.erfnet_ablations import REFERENCE_NAMES
    from mdilss_tpu_torch.models.topology import make_dropout_masks
    from mdilss_tpu_torch.train import steps
    from mdilss_tpu_torch.train.masks import ablation_lr_tree

    model = _ablation_model(name, [6, 7], 8, "cpu")
    x = torch.rand(2, 64, 128, 3)
    want = model(x, 1)
    model.to(cuda)
    before = _launches()
    got = model(x.to(cuda), 1)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(_launches(), before)) == (8, 0, 0)
    assert _rel(got.cpu(), want) <= 1e-5
    lr = ablation_lr_tree(model, variant=REFERENCE_NAMES[name], current_task=1,
                          shared_lr=5e-4, ds_lr=5e-4)
    ce = steps.make_ce_step(task=1, class_weight=np.ones(7, np.float32), lr_tree=lr,
                            num_epochs=150)
    y = torch.randint(0, 7, (2, 64, 128), device=cuda)
    before = _launches()
    ts, m = ce(steps.init_train_state(model), x.to(cuda), y,
               make_dropout_masks(np.random.default_rng(1), 2), 1)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(_launches(), before)) == (0, 8, 8)
    assert np.isfinite(float(m["loss"])) and ts.opt.count == 1


# ---- K2 / K3 in bfloat16 (bf16 training) ------------------------------------------------------
TOL_BF16_PAIR = 1e-2  # as chip_smoke.py: the same rounding points, another summation order


def _bf16_pair_args(gen, c, use_rap, use_pre, dev):
    """_pair_args with the weight matrices rounded to bf16 values."""
    w31, b31, w13, rap, pre = _pair_args(gen, c, use_rap, use_pre, dev)
    bf = lambda t: None if t is None else t.to(torch.bfloat16).float()  # noqa: E731
    return bf(w31), b31, bf(w13), bf(rap), pre


def _bf16_act(gen, n, c, h, w, dev):
    return torch.randn(n, c, h, w, generator=gen).to(dev, torch.bfloat16).contiguous(
        memory_format=torch.channels_last)


@pytest.mark.parametrize("use_rap,use_pre", [(False, False), (True, True), (True, False),
                                             (False, True)])
@pytest.mark.parametrize("c,d,n,h,w", TRAIN_SHAPES)
def test_bf16_train_pairs_match_plain(cuda, c, d, n, h, w, use_rap, use_pre):
    gen = torch.Generator().manual_seed(c + d + h + 1)
    args = _bf16_pair_args(gen, c, use_rap, use_pre, cuda)
    x, gy = _bf16_act(gen, n, c, h, w, cuda), _bf16_act(gen, n, c, h, w, cuda)
    before = T.LAUNCHES_FWD_BF16, T.LAUNCHES_BWD_BF16, T.LAUNCHES_FWD, T.LAUNCHES_BWD
    y, st = T.fwd_pair(x, *args, d)
    got = T.bwd_pair(x, gy, *args, d)
    torch.cuda.synchronize()
    assert (T.LAUNCHES_FWD_BF16, T.LAUNCHES_BWD_BF16, T.LAUNCHES_FWD, T.LAUNCHES_BWD) == tuple(
        b + 1 for b in before)
    y_p, st_p = T.fwd_pair_plain(x, *args, d)
    want = T.bwd_pair_plain(x, gy, *args, d)
    assert y.dtype == got[0].dtype == torch.bfloat16 and st.dtype == torch.float32
    assert y.is_contiguous(memory_format=torch.channels_last)
    assert _rel(y, y_p) <= TOL_BF16_PAIR and _rel(st, st_p) <= TOL_BF16_PAIR
    for name, g, g_p in zip(("du", "dw31", "db31", "dw13", "drap"), got, want):
        if g_p is None:
            assert g is None
            continue
        assert g.shape == g_p.shape and g.dtype == g_p.dtype, name
        assert _rel(g, g_p) <= TOL_BF16_PAIR, (name, _rel(g, g_p))


@pytest.mark.parametrize("c", [16, 64, 128])
def test_bf16_train_pairs_bitwise_repeatable(cuda, c):
    gen = torch.Generator().manual_seed(c)
    args = _bf16_pair_args(gen, c, True, True, cuda)
    x, gy = _bf16_act(gen, 2, c, 9, 150, cuda), _bf16_act(gen, 2, c, 9, 150, cuda)
    first = (*T.fwd_pair(x, *args, 4), *T.bwd_pair(x, gy, *args, 4))
    second = (*T.fwd_pair(x, *args, 4), *T.bwd_pair(x, gy, *args, 4))
    for a, b in zip(first, second):
        assert torch.equal(a, b)


# K3 bf16's tiles: the conv launches take 128 / 256 / 512 pixels of a row (C = 128 / 64 / 16) per
# tile and the weight gradients 64 / 64 / 128, the conv launches on a persistent grid of at most
# as many CTAs as the card holds and the weight gradients on 32 / 128 / 128 walkers. Edges: W a
# multiple of no tile and above one, H below the row taps' reach (both skipped on every row), d = 16
# at H = 37 (gy's halo staged once, rows skipped at both ends), and fewer tiles than CTAs.
K3_BF16_EDGES = [  # n, h, d and W per C
    (2, 5, 1, {128: 300, 64: 300, 16: 600}),
    (1, 3, 2, {128: 71, 64: 135, 16: 263}),
    (1, 37, 16, {128: 83, 64: 83, 16: 83}),
    (1, 9, 4, {128: 150, 64: 150, 16: 150}),
]
K3_BF16_EDGE_IDS = ["w_ragged", "h_below_taps", "d16_h37", "few_tiles"]


def _k3_bf16_edge(edge, c, use_rap, use_pre, dev):
    n, h, d, widths = edge
    gen = torch.Generator().manual_seed(7 * c + h + d + 2 * use_rap + use_pre)
    args = _bf16_pair_args(gen, c, use_rap, use_pre, dev)
    w = widths[c]
    return args, _bf16_act(gen, n, c, h, w, dev), _bf16_act(gen, n, c, h, w, dev), d


@pytest.mark.parametrize("use_rap,use_pre", [(True, True), (False, False), (True, False),
                                             (False, True)])
@pytest.mark.parametrize("edge", K3_BF16_EDGES, ids=K3_BF16_EDGE_IDS)
@pytest.mark.parametrize("c", [16, 64, 128])
def test_bf16_bwd_pair_tile_edges(cuda, c, edge, use_rap, use_pre):
    """du and the weight gradients of K3 bf16 at its tile edges against the
    plain bf16 pair (TOL_BF16_PAIR) and against float64: within 2x the plain
    bf16 pair's own error plus 1e-4."""
    args, x, gy, d = _k3_bf16_edge(edge, c, use_rap, use_pre, cuda)
    got = T.bwd_pair(x, gy, *args, d)
    plain = T.bwd_pair_plain(x, gy, *args, d)
    want = T.bwd_pair_plain(x.double(), gy.double(), *(_f64(a) for a in args), d)
    for name, g, g_p, g64 in zip(("du", "dw31", "db31", "dw13", "drap"), got, plain, want):
        if g64 is None:
            assert g is None
            continue
        assert g.shape == g64.shape and g.dtype == g_p.dtype, name
        assert bool(torch.isfinite(g).all()), name
        assert _rel(g, g_p) <= TOL_BF16_PAIR, (name, _rel(g, g_p))
        assert _rel(g, g64) <= 2 * _rel(g_p, g64) + 1e-4, (name, _rel(g, g64), _rel(g_p, g64))


@pytest.mark.parametrize("edge", K3_BF16_EDGES, ids=K3_BF16_EDGE_IDS)
@pytest.mark.parametrize("c", [16, 64, 128])
def test_bf16_bwd_pair_tile_edges_bitwise_repeatable(cuda, c, edge):
    args, x, gy, d = _k3_bf16_edge(edge, c, True, True, cuda)
    first = T.bwd_pair(x, gy, *args, d)
    second = T.bwd_pair(x, gy, *args, d)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


# K2 bf16's tiles are K3's conv tiles (a row of 128 / 256 / 512 pixels at C = 128 / 64 / 16, a halo
# pass of 16 columns on each side where a row has two or more tiles), walked by at most 128
# walkers; for d > 16 a tile is 32 / 80 / 160 columns and computes c in three windows. Edges: K3's,
# and d = 40 (windows apart) and d = 20 (windows overlapping).
K2_BF16_EDGES = K3_BF16_EDGES + [
    (1, 5, 40, {128: 90, 64: 100, 16: 90}),
    (2, 6, 20, {128: 70, 64: 130, 16: 200}),
]
K2_BF16_EDGE_IDS = K3_BF16_EDGE_IDS + ["d40_windows", "d20_windows"]
K2_BF16_EDGE_SHAPES = [(c, d, n, h, ws[c]) for c in (16, 64, 128) for n, h, d, ws in K2_BF16_EDGES]
K2_BF16_EDGE_SHAPE_IDS = [f"c{c}-{e}" for c in (16, 64, 128) for e in K2_BF16_EDGE_IDS]


def _k2_bf16_edge(edge, c, use_rap, use_pre, dev):
    n, h, d, widths = edge
    gen = torch.Generator().manual_seed(5 * c + h + d + 2 * use_rap + use_pre)
    args = _bf16_pair_args(gen, c, use_rap, use_pre, dev)
    return args, _bf16_act(gen, n, c, h, widths[c], dev), d


def _two_pass(y):
    """The float64 [2, C] sum and sum of squares of y."""
    y = y.double()
    return torch.stack([y.sum((0, 2, 3)), y.square().sum((0, 2, 3))])


@pytest.mark.parametrize("use_rap,use_pre", [(True, True), (False, False), (True, False),
                                             (False, True)])
@pytest.mark.parametrize("edge", K2_BF16_EDGES, ids=K2_BF16_EDGE_IDS)
@pytest.mark.parametrize("c", [16, 64, 128])
def test_bf16_fwd_pair_tile_edges(cuda, c, edge, use_rap, use_pre):
    """y and the stats of K2 bf16 at its tile edges against the plain bf16
    pair (TOL_BF16_PAIR) and against float64: within 2x the plain bf16 pair's
    own error plus 1e-4; the stats against a float64 two-pass over the
    returned y (they sum the rounded y in float32)."""
    args, x, d = _k2_bf16_edge(edge, c, use_rap, use_pre, cuda)
    y, st = T.fwd_pair(x, *args, d)
    y_p, st_p = T.fwd_pair_plain(x, *args, d)
    y64, st64 = T.fwd_pair_plain(x.double(), *(_f64(a) for a in args), d)
    assert y.dtype == torch.bfloat16 and st.dtype == torch.float32
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(st).all())
    for got, plain, want in ((y, y_p, y64), (st, st_p, st64)):
        assert _rel(got, plain) <= TOL_BF16_PAIR, _rel(got, plain)
        assert _rel(got, want) <= 2 * _rel(plain, want) + 1e-4, (_rel(got, want), _rel(plain, want))
    assert _rel(st, _two_pass(y)) <= 1e-5, _rel(st, _two_pass(y))


@pytest.mark.parametrize("edge", K2_BF16_EDGES, ids=K2_BF16_EDGE_IDS)
@pytest.mark.parametrize("c", [16, 64, 128])
def test_bf16_fwd_pair_tile_edges_bitwise_repeatable(cuda, c, edge):
    args, x, d = _k2_bf16_edge(edge, c, True, True, cuda)
    first, second = T.fwd_pair(x, *args, d), T.fwd_pair(x, *args, d)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("c,d,n,h,w", [(64, 2, 2, 9, 150)] + K2_BF16_EDGE_SHAPES,
                         ids=["base"] + K2_BF16_EDGE_SHAPE_IDS)
def test_bf16_fwd_and_bwd_compute_the_same_c(cuda, c, d, n, h, w):
    """K2's bf16 c passes and K3's k3_c_dc_bf16_kernel compute c in the same
    order. With w13 the identity at its centre tap and no RAP, K2's y is the
    bf16 c times 1 summed in float32, c itself; so y must equal the bf16 c
    that K3 writes to its scratch, bit for bit; at K2's tile edges too."""
    gen = torch.Generator().manual_seed(12 + c + d + h)
    w31, b31, _, _, pre = _bf16_pair_args(gen, c, False, True, cuda)
    w13 = torch.zeros(c, c, 1, 3, device=cuda)
    w13[:, :, 0, 1] = torch.eye(c, device=cuda)
    x, gy = _bf16_act(gen, n, c, h, w, cuda), _bf16_act(gen, n, c, h, w, cuda)
    y, _ = T.fwd_pair(x, w31, b31, w13, None, pre, d)
    lib = T._library()
    w31s, b31v, w13s, _, pa, pb = T._kernel_operands(x, w31, b31, w13, None, pre)
    scratch = torch.empty(lib.nb1d_train_bwd_bf16_scratch(c, n, h, w, 0), device=cuda)
    du = torch.empty_like(x)
    grads = torch.empty(lib.nb1d_train_grad_len(c, 0), device=cuda)
    rc = lib.nb1d_train_bwd_bf16(c, x.data_ptr(), gy.data_ptr(), w31s.data_ptr(),
                                 b31v.data_ptr(), T._stack_t(w13s).data_ptr(),
                                 T._stack_t(w31s).data_ptr(), None, pa.data_ptr(),
                                 pb.data_ptr(), du.data_ptr(), grads.data_ptr(),
                                 scratch.data_ptr(), n, h, w, d,
                                 torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert rc == 0
    c_k3 = scratch.view(torch.bfloat16)[: n * h * w * c].view(n, h, w, c)  # K3's c, NHWC
    got = y.permute(0, 2, 3, 1)
    assert int((c_k3 > 0).sum()) > 0
    assert torch.equal(got, c_k3), int((got != c_k3).sum())


@pytest.mark.parametrize("edge", [(2, 9, 8, dict.fromkeys((16, 64, 128), 300))] + K2_BF16_EDGES,
                         ids=["base"] + K2_BF16_EDGE_IDS)
@pytest.mark.parametrize("rap", [True, False], ids=["rap", "plain"])
@pytest.mark.parametrize("c", [16, 64, 128])
def test_k1_bf16_and_k2_bf16_compute_the_same_y(cuda, c, rap, edge):
    """K1's bf16 kernel and K2's bf16 kernel multiply in the same order
    (stage B's column taps 0, 1, 2 over the channels ascending, then RAP). One
    K1 pair with a = 1, b = 0 and no residual writes bf16(relu(fma(1, y, 0))),
    which must equal relu of K2's bf16 y; at K2's tile edges too."""
    n, h, d, widths = edge
    gen = torch.Generator().manual_seed(9 * c + rap + h + d)
    w31, b31, w13, rapw, _ = _bf16_pair_args(gen, c, rap, False, cuda)
    x = _bf16_act(gen, n, c, h, widths[c], cuda)
    y, _ = T.fwd_pair(x, w31, b31, w13, rapw, None, d)
    w31s, b31v, w13s, rapm, _, _ = T._kernel_operands(x, w31, b31, w13, rapw, None)
    ones = torch.ones(c, device=cuda)
    before = K.LAUNCHES_BF16
    got = K._launch_pair(x, w31s, b31v, w13s, rapm, ones, torch.zeros_like(ones), None, d)
    torch.cuda.synchronize()
    assert K.LAUNCHES_BF16 == before + 1
    assert int((y > 0).sum()) > 0 and int((y < 0).sum()) > 0
    assert torch.equal(got, torch.relu(y)), int((got != torch.relu(y)).sum())


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64], ids=["f16", "f64"])
def test_train_pairs_refuse_other_types_on_the_card(cuda, dtype):
    gen = torch.Generator().manual_seed(3)
    args = _pair_args(gen, 16, True, True, cuda)
    x = torch.randn(1, 16, 8, 8, device=cuda).to(dtype).contiguous(
        memory_format=torch.channels_last)
    before = T.LAUNCHES_FWD, T.LAUNCHES_BWD
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        T.fwd_pair(x, *args, 1)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        T.bwd_pair(x, x, *args, 1)
    with pytest.raises(ValueError, match="does not match"):
        T.bwd_pair(x.to(torch.bfloat16), x.float(), *args, 1)
    assert (T.LAUNCHES_FWD, T.LAUNCHES_BWD) == before


@pytest.mark.parametrize("c,d,rap", [(64, 1, True), (128, 16, True), (16, 1, False)])
def test_bf16_train_block_matches_plain_pairs(cuda, c, d, rap):
    """The bf16 training block on the kernels against the same block built
    from the plain bf16 pairs: output bf16 and within TOL_BF16_PAIR; dx, the
    parameters' gradients (float32) and the running statistics within 4x
    that (the BN backward divides by the batch std)."""
    gen = torch.Generator().manual_seed(c * 10 + d + 1)
    torch.manual_seed(c + d + 1)
    blocks = [NonBottleneck1dRAP(c, d, 2, 0.3) if rap else NonBottleneck1d(c, d) for _ in range(2)]
    blocks[1].load_state_dict(blocks[0].state_dict())
    for blk in blocks:
        blk.to(cuda).train()
    x = _bf16_act(gen, 2, c, 16, 40, cuda)
    mask = (torch.rand(2, c, generator=gen) < 0.7).to(cuda) if rap else None
    cot = torch.randn(2, c, 16, 40, generator=gen).to(cuda)
    results = []
    for blk, pairs in zip(blocks, (T.KERNEL_PAIRS, T.PLAIN_PAIRS)):
        xi = x.clone().requires_grad_()
        out = T.nb1d_train_apply(blk, xi, 1 if rap else None, 0.3 if rap else 0.0, mask, pairs)
        grads = torch.autograd.grad((out.float() * cot).sum(), [xi] + list(blk.parameters()),
                                    allow_unused=True)
        results.append((out, grads, [b.clone() for b in blk.buffers()]))
    (out_k, g_k, b_k), (out_p, g_p, b_p) = results
    assert out_k.dtype == out_p.dtype == torch.bfloat16 and g_k[0].dtype == torch.bfloat16
    assert _rel(out_k, out_p) <= TOL_BF16_PAIR
    for a, b in zip(g_k, g_p):
        assert (a is None) == (b is None)
        if a is not None and b.norm() > 0:
            assert _rel(a, b) <= 4 * TOL_BF16_PAIR
    for a, b in zip(b_k, b_p):
        if a.is_floating_point() and b.norm() > 0:
            assert _rel(a, b) <= 4 * TOL_BF16_PAIR
        else:
            assert torch.equal(a, b)


def test_bf16_training_forward_and_backward_stay_bf16(cuda):
    """A bf16 training forward of ERFNet-RAP keeps bf16 to the logits and
    launches only the bf16 kernels: 34 K2 for the forward, 34 K3 for its
    backward; the parameters' gradients float32."""
    from mdilss_tpu_torch.models.topology import make_dropout_masks

    torch.manual_seed(0)
    model = ERFNetRAP([5, 5], 2, device=cuda).train()
    x = torch.rand(2, 64, 128, 3, device=cuda).to(torch.bfloat16)
    masks = make_dropout_masks(np.random.default_rng(0), 2)
    before, before16 = _launches(), (K.LAUNCHES_BF16, T.LAUNCHES_FWD_BF16, T.LAUNCHES_BWD_BF16)
    logits = model(x, 1, masks)
    grads = torch.autograd.grad(logits.float().square().mean(), list(model.parameters()),
                                allow_unused=True)
    torch.cuda.synchronize()
    assert logits.dtype == torch.bfloat16
    assert all(g is None or g.dtype == torch.float32 for g in grads)
    got = tuple(a - b for a, b in zip(_launches(), before))
    got16 = tuple(a - b for a, b in zip(
        (K.LAUNCHES_BF16, T.LAUNCHES_FWD_BF16, T.LAUNCHES_BWD_BF16), before16))
    assert got == got16 == (0, 34, 34)


# ---- remat: regions that replay in the backward, K2 rerun there ---------------------------------

@pytest.fixture
def deterministic_cudnn():
    """cuDNN on its deterministic algorithms (its transposed convs are not
    bit-reproducible between runs otherwise)."""
    old = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    yield
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = old


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("c,d,rap", [(64, 1, True), (128, 16, True), (16, 1, False)])
def test_remat_block_on_the_kernels_is_bitwise(cuda, c, d, rap, dtype):
    """A training block as a remat region (`topology._ckpt`) against the same
    block without one: the output, dx, every gradient and the running
    statistics bit for bit. Its forward launches K2 twice (two pairs); its
    backward reruns both (K2 again, twice) before K3's two launches; the
    replay leaves the running statistics as the forward left them."""
    from mdilss_tpu_torch.models.topology import _ckpt

    gen = torch.Generator().manual_seed(c * 10 + d + 2)
    torch.manual_seed(c + d + 2)
    blocks = [NonBottleneck1dRAP(c, d, 2, 0.3) if rap else NonBottleneck1d(c, d) for _ in range(2)]
    blocks[1].load_state_dict(blocks[0].state_dict())
    for blk in blocks:
        blk.to(cuda).train()
    x = torch.randn(2, c, 16, 40, generator=gen).to(cuda, dtype).contiguous(
        memory_format=torch.channels_last)
    mask = (torch.rand(2, c, generator=gen) < 0.7).to(cuda) if rap else None
    cot = torch.randn(2, c, 16, 40, generator=gen).to(cuda)
    task = 1 if rap else None
    results = []
    for blk, remat in zip(blocks, (False, True)):
        xi = x.clone().requires_grad_()
        before = T.LAUNCHES_FWD, T.LAUNCHES_BWD
        out = _ckpt(blk, xi, task, mask) if remat else blk(xi, task, mask)
        after_fwd = [b.clone() for b in blk.buffers()]
        fwd = (T.LAUNCHES_FWD - before[0], T.LAUNCHES_BWD - before[1])
        grads = torch.autograd.grad((out.float() * cot).sum(), [xi] + list(blk.parameters()),
                                    allow_unused=True)
        torch.cuda.synchronize()
        total = (T.LAUNCHES_FWD - before[0], T.LAUNCHES_BWD - before[1])
        assert fwd == (2, 0) and total == ((4, 2) if remat else (2, 2))
        assert all(torch.equal(a, b) for a, b in zip(after_fwd, blk.buffers()))
        results.append((out, grads, after_fwd))
    (out_a, g_a, b_a), (out_b, g_b, b_b) = results
    assert torch.equal(out_a, out_b)
    for a, b in zip(g_a, g_b):
        assert (a is None and b is None) or torch.equal(a, b)
    assert all(torch.equal(a, b) for a, b in zip(b_a, b_b))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_remat_model_reruns_k2_in_the_backward(cuda, deterministic_cudnn, dtype):
    """An ERFNet-RAP training forward with remat=True launches K2 34 times,
    and its backward 34 more (the 11 regions' replays) with K3's 34; the
    logits, every gradient and every running statistic bit for bit those of
    remat=False, and the backward leaves the statistics as the forward did."""
    import copy

    from mdilss_tpu_torch.models.topology import make_dropout_masks

    torch.manual_seed(4)
    model = ERFNetRAP([5, 5], 2, device=cuda).train()
    _randomize_bn(model, torch.Generator().manual_seed(5))
    twin = copy.deepcopy(model)
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.random((2, 64, 128, 3), dtype=np.float32)).to(cuda, dtype)
    masks = make_dropout_masks(rng, 2)
    out = []
    for m, remat in ((model, False), (twin, True)):
        before = _launches()
        logits = m(x, 1, masks, remat=remat)
        stats = [b.clone() for b in m.buffers()]
        fwd = tuple(a - b for a, b in zip(_launches(), before))
        grads = torch.autograd.grad(logits.float().square().mean(), list(m.parameters()),
                                    allow_unused=True)
        torch.cuda.synchronize()
        total = tuple(a - b for a, b in zip(_launches(), before))
        assert fwd == (0, 34, 0) and total == ((0, 68, 34) if remat else (0, 34, 34))
        assert all(torch.equal(a, b) for a, b in zip(stats, m.buffers()))
        out.append((logits, grads, stats))
    (l_a, g_a, s_a), (l_b, g_b, s_b) = out
    assert torch.equal(l_a, l_b)
    assert all((a is None and b is None) or torch.equal(a, b) for a, b in zip(g_a, g_b))
    assert all(torch.equal(a, b) for a, b in zip(s_a, s_b))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["step2", "step3"])
def test_remat_steps_on_the_kernels_are_bitwise(cuda, deterministic_cudnn, kind, dtype):
    """A step-2 step and a two-phase step-3 batch at 2x64x128 with remat=True
    and remat_prev=True against the same without: the losses, the confusion
    matrix, every parameter and running statistic and Adam's moments bit for
    bit, the teacher unchanged; the launches (K1, K2, K3) exactly
    (34, 170, 68) and (0, 340, 102) against (34, 68, 68) and (0, 170, 102)."""
    import copy

    from mdilss_tpu_torch.models.topology import make_dropout_masks
    from mdilss_tpu_torch.train import steps
    from mdilss_tpu_torch.train.masks import rap_lr_tree

    if kind == "step3":
        student, teacher, x, y, masks = _step3_setup(cuda, seed=6)
        masks = masks[:3]
        make = lambda s, **kw: _step3(s, compute_dtype=dtype, **kw)  # noqa: E731
        want = {False: (0, 170, 102), True: (0, 340, 102)}
    else:
        torch.manual_seed(6)
        student, teacher = ERFNetRAP([5, 5], 2, device=cuda), ERFNetRAP([5], 1, device=cuda)
        gen = torch.Generator().manual_seed(7)
        _randomize_bn(student, gen)
        _randomize_bn(teacher, gen)
        rng = np.random.default_rng(6)
        x = torch.from_numpy(rng.random((2, 64, 128, 3), dtype=np.float32)).to(cuda)
        y = torch.from_numpy(rng.integers(0, 5, (2, 64, 128))).to(cuda)
        masks = [make_dropout_masks(rng, 2) for _ in range(2)]

        def make(s, **kw):
            lr = rap_lr_tree(s, current_task=1, shared_lr=5e-6, ds_lr=5e-4)
            return steps.make_distill_step(current_task=1, prev_tasks=(0,),
                                           class_weight=np.ones(5, np.float32), lr_tree=lr,
                                           num_epochs=150, iou_train=True, compute_dtype=dtype,
                                           **kw)
        want = {False: (34, 68, 68), True: (34, 170, 68)}
    t_before = {k: v.clone() for k, v in teacher.state_dict().items()}
    twin = copy.deepcopy(student)
    out = []
    for s, remat in ((student, False), (twin, True)):
        before = _launches()
        ts, m = make(s, remat=remat, remat_prev=remat)(steps.init_train_state(s), teacher, x, y,
                                                       masks, 1)
        torch.cuda.synchronize()
        assert tuple(a - b for a, b in zip(_launches(), before)) == want[remat]
        assert all(torch.equal(v, t_before[k]) for k, v in teacher.state_dict().items())
        out.append((m, s.state_dict(), ts.opt))
    (m_a, s_a, o_a), (m_b, s_b, o_b) = out
    for k in ("loss", "ce", "kld", "cm"):
        assert torch.equal(m_a[k], m_b[k]), k
    assert all(torch.equal(s_a[k], s_b[k]) for k in s_a)
    assert torch.equal(o_a.m, o_b.m) and torch.equal(o_a.v, o_b.v) and o_a.count == o_b.count


@pytest.fixture
def world1_nccl(cuda, tmp_path):
    """A process group of one rank under NCCL, made in-process from a
    FileStore, and the port's mesh over it: every collective of the sync-BN
    glue, the losses and the gradients runs, over one rank."""
    import torch.distributed as dist

    from mdilss_tpu_torch.parallel import make_mesh

    dev = torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
                            world_size=1, device_id=dev)
    try:
        mesh = make_mesh(2, device=dev)
        assert mesh.active and mesh.data == 1
        yield mesh
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("c,d,rap", [(64, 1, True), (128, 16, True), (16, 1, False)])
def test_sync_bn_block_on_one_nccl_rank_is_bitwise(cuda, world1_nccl, c, d, rap, dtype):
    """The training block on the kernels under `synced` over a one-rank NCCL
    group (K2's sums and the BN backward's sums all-reduced) against the
    same block outside it: the output, dx, every gradient and the running
    statistics bit for bit, and the same launches (K2 twice, K3 twice)."""
    from mdilss_tpu_torch.ops.norm import synced

    gen = torch.Generator().manual_seed(c * 10 + d + 3)
    torch.manual_seed(c + d + 3)
    blocks = [NonBottleneck1dRAP(c, d, 2, 0.3) if rap else NonBottleneck1d(c, d) for _ in range(2)]
    blocks[1].load_state_dict(blocks[0].state_dict())
    for blk in blocks:
        blk.to(cuda).train()
    x = torch.randn(2, c, 16, 40, generator=gen).to(cuda, dtype).contiguous(
        memory_format=torch.channels_last)
    mask = (torch.rand(2, c, generator=gen) < 0.7).to(cuda) if rap else None
    cot = torch.randn(2, c, 16, 40, generator=gen).to(cuda)
    results = []
    for blk, mesh in zip(blocks, (None, world1_nccl)):
        xi = x.clone().requires_grad_()
        before = T.LAUNCHES_FWD, T.LAUNCHES_BWD
        with synced(mesh):
            out = blk(xi, 1 if rap else None, mask)
            grads = torch.autograd.grad((out.float() * cot).sum(), [xi] + list(blk.parameters()),
                                        allow_unused=True)
        torch.cuda.synchronize()
        assert (T.LAUNCHES_FWD - before[0], T.LAUNCHES_BWD - before[1]) == (2, 2)
        results.append((out, grads, [b.clone() for b in blk.buffers()]))
    (out_a, g_a, b_a), (out_b, g_b, b_b) = results
    assert torch.equal(out_a, out_b)
    assert all((a is None and b is None) or torch.equal(a, b) for a, b in zip(g_a, g_b))
    assert all(torch.equal(a, b) for a, b in zip(b_a, b_b))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["step2", "step3"])
def test_steps_on_one_nccl_rank_are_bitwise(cuda, deterministic_cudnn, world1_nccl, kind, dtype):
    """A step-2 step and a two-phase step-3 batch at 2x64x128 with `mesh` over
    a one-rank NCCL group against the same step without: the losses, the
    confusion matrix, every parameter, running statistic and Adam tensor bit
    for bit, the teacher unchanged, the launches (K1, K2, K3) exactly (34,
    68, 68) and (0, 170, 102) in both."""
    import copy

    from mdilss_tpu_torch.models.topology import make_dropout_masks
    from mdilss_tpu_torch.train import steps
    from mdilss_tpu_torch.train.masks import rap_lr_tree

    if kind == "step3":
        student, teacher, x, y, masks = _step3_setup(cuda, seed=8)
        masks = masks[:3]
        make = lambda s, **kw: _step3(s, compute_dtype=dtype, **kw)  # noqa: E731
        want = (0, 170, 102)
    else:
        torch.manual_seed(8)
        student, teacher = ERFNetRAP([5, 5], 2, device=cuda), ERFNetRAP([5], 1, device=cuda)
        gen = torch.Generator().manual_seed(9)
        _randomize_bn(student, gen)
        _randomize_bn(teacher, gen)
        rng = np.random.default_rng(8)
        x = torch.from_numpy(rng.random((2, 64, 128, 3), dtype=np.float32)).to(cuda)
        y = torch.from_numpy(rng.integers(0, 5, (2, 64, 128))).to(cuda)
        masks = [make_dropout_masks(rng, 2) for _ in range(2)]

        def make(s, **kw):
            lr = rap_lr_tree(s, current_task=1, shared_lr=5e-6, ds_lr=5e-4)
            return steps.make_distill_step(current_task=1, prev_tasks=(0,),
                                           class_weight=np.ones(5, np.float32), lr_tree=lr,
                                           num_epochs=150, iou_train=True, compute_dtype=dtype,
                                           **kw)
        want = (34, 68, 68)
    t_before = {k: v.clone() for k, v in teacher.state_dict().items()}
    twin = copy.deepcopy(student)
    out = []
    for s, mesh in ((student, None), (twin, world1_nccl)):
        before = _launches()
        ts, m = make(s, mesh=mesh)(steps.init_train_state(s), teacher, x, y, masks, 1)
        torch.cuda.synchronize()
        assert tuple(a - b for a, b in zip(_launches(), before)) == want
        assert all(torch.equal(v, t_before[k]) for k, v in teacher.state_dict().items())
        out.append((m, s.state_dict(), ts.opt))
    (m_a, s_a, o_a), (m_b, s_b, o_b) = out
    for k in ("loss", "ce", "kld", "cm"):
        assert torch.equal(m_a[k], m_b[k]), k
    assert all(torch.equal(s_a[k], s_b[k]) for k in s_a)
    assert torch.equal(o_a.m, o_b.m) and torch.equal(o_a.v, o_b.v) and o_a.count == o_b.count


# ---- the spatial axis (A11): K2's stats window; K1/K2/K3 on padded slabs ----------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("c,d,n,h,w", [(128, 16, 2, 20, 45), (64, 1, 6, 9, 150),
                                       (16, 2, 1, 8, 300), (128, 4, 6, 64, 128)])
def test_k2_stats_window(cuda, c, d, n, h, w, dtype):
    """K2 with a stats window: the whole height bitwise the call without one;
    any window leaves y bitwise as it was and sums the window's rows of it
    (to 1e-6 of the largest sum, against float64 sums of the same y)."""
    gen = torch.Generator().manual_seed(c + d + h)
    w31, b31, w13, rap, pre = _pair_args(gen, c, True, True, cuda)
    x = torch.randn(n, c, h, w, generator=gen).to(cuda, dtype).contiguous(
        memory_format=torch.channels_last)
    y, st = T.fwd_pair(x, w31, b31, w13, rap, pre, d)
    yw, stw = T.fwd_pair(x, w31, b31, w13, rap, pre, d, (0, h))
    assert torch.equal(y, yw) and torch.equal(st, stw)
    for r0, r1 in ((0, h // 2), (1, h - 1), (h // 2, h), (3, 3)):
        yr, sr = T.fwd_pair(x, w31, b31, w13, rap, pre, d, (r0, r1))
        assert torch.equal(yr, y)
        rows = y[:, :, r0:r1].double()
        want = torch.stack([rows.sum((0, 2, 3)), rows.square().sum((0, 2, 3))])
        scale = want.abs().amax(1, keepdim=True).clamp_min(1e-30)
        assert float(((sr.double() - want).abs() / scale).max()) <= 1e-6, (r0, r1)
    with pytest.raises(ValueError, match="stats rows"):
        T.fwd_pair(x, w31, b31, w13, rap, pre, d, (2, h + 1))


@pytest.fixture(scope="module")
def smoke():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("n_sp", [2, 4, 8])
@pytest.mark.parametrize("d", [2, 4, 8, 16])
def test_pairs_on_padded_slabs_equal_the_whole_call(cuda, smoke, d, n_sp, dt):
    """K2 (pre-stage and RAP) and K3 on S padded slabs of the encoder's 1/8
    maps (6x128x64x128: 32 to 8 rows a slab against d = 2 .. 16), each slab
    with d halo rows cut from the whole tensor, K2's stats over the slab's
    rows and K3's gy zero on the halo rows, and K1 on slabs with 1 + d halo
    rows: stitched (K3's du summed over the slabs that hold a row, its weight
    gradients and K2's stats over the slabs) against the whole calls, within
    chip_smoke.SP_TOL (y and K1's output per pixel, the sums to 1e-6 in
    fp32)."""
    r = smoke.padded_slab_case(d * 10 + n_sp, cuda, dt, d, n_sp)
    j = 0 if dt == "f32" else 1
    for k in ("y", "stats", "du", "wgrads", "k1"):
        tol = smoke.SP_TOL["sums" if k in ("stats", "wgrads") else k][j]
        assert r[k] <= tol, (k, r[k], tol)


# ---------------------------------------------------------------------------
# the sync-free training step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["step2", "step3"])
def test_steps_make_no_sync_after_their_first_call(cuda, kind):
    """After a warm first call, two more steps (no iou_train) under
    `torch.cuda.set_sync_debug_mode("error")`: no blocking host <-> device
    call (Adam's LRs, the dropout masks, the class weights, the teacher's
    buffers); the train-mode teacher of step 3 ends bitwise as it began."""
    from mdilss_tpu_torch.models.topology import make_dropout_masks
    from mdilss_tpu_torch.train import steps
    from mdilss_tpu_torch.train.masks import rap_lr_tree

    step3 = kind == "step3"
    classes = [5, 5, 6] if step3 else [5, 5]
    prev = (1, 0) if step3 else (0,)
    torch.manual_seed(0)
    student = ERFNetRAP(classes, len(classes), device=cuda)
    teacher = ERFNetRAP(classes[:-1], len(classes) - 1, device=cuda)
    cur = len(classes) - 1
    lr = rap_lr_tree(student, current_task=cur, shared_lr=5e-6, ds_lr=5e-4)
    make = steps.make_two_phase_distill_step if step3 else steps.make_distill_step
    step = make(current_task=cur, prev_tasks=prev, class_weight=np.linspace(0.5, 2, classes[-1]),
                lr_tree=lr, num_epochs=150)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.random((2, 64, 128, 3), dtype=np.float32)).to(cuda)
    y = torch.from_numpy(rng.integers(0, classes[-1], (2, 64, 128))).to(cuda)
    ts = steps.init_train_state(student)
    ts, _ = step(ts, teacher, x, y, [make_dropout_masks(rng, 2) for _ in prev + (cur,)], 1)
    torch.cuda.synchronize()
    before = {k: v.clone() for k, v in teacher.state_dict().items()}
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            ts, m = step(ts, teacher, x, y, [make_dropout_masks(rng, 2) for _ in prev + (cur,)], 1)
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    torch.cuda.synchronize()
    assert ts.opt.count == (6 if step3 else 3)
    assert all(np.isfinite(float(v)) for v in m.values())
    assert all(torch.equal(v, teacher.state_dict()[k]) for k, v in before.items())


def test_pinned_mask_copy_equals_the_plain_copy(cuda):
    """`layer_drop_masks` on the card (one pinned block, copied without a
    wait) gives every layer's keep-mask bitwise `torch.as_tensor(...).to(dev)`,
    from contiguous masks and from a data index's rows of them, the host
    arrays overwritten right after each call."""
    from mdilss_tpu_torch.models.topology import layer_drop_masks, make_dropout_masks

    rng = np.random.default_rng(3)
    for _ in range(4):
        m = make_dropout_masks(rng, 6)
        for masks in (m, {"g64": m["g64"][:, 1::2], "g128": m["g128"][:, :, 1::2]}):
            want = layer_drop_masks({k: v.copy() for k, v in masks.items()}, "cpu")
            want = {i: t.to(cuda) for i, t in want.items()}
            host = {k: np.array(v) for k, v in masks.items()}
            got = layer_drop_masks(host, cuda)
            for v in host.values():
                v[...] = ~v
            g64 = torch.as_tensor(np.asarray(masks["g64"])).to(cuda)
            assert len(got) == len(want) == 13
            assert all(t.is_cuda for t in got.values())
            assert all(torch.equal(got[i], want[i]) for i in want)
            assert all(torch.equal(got[1 + i], g64[i].reshape(g64.shape[1], -1)) for i in range(5))


@pytest.mark.parametrize("count", [1, 50])
@pytest.mark.parametrize("classes", [[20, 20], [20, 20, 27]], ids=["step2", "step3"])
def test_apply_updates_bitwise_its_predecessor_on_the_card(cuda, classes, count):
    """tests/test_torch_optim.py's bitwise check on the card: three steps from
    step `count`, every leaf and both moments bitwise the frozen copy's."""
    import copy

    from _torch_adam_before import adam_case, apply_updates_before
    from mdilss_tpu_torch.train import optim

    params, lrs, state, grads, _ = adam_case(classes, count, device=cuda)
    mine, ref = copy.deepcopy(params), copy.deepcopy(params)
    st_mine = st_ref = state
    cache = optim.LrCache()
    for i in range(3):
        g = grads()
        st_mine = optim.apply_updates(mine, g, st_mine, lrs, lr_scale=0.9 ** i, cache=cache)
        st_ref = apply_updates_before(ref, g, st_ref, lrs, lr_scale=0.9 ** i)
        assert all(torch.equal(mine[k], ref[k]) for k in mine), i
        assert torch.equal(st_mine.m, st_ref.m) and torch.equal(st_mine.v, st_ref.v)
