"""The hand-written CUDA nb1d kernel against its plain PyTorch version, on the
card (marker `cuda`; skips without one). Run on a machine with an H100:

    python -m pytest tests/test_torch_cuda.py -m cuda -q

Tolerances: float32 relative L2 1e-5 with TF32 off in the plain version
(cuDNN would otherwise run the float32 convs in TF32); bfloat16 relative L2
2e-2, since the kernel keeps the intermediate c in float32 while the plain
version rounds every conv to bfloat16.
"""
import numpy as np
import pytest
import torch

from mdilss_tpu_torch.models import ERFNetRAP
from mdilss_tpu_torch.models.blocks import NonBottleneck1d, NonBottleneck1dRAP
from mdilss_tpu_torch.ops import nb1d_infer as K

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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("c,d,rap,n,h,w", [
    (64, 1, True, 2, 16, 48),
    (128, 2, True, 1, 16, 64),
    (128, 16, True, 2, 13, 37),   # ragged: H, W multiples of no tile
    (64, 1, False, 1, 24, 200),
    (16, 1, False, 2, 16, 300),
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
