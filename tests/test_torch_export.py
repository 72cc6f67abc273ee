"""Serving export of the port (mdilss_tpu_torch/serving.py `export_head`,
`export_checkpoint`, `load_head`, `serve_batches`) against the in-process
forward and against the JAX package's StableHLO export of the same
checkpoint (mdilss_tpu/serving.py), on the CPU at 64x128, as
tests/test_serving.py holds the JAX package; and K1 as the custom op
`mdilss::nb1d_infer` (ops/nb1d_infer.py) that the exported programs carry.

Tolerances: an exported program against the in-process forward of the same
model runs the same ops, 1e-6 relative L2 on float32 logits and labels equal;
against JAX, float32 logits 1e-5 relative L2 and labels equal off the pixels
whose JAX top-2 logit gap is within 1e-4; bfloat16 against float32 as the JAX
package quantifies its own default."""
import os

import numpy as np
import pytest
import torch

import jax

from _torch_port import randomize_bn, rel_l2
from mdilss_tpu import serving as jserving
from mdilss_tpu.ckpt import export_state_dict
from mdilss_tpu.models import erfnet_rap
from mdilss_tpu_torch import serving
from mdilss_tpu_torch.evaluate import load_checkpoint
from mdilss_tpu_torch.models import blocks
from mdilss_tpu_torch.models.blocks import NonBottleneck1d, NonBottleneck1dRAP
from mdilss_tpu_torch.ops import nb1d_infer as K

torch.set_num_threads(1)
H, W = 64, 128
NC = [5, 7]


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A reference-format `.pth.tar` of JAX weights with random BN, and the
    port's model of it."""
    tmp = tmp_path_factory.mktemp("torch_export")
    params, bn = randomize_bn(*erfnet_rap.init(jax.random.key(0), NC, 2),
                              np.random.default_rng(0))
    sd = export_state_dict(params, bn, kind="rap", prefix="module.")
    path = str(tmp / "model_best.pth.tar")
    torch.save({"epoch": 1, "arch": "Net", "best_acc": 0.0,
                "state_dict": {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}}, path)
    return dict(path=path, tmp=tmp, model=load_checkpoint(path, kind="rap", device="cpu"))


def _images(seed: int, n: int) -> np.ndarray:
    return np.random.default_rng(seed).random((n, H, W, 3), dtype=np.float32)


@pytest.mark.parametrize("output", ["logits", "labels"])
def test_export_round_trip(ckpt, tmp_path, output):
    """export_head -> torch.export.save -> load_head: the in-process forward's
    output on the same model."""
    model = ckpt["model"]
    program = serving.export_head(model, 1, height=H, width=W, batch_size=2, output=output,
                                  compute_dtype=torch.float32)
    torch.export.save(program, str(tmp_path / "head1.cpu.pt2"))
    fn = serving.load_head(str(tmp_path), 1, device="cpu")
    x = torch.from_numpy(_images(1, 2))
    got = fn(x)
    want = serving.build_infer_fn(model, 1, output=output, compute_dtype=torch.float32)(x)
    if output == "logits":
        assert got.shape == (2, H, W, 7) and got.dtype == torch.float32
        assert rel_l2(got.numpy(), want.numpy()) <= 1e-6
    else:
        assert got.shape == (2, H, W) and got.dtype == torch.int32
        assert torch.equal(got, want)
    with pytest.raises((AssertionError, RuntimeError)):  # a guard of the static batch of 2
        fn(torch.from_numpy(_images(1, 3)))


def test_symbolic_batch(ckpt, tmp_path):
    model = ckpt["model"]
    program = serving.export_head(model, 0, height=H, width=W, batch_size=None,
                                  compute_dtype=torch.float32)
    torch.export.save(program, str(tmp_path / "head0.cpu.pt2"))
    fn = serving.load_head(str(tmp_path), 0, device="cpu")
    infer = serving.build_infer_fn(model, 0, compute_dtype=torch.float32)
    for n in (1, 3):
        x = torch.from_numpy(_images(n, n))
        got = fn(x)
        assert got.shape == (n, H, W, 5)
        assert rel_l2(got.numpy(), infer(x).numpy()) <= 1e-6


def test_exported_graph_carries_the_custom_op(ckpt):
    """17 `mdilss::nb1d_infer` calls (one per nb1d block), no other route to
    the blocks, and each block's folded BN computed in the graph from the
    model's parameters and buffers (34 folds: sqrt(var + eps) per BN), not
    baked in as constants."""
    program = serving.export_head(ckpt["model"], 1, height=H, width=W,
                                  compute_dtype=torch.float32)
    calls = [n for n in program.graph.nodes if n.op == "call_function"]
    nb1d = [n for n in calls if n.target is torch.ops.mdilss.nb1d_infer.default]
    assert len(nb1d) == 17
    assert sum(n.target is torch.ops.aten.sqrt.default for n in calls) == 34
    assert not program.constants
    inputs = {s.arg.name for s in program.graph_signature.input_specs if s.kind.name in
              ("PARAMETER", "BUFFER")}

    def sources(node, seen):
        if node.op == "placeholder":
            seen.add(node.name)
        for a in node.all_input_nodes:
            sources(a, seen)
        return seen

    for node in nb1d:
        a1 = node.args[5]  # the first pair's folded BN scale
        assert sources(a1, set()) <= inputs and sources(a1, set())


@pytest.fixture(scope="module")
def exported(ckpt):
    """The checkpoint exported by both packages (head 1, batch 2, float32,
    logits and labels, the CPU)."""
    out = {}
    for output in ("logits", "labels"):
        kw = dict(kind="rap", num_classes=NC, tasks=[1], height=H, width=W, batch_size=2,
                  output=output, compute_dtype="float32", platforms=("cpu",))
        jdir, pdir = str(ckpt["tmp"] / f"jax_{output}"), str(ckpt["tmp"] / f"port_{output}")
        out[output] = (jserving.export_checkpoint(ckpt["path"], out_dir=jdir, **kw), jdir,
                       serving.export_checkpoint(ckpt["path"], out_dir=pdir, **kw), pdir)
    return out


def test_export_checkpoint_and_serve_batches_equal_jax(ckpt, exported):
    batches = [np.random.default_rng(i).integers(0, 256, (2, H, W, 3), np.uint8)
               for i in range(2)]
    logits = {}
    for output in ("logits", "labels"):
        _, jdir, _, pdir = exported[output]
        want = list(jserving.serve_batches(jdir, 1, batches))
        got = list(serving.serve_batches(pdir, 1, batches, device="cpu"))
        assert len(got) == len(want) == 2
        for i, (g, w) in enumerate(zip(got, want)):
            assert g.shape == w.shape and g.dtype == w.dtype
            if output == "logits":
                assert rel_l2(g, w) <= 1e-5
                logits[i] = w
            else:
                top2 = np.sort(logits[i], axis=-1)[..., -2:]
                decided = top2[..., 1] - top2[..., 0] > 1e-4
                np.testing.assert_array_equal(g[decided], w[decided])
        with pytest.raises(ValueError, match="serves"):
            list(serving.serve_batches(pdir, 1, [np.zeros((2, 32, W, 3), np.uint8)],
                                       device="cpu"))


def test_meta_json_keys(exported):
    jmeta, jdir, meta, pdir = exported["labels"]
    assert set(meta) == set(jmeta) - {"jax_version"} | {"torch_version"}
    assert meta == serving.load_meta(pdir)
    for k in ("kind", "num_classes", "tasks", "height", "width", "batch_size", "output",
              "compute_dtype", "platforms", "source_checkpoint"):
        assert meta[k] == jmeta[k], k
    assert meta["torch_version"] == torch.__version__
    assert meta["artifact_bytes"] == {"1": {"cpu": os.path.getsize(
        os.path.join(pdir, "head1.cpu.pt2"))}}
    assert sorted(os.listdir(pdir)) == ["head1.cpu.pt2", "meta.json"]


def test_bf16_default_vs_f32_quantified(ckpt, tmp_path):
    """The shipped default, bfloat16, against float32 on the export path
    itself, with the JAX package's bounds (tests/test_serving.py): logits
    within 8% of the logit scale, at most 2% of labels flipped, every flip a
    near-tie (top-2 gap within 10% of the scale)."""
    kw = dict(kind="rap", tasks=[1], height=H, width=W, batch_size=4, platforms=("cpu",))
    serving.export_checkpoint(ckpt["path"], out_dir=str(tmp_path / "f32"),
                              compute_dtype="float32", **kw)
    serving.export_checkpoint(ckpt["path"], out_dir=str(tmp_path / "bf16"), **kw)
    assert serving.load_meta(str(tmp_path / "bf16"))["compute_dtype"] == "bfloat16"
    x = [_images(3, 4)]
    l32, = serving.serve_batches(str(tmp_path / "f32"), 1, x, device="cpu")
    l16, = serving.serve_batches(str(tmp_path / "bf16"), 1, x, device="cpu")
    assert l16.dtype == np.float32
    scale = np.abs(l32).max()
    assert np.abs(l32 - l16).max() <= 0.08 * scale
    flips = l32.argmax(-1) != l16.argmax(-1)
    assert flips.mean() <= 0.02
    if flips.any():
        top2 = np.sort(l32, axis=-1)[..., -2:]
        assert (top2[..., 1] - top2[..., 0])[flips].max() <= 0.1 * scale


def test_load_head_raises_for_an_absent_platform(ckpt, exported, tmp_path):
    _, _, _, pdir = exported["logits"]
    # a directory that holds head 1 for the card only
    os.link(os.path.join(pdir, "head1.cpu.pt2"), str(tmp_path / "head1.cuda.pt2"))
    with pytest.raises(FileNotFoundError, match=r"no cpu artifact of head 1 .*\['cuda'\]"):
        serving.load_head(str(tmp_path), 1, device="cpu")
    with pytest.raises(FileNotFoundError, match="head 0"):
        serving.load_head(pdir, 0, device="cpu")
    with pytest.raises(ValueError, match="platforms"):
        serving.export_checkpoint(ckpt["path"], kind="rap", out_dir=str(tmp_path / "x"),
                                  platforms=("tpu",))


# ---- K1 as the custom op mdilss::nb1d_infer ---------------------------------------------------

def _block_args(rap: bool, dtype, seed: int):
    gen = torch.Generator().manual_seed(seed)
    blk = NonBottleneck1dRAP(16, 2, 2) if rap else NonBottleneck1d(16, 2)
    with torch.no_grad():
        for p in blk.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.3)
    x = torch.randn(2, 16, 6, 10, generator=gen).to(dtype).contiguous(
        memory_format=torch.channels_last)
    return (x, *K.prepare_operands(blk, 1 if rap else None, dtype), 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("rap", [True, False], ids=["rap", "plain"])
def test_custom_op_opcheck(rap, dtype):
    torch.library.opcheck(torch.ops.mdilss.nb1d_infer.default, _block_args(rap, dtype, 1))


@pytest.mark.parametrize("rap", [True, False], ids=["rap", "plain"])
def test_custom_op_fake_matches_the_cpu_implementation(rap):
    """The fake implementation's shape, strides and type are the CPU
    implementation's (channels_last, as the kernel allocates)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    args = _block_args(rap, torch.float32, 2)
    real = torch.ops.mdilss.nb1d_infer(*args)
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        fake = torch.ops.mdilss.nb1d_infer(*(mode.from_tensor(a) if isinstance(a, torch.Tensor)
                                              else a for a in args))
    assert fake.shape == real.shape and fake.stride() == real.stride()
    assert fake.dtype == real.dtype and real.is_contiguous(memory_format=torch.channels_last)


def test_eager_cpu_forward_is_bitwise_the_plain_route(ckpt, monkeypatch):
    """The model's eval forward through the custom op equals the same forward
    with every block calling the plain version directly, bit for bit."""
    model = ckpt["model"]
    x = torch.from_numpy(_images(4, 2))
    via_op = model(x, 1)
    monkeypatch.setattr(blocks, "nb1d_infer", K.nb1d_infer_plain)
    assert torch.equal(model(x, 1), via_op)
