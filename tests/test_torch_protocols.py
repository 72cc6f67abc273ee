"""The port's protocol builders (mdilss_tpu_torch/train/protocols.py
`build_trainer`) against the JAX package's (mdilss_tpu/train/protocols.py)
on the CPU: from the same checkpoint file, the port's initial student and
teacher state dicts equal JAX's `build_trainer` output exported through
`export_state_dict`, bit for bit, on every key that comes from the file.
The freshly drawn parts (each package's own initialisation of what the file
does not hold: step 1's per-task slots and head, the new head of step 2, step
3 and ft) are left out, checked for shape, and, where the port draws them,
for the port's own seeded draw."""
import numpy as np
import pytest
import torch

import jax

from _torch_port import randomize_bn
from mdilss_tpu import config as JC
from mdilss_tpu.ckpt import export_state_dict
from mdilss_tpu.models import erfnet as jerfnet
from mdilss_tpu.models import erfnet_multihead as jmh
from mdilss_tpu.models import erfnet_rap
from mdilss_tpu.train.protocols import build_trainer as jax_build_trainer
from mdilss_tpu_torch import config as C
from mdilss_tpu_torch.ckpt import torch_io
from mdilss_tpu_torch.ckpt.surgery import extend_for_new_task, keep_tasks
from mdilss_tpu_torch.models import ERFNetMultiHead, ERFNetRAP
from mdilss_tpu_torch.train import steps
from mdilss_tpu_torch.train.loop import init_model
from mdilss_tpu_torch.train.protocols import build_trainer

torch.set_num_threads(1)
TINY = dict(synthetic=True, synthetic_size=2, batch_size=2, height=32, width=64,
            num_workers=1, num_epochs=1)


def _save(path, params, bn, kind, keep=None) -> dict:
    """A reference `.pth.tar` of JAX weights (`module.` keys); returns its
    state dict without the prefix."""
    sd = export_state_dict(params, bn, kind=kind)
    if keep is not None:
        sd = {k: v for k, v in sd.items() if keep(k)}
    out = {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
    torch.save({"epoch": 3, "arch": kind, "best_acc": 0.1, "optimizer": {},
                "state_dict": {"module." + k: v for k, v in out.items()}}, path)
    return out


def _export(ts_like, kind) -> dict:
    return {k: torch.from_numpy(np.array(v))
            for k, v in export_state_dict(ts_like.params, ts_like.bn, kind=kind).items()}


def _equal_on(got: dict, want: dict, keys) -> int:
    keys = list(keys)
    for k in keys:
        assert torch.equal(got[k], want[k]), k
    return len(keys)


def _rap_file(tmp_path, classes, seed):
    rng = np.random.default_rng(seed)
    params, bn = randomize_bn(*erfnet_rap.init(jax.random.key(seed), classes, len(classes)),
                              rng)
    return _save(str(tmp_path / "prev.pth.tar"), params, bn, "rap"), str(tmp_path / "prev.pth.tar")


def test_step1_loads_the_shared_encoder_convs(tmp_path):
    """A single-task encoder under `module.features.*`: only the shared convs
    fit the RAP model; its per-task slots and head keep the port's seeded init."""
    rng = np.random.default_rng(0)
    params, bn = randomize_bn(*jmh.init(jax.random.key(7), [20]), rng)
    enc = _save(str(tmp_path / "enc.pth.tar"), params, bn, "multi_task",
                keep=lambda k: k.startswith("encoder."))
    blob = torch.load(str(tmp_path / "enc.pth.tar"), weights_only=False)
    blob["state_dict"] = {k.replace("module.", "module.features.", 1): v
                          for k, v in blob["state_dict"].items()}
    torch.save(blob, str(tmp_path / "enc.pth.tar"))
    kw = dict(pretrained_encoder=str(tmp_path / "enc.pth.tar"), **TINY)
    jtr = jax_build_trainer(JC.step1(savedir=str(tmp_path / "j"), **kw))
    tr = build_trainer(C.step1(savedir=str(tmp_path / "p"), **kw), device="cpu")
    got, want = tr.ts.model.state_dict(), _export(jtr.ts, "rap")
    fresh = init_model(tr.cfg).state_dict()
    from_file = [k for k in got if k in enc and ".bn" not in k and "num_batches" not in k]
    assert _equal_on(got, want, from_file) == 2 * (3 + 4 * 13)  # 3 downsamplers, 13 blocks
    assert _equal_on(got, enc, from_file)
    assert _equal_on(got, fresh, [k for k in got if k not in from_file]) == len(got) - 110


@pytest.mark.parametrize("protocol,classes", [("step2", [20]), ("step3", [20, 20])])
def test_incremental_teacher_and_student_equal_jax(tmp_path, protocol, classes):
    sd, path = _rap_file(tmp_path, classes, 1)
    kw = dict(state=path, **TINY)
    jtr = jax_build_trainer(getattr(JC, protocol)(savedir=str(tmp_path / "j"), **kw))
    tr = build_trainer(getattr(C, protocol)(savedir=str(tmp_path / "p"), **kw), device="cpu")
    teacher = tr.teacher.state_dict()
    assert _equal_on(teacher, _export(jtr.teacher, "rap"), teacher) == len(sd)
    assert _equal_on(teacher, sd, sd)
    got, want = tr.ts.model.state_dict(), _export(jtr.ts, "rap")
    nb = len(classes)
    head = f"decoder.{nb}.output_conv."
    assert set(got) == set(want)
    assert _equal_on(got, want, [k for k in got if not k.startswith(head)]) == len(got) - 2
    assert got[head + "weight"].shape == want[head + "weight"].shape
    drawn = extend_for_new_task(sd, tr.cfg.num_classes[-1],
                                generator=torch.Generator().manual_seed(tr.cfg.seed))
    assert _equal_on(got, drawn, got)
    # the teacher shares no tensor with the student
    ptrs = {t.data_ptr() for t in tr.ts.model.state_dict().values()}
    assert not ptrs & {t.data_ptr() for t in tr.teacher.state_dict().values()}


@pytest.mark.parametrize("protocol,nb_prev", [("step2", 1), ("step3", 2)])
def test_incremental_from_a_file_with_more_tasks_equals_jax(tmp_path, protocol, nb_prev):
    """A 3-task file into step 2 (teacher 1 task) and step 3 (teacher 2 tasks):
    the port keeps the file's first tasks, as JAX's `_load_params(kind="rap",
    nb_tasks=...)` converts them; the teacher and the student equal JAX's
    `build_trainer` on every key but the new head's drawn output_conv."""
    from mdilss_tpu.train.protocols import _load_params

    sd, path = _rap_file(tmp_path, [20, 20, 27], 4)
    kw = dict(state=path, **TINY)
    jtr = jax_build_trainer(getattr(JC, protocol)(savedir=str(tmp_path / "j"), **kw))
    tr = build_trainer(getattr(C, protocol)(savedir=str(tmp_path / "p"), **kw), device="cpu")
    prev_nc = tr.cfg.num_classes[:nb_prev]
    jp, jb = _load_params(path, kind="rap", nb_tasks=nb_prev, num_classes=prev_nc)
    want = {k: torch.from_numpy(np.array(v))
            for k, v in export_state_dict(jp, jb, kind="rap").items()}
    teacher = tr.teacher.state_dict()
    assert set(teacher) == set(want) == {k for k in keep_tasks(sd, nb_prev)}
    assert _equal_on(teacher, want, teacher) == _equal_on(teacher, _export(jtr.teacher, "rap"),
                                                          teacher)
    got, jwant = tr.ts.model.state_dict(), _export(jtr.ts, "rap")
    head = f"decoder.{nb_prev}.output_conv."
    assert set(got) == set(jwant)
    assert _equal_on(got, jwant, [k for k in got if not k.startswith(head)]) == len(got) - 2


@pytest.mark.parametrize("heads", [2, 3])
def test_ft_heads_equal_jax(tmp_path, heads):
    """ft with 2 heads from a single-task (erfnet) file, with 3 heads from an
    ftp1 file: the encoder and the old heads equal JAX's; the new head fresh."""
    rng = np.random.default_rng(2)
    if heads == 2:
        params, bn = randomize_bn(*jerfnet.init(jax.random.key(3), 20), rng)
        src_kind, kind = "erfnet", "ftp1"
    else:
        params, bn = randomize_bn(*jmh.init(jax.random.key(3), [20, 20]), rng)
        src_kind, kind = "ftp1", "ftp2"
    sd = _save(str(tmp_path / "prev.pth.tar"), params, bn, src_kind)
    kw = dict(state=str(tmp_path / "prev.pth.tar"), **TINY)
    jtr = jax_build_trainer(JC.ft_step(n_heads=heads, savedir=str(tmp_path / "j"), **kw))
    tr = build_trainer(C.ft_step(n_heads=heads, savedir=str(tmp_path / "p"), **kw),
                       device="cpu")
    got, want = tr.ts.model.state_dict(), _export(jtr.ts, kind)
    assert set(got) == set(want)
    loaded = [k for k in got if not k.startswith("decoder_new.")]
    assert _equal_on(got, want, loaded) == len(sd)
    fresh = init_model(tr.cfg).state_dict()
    assert _equal_on(got, fresh, [k for k in got if k.startswith("decoder_new.")]) > 50


@pytest.mark.parametrize("protocol", ["singletask", "multitask"])
def test_plain_baselines_load_the_whole_encoder(tmp_path, protocol):
    """The multitask and single-task baselines take every encoder key of the
    ImageNet file (their encoder is the plain one), as JAX's; the heads keep
    the port's seeded init."""
    rng = np.random.default_rng(4)
    params, bn = randomize_bn(*jmh.init(jax.random.key(9), [20]), rng)
    enc = _save(str(tmp_path / "enc.pth.tar"), params, bn, "multi_task",
                keep=lambda k: k.startswith("encoder."))
    blob = torch.load(str(tmp_path / "enc.pth.tar"), weights_only=False)
    blob["state_dict"] = {k.replace("module.", "module.features.", 1): v
                          for k, v in blob["state_dict"].items()}
    torch.save(blob, str(tmp_path / "enc.pth.tar"))
    kw = dict(pretrained_encoder=str(tmp_path / "enc.pth.tar"), **TINY)
    make, pmake = getattr(JC, protocol), getattr(C, protocol)
    jtr = jax_build_trainer(make(savedir=str(tmp_path / "j"), **kw))
    tr = build_trainer(pmake(savedir=str(tmp_path / "p"), **kw), device="cpu")
    got, want = tr.ts.model.state_dict(), _export(jtr.ts, "multi_task")
    from_file = [k for k in enc if "num_batches" not in k]
    assert _equal_on(got, want, from_file) == _equal_on(got, enc, from_file) == 3 * 6 + 13 * 16
    fresh = init_model(tr.cfg).state_dict()
    assert _equal_on(got, fresh, [k for k in got if k.startswith("decoder.")]) > 50


def test_step2_without_a_checkpoint_and_the_options_checked(tmp_path):
    """No `state`: the teacher is torch's init seeded from seed + 1 (JAX's
    smoke path); teacher_dropout outside step 3 raises (stricter than JAX)."""
    tr = build_trainer(C.step2(savedir=str(tmp_path / "a"), seed=5, **TINY), device="cpu")
    torch.manual_seed(6)
    want = ERFNetRAP([20], 1, device="cpu").state_dict()
    assert _equal_on(tr.teacher.state_dict(), want, want)
    for make in (C.step1, C.step2):
        with pytest.raises(ValueError, match="teacher_dropout is a step-3 option"):
            make(savedir=str(tmp_path / "b"), teacher_dropout=True, **TINY)
    C.step3(savedir=str(tmp_path / "c"), teacher_dropout=True, **TINY)


def test_load_state_by_kind(tmp_path):
    """A checkpoint directory of the port is read directly; a one-head
    `decoder.0.*` run loads as kind erfnet (`decoder.*`) and as ftp1's old
    head; an Orbax directory of the JAX package raises, naming the
    conversion command."""
    from mdilss_tpu.ckpt import orbax_io
    from mdilss_tpu.train import steps as jsteps

    torch.manual_seed(0)
    single = ERFNetMultiHead([20], device="cpu")
    torch_io.save(str(tmp_path / "st"), 1, steps.init_train_state(single), best_acc=0.0,
                  aug_state=torch.Generator().get_state())
    sd = torch_io.load_state(str(tmp_path / "st"), "erfnet")
    assert all(not k.startswith("decoder.0.") for k in sd) and "decoder.output_conv.bias" in sd
    for k, v in single.state_dict().items():
        assert torch.equal(sd[k.replace("decoder.0.", "decoder.")], v), k
    assert torch_io.load_state(str(tmp_path / "st"), "multi_task").keys() == \
        single.state_dict().keys()
    with pytest.raises(ValueError, match="kind 'ftp1' has 2 heads, not 1"):
        torch_io.load_state(str(tmp_path / "st"), "ftp1")

    params, bn = erfnet_rap.init(jax.random.key(0), [6], 1)
    orbax_io.save(str(tmp_path / "orbax"), 0, jsteps.init_train_state(params, bn),
                  best_acc=0.0, rng=jax.random.key(0))
    with pytest.raises(ValueError, match="python -m mdilss_tpu convert .* --export"):
        torch_io.load_state(str(tmp_path / "orbax"), "rap")
    with pytest.raises(ValueError, match="python -m mdilss_tpu convert"):
        build_trainer(C.step2(savedir=str(tmp_path / "s2"), state=str(tmp_path / "orbax"),
                              **TINY), device="cpu")


def test_infer_num_classes_named_ft_heads(tmp_path):
    """ftp1 / ftp2 reference checkpoints name their heads (decoder_old,
    decoder_new, decoder_old1, decoder_old2); the class counts come back in
    task order, as the JAX package's `infer_num_classes` reads them, and the
    file loads as its kind."""
    from mdilss_tpu.evaluate import infer_num_classes as jax_infer
    from mdilss_tpu_torch.evaluate import infer_num_classes, load_checkpoint

    for kind, ncls in (("ftp1", [5, 7]), ("ftp2", [5, 7, 9]), ("multi_task", [5, 7, 9]),
                       ("erfnet", [5])):
        init = jerfnet.init(jax.random.key(0), 5) if kind == "erfnet" else jmh.init(
            jax.random.key(0), ncls)
        path = str(tmp_path / f"{kind}.pth.tar")
        _save(path, *init, kind)
        assert infer_num_classes(path) == jax_infer(path) == ncls, kind
        model = load_checkpoint(path, kind=kind, device="cpu")
        assert [h.output_conv.bias.shape[0] for h in model.heads] == ncls
