"""The port's step1 -> step2 -> step3 chain and its baselines
(mdilss_tpu_torch/train/pipeline.py `run_pipeline`), each case of
tests/test_pipeline.py that this slice holds, on the CPU at its TINY size:
the chain's files and skips, the predecessor rule, the baseline chain's
orders, and the ft and single-task chains through the port's checkpoint
directories."""
import os
import shutil

import pytest
import torch

from mdilss_tpu_torch import config as C
from mdilss_tpu_torch.ckpt import torch_io
from mdilss_tpu_torch.train import pipeline as P
from mdilss_tpu_torch.train.pipeline import run_pipeline
from mdilss_tpu_torch.train.protocols import build_trainer

torch.set_num_threads(1)
TINY = dict(synthetic=True, synthetic_size=4, batch_size=2, height=32, width=64,
            num_workers=2, num_epochs=1)
STAGES = ("step1", "step2", "step3", "single_cs", "ft_step2", "ft_step3", "multitask")


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    root = tmp_path_factory.mktemp("pipeline")
    results = run_pipeline(order="CS_BDD_IDD", savedir=str(root), common=TINY,
                           with_baselines=True, device="cpu")
    return root, results


def test_pipeline_chains_checkpoints(chain):
    """One call runs the seven stages, each seeded from its predecessor's best:
    step 2's frozen task-0 head and slots equal step 1's best (loaded verbatim,
    then frozen), step 3's tasks 0 and 1 step 2's."""
    root, results = chain
    assert tuple(results) == STAGES
    for stage in STAGES:
        assert torch_io.latest_epoch(str(root / stage / "best")) == 1, stage
        for name in ("opts.txt", "model.txt", "automated_log.txt", "metrics.jsonl"):
            assert (root / stage / name).exists(), (stage, name)
    s1, s2, s3 = (torch_io.load_state(str(root / s / "best"), "rap")
                  for s in ("step1", "step2", "step3"))
    assert torch_io.heads_num_classes(s3, "step3") == [20, 20, 27]

    def frozen(sd, tasks):
        return [k for k in sd if any(k.startswith(f"decoder.{t}.") or f"_ini.{t}." in k or
                                     f"_1.{t}." in k or f"_2.{t}." in k for t in tasks)
                and ("weight" in k or "bias" in k) and "running" not in k]

    for prev, cur, tasks in ((s1, s2, (0,)), (s2, s3, (0, 1))):
        keys = frozen(prev, tasks)
        assert len(keys) > 100
        for k in keys:
            assert torch.equal(prev[k], cur[k]), k
    assert torch_io.heads_num_classes(torch_io.load_state(
        str(root / "ft_step3" / "best"), "ftp2"), "ft") == [20, 20, 27]


def test_pipeline_skips_finished_stages(chain, capsys):
    root, _ = chain
    results = run_pipeline(order="CS_BDD_IDD", savedir=str(root), common=TINY,
                           with_baselines=True, device="cpu")
    out = capsys.readouterr().out
    assert results == {}
    for stage in STAGES:
        assert f"{stage}: found existing" in out, stage


def test_pipeline_baseline_chain_follows_order(monkeypatch, tmp_path):
    """--with-baselines derives the ft chain from --order (the notebook's
    CS|IDD->BDD ft baseline comes from `pipeline --order CS_IDD_BDD`)."""
    seen = {}

    class _Dummy:
        def fit(self):
            return {}

    def fake_build(cfg, device=None):
        seen[os.path.basename(cfg.savedir)] = (cfg, device)
        return _Dummy()

    monkeypatch.setattr(P, "build_trainer", fake_build)
    P.run_pipeline(order="CS_IDD_BDD", savedir=str(tmp_path), with_baselines=True,
                   common=TINY, device="cpu")
    cfgs = {k: v[0] for k, v in seen.items()}
    assert {v[1] for v in seen.values()} == {"cpu"}
    assert cfgs["step2"].datasets == ("cityscapes", "IDD")
    assert cfgs["step3"].datasets == ("cityscapes", "IDD", "BDD")
    assert cfgs["ft_step2"].datasets == ("cityscapes", "IDD")
    assert cfgs["ft_step2"].num_classes == (20, 27)
    assert cfgs["ft_step3"].datasets == ("cityscapes", "IDD", "BDD")
    assert cfgs["ft_step3"].num_classes == (20, 27, 20)
    assert cfgs["ft_step3"].current_task == 2
    assert cfgs["ft_step3"].state == str(tmp_path / "ft_step2" / "best")


def test_pipeline_stage_subset_requires_predecessor(tmp_path):
    with pytest.raises(ValueError, match="step2"):
        run_pipeline(order="CS_BDD_IDD", savedir=str(tmp_path), common=TINY,
                     stages=("step3",), device="cpu")


def test_pipeline_stage_subset_resolves_prev_from_disk(chain, tmp_path):
    """A later stage alone picks its predecessor's best up from the savedir."""
    root, _ = chain
    shutil.copytree(root / "step1", tmp_path / "step1")
    results = run_pipeline(order="CS_BDD_IDD", savedir=str(tmp_path), common=TINY,
                           stages=("step2",), device="cpu")
    assert list(results) == ["step2"]
    s1 = torch_io.load_state(str(tmp_path / "step1" / "best"), "rap")
    s2 = torch_io.load_state(str(tmp_path / "step2" / "best"), "rap")
    assert torch.equal(s1["decoder.0.output_conv.weight"], s2["decoder.0.output_conv.weight"])


def test_ft_and_single_chains_through_checkpoint_directories(chain, tmp_path):
    """ft's 2-head stage starts from the single-task run's best (its one
    `decoder.0` head as ft's old head), the 3-head stage from the 2-head
    run's best (both heads)."""
    root, _ = chain
    single = torch_io.load_state(str(root / "single_cs" / "best"), "multi_task")
    ft2 = build_trainer(C.ft_step(n_heads=2, savedir=str(tmp_path / "ft2"),
                                  state=str(root / "single_cs" / "best"), **TINY),
                        device="cpu").ts.model.state_dict()
    for k, v in single.items():
        assert torch.equal(ft2[k.replace("decoder.0.", "decoder_old.")], v), k
    best2 = torch_io.load_state(str(root / "ft_step2" / "best"), "ftp1")
    ft3 = build_trainer(C.ft_step(n_heads=3, savedir=str(tmp_path / "ft3"),
                                  state=str(root / "ft_step2" / "best"), **TINY),
                        device="cpu").ts.model.state_dict()
    rename = {"decoder_old.": "decoder_old1.", "decoder_new.": "decoder_old2."}
    for k, v in best2.items():
        key = next((rename[p] + k[len(p):] for p in rename if k.startswith(p)), k)
        assert torch.equal(ft3[key], v), k
