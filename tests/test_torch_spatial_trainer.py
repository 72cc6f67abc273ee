"""The port Trainer and CLI on a spatial mesh (mdilss_tpu_torch/train/loop.py,
parallel/mesh.py `make_mesh(spatial=)`, `--spatial-shards`) on gloo
processes on the CPU: one `torchrun --nproc_per_node 4` launch of
tests/_torch_dist_worker.py's "spatial_trainer" cases (the 2x2 mesh) and
one `torchrun --nproc_per_node 2` launch of `-m mdilss_tpu_torch step1
--spatial-shards 2 --device cpu` (the 1x2 mesh), each against the same run
on one process; and the errors that a spatial axis raises, as JAX's."""
import json
import os

import numpy as np
import pytest
import torch

from _torch_port import finish, torchrun
from mdilss_tpu_torch import cli
from mdilss_tpu_torch import config as C
from mdilss_tpu_torch.ckpt import torch_io
from mdilss_tpu_torch.parallel import make_mesh
from mdilss_tpu_torch.train.protocols import build_trainer

torch.set_num_threads(1)

CLI = ["step1", "--device", "cpu", "--synthetic", "--synthetic-size", "4", "--batch-size", "4",
       "--height", "32", "--width", "64", "--num-epochs", "1", "--num-workers", "1"]
CONFIGS = ("step3_rcm", "step1", "step2_remat")  # the worker's SP_CONFIGS


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the 4 ranks' results, the worker's directory, the CLI's output at
    world 2, the one-process Trainer's result)."""
    d = tmp_path_factory.mktemp("spatial_trainer")
    worker = torchrun(["tests/_torch_dist_worker.py", "spatial_trainer", "-", d], nproc=4)
    two = torchrun(["-m", "mdilss_tpu_torch", *CLI, "--spatial-shards", "2",
                    "--savedir", d / "cli2"])
    try:
        cli.main([*CLI, "--savedir", str(d / "cli1")])
        one = build_trainer(C.step2(num_epochs=1, savedir=str(d / "one"), synthetic=True,
                                    synthetic_size=8, batch_size=8, height=32, width=64,
                                    num_workers=1, device_cache="auto"), device="cpu").fit()
    finally:
        finish(worker)
        out = finish(two)
    ranks = [np.load(d / f"spatial_trainer_rank{r}.npz") for r in range(4)]
    return ranks, d, out, one


def _case(npz, case: str) -> dict:
    p = f"{case}|"
    return {k[len(p):]: npz[k] for k in npz.files if k.startswith(p)}


def test_trainer_epoch_with_cache_on_a_2x2_mesh(runs):
    """tests/test_multichip.py:181-195 on the port: a step-2 Trainer epoch
    with spatial_shards=2 on 4 processes runs on the 2x2 mesh, its cache the
    mesh arm (whole images of the data index on each spatial rank); every
    rank returns the same result, its one step's loss that of one process
    to 1e-5 relative, and only rank 0 writes the run's files."""
    ranks, d, _, one = runs
    results = [_case(npz, "sp_trainer") for npz in ranks]
    for r in results:
        assert (int(r["data"]), int(r["spatial"])) == (2, 2)
        assert str(r["cache"]) == "DeviceCache" and bool(r["cache_meshed"])
        assert str(r["final"]) == str(results[0]["final"])
        assert np.isfinite(r["train_loss"])
    np.testing.assert_allclose(float(results[0]["train_loss"]), one["train_loss"], rtol=1e-5)
    assert (d / "sp_trainer" / "automated_log.txt").exists()


@pytest.mark.parametrize("name", CONFIGS)
def test_configs_build_on_a_spatial_mesh(runs, name):
    """The step-3 erfnet_RCM, step-1 and remat step-2 configs with
    spatial_shards=2 (which the port refused before its spatial axis) build
    their Trainer on 4 processes: a 2x2 mesh."""
    ranks, _, _, _ = runs
    for npz in ranks:
        r = _case(npz, "sp_configs")
        assert (int(r[f"{name}/data"]), int(r[f"{name}/spatial"])) == (2, 2)
    assert str(r["step3_rcm/model"]) == "ERFNetAblation"


def test_uneven_height_raises(runs):
    """A height that does not split into S slabs at every level of the
    encoder raises ValueError on every rank (the port's deliberate deviation:
    GSPMD pads uneven shards)."""
    ranks, _, _, _ = runs
    for npz in ranks:
        err = str(_case(npz, "sp_uneven")["error"])
        assert "--spatial-shards 2 needs a height divisible by 16" in err and "not 40" in err


def test_cli_spatial_shards_under_torchrun_matches_one_process(runs):
    """`torchrun --nproc_per_node 2 -m mdilss_tpu_torch step1 --spatial-shards
    2 --device cpu` (the 1x2 mesh, one step of 4 images, each rank its 16
    rows of each): rank 0 alone writes the run's files and prints the result
    line, and the final state is one process's at tests/test_multichip.py's
    criterion (the loss to 1e-5 relative, every parameter within 1.1e-3 and
    at most 1% beyond 2e-5, the running statistics to 1e-4 relative)."""
    _, d, out, _ = runs
    one, two = d / "cli1", d / "cli2"

    def files(root):
        return sorted(os.path.relpath(os.path.join(p, f), root)
                      for p, _, fs in os.walk(root) for f in fs)

    assert files(one) == files(two)
    rows = [json.loads(line) for line in out.splitlines() if line.startswith("{")]
    assert len(rows) == 1
    want = json.loads((one / "metrics.jsonl").read_text().splitlines()[-1])
    np.testing.assert_allclose(rows[0]["train_loss"], want["train_loss"], rtol=1e-5)
    sa = torch_io._load(str(one / "ckpt"), None)["state_dict"]
    sb = torch_io._load(str(two / "ckpt"), None)["state_dict"]
    diffs = []
    for k in sa:
        if "running" in k:
            a, b = sa[k].double(), sb[k].double()
            assert float((a - b).norm() / a.norm()) <= 1e-4, k
        elif "num_batches_tracked" not in k:
            diffs.append((sa[k] - sb[k]).abs().flatten())
    dd = torch.cat(diffs)
    assert dd.max() <= 1.1e-3, dd.max()
    assert (dd > 2e-5).float().mean() <= 0.01


def test_cli_spatial_shards_on_one_process_raises(tmp_path):
    """A plain `python -m mdilss_tpu_torch step1 --spatial-shards 2` is one
    process: JAX's error, the shards must divide the devices."""
    with pytest.raises(ValueError, match="--spatial-shards 2 must divide the device count"):
        cli.main([*CLI, "--spatial-shards", "2", "--savedir", str(tmp_path / "run")])


@pytest.mark.parametrize("spatial", [0, 3])
def test_make_mesh_spatial_must_divide_the_world(spatial):
    """`make_mesh(spatial=)` on one process: JAX's ValueError unless the
    shards divide the world (mdilss_tpu/train/loop.py:249-254); spatial=1
    is the single-process path."""
    with pytest.raises(ValueError, match=f"--spatial-shards {spatial} must divide"):
        make_mesh(4, spatial=spatial, device="cpu")
    mesh = make_mesh(4, spatial=1, device="cpu")
    assert not mesh.active and (mesh.data, mesh.spatial, mesh.size) == (1, 1, 1)
