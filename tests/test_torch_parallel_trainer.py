"""The port Trainer's mesh arms (mdilss_tpu_torch/train/loop.py,
data/loader.py `shard`, data/device_cache.py `mesh`, the CLI under torchrun)
at world 2 on the CPU, gloo: one `torchrun --nproc_per_node 2` launch of
tests/_torch_dist_worker.py's "trainer" cases and one of
`-m mdilss_tpu_torch step2 --device cpu`, each against the same run on one
process."""
import json
import os

import numpy as np
import pytest
import torch

from _torch_port import finish, torchrun
from mdilss_tpu_torch import cli
from mdilss_tpu_torch import config as C
from mdilss_tpu_torch.ckpt import torch_io
from mdilss_tpu_torch.data.device_cache import cache_bytes
from mdilss_tpu_torch.data.loader import Loader, SyntheticSource
from mdilss_tpu_torch.train import loop

torch.set_num_threads(1)

CLI = ["step2", "--device", "cpu", "--synthetic", "--synthetic-size", "4", "--batch-size", "4",
       "--height", "32", "--width", "64", "--num-epochs", "1", "--num-workers", "1"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the two ranks' results, the worker's directory, the CLI's output and
    directory at world 2, the CLI's directory at world 1)."""
    d = tmp_path_factory.mktemp("dist")
    worker = torchrun(["tests/_torch_dist_worker.py", "trainer", "-", d])
    two = torchrun(["-m", "mdilss_tpu_torch", *CLI, "--savedir", d / "cli2"])
    try:
        cli.main([*CLI, "--savedir", str(d / "cli1")])
    finally:
        finish(worker)
        out = finish(two)
    ranks = [np.load(d / f"trainer_rank{r}.npz") for r in (0, 1)]
    return ranks, d, out


def _case(npz, case: str) -> dict:
    p = f"{case}|"
    return {k[len(p):]: npz[k] for k in npz.files if k.startswith(p)}


@pytest.mark.parametrize("shuffle", [True, False], ids=["shuffled", "eval"])
def test_device_cache_mesh_arm_equals_streaming(runs, shuffle):
    """The DeviceCache mesh arm over 11 rows (12 with padding, 6 on each
    rank), batches of 4: every batch on each rank bitwise the streaming
    Loader's rows of that rank (one process's batch, the rank's half) and
    the sharded Loader's, a shuffled epoch (drop-last) and an eval pass (the
    last batch padded, its valid mask split too)."""
    ranks, _, _ = runs
    ld = Loader(SyntheticSource(6, n=11, height=32, width=64), batch_size=4, height=32,
                width=64, shuffle=shuffle, num_threads=1)
    ld.set_epoch(2)
    whole = list(ld)
    assert len(whole) == (2 if shuffle else 3)
    for r, npz in enumerate(ranks):
        c = _case(npz, "cache")
        assert c[f"{shuffle}/rows_held"] == 6 and c[f"{shuffle}/n_batches"] == len(whole)
        for i, (imgs, lbls, valid) in enumerate(whole):
            rows = slice(2 * r, 2 * r + 2)
            for k, v in (("images", imgs), ("labels", lbls), ("valid", valid)):
                np.testing.assert_array_equal(c[f"{shuffle}/{i}/{k}"], v[rows], err_msg=k)
                np.testing.assert_array_equal(c[f"{shuffle}/{i}/s_{k}"], v[rows], err_msg=k)


def test_cache_budget_on_a_mesh(runs):
    """JAX's budget rules on a mesh (mdilss_tpu/train/loop.py:189-222): a
    budget of 6 rows' bytes, times D = 2, holds the 10 rows: a full cache,
    charged 10 / 2 rows; a budget of 3 rows would need a hybrid cache, which
    a mesh does not take: it streams, with JAX's message."""
    ranks, _, _ = runs
    row = cache_bytes(1, 32, 64)
    for npz in ranks:
        c = _case(npz, "budget")
        assert str(c["full/kind"]) == "DeviceCache"
        assert c["full/before"] == 6 * row and c["full/after"] == 6 * row - 10 * row // 2
        assert str(c["hybrid/kind"]) == "NoneType"
        assert c["hybrid/after"] == c["hybrid/before"] == 3 * row
        assert ("device cache for cityscapes/train: dataset exceeds even the mesh-sharded "
                "budget; streaming") in str(c["hybrid/printed"])


def test_a_batch_that_does_not_split_trains_on_one_rank(runs):
    """A global batch of 3 on 2 ranks: D = gcd(3, 2) = 1, rank 1 builds
    nothing and returns rank 0's result, and the run is the single
    process's, bit for bit: the result and the checkpoint rank 0 wrote."""
    ranks, d, _ = runs
    a, b = _case(ranks[0], "gcd"), _case(ranks[1], "gcd")
    assert a["data"] == b["data"] == 1 and a["member"] and not b["member"]
    assert str(a["final"]) == str(b["final"])
    cfg = C.step1(synthetic=True, synthetic_size=6, batch_size=3, height=32, width=64,
                  num_workers=1, num_epochs=2, savedir=str(d / "gcd_world1"))
    tr = loop.Trainer(cfg, device="cpu")
    final = tr.fit()
    assert str(a["final"]) == repr(sorted((k, v) for k, v in final.items()
                                          if k != "epoch_seconds"))
    two = torch_io._load(str(d / "gcd" / "ckpt"), None)["state_dict"]
    one = tr.ts.model.state_dict()
    assert two.keys() == one.keys()
    for k in one:
        assert torch.equal(two[k], one[k]), k


def test_fused_train_on_a_mesh_raises(runs):
    for npz in runs[0]:
        assert str(_case(npz, "fused")["error"]).startswith(
            "--fused-train is single-device only (in-kernel BN batch stats are not "
            "mesh-reduced)")


def test_cli_under_torchrun_matches_one_process(runs):
    """`python -m torch.distributed.run --nproc_per_node 2 -m mdilss_tpu_torch
    step2 --device cpu` for one epoch (one step of 4 images, 2 per rank):
    rank 0 alone writes the run's files (the same files as one process's
    run, one log row) and prints the result line; the final state is one
    process's at tests/test_multichip.py's criterion (one Adam step: every
    parameter within 1.1e-3, at most 1% beyond 2e-5; the loss to 1e-5
    relative; the running statistics to 1e-4 relative)."""
    _, d, out = runs
    one, two = d / "cli1", d / "cli2"

    def files(root):
        return sorted(os.path.relpath(os.path.join(p, f), root)
                      for p, _, fs in os.walk(root) for f in fs)

    assert files(one) == files(two)
    for name in ("automated_log.txt", "metrics.jsonl"):
        assert len((one / name).read_text().splitlines()) == len(
            (two / name).read_text().splitlines())
    rows = [json.loads(line) for line in out.splitlines() if line.startswith("{")]
    assert len(rows) == 1  # the result line, from rank 0 only
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
