"""The plain reference against the port's CPU path (its kernels' plain
versions) at 2x64x128 on seeded weights: one step-2 step and one step-3
batch, each with the one after it from the state it left, and the eval
batches of a short window, through the benchmark's loops."""
import pytest
import torch

from benchmark import harness

from ._small import OVERRIDES, ROOT, SEED

CPU = torch.device("cpu")


def _train_readings(name: str):
    cell = harness.Cell.load(ROOT, name, {**OVERRIDES[name], "checked_batches": 1})
    loop = cell.loop_class()(cell, SEED, CPU)
    loop.setup()
    prog = loop.program_readings()
    return loop.compare(prog, loop.reference_readings(tf32=False))


@pytest.mark.parametrize("name", ["step2_fp32", "step3_fp32"])
def test_one_training_batch_matches_the_reference(name):
    r = _train_readings(name)
    # the same float32 sums in another order: the loss to rounding; Adam's
    # first moment within the BN + relu stack's own rounding noise at this size
    # the same again for the batch after the set-up's, from the state it left
    for stage in ("", "window."):
        assert r[stage + "first_loss_gap"] <= 1e-6, r
        assert r[stage + "moment_gap"] <= 3e-2, r
        assert r[stage + "running_gap"] <= 2e-2, r
    assert r["frozen_moved"] == 0, r


def test_eval_batches_match_the_reference():
    cell = harness.Cell.load(ROOT, "eval_fp32", OVERRIDES["eval_fp32"])
    loop = cell.loop_class()(cell, SEED, CPU)
    loop.setup()
    loop.window(0.5)
    prog = loop.program_readings()
    r = loop.compare(prog, loop.reference_readings(tf32=False))
    assert r["loss_gap"] <= 1e-6, r
    assert r["label_gap"] <= 1e-3, r


@pytest.mark.parametrize("num_classes", [[20], [20, 20, 27]])
def test_reference_eval_forward_is_the_ports(num_classes):
    from benchmark import inputs
    from benchmark.reference.erfnet_rap import Forward
    from mdilss_tpu_torch.models import ERFNetRAP

    gen = torch.Generator().manual_seed(SEED)
    sd = inputs.state_dict(num_classes, gen, CPU)
    model = ERFNetRAP(num_classes, len(num_classes), device="cpu")
    model.load_state_dict(sd, strict=True)
    x = torch.rand(2, 64, 128, 3, generator=gen)
    for t in range(len(num_classes)):
        want = Forward(sd, t, train=False)(x)
        got = model(x, t)
        assert float((got - want).norm() / want.norm()) <= 1e-5
