"""The port's poly LR factor (mdilss_tpu_torch/train/optim.py
`poly_lr_factor`) against the JAX package's (mdilss_tpu/train/optim.py:118-122,
called eagerly, as its Trainer computes the logged LR columns) at every epoch
of several schedule lengths: bitwise equal (the float32 base raised to the
float32 exponent, correctly rounded to float32). `apply_updates` bitwise its
frozen predecessor (tests/_torch_adam_before.py) on step-2 and step-3
parameter sets, and the LR cache built once per step maker (`LR_BUILDS`)."""
import copy

import numpy as np
import pytest
import torch

from _torch_adam_before import adam_case, apply_updates_before
from mdilss_tpu.train.optim import poly_lr_factor as jax_poly_lr_factor
from mdilss_tpu_torch.models import ERFNetRAP
from mdilss_tpu_torch.models.topology import make_dropout_masks
from mdilss_tpu_torch.train import optim, steps
from mdilss_tpu_torch.train.masks import rap_lr_tree
from mdilss_tpu_torch.train.optim import poly_lr_factor


@pytest.mark.parametrize("num_epochs", [1, 2, 3, 5, 10, 50, 150])
def test_poly_lr_factor_equals_jax(num_epochs):
    epochs = range(1, num_epochs + 1)
    want = [float(jax_poly_lr_factor(e, num_epochs)) for e in epochs]
    got = [poly_lr_factor(e, num_epochs) for e in epochs]
    assert got == want



def _same(a: dict, b: dict) -> bool:
    return all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("count", [1, 2, 50])
@pytest.mark.parametrize("classes", [[20, 20], [20, 20, 27]], ids=["step2", "step3"])
def test_apply_updates_bitwise_its_predecessor(classes, count):
    """Three successive steps from step `count`, one cache reused by the new
    one: every leaf, both moments and the count bitwise the frozen copy's;
    the frozen leaves unchanged, None gradients included."""
    params, lrs, state, grads, frozen = adam_case(classes, count)
    assert frozen and any(g is None for g in grads().values())
    mine, ref = copy.deepcopy(params), copy.deepcopy(params)
    st_mine = st_ref = state
    cache = optim.LrCache()
    for i in range(3):
        g = grads()
        kw = dict(lr_scale=float(np.float32(0.9) ** i), weight_decay=1e-4)
        st_mine = optim.apply_updates(mine, g, st_mine, lrs, cache=cache, **kw)
        st_ref = apply_updates_before(ref, g, st_ref, lrs, **kw)
        assert _same(mine, ref), i
        assert torch.equal(st_mine.m, st_ref.m) and torch.equal(st_mine.v, st_ref.v)
        assert st_mine.count == st_ref.count == count + i
    assert all(torch.equal(mine[k], params[k]) for k in frozen)
    assert not _same(mine, params)


def test_lr_builds_once_per_maker_and_again_when_an_lr_changes():
    """`optim.LR_BUILDS` grows once per step maker, whatever its steps and
    Adam steps a step (the two-phase step takes two), and again when an LR of
    its dict changes; a cache without a maker builds once for its key."""
    torch.manual_seed(0)
    teacher = ERFNetRAP([20, 20], 2, device="cpu")
    student = ERFNetRAP([20, 20, 27], 3, device="cpu")
    lrs = rap_lr_tree(student, current_task=2, shared_lr=5e-6, ds_lr=5e-4)
    weight = np.linspace(0.5, 2.0, 27).astype(np.float32)
    kw = dict(current_task=2, prev_tasks=(1, 0), class_weight=weight, lr_tree=lrs,
              num_epochs=10)
    g = torch.Generator().manual_seed(1)
    x = torch.rand(2, 32, 64, 3, generator=g)
    y = torch.randint(0, 27, (2, 32, 64), generator=g, dtype=torch.int32)
    rng = np.random.default_rng(2)
    ts = steps.init_train_state(student)

    def masks():
        return [make_dropout_masks(rng, 2) for _ in range(3)]

    start = optim.LR_BUILDS
    two_phase = steps.make_two_phase_distill_step(**kw)
    distill = steps.make_distill_step(**kw)
    assert optim.LR_BUILDS == start  # nothing is built before a maker's first call
    for _ in range(2):
        ts, _ = two_phase(ts, teacher, x, y, masks(), 1)
    assert optim.LR_BUILDS == start + 1
    ts, _ = distill(ts, teacher, x, y, masks(), 1)
    assert optim.LR_BUILDS == start + 2
    lrs[next(k for k, v in lrs.items() if v > 0)] = 1e-3  # the dict the makers hold
    ts, _ = two_phase(ts, teacher, x, y, masks(), 1)
    assert optim.LR_BUILDS == start + 3
    ts, _ = two_phase(ts, teacher, x, y, masks(), 1)
    ts, _ = distill(ts, teacher, x, y, masks(), 1)
    assert optim.LR_BUILDS == start + 4
    cache, params = optim.LrCache(), dict(student.named_parameters())
    names, ps = list(params), list(params.values())
    assert cache.get(names, ps, lrs) is cache.get(names, ps, dict(lrs))
    assert optim.LR_BUILDS == start + 5
