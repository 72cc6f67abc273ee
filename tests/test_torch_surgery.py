"""The port's checkpoint surgery (mdilss_tpu_torch/ckpt/surgery.py) against
the JAX package's (mdilss_tpu/ckpt/surgery.py) followed by
`export_state_dict`, on JAX-initialised weights with random BN: bit for bit
on every key but the new head's output_conv, which is checked for its shape
and torch's default initialisation from the generator."""
import math

import numpy as np
import pytest
import torch

import jax

from _torch_port import randomize_bn
from mdilss_tpu.ckpt import export_state_dict
from mdilss_tpu.ckpt import surgery as jsurgery
from mdilss_tpu.models import erfnet_multihead as jmh
from mdilss_tpu.models import erfnet_rap
from mdilss_tpu_torch.ckpt import surgery
from mdilss_tpu_torch.models import ERFNetMultiHead, ERFNetRAP

torch.set_num_threads(1)


def _sd(params, bn, kind="rap", prefix="") -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v)) for k, v in
            export_state_dict(params, bn, kind=kind, prefix=prefix).items()}


def _assert_equal(got: dict, want: dict, skip=()):
    assert set(got) == set(want)
    for k, v in want.items():
        if k not in skip:
            assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


@pytest.mark.parametrize("classes,new", [([6], 7), ([6, 7], 8)])
def test_extend_for_new_task_equals_jax(classes, new):
    rng = np.random.default_rng(0)
    nb = len(classes)
    params, bn = randomize_bn(*erfnet_rap.init(jax.random.key(1), classes, nb), rng)
    sd = _sd(params, bn, prefix="module.")
    want = _sd(*jsurgery.extend_for_new_task(params, bn, new, jax.random.key(2)))
    got = surgery.extend_for_new_task(sd, new, generator=torch.Generator().manual_seed(3))
    head = f"decoder.{nb}.output_conv."
    _assert_equal(got, want, skip=(head + "weight", head + "bias"))
    # the new slot's running statistics start fresh, its affine from slot t-1
    assert torch.equal(got[f"encoder.layers.1.bns_1.{nb}.running_var"], torch.ones(64))
    assert torch.equal(got[f"encoder.layers.1.bns_1.{nb}.weight"],
                       sd[f"module.encoder.layers.1.bns_1.{nb - 1}.weight"])
    # no tensor of the input is shared
    ptrs = {v.data_ptr() for v in sd.values()}
    assert not ptrs & {v.data_ptr() for v in got.values()}
    # the fresh output_conv: the shape, torch's default bounds, the generator's draws
    w, b = got[head + "weight"], got[head + "bias"]
    assert w.shape == (16, new, 2, 2) and b.shape == (new,)
    bound = 1 / math.sqrt(new * 4)  # kaiming_uniform_(a=sqrt(5)) and the bias: 1/sqrt(fan_in)
    assert w.abs().max() <= bound and b.abs().max() <= bound and w.std() > bound / 4
    again = surgery.extend_for_new_task(sd, new, generator=torch.Generator().manual_seed(3))
    assert torch.equal(again[head + "weight"], w) and torch.equal(again[head + "bias"], b)
    ref = torch.nn.ConvTranspose2d(16, new, 2, stride=2)
    assert ref.weight.shape == w.shape
    # the grown state dict loads into the grown model
    model = ERFNetRAP(classes + [new], nb + 1, device="cpu")
    model.load_state_dict(got, strict=True)


def _pretrained(base: dict, rng, keep) -> dict:
    """A fake ImageNet encoder: random values for the encoder keys `keep`
    selects under `module.features.`, an entry of another shape and one
    unknown key (both ignored)."""
    out = {"module.features." + k: torch.from_numpy(
        rng.standard_normal(tuple(v.shape)).astype(np.float32))
        for k, v in base.items() if k.startswith("encoder.") and keep(k)}
    out["module.features.encoder.layers.1.conv3x1_1.bias"] = torch.zeros(5)
    out["module.features.encoder.layers.1.bn9.weight"] = torch.ones(64)
    return out


@pytest.mark.parametrize("kind", ["rap", "multi_task"])
def test_load_imagenet_encoder_and_merge_equal_jax(kind):
    rng = np.random.default_rng(1)
    if kind == "rap":
        params, bn = randomize_bn(*erfnet_rap.init(jax.random.key(4), [6], 1), rng)
    else:
        params, bn = randomize_bn(*jmh.init(jax.random.key(4), [6, 7]), rng)
    base = _sd(params, bn, kind)
    pre = _pretrained(base, rng, lambda k: "conv" in k or kind != "rap")
    np_pre = {k: v.numpy() for k, v in pre.items()}
    want = _sd(*jsurgery.load_imagenet_encoder(params, bn, np_pre, kind=kind), kind)
    got = surgery.load_imagenet_encoder(base, pre)
    _assert_equal(got, want)
    loaded = [k for k in base if not torch.equal(got[k], base[k])]
    assert loaded and all(k.startswith("encoder.") for k in loaded)

    # merge_state_dict: `module.` keys of the model's own grammar, strict=False
    renamed = {k.replace("module.features.", "module."): v.numpy() for k, v in pre.items()}
    want = _sd(*jsurgery.merge_state_dict(params, bn, renamed, kind=kind), kind)
    _assert_equal(surgery.merge_state_dict(base, renamed), want)


def test_graft_shared_encoder_equals_jax():
    """RAP -> RAP: the shared convs of one model into another, its adapters,
    BN and decoders untouched."""
    rng = np.random.default_rng(2)
    dst_p, dst_b = randomize_bn(*erfnet_rap.init(jax.random.key(5), [6, 7], 2), rng)
    src_p, src_b = randomize_bn(*erfnet_rap.init(jax.random.key(6), [6], 1), rng)
    want = _sd(jsurgery.graft_shared_encoder(dst_p, src_p["encoder"]), dst_b)
    dst = _sd(dst_p, dst_b)
    got = surgery.graft_shared_encoder(dst, _sd(src_p, src_b, prefix="module."))
    _assert_equal(got, want)
    grafted = {k for k in got if not torch.equal(got[k], dst[k])}
    assert grafted and all(k.startswith("encoder.") and ".conv" in k and "parallel" not in k
                           for k in grafted)


def test_keep_tasks_drops_later_tasks():
    model = ERFNetRAP([5, 6, 7], 3, device="cpu")
    sd = surgery.keep_tasks(model.state_dict(), 2)
    ERFNetRAP([5, 6], 2, device="cpu").load_state_dict(sd, strict=True)
    mt = ERFNetMultiHead([5, 6, 7], kind="multi_task", device="cpu")
    ERFNetMultiHead([5], device="cpu").load_state_dict(
        surgery.keep_tasks(mt.state_dict(), 1), strict=True)
    with pytest.raises(ValueError, match="fewer than 4"):
        surgery.keep_tasks(model.state_dict(), 4)
