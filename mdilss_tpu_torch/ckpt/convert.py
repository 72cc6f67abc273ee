"""Weight bridge: the JAX package's grouped (params, state) pytree of
ERFNet-RAP or of an ablation model -> a state dict that
`ERFNetRAP` / `ERFNetAblation.load_state_dict(strict=True)` takes.

Port of the RAP branch of mdilss_tpu/ckpt/pth_converter.py
`export_state_dict` (:240-357), without JAX, extended to the ablation
models' pytrees (mdilss_tpu/models/erfnet_ablations.py `init`) in the
port's grammar for them (models/erfnet_ablations.py): the pytree's leaves
are anything numpy can read (numpy or JAX arrays), and a BN state is any
object with `.mean` and `.var`. Layouts: conv HWIO -> OIHW, transposed conv
HWIO -> (in, out, kH, kW); task-stacked leaves [T, ...] -> `.{t}` entries
(the task axis is 0 on the downsamplers' BN and 1 on grouped leaves,
mdilss_tpu/ckpt/surgery.py:55-56); RCM's `wt` [T, C, C] -> `Wt_k.{t}` as
is; `num_batches_tracked` is 0 (unused at the reference's momentum). A
block's variant is told by its keys, the task count by the decoders.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..models.topology import DECODER_PLAN, ENCODER_PLAN, GROUP128_DILATIONS


class _BN(NamedTuple):
    mean: np.ndarray
    var: np.ndarray


def encoder_layer_address(i: int):
    """Reference `encoder.layers.{i}` -> (segment, index) in the grouped
    pytree: ("down1"|"down2", None), ("group64", k) or
    ("group128", (rep, "d{d}"))."""
    if i == 0:
        return "down1", None
    if 1 <= i <= 5:
        return "group64", i - 1
    if i == 6:
        return "down2", None
    rep, pos = divmod(i - 7, 4)
    return "group128", (rep, f"d{GROUP128_DILATIONS[pos]}")


def decoder_layer_address(j: int):
    """Reference `decoder.{t}.layers.{j}` -> (segment, index)."""
    return [
        ("up1", None), ("group64", 0), ("group64", 1),
        ("up2", None), ("group16", 0), ("group16", 1),
    ][j]


def _get(tree, key):
    return None if tree is None else tree[key]


def _index(tree, i):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    if hasattr(tree, "shape"):  # an array (arrays have .mean/.var methods too)
        return np.asarray(tree)[i]
    return _BN(np.asarray(tree.mean)[i], np.asarray(tree.var)[i])


def _put(out: dict, key: str, a) -> None:
    out[key] = torch.from_numpy(np.array(a))


def _conv(out, prefix, p, transposed: bool) -> None:
    w = np.asarray(p["w"])  # [kh, kw, in, out]
    _put(out, f"{prefix}.weight", w.transpose(2, 3, 0, 1) if transposed else w.transpose(3, 2, 0, 1))
    _put(out, f"{prefix}.bias", p["b"])


def _bn(out, prefix, p, s, tasks) -> None:
    entries = [(prefix, lambda a: a)] if tasks is None else [
        (f"{prefix}.{t}", lambda a, t=t: np.asarray(a)[t]) for t in tasks
    ]
    for pre, pick in entries:
        _put(out, f"{pre}.weight", pick(p["scale"]))
        _put(out, f"{pre}.bias", pick(p["bias"]))
        if s is None:
            continue
        _put(out, f"{pre}.running_mean", pick(s.mean))
        _put(out, f"{pre}.running_var", pick(s.var))
        out[f"{pre}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)


# JAX's task-stacked 1x1 adapters of a block -> the port's module names
_ADAPTERS = {"rap": "parallel_conv_", "ser": "series_conv_"}


def _block_tasks(p) -> list[int] | None:
    """The tasks of one block's (ungrouped) params, or None for a plain block."""
    for k, leaf in (("bns1", "scale"), ("rap1", "w"), ("ser1", "w"), ("wt1", None)):
        if k in p:
            return list(range(np.shape(p[k] if leaf is None else p[k][leaf])[0]))
    return None


def _nb(out, pre, p, s, tasks) -> None:
    """One nb1d block: plain, RAP or an ablation variant, told apart by its
    keys (`bns*` per-task BN or `bn*` shared; `rap*`, `ser*` or `wt*`
    adapters); `tasks` the model's tasks (None for a plain block)."""
    _conv(out, f"{pre}.conv3x1_1", p["conv3x1_1"], False)
    _conv(out, f"{pre}.conv1x3_1", p["conv1x3_1"], False)
    _conv(out, f"{pre}.conv3x1_2", p["conv3x1_2"], False)
    _conv(out, f"{pre}.conv1x3_2", p["conv1x3_2"], False)
    for k in (1, 2):
        if f"bns{k}" in p:
            _bn(out, f"{pre}.bns_{k}", p[f"bns{k}"], _get(s, f"bns{k}"), tasks)
        else:
            _bn(out, f"{pre}.bn{k}", p[f"bn{k}"], _get(s, f"bn{k}"), None)
        for jax_key, name in _ADAPTERS.items():
            if f"{jax_key}{k}" in p:
                a = p[f"{jax_key}{k}"]
                for t in tasks:
                    _conv(out, f"{pre}.{name}{k}.{t}",
                          {"w": np.asarray(a["w"])[t], "b": np.asarray(a["b"])[t]}, False)
        if f"wt{k}" in p:
            for t in tasks:
                _put(out, f"{pre}.Wt_{k}.{t}", np.asarray(p[f"wt{k}"])[t])


def nb_block_state_dict(p, s) -> dict[str, torch.Tensor]:
    """State dict of ONE nb1d block (plain, RAP or an ablation variant) from
    its JAX (params, state), keys relative to the block module."""
    out: dict[str, torch.Tensor] = {}
    _nb(out, "", p, s, _block_tasks(p))
    return {k.removeprefix("."): v for k, v in out.items()}


def from_jax(params, state) -> dict[str, torch.Tensor]:
    """ERFNet-RAP (params, state) from mdilss_tpu.models.erfnet_rap.init (or
    a converted checkpoint) -> reference-grammar state dict; an ablation
    model's from mdilss_tpu.models.erfnet_ablations.init -> the port's
    grammar for it."""
    return _convert(params, state)


def params_from_jax(tree) -> dict[str, torch.Tensor]:
    """Any tree shaped like ERFNet-RAP's or an ablation model's params
    (params, their grads, an LR tree whose leaves are broadcast to the
    parameters' shapes) -> {state-dict parameter name: tensor}, with the
    layouts of `from_jax`."""
    return _convert(tree, None)


def _convert(params, state) -> dict[str, torch.Tensor]:
    """`state` None: parameter entries only."""
    out: dict[str, torch.Tensor] = {}
    enc_p, enc_s = params["encoder"], _get(state, "encoder")
    tasks = list(range(len(params["decoders"])))

    def down(pre, p, s):
        _conv(out, f"{pre}.conv", p["conv"], False)
        if np.ndim(p["bn"]["scale"]) == 2:  # per-task `bn_ini` (RAP, bn, ras, rcm)
            _bn(out, f"{pre}.bn_ini", p["bn"], _get(s, "bn"), tasks)
        else:  # onlyrap's shared downsampler BN
            _bn(out, f"{pre}.bn", p["bn"], _get(s, "bn"), None)

    down("encoder.initial_block", enc_p["initial"], _get(enc_s, "initial"))
    for i, spec in enumerate(ENCODER_PLAN):
        seg, idx = encoder_layer_address(i)
        p, s = enc_p[seg], _get(enc_s, seg)
        if seg == "group64":
            p, s = _index(p, idx), _index(s, idx)
        elif seg == "group128":
            rep, dkey = idx
            p, s = _index(p[dkey], rep), _index(_get(s, dkey), rep)
        pre = f"encoder.layers.{i}"
        if spec[0] == "down":
            down(pre, p, s)
        else:
            _nb(out, pre, p, s, tasks)
    dec_s = [None] * len(params["decoders"]) if state is None else state["decoders"]
    for t, (dp, ds) in enumerate(zip(params["decoders"], dec_s)):
        for j, spec in enumerate(DECODER_PLAN):
            seg, idx = decoder_layer_address(j)
            p, s = dp[seg], _get(ds, seg)
            if idx is not None:
                p, s = _index(p, idx), _index(s, idx)
            pre = f"decoder.{t}.layers.{j}"
            if spec[0] == "up":
                _conv(out, f"{pre}.conv", p["conv"], True)
                _bn(out, f"{pre}.bn", p["bn"], _get(s, "bn"), None)
            else:
                _nb(out, pre, p, s, None)
        _conv(out, f"decoder.{t}.output_conv", dp["output_conv"], True)
    return out
