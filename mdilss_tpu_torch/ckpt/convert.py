"""Weight bridge: the JAX package's grouped (params, state) pytree -> a state
dict in the reference grammar that `ERFNetRAP.load_state_dict(strict=True)`
takes.

Port of the RAP branch of mdilss_tpu/ckpt/pth_converter.py
`export_state_dict` (:240-357), without JAX: the pytree's leaves are
anything numpy can read (numpy or JAX arrays), and a BN state is any object
with `.mean` and `.var`. Layouts: conv HWIO -> OIHW, transposed conv HWIO ->
(in, out, kH, kW); task-stacked leaves [T, ...] -> `.{t}` entries;
`num_batches_tracked` is 0 (unused at the reference's momentum).
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


def _nb(out, pre, p, s, tasks) -> None:
    """One nb1d block; `tasks` None -> plain (bn1/bn2), else RAP."""
    _conv(out, f"{pre}.conv3x1_1", p["conv3x1_1"], False)
    _conv(out, f"{pre}.conv1x3_1", p["conv1x3_1"], False)
    _conv(out, f"{pre}.conv3x1_2", p["conv3x1_2"], False)
    _conv(out, f"{pre}.conv1x3_2", p["conv1x3_2"], False)
    if tasks is None:
        _bn(out, f"{pre}.bn1", p["bn1"], _get(s, "bn1"), None)
        _bn(out, f"{pre}.bn2", p["bn2"], _get(s, "bn2"), None)
        return
    for t in tasks:
        for k in (1, 2):
            rap = p[f"rap{k}"]
            _conv(out, f"{pre}.parallel_conv_{k}.{t}",
                  {"w": np.asarray(rap["w"])[t], "b": np.asarray(rap["b"])[t]}, False)
    _bn(out, f"{pre}.bns_1", p["bns1"], _get(s, "bns1"), tasks)
    _bn(out, f"{pre}.bns_2", p["bns2"], _get(s, "bns2"), tasks)


def nb_block_state_dict(p, s) -> dict[str, torch.Tensor]:
    """State dict of ONE nb1d block (plain or RAP, told apart by `rap1`) from
    its JAX (params, state), keys relative to the block module."""
    out: dict[str, torch.Tensor] = {}
    tasks = list(range(np.asarray(p["rap1"]["w"]).shape[0])) if "rap1" in p else None
    _nb(out, "", p, s, tasks)
    return {k.removeprefix("."): v for k, v in out.items()}


def from_jax(params, state) -> dict[str, torch.Tensor]:
    """ERFNet-RAP (params, state) from mdilss_tpu.models.erfnet_rap.init (or
    a converted checkpoint) -> reference-grammar state dict."""
    return _convert(params, state)


def params_from_jax(tree) -> dict[str, torch.Tensor]:
    """Any tree shaped like ERFNet-RAP params (params, their grads, an LR tree
    whose leaves are broadcast to the parameters' shapes) -> {state-dict
    parameter name: tensor}, with the layouts of `from_jax`."""
    return _convert(tree, None)


def _convert(params, state) -> dict[str, torch.Tensor]:
    """`state` None: parameter entries only."""
    out: dict[str, torch.Tensor] = {}
    enc_p, enc_s = params["encoder"], _get(state, "encoder")
    tasks = list(range(np.asarray(enc_p["initial"]["bn"]["scale"]).shape[0]))
    _conv(out, "encoder.initial_block.conv", enc_p["initial"]["conv"], False)
    _bn(out, "encoder.initial_block.bn_ini", enc_p["initial"]["bn"],
        _get(_get(enc_s, "initial"), "bn"), tasks)
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
            _conv(out, f"{pre}.conv", p["conv"], False)
            _bn(out, f"{pre}.bn_ini", p["bn"], _get(s, "bn"), tasks)
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
