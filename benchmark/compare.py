"""The numbers that decide `correct`, each a reading of the program (or the
control) against the plain reference.

Training, over the batches that set-up drives through the window's own call
(and, named `window.<number>`, over as many driven right after the window,
from the program's state as the window left it):
  loss_gap      the largest relative gap of a batch's loss, CE or KLD;
  first_loss_gap  the same of the first batch alone;
  moment_gap    the gradient as Adam took it in on the first batch, weight
                decay and freeze masks applied ((m - b1^k m_start) / (1 - b1)
                over its k steps): by the worst leaf, the gap between the two norms
                over the larger of the reference leaf's norm and the median
                leaf's;
  change_gap    the parameters' change after the checked batches, the same
                measure, over the leaves the reference's first gradient
                moves: a leaf whose raw gradient norm is under 1e-3 of the
                median leaf's (a bias that the batch mean absorbs under BN)
                moves by round-off alone and is left out;
  group_change_gap   per LR group (the leaves of one base LR: the shared
                convs, the new task's), the median leaf's gap of the
                change within it; the largest over the groups, so that an
                update wrong in a minority of the leaves shows;
  running_gap   the BN running statistics' change, the same measure;
and, over the whole run,
  frozen_moved  elements of frozen parameters (LR 0) or of the teacher that
                differ at the end from where they started.
Eval, over a sample of the window's batches drawn from the seed:
  loss_gap      the largest relative gap of a batch's CE;
  label_gap     the largest share of a batch's pixels whose predicted
                label differs (half the L1 distance of the two confusion
                matrices over the pixels).
"""
from __future__ import annotations

import statistics

import torch

RAW_GRAD_FLOOR = 1e-3  # a leaf under this share of the median leaf's raw gradient is not compared


def rel(a: float, b: float) -> float:
    return abs(a - b) / abs(b) if b else abs(a - b)


def worst_leaf_gap(prog: dict, ref: dict, leaves=None) -> float:
    """max over `leaves` of |prog - ref| / max(ref, median ref) of per-leaf norms."""
    leaves = list(ref if leaves is None else leaves)
    if not leaves:
        return 0.0
    med = statistics.median(ref[k] for k in leaves)
    return max(abs(prog[k] - ref[k]) / max(ref[k], med) if max(ref[k], med) > 0
               else abs(prog[k] - ref[k]) for k in leaves)


def worst_leaves(prog: dict, ref: dict, leaves, k: int = 3) -> list:
    """The k leaves of worst_leaf_gap's largest measure: [(measure, leaf,
    program norm, reference norm)]."""
    leaves = list(leaves)
    med = statistics.median(ref[x] for x in leaves)
    return sorted(((abs(prog[x] - ref[x]) / max(ref[x], med, 1e-30), x, prog[x], ref[x])
                   for x in leaves), reverse=True)[:k]


def median_leaf_gap(prog: dict, ref: dict, leaves) -> float:
    """The median over `leaves` of worst_leaf_gap's per-leaf measure."""
    leaves = list(leaves)
    med = statistics.median(ref[k] for k in leaves)
    return statistics.median(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in leaves)


@torch.no_grad()
def change_norms(after: dict, before: dict) -> dict:
    return {k: float((after[k].double() - before[k].double()).norm()) for k in after}


def group_leaf_gap(prog: dict, ref: dict, leaves, group_of: dict) -> float:
    """The largest over the groups of `group_of` of median_leaf_gap within one."""
    groups: dict = {}
    for k in leaves:
        groups.setdefault(group_of[k], []).append(k)
    return max(median_leaf_gap(prog, ref, ks) for ks in groups.values())


def train_readings(prog: dict, ref: dict) -> dict:
    """prog / ref: {"losses": [{"loss", "ce", "kld"}] per batch, "moment",
    "change", "running": {leaf: norm}}; ref also "raw_grad": {leaf: norm} and
    "lrs": {leaf: base LR} of the leaves with an LR above 0 (the frozen ones
    are held exactly by frozen_moved)."""
    loss_gap = max(rel(p[k], r[k]) for p, r in zip(prog["losses"], ref["losses"]) for k in r)
    lrs, raw = ref["lrs"], ref["raw_grad"]
    trainable = list(lrs)
    med = statistics.median(raw[k] for k in trainable)
    moved = [k for k in trainable if raw[k] >= RAW_GRAD_FLOOR * med]
    return {"loss_gap": loss_gap,
            "first_loss_gap": max(rel(prog["losses"][0][k], v)
                                  for k, v in ref["losses"][0].items()),
            "moment_gap": worst_leaf_gap(prog["moment"], ref["moment"], trainable),
            "change_gap": worst_leaf_gap(prog["change"], ref["change"], moved),
            "group_change_gap": group_leaf_gap(prog["change"], ref["change"], moved, lrs),
            "running_gap": worst_leaf_gap(prog["running"], ref["running"])}


def eval_readings(prog: list, ref: list) -> dict:
    """prog / ref: [(loss, cm [C, C] int64 on the CPU)] of the same batches."""
    loss_gap = max(rel(p[0], r[0]) for p, r in zip(prog, ref))
    label_gap = max(float((p[1] - r[1]).abs().sum()) / 2 / float(r[1].sum())
                    for p, r in zip(prog, ref))
    return {"loss_gap": loss_gap, "label_gap": label_gap}
