"""Loss functions: weighted pixel cross-entropy and the distillation KLD.

Port of mdilss_tpu/losses.py:33-68, on the port's spatial logits [N, H, W, C]
(class axis last, as the model returns them):

  * `weighted_cross_entropy`: CrossEntropyLoss2d(weight), the weighted mean
    sum_i w[y_i] * nll_i / sum_i w[y_i]; the ignore class has weight 0, and a
    target outside [0, C) counts nowhere.
  * `kld_faithful`: the reference's KLDivLoss()(softmax(student),
    softmax(teacher)), probabilities as the input: mean over B*C*H*W of
    p_t * (log p_t - p_s), with 0 * log 0 = 0.
  * `kld_corrected`: the intended KL(p_t || p_s), mean of p_t * (log p_t - log p_s).

Sharded (`mesh`, parallel/mesh.py): a rank's loss is its share of the
global batch's, so the shares sum to it and their gradients sum to its
gradient. The CE's share is this rank's sum of w * nll over the global sum
of w (all-reduced over every rank of the mesh, no gradient); the KLDs' is
this rank's mean over D * S (`kld_share`: the ranks hold equal blocks of
images and of rows).
"""
from __future__ import annotations

import torch

from .parallel.mesh import active, all_reduce_


def weighted_nll_sums(logits: torch.Tensor, targets: torch.Tensor,
                      weight: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(sum of w[y] * nll, sum of w[y]) over the pixels: the weighted CE's
    numerator and denominator."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    c = logits.shape[-1]
    valid = (targets >= 0) & (targets < c)
    idx = torch.where(valid, targets, torch.zeros_like(targets)).long()
    nll = -logp.gather(-1, idx.unsqueeze(-1)).squeeze(-1)
    weight = weight.to(device=logits.device, dtype=torch.float32)
    w = weight[idx] * valid
    return (w * nll).sum(), w.sum()


def weighted_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                           weight: torch.Tensor, mesh=None) -> torch.Tensor:
    """logits [N,H,W,C], targets [N,H,W] int, weight [C] -> scalar float32;
    with `mesh`, this rank's share of the global batch's CE."""
    num, den = weighted_nll_sums(logits, targets, weight)
    if active(mesh):
        den = all_reduce_(den.detach().clone(), mesh)
    return num / den


def kld_share(kld: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's share of the global batch's KLD from its local mean `kld`."""
    return kld / mesh.size if active(mesh) else kld


def kld_faithful(student_logits: torch.Tensor, teacher_logits: torch.Tensor) -> torch.Tensor:
    """Reference-exact KLD: KLDivLoss()(softmax(student), softmax(teacher))."""
    p_s = torch.softmax(student_logits.float(), dim=-1)
    p_t = torch.softmax(teacher_logits.float(), dim=-1)
    return (torch.xlogy(p_t, p_t) - p_t * p_s).mean()


def kld_corrected(student_logits: torch.Tensor, teacher_logits: torch.Tensor) -> torch.Tensor:
    """KL(p_t || p_s) with log-probability input, 'mean' reduction."""
    logp_s = torch.log_softmax(student_logits.float(), dim=-1)
    p_t = torch.softmax(teacher_logits.float(), dim=-1)
    return (torch.xlogy(p_t, p_t) - p_t * logp_s).mean()
