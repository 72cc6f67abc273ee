"""Plain SegFormer with per-domain LayerNorms, adapters and heads over a state
dict, and its step-2 and step-3 training steps, for the comparison that
decides `correct` in the SegFormer cells.

The model is SegFormer-B5 as published (Xie et al., "SegFormer: Simple and
Efficient Design for Semantic Segmentation with Transformers", NeurIPS
2021, arXiv:2105.15203; NVlabs/SegFormer mix_transformer.py `mit_b5` and
segformer.b5.1024x1024.city.160k's all-MLP head), with MDIL-SS's incremental
rule mapped onto it:

  stage i  patch embedding: conv (7x7 stride 4 pad 3 for the first stage,
           3x3 stride 2 pad 1 after), tokens, LayerNorm_t (eps 1e-5); the
           stage's blocks; LayerNorm_t (eps 1e-6)
  block    x = x + dp(Attn(LN1_t(x)));
           y = LN2_t(x); x = x + dp(MixFFN(y) + A_t(y))   (LN eps 1e-6)
  Attn     q = W_q x; x_r = LN_sr_t(conv RxR stride R(x)) (eps 1e-5) for
           R > 1, else x; k, v = W_kv x_r; per head softmax(q k^T / sqrt(d)) v,
           computed as written over blocks of `QUERY_BLOCK` queries; W_proj
  MixFFN   fc1 (C -> 4C), depthwise 3x3 conv with bias, exact GELU, fc2
  A_t      the domain's adapter, a Linear C -> C with bias
  head_t   per stage a Linear to D, resized bilinearly (align_corners False)
           to the first stage's size, concatenated [c4, c3, c2, c1]; a 1x1
           conv 4D -> D without bias, BN (eps 1e-5, momentum 0.1), ReLU,
           Dropout2d, a 1x1 conv D -> classes; the logits resized bilinearly
           to the input size

Departures from the published description, each the port's too: the
LayerNorms and adapters are per domain (`.{t}` in the name), each domain
has its own head, images are x / 255 (the system's transforms; SegFormer
normalises with ImageNet's mean and deviation), and the drop-path rate of
block b of n is b * rate / (n - 1) in float64 (numpy's linspace; NVlabs
takes torch's float32 linspace). Drop-path uses one keep-mask per sample
and residual branch, x / keep_prob * mask (timm's DropPath), and the head's
Dropout2d one per sample and channel, from host masks ("drop_path" [blocks,
2, B], "head" [B, D]) that `keep_masks` draws from the generator the
program draws its own from, at this module's rates. A training forward normalises
the head's BN with the batch statistics and, given running buffers (the
student's), updates them as torch does (the unbiased variance); a teacher
in training mode is given none.

`tf32=True` rounds the operands of every product (each Linear, conv and
attention matmul, and in the backward the gradient of its output) to TF32
and sums in float32: the precision one step below float32, the control of
the comparison (`erfnet_rap.tf32_product`).

This module imports torch, numpy and the benchmark's reference helpers
only: no JAX, and nothing of the program under test.
"""
from __future__ import annotations

import re

import numpy as np
import torch
import torch.nn.functional as F

from .erfnet_rap import float32_exact, tf32_product
from .train import B1, State, augment, cross_entropy, kld, poly_lr  # noqa: F401 (the loop's)

PATCH = ((7, 4, 3), (3, 2, 1), (3, 2, 1), (3, 2, 1))  # (kernel, stride, padding) per stage
EMBED_LN_EPS, BLOCK_LN_EPS, SR_LN_EPS, HEAD_BN_EPS = 1e-5, 1e-6, 1e-5, 1e-5
BN_MOMENTUM = 0.1
QUERY_BLOCK = 8192

B5 = {"embed_dims": (64, 128, 320, 512), "num_heads": (1, 2, 5, 8), "depths": (3, 6, 40, 3),
      "sr_ratios": (8, 4, 2, 1), "mlp_ratio": 4, "decoder_dim": 768, "drop_path_rate": 0.1,
      "head_dropout": 0.1}
_SLOT = re.compile(r"\.(?:norm\d?|adapter)\.(\d+)\.")


def spec_of(config: dict) -> dict:
    """The widths and depths of a configuration file's published keys."""
    return {"embed_dims": tuple(config["embed_dims"]), "num_heads": tuple(config["num_heads"]),
            "depths": tuple(config["depths"]), "sr_ratios": tuple(config["sr_ratios"]),
            "mlp_ratio": config["mlp_ratios"][0], "decoder_dim": config["decoder_embed_dim"],
            "drop_path_rate": config["drop_path_rate"], "head_dropout": config["dropout_ratio"]}


def drop_path_rates(spec: dict) -> np.ndarray:
    return np.linspace(0.0, spec["drop_path_rate"], sum(spec["depths"]))


def keep_masks(rng: np.random.Generator, spec: dict, batch: int) -> dict:
    """One training forward's keep-masks from `rng`: first each block's two
    residual branches per sample, kept with probability 1 - the block's
    drop-path rate, then the head's Dropout2d per sample and channel, kept
    with probability 1 - head_dropout."""
    keep = 1.0 - drop_path_rates(spec)
    return {"drop_path": rng.random((sum(spec["depths"]), 2, batch)) < keep[:, None, None],
            "head": rng.random((batch, spec["decoder_dim"])) < 1.0 - spec["head_dropout"]}


# ---------------------------------------------------------------------------
# parameter names and shapes
# ---------------------------------------------------------------------------

def _linear(p: str, cout: int, cin: int):
    return [(f"{p}.weight", (cout, cin), ("linear",)), (f"{p}.bias", (cout,), ("bias",))]


def _conv(p: str, cout: int, cin: int, k: int, groups: int = 1, bias: bool = True):
    out = [(f"{p}.weight", (cout, cin // groups, k, k), ("conv", k * k * cout // groups))]
    return out + ([(f"{p}.bias", (cout,), ("bias",))] if bias else [])


def _ln(p: str, dim: int, tasks: int):
    return [x for t in range(tasks) for x in ((f"{p}.{t}.weight", (dim,), ("ln_weight",)),
                                              (f"{p}.{t}.bias", (dim,), ("ln_bias",)))]


def _bn(p: str, ch: int):
    return [(f"{p}.weight", (ch,), ("bn_weight",)), (f"{p}.bias", (ch,), ("bn_bias",)),
            (f"{p}.running_mean", (ch,), ("bn_mean",)), (f"{p}.running_var", (ch,), ("bn_var",)),
            (f"{p}.num_batches_tracked", (), ("count",))]


def param_spec(num_classes, spec: dict = B5) -> list[tuple[str, tuple, tuple]]:
    """[(name, shape, init)] of every tensor of the state dict of the model
    with one domain per entry of `num_classes`; `init` is ("linear",),
    ("conv", fan_out), ("classifier",), ("bias",), ("ln_weight",),
    ("ln_bias",), ("bn_weight",), ("bn_bias",), ("bn_mean",), ("bn_var",) or
    ("count",)."""
    tasks, out, cin = len(num_classes), [], 3
    for i, (dim, depth, sr) in enumerate(zip(spec["embed_dims"], spec["depths"],
                                             spec["sr_ratios"])):
        e = f"encoder.patch_embed{i + 1}"
        out += _conv(f"{e}.proj", dim, cin, PATCH[i][0]) + _ln(f"{e}.norm", dim, tasks)
        hidden = spec["mlp_ratio"] * dim
        for j in range(depth):
            b = f"encoder.block{i + 1}.{j}"
            out += _ln(f"{b}.norm1", dim, tasks)
            out += _linear(f"{b}.attn.q", dim, dim) + _linear(f"{b}.attn.kv", 2 * dim, dim)
            out += _linear(f"{b}.attn.proj", dim, dim)
            if sr > 1:
                out += _conv(f"{b}.attn.sr", dim, dim, sr) + _ln(f"{b}.attn.norm", dim, tasks)
            out += _ln(f"{b}.norm2", dim, tasks)
            out += _linear(f"{b}.mlp.fc1", hidden, dim)
            out += _conv(f"{b}.mlp.dwconv", hidden, hidden, 3, groups=hidden)
            out += _linear(f"{b}.mlp.fc2", dim, hidden)
            for t in range(tasks):
                out += _linear(f"{b}.adapter.{t}", dim, dim)
        out += _ln(f"encoder.norm{i + 1}", dim, tasks)
        cin = dim
    d = spec["decoder_dim"]
    for t, nc in enumerate(num_classes):
        h = f"decoder.{t}"
        for i, dim in enumerate(spec["embed_dims"]):
            out += _linear(f"{h}.linear_c.{i}", d, dim)
        out += _conv(f"{h}.linear_fuse", d, 4 * d, 1, bias=False) + _bn(f"{h}.bn", d)
        out += [(f"{h}.output_conv.weight", (nc, d, 1, 1), ("classifier",)),
                (f"{h}.output_conv.bias", (nc,), ("bias",))]
    return out


def base_lrs(names, *, current_task: int, shared_lr: float, ds_lr: float) -> dict:
    """{parameter name: base LR}: the current domain's LayerNorms, adapters
    and head at ds_lr, every other domain's at 0, the rest of the encoder at
    shared_lr (MDIL-SS's rule, train_new_task_step2.py:202-239, on these
    names)."""
    out = {}
    for name in names:
        if name.startswith("decoder."):
            task = int(name.split(".")[1])
        else:
            m = _SLOT.search(name)
            if m is None:
                out[name] = shared_lr
                continue
            task = int(m.group(1))
        out[name] = ds_lr if task == current_task else 0.0
    return out


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

class Forward:
    """One forward's settings, as `erfnet_rap.Forward`: `train` (batch
    statistics, drop-path and dropout from `keep_masks`) or eval (running
    statistics); `update_running` (the student's training forward); `tf32`
    (the control's precision)."""

    def __init__(self, sd: dict, task: int, spec: dict = B5, *, train: bool,
                 update_running: bool = False, keep_masks: dict | None = None,
                 tf32: bool = False):
        self.sd, self.task, self.spec, self.train = sd, task, spec, train
        self.update_running, self.tf32 = update_running and train, tf32
        self.keep = keep_masks if train else None
        self.rates = drop_path_rates(spec)

    def linear(self, x, p: str):
        w, b = self.sd[f"{p}.weight"], self.sd[f"{p}.bias"]
        return tf32_product(F.linear, x, w, b) if self.tf32 else F.linear(x, w, b)

    def conv(self, x, p: str, stride=1, padding=0, groups=1):
        w, b = self.sd[f"{p}.weight"], self.sd.get(f"{p}.bias")
        if self.tf32:
            return tf32_product(F.conv2d, x, w, b, stride, padding, 1, groups)
        return F.conv2d(x, w, b, stride, padding, 1, groups)

    def matmul(self, a, b):
        return tf32_product(torch.matmul, a, b) if self.tf32 else torch.matmul(a, b)

    def ln(self, x, p: str, eps: float):
        return F.layer_norm(x, x.shape[-1:], self.sd[f"{p}.{self.task}.weight"],
                            self.sd[f"{p}.{self.task}.bias"], eps)

    def bn(self, x, p: str):
        sd = self.sd
        mean, var = sd[f"{p}.running_mean"], sd[f"{p}.running_var"]
        if self.train and not self.update_running:
            mean = var = None
        return F.batch_norm(x, mean, var, sd[f"{p}.weight"], sd[f"{p}.bias"],
                            training=self.train, momentum=BN_MOMENTUM, eps=HEAD_BN_EPS)

    def attention(self, x, h: int, w: int, p: str, heads: int, sr: int):
        n, t, c = x.shape
        d = c // heads
        q = self.linear(x, f"{p}.q").reshape(n, t, heads, d).permute(0, 2, 1, 3)
        xr = x
        if sr > 1:
            grid = x.transpose(1, 2).reshape(n, c, h, w)
            xr = self.ln(self.conv(grid, f"{p}.sr", stride=sr).flatten(2).transpose(1, 2),
                         f"{p}.norm", SR_LN_EPS)
        kv = self.linear(xr, f"{p}.kv").reshape(n, -1, 2, heads, d).permute(2, 0, 3, 1, 4)
        k, v = kv[0], kv[1]
        outs = []
        for i in range(0, t, QUERY_BLOCK):
            s = self.matmul(q[:, :, i:i + QUERY_BLOCK], k.transpose(-2, -1)) * d ** -0.5
            outs.append(self.matmul(torch.softmax(s, dim=-1), v))
        o = torch.cat(outs, 2).permute(0, 2, 1, 3).reshape(n, t, c)
        return self.linear(o, f"{p}.proj")

    def mix_ffn(self, x, h: int, w: int, p: str):
        y = self.linear(x, f"{p}.fc1")
        n, t, c = y.shape
        y = self.conv(y.transpose(1, 2).reshape(n, c, h, w), f"{p}.dwconv", padding=1, groups=c)
        return self.linear(F.gelu(y.flatten(2).transpose(1, 2)), f"{p}.fc2")

    def drop_path(self, x, b: int, branch: int):
        if self.keep is None or self.rates[b] == 0.0:
            return x
        keep = self.keep["drop_path"][b, branch]
        return x.div(1.0 - self.rates[b]) * keep.to(x.dtype).view(-1, 1, 1)

    def head(self, feats: list):
        p, sd = f"decoder.{self.task}", self.sd
        size = feats[0].shape[2:]
        outs = []
        for i in reversed(range(len(feats))):
            c = feats[i]
            n, _, h, w = c.shape
            y = self.linear(c.flatten(2).transpose(1, 2), f"{p}.linear_c.{i}")
            y = y.transpose(1, 2).reshape(n, -1, h, w)
            if i > 0:
                y = F.interpolate(y, size=size, mode="bilinear", align_corners=False)
            outs.append(y)
        x = F.relu(self.bn(self.conv(torch.cat(outs, 1), f"{p}.linear_fuse"), f"{p}.bn"))
        if self.keep is not None:
            keep = self.keep["head"].to(x.dtype)
            x = x * (keep[:, :, None, None] / (1.0 - self.spec["head_dropout"]))
        return self.conv(x, f"{p}.output_conv")

    def __call__(self, x_nhwc: torch.Tensor) -> torch.Tensor:
        """x [N, H, W, 3] float32 -> logits [N, H, W, classes of the domain]."""
        spec, size = self.spec, x_nhwc.shape[1:3]
        x = x_nhwc.permute(0, 3, 1, 2).contiguous()
        feats, b = [], 0
        for i, (depth, heads, sr) in enumerate(zip(spec["depths"], spec["num_heads"],
                                                   spec["sr_ratios"])):
            e = f"encoder.patch_embed{i + 1}"
            x = self.conv(x, f"{e}.proj", stride=PATCH[i][1], padding=PATCH[i][2])
            n, c, h, w = x.shape
            x = self.ln(x.flatten(2).transpose(1, 2), f"{e}.norm", EMBED_LN_EPS)
            for j in range(depth):
                p = f"encoder.block{i + 1}.{j}"
                a = self.attention(self.ln(x, f"{p}.norm1", BLOCK_LN_EPS), h, w, f"{p}.attn",
                                   heads, sr)
                x = x + self.drop_path(a, b, 0)
                y = self.ln(x, f"{p}.norm2", BLOCK_LN_EPS)
                f = self.mix_ffn(y, h, w, f"{p}.mlp") + self.linear(y, f"{p}.adapter.{self.task}")
                x = x + self.drop_path(f, b, 1)
                b += 1
            x = self.ln(x, f"encoder.norm{i + 1}", BLOCK_LN_EPS)
            x = x.transpose(1, 2).reshape(n, c, h, w)
            feats.append(x)
        logits = F.interpolate(self.head(feats), size=size, mode="bilinear", align_corners=False)
        return logits.permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# training steps (benchmark/reference/train.py's, on this forward)
# ---------------------------------------------------------------------------

def _forward(sd, images, task, spec, **kw):
    return Forward(sd, task, spec, **kw)(images)


def distill_step(state: State, teacher_sd: dict, images, labels, keep_masks: list, *,
                 spec: dict, current_task: int, prev_tasks, class_weight, lambda_c: float,
                 lr_scale: float, tf32: bool = False):
    """Step 2: CE on the current head plus lambda * KLD against the eval-mode
    teacher on each previous head, and one Adam step. The gradient of that
    sum is taken as the sum of its terms' gradients, one backward per term
    right after its forward, so that no two forwards' graphs are alive
    together (the reference keeps more of a forward than the program).
    Returns ({"loss", "ce", "kld"} floats, raw gradients)."""
    with float32_exact():
        logits = _forward(state.sd(), images, current_task, spec, train=True,
                          update_running=True, keep_masks=keep_masks[0], tf32=tf32)
        ce = cross_entropy(logits, labels, class_weight)
        grads = state.grads(ce)
        del logits
        kl = torch.zeros((), device=images.device)
        for i, t in enumerate(prev_tasks):
            s = _forward(state.sd(), images, t, spec, train=True, update_running=True,
                         keep_masks=keep_masks[1 + i], tf32=tf32)
            with torch.no_grad():
                tl = _forward(teacher_sd, images, t, spec, train=False, tf32=tf32)
            term = kld(s, tl)
            grads = _summed(grads, state.grads(lambda_c * term))
            kl = kl + term.detach()
        total = ce.detach() + lambda_c * kl
        state.adam(grads, lr_scale)
    return {"loss": total.item(), "ce": ce.item(), "kld": kl.item()}, grads


def _summed(a: dict, b: dict) -> dict:
    """Two gradient dicts added leaf by leaf, None where neither reaches it."""
    return {k: a[k] if b[k] is None else b[k] if a[k] is None else a[k] + b[k] for k in a}


def two_phase_step(state: State, teacher_sd: dict, images, labels, keep_masks: list, *,
                   spec: dict, current_task: int, prev_tasks, class_weight, lambda_c: float,
                   lr_scale: float, tf32: bool = False):
    """Step 3: a CE backward and Adam step, then lambda * sum KLD against the
    teacher in training mode on the updated weights, a backward and a second
    Adam step. Returns ({"loss", "ce", "kld"} floats, the two phases' raw
    gradients summed)."""
    with float32_exact():
        logits = _forward(state.sd(), images, current_task, spec, train=True,
                          update_running=True, keep_masks=keep_masks[0], tf32=tf32)
        ce = cross_entropy(logits, labels, class_weight)
        g_ce = state.grads(ce)
        del logits
        state.adam(g_ce, lr_scale)
        kl = torch.zeros((), device=images.device)
        for i, t in enumerate(prev_tasks):
            s = _forward(state.sd(), images, t, spec, train=True, update_running=True,
                         keep_masks=keep_masks[1 + i], tf32=tf32)
            with torch.no_grad():
                tl = _forward(teacher_sd, images, t, spec, train=True, tf32=tf32)
            kl = kl + kld(s, tl)
        kd = lambda_c * kl
        g_kd = state.grads(kd)
        state.adam(g_kd, lr_scale)
    return {"loss": ce.item() + kd.item(), "ce": ce.item(), "kld": kl.item()}, _summed(g_ce, g_kd)


STEPS = {"distill": distill_step, "two_phase": two_phase_step}
