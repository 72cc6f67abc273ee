"""Plain ERFNet-RAP (Romera et al., ERFNet, IEEE T-ITS 2018; Garg et al.,
MDIL-SS, WACV 2022) over a state dict in the reference checkpoints' names.

Every layer is one plain op: `F.conv2d`, `F.conv_transpose2d`,
`F.max_pool2d`, `F.batch_norm`, `F.relu`, on NCHW float32 tensors. No
kernel, layout trick, fused block or cache. The model:

  encoder  initial_block Down(3->16); Down(16->64); 5x nb1d_RAP(64, d=1,
           dropout 0.03); Down(64->128); 2x [nb1d_RAP(128, d) for d in
           2, 4, 8, 16] (dropout 0.3)
  decoder  per task: Up(128->64); 2x nb1d(64); Up(64->16); 2x nb1d(16);
           ConvTranspose2d(16 -> classes, 2, stride 2)

  Down(i->o)  cat(conv3x3/s2(x) [o-i channels], maxpool2x2(x)) -> BN -> relu
  Up(i->o)    ConvTranspose2d(3, s2, p1, op1) -> BN -> relu
  nb1d_RAP    y1 = conv1x3(relu(conv3x1(x))) + parallel_conv_1[t](x);
              m = relu(BN1[t](y1));
              y2 = conv1x3_d(relu(conv3x1_d(m))) + parallel_conv_2[t](m);
              out = relu(dropout(BN2[t](y2)) + x)
  nb1d        the same without the parallel 1x1 convs, one BN each

BN has eps 1e-3 and momentum 0.1. A training forward normalises with the
batch statistics and, where it is given running buffers, updates them as
torch does (the unbiased variance); a teacher in training mode is given
none, so its buffers stay as they were. Dropout is channel-wise from a
keep-mask per image and channel, kept channels scaled by 1 / keep.

`tf32=True` rounds every conv's input and weight, and in the backward the
gradient of its output, to TF32 (a 10-bit mantissa, to nearest) and sums
in float32: what the tensor cores compute with TF32 switched on, the
precision one step below float32, on any device. It is the control of the
comparison that decides `correct`.

This module imports torch and nothing else: no JAX, and nothing of the
program under test.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

BN_EPS = 1e-3
BN_MOMENTUM = 0.1

# (kind, *args): ("down", nin, nout) | ("nb", channels, dropout rate, dilation)
ENCODER_PLAN = (
    ("down", 16, 64),
    *[("nb", 64, 0.03, 1)] * 5,
    ("down", 64, 128),
    *[("nb", 128, 0.3, d) for _ in range(2) for d in (2, 4, 8, 16)],
)
DECODER_PLAN = (
    ("up", 128, 64), ("nb", 64, 0.0, 1), ("nb", 64, 0.0, 1),
    ("up", 64, 16), ("nb", 16, 0.0, 1), ("nb", 16, 0.0, 1),
)
# the encoder layers that drop channels, by the keep-mask groups that feed them:
# "g64" [5, N, 1, 1, 64] for layers 1-5, "g128" [2, 4, N, 1, 1, 128] for layers 7-14
G64_LAYERS = tuple(range(1, 6))
G128_LAYERS = tuple(range(7, 15))


@contextlib.contextmanager
def float32_exact():
    """TF32 off for cuDNN's convs and matmuls while the reference runs, the
    flags as they were afterwards."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 `t` rounded to TF32's 10-bit mantissa, to nearest (ties away
    from zero), still stored as float32."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


class _Tf32Operand(torch.autograd.Function):
    """An operand of a TF32 product: rounded going forward, its gradient
    passed through."""

    @staticmethod
    def forward(ctx, t):
        return round_tf32(t)

    @staticmethod
    def backward(ctx, g):
        return g


class _Tf32Gradient(torch.autograd.Function):
    """A TF32 product's output: unchanged going forward; the gradient that
    comes back, an operand of the input- and weight-gradient products, is
    rounded."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return round_tf32(g)


def tf32_product(fn, x, w, *args, **kw):
    """fn(x, w, ...) as TF32 computes it forward and backward: x, w and the
    output's gradient rounded to TF32, the sums in float32."""
    return _Tf32Gradient.apply(fn(_Tf32Operand.apply(x), _Tf32Operand.apply(w), *args, **kw))


# ---------------------------------------------------------------------------
# parameter names and shapes
# ---------------------------------------------------------------------------

def _conv_spec(prefix: str, cout: int, cin: int, kh: int, kw: int, transposed=False):
    shape = (cin, cout, kh, kw) if transposed else (cout, cin, kh, kw)
    fan_in = shape[1] * kh * kw  # torch's rule, ConvTranspose2d's weight included
    return [(f"{prefix}.weight", shape, ("conv", fan_in)), (f"{prefix}.bias", (cout,), ("conv", fan_in))]


def _bn_spec(prefix: str, ch: int):
    return [(f"{prefix}.weight", (ch,), ("bn_weight",)), (f"{prefix}.bias", (ch,), ("bn_bias",)),
            (f"{prefix}.running_mean", (ch,), ("bn_mean",)),
            (f"{prefix}.running_var", (ch,), ("bn_var",)),
            (f"{prefix}.num_batches_tracked", (), ("count",))]


def _nb_spec(p: str, ch: int, tasks: int | None):
    out = _conv_spec(f"{p}.conv3x1_1", ch, ch, 3, 1) + _conv_spec(f"{p}.conv1x3_1", ch, ch, 1, 3)
    if tasks is None:
        out += _bn_spec(f"{p}.bn1", ch)
    else:
        for t in range(tasks):
            out += _conv_spec(f"{p}.parallel_conv_1.{t}", ch, ch, 1, 1)
        for t in range(tasks):
            out += _bn_spec(f"{p}.bns_1.{t}", ch)
    out += _conv_spec(f"{p}.conv3x1_2", ch, ch, 3, 1) + _conv_spec(f"{p}.conv1x3_2", ch, ch, 1, 3)
    if tasks is None:
        out += _bn_spec(f"{p}.bn2", ch)
    else:
        for t in range(tasks):
            out += _conv_spec(f"{p}.parallel_conv_2.{t}", ch, ch, 1, 1)
        for t in range(tasks):
            out += _bn_spec(f"{p}.bns_2.{t}", ch)
    return out


def _down_spec(p: str, nin: int, nout: int, tasks: int):
    out = _conv_spec(f"{p}.conv", nout - nin, nin, 3, 3)
    for t in range(tasks):
        out += _bn_spec(f"{p}.bn_ini.{t}", nout)
    return out


def param_spec(num_classes) -> list[tuple[str, tuple, tuple]]:
    """[(name, shape, init)] of every tensor of the state dict of ERFNet-RAP
    with one task per entry of `num_classes`, in the checkpoints' order;
    `init` is ("conv", fan_in), ("bn_weight",), ("bn_bias",), ("bn_mean",),
    ("bn_var",) or ("count",)."""
    tasks = len(num_classes)
    out = _down_spec("encoder.initial_block", 3, 16, tasks)
    for i, spec in enumerate(ENCODER_PLAN):
        p = f"encoder.layers.{i}"
        out += _down_spec(p, spec[1], spec[2], tasks) if spec[0] == "down" else _nb_spec(p, spec[1], tasks)
    for t, nc in enumerate(num_classes):
        for i, spec in enumerate(DECODER_PLAN):
            p = f"decoder.{t}.layers.{i}"
            if spec[0] == "up":
                out += _conv_spec(f"{p}.conv", spec[2], spec[1], 3, 3, transposed=True)
                out += _bn_spec(f"{p}.bn", spec[2])
            else:
                out += _nb_spec(p, spec[1], None)
        out += _conv_spec(f"decoder.{t}.output_conv", nc, 16, 2, 2, transposed=True)
    return out


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

class Forward:
    """One forward's settings: `train` (batch statistics and dropout) or
    eval (running statistics); `update_running` (a training forward of the
    student: the running buffers take the batch statistics); `tf32` (the
    control's precision)."""

    def __init__(self, sd: dict, task: int, *, train: bool, update_running: bool = False,
                 keep_masks: dict | None = None, tf32: bool = False):
        self.sd, self.task, self.train = sd, task, train
        self.update_running, self.tf32 = update_running and train, tf32
        self.keep = keep_masks if train else None

    def conv(self, x, prefix: str, stride=1, padding=0, dilation=1):
        w, b = self.sd[f"{prefix}.weight"], self.sd[f"{prefix}.bias"]
        if self.tf32:
            return tf32_product(F.conv2d, x, w, b, stride, padding, dilation)
        return F.conv2d(x, w, b, stride, padding, dilation)

    def conv_t(self, x, prefix: str, **kw):
        w, b = self.sd[f"{prefix}.weight"], self.sd[f"{prefix}.bias"]
        if self.tf32:
            return tf32_product(F.conv_transpose2d, x, w, b, **kw)
        return F.conv_transpose2d(x, w, b, **kw)

    def bn(self, x, prefix: str):
        sd = self.sd
        mean, var = sd[f"{prefix}.running_mean"], sd[f"{prefix}.running_var"]
        if self.train and not self.update_running:
            mean = var = None
        return F.batch_norm(x, mean, var, sd[f"{prefix}.weight"], sd[f"{prefix}.bias"],
                            training=self.train, momentum=BN_MOMENTUM, eps=BN_EPS)

    def down(self, x, p: str):
        out = torch.cat([self.conv(x, f"{p}.conv", stride=2, padding=1), F.max_pool2d(x, 2, 2)], 1)
        return F.relu(self.bn(out, f"{p}.bn_ini.{self.task}"))

    def up(self, x, p: str):
        out = self.conv_t(x, f"{p}.conv", stride=2, padding=1, output_padding=1)
        return F.relu(self.bn(out, f"{p}.bn"))

    def nb(self, x, p: str, dilation: int, rap: bool, rate: float, keep):
        t = self.task
        y = self.conv(F.relu(self.conv(x, f"{p}.conv3x1_1", padding=(1, 0))), f"{p}.conv1x3_1",
                      padding=(0, 1))
        if rap:
            y = y + self.conv(x, f"{p}.parallel_conv_1.{t}")
        m = F.relu(self.bn(y, f"{p}.bns_1.{t}" if rap else f"{p}.bn1"))
        y = self.conv(F.relu(self.conv(m, f"{p}.conv3x1_2", padding=(dilation, 0),
                                       dilation=(dilation, 1))),
                      f"{p}.conv1x3_2", padding=(0, dilation), dilation=(1, dilation))
        if rap:
            y = y + self.conv(m, f"{p}.parallel_conv_2.{t}")
        y = self.bn(y, f"{p}.bns_2.{t}" if rap else f"{p}.bn2")
        if keep is not None and rate > 0.0:
            y = y * (keep.to(y.dtype)[:, :, None, None] / (1.0 - rate))
        return F.relu(y + x)

    def layer_keep(self, i: int):
        """The keep-mask [N, C] of encoder layer i, or None."""
        if self.keep is None:
            return None
        if i in G64_LAYERS:
            m = self.keep["g64"][G64_LAYERS.index(i)]
        elif i in G128_LAYERS:
            j = G128_LAYERS.index(i)
            m = self.keep["g128"][j // 4][j % 4]
        else:
            return None
        return m.reshape(m.shape[0], -1)

    def __call__(self, x_nhwc: torch.Tensor) -> torch.Tensor:
        """x [N, H, W, 3] float32 -> logits [N, H, W, classes of the task]."""
        x = x_nhwc.permute(0, 3, 1, 2).contiguous()
        x = self.down(x, "encoder.initial_block")
        for i, spec in enumerate(ENCODER_PLAN):
            p = f"encoder.layers.{i}"
            if spec[0] == "down":
                x = self.down(x, p)
            else:
                x = self.nb(x, p, spec[3], True, spec[2], self.layer_keep(i))
        for i, spec in enumerate(DECODER_PLAN):
            p = f"decoder.{self.task}.layers.{i}"
            x = self.up(x, p) if spec[0] == "up" else self.nb(x, p, spec[3], False, 0.0, None)
        x = self.conv_t(x, f"decoder.{self.task}.output_conv", stride=2)
        return x.permute(0, 2, 3, 1)
