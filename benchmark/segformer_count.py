"""The frozen arithmetic of the SegFormer cells: the model FLOPs of a forward
and a training pass, and the least time of the attention kernels for the
passes the program's counters saw (`metrics/attn_roofline.train.py`).

Multiply-adds are counted for every Linear and conv, and for attention's
two products (q k^T and p v); LayerNorm, GELU, softmax, the resizes, BN,
drop-path and the losses are not, as `roofline.forward_macs` leaves BN and
pooling out of ERFNet's count. A backward counts twice its forward (the
input- and weight-gradient products), so a pass with its backward counts
three forwards; nothing recomputed is counted.

Attention's bound per call: the FLOPs of q k^T and p v (4 B h Nq Nk d)
at `roofline.effective_peak_flops` of the dtype (float32 as 3xTF32)
against q, k, v and the output read or written once at `roofline.PEAK_BYTES`,
the larger of the two; its backward twice both (the gradients of q, k and v
from those of the output, each read or written once, beside q, k, v and o).
A `spec` is `reference.segformer_rap.spec_of` of a configuration.
"""
from __future__ import annotations

from benchmark import roofline

PATCH_KERNELS = (7, 3, 3, 3)
PATCH_STRIDES = (4, 2, 2, 2)
# the attention kernels of the port on the card, by name in the device trace:
# torch's memory-efficient (CUTLASS) forward and backward
ATTN_KERNELS = ("fmha_cutlassF", "fmha_cutlassB")


def stages(spec: dict, height: int, width: int) -> list[tuple]:
    """(dim, heads, depth, sr ratio, h, w, input channels, patch kernel) of
    each stage at height x width."""
    out, h, w, cin = [], height, width, 3
    for i, (dim, heads, depth, sr) in enumerate(zip(spec["embed_dims"], spec["num_heads"],
                                                    spec["depths"], spec["sr_ratios"])):
        h, w = h // PATCH_STRIDES[i], w // PATCH_STRIDES[i]
        out.append((dim, heads, depth, sr, h, w, cin, PATCH_KERNELS[i]))
        cin = dim
    return out


def forward_macs(spec: dict, height: int, width: int, num_classes: int) -> int:
    """Multiply-adds of one forward of one image on a head of `num_classes`."""
    macs, d = 0, spec["decoder_dim"]
    for dim, _, depth, sr, h, w, cin, k in stages(spec, height, width):
        n = h * w
        m = n // (sr * sr)
        hidden = spec["mlp_ratio"] * dim
        macs += n * dim * cin * k * k  # patch embedding
        block = n * dim * dim * 2  # q, proj
        block += (n * dim * dim if sr > 1 else 0) + m * 2 * dim * dim  # sr conv, kv
        block += 2 * n * m * dim  # q k^T and p v over the heads
        block += 2 * n * hidden * dim + n * hidden * 9  # fc1, fc2, the depthwise conv
        block += n * dim * dim  # the adapter
        macs += depth * block
        macs += n * dim * d  # the head's Linear of this stage
    _, _, _, _, h1, w1, _, _ = stages(spec, height, width)[0]
    macs += h1 * w1 * (4 * d * d + d * num_classes)  # fuse conv, classifier
    return macs


def pass_flops(spec: dict, n: int, height: int, width: int, num_classes: int,
               backward: bool) -> int:
    """FLOPs of one forward of n images, with its backward where `backward`."""
    return 2 * n * forward_macs(spec, height, width, num_classes) * (3 if backward else 1)


def attention_calls(spec: dict, n: int, height: int, width: int) -> list[tuple]:
    """(calls, batch, heads, queries, keys, head dim) of one forward."""
    return [(depth, n, heads, h * w, (h // sr) * (w // sr), dim // heads)
            for dim, heads, depth, sr, h, w, _, _ in stages(spec, height, width)]


def attention_bound_ms(spec: dict, n: int, height: int, width: int, dtype: str) -> dict:
    """Attention's least time over one forward ("fwd_ms") and one backward
    ("bwd_ms"), and the calls of a forward ("calls")."""
    fwd_ms, calls = 0.0, 0
    item = roofline.ITEM[roofline.dt_of(dtype)]
    peak = roofline.effective_peak_flops(dtype)
    for count, b, heads, nq, nk, d in attention_calls(spec, n, height, width):
        flops = 4 * b * heads * nq * nk * d
        nbytes = item * b * heads * d * (2 * nq + 2 * nk)
        fwd_ms += count * max(flops / peak, nbytes / roofline.PEAK_BYTES) * 1e3
        calls += count
    return {"fwd_ms": fwd_ms, "bwd_ms": 2 * fwd_ms, "calls": calls}
