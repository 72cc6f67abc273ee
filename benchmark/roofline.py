"""The benchmark's frozen arithmetic: the card's peaks, the least time of each
kernel of the port from its shapes, the model's FLOPs, and the table that
attributes device time to the module that launched it.

The bounds and the family table are copies of the bring-up smoke script's
(`chip_smoke.py`: `PEAK_FLOPS`, `BLOCKS`, `block_bound`, `pair_bound`,
`k3_kind_bounds`, `student_pass_bound`, `glue_bound`, `FAMILIES`,
`ms_by_family`), taken with the image size and batch as arguments and one
family added for the data path. The program may change; this yardstick does
not.

Every share is a bound over a measured time. For float32 work the bound is
float32-accurate work on the tensor cores, 3xTF32: three TF32 products per
float32 product at 495 TFLOP/s, so an effective 165 TFLOP/s, against bytes
at 3.35 TB/s; bfloat16 work runs at 989 TFLOP/s. A bound counts each input
byte read once and each output byte written once, and the FLOPs the
algorithm needs, so a share cannot pass 100% unless the count is wrong or
the time leaves out part of the work.
"""
from __future__ import annotations

# H100 SXM dense peaks (NVIDIA data sheet): float32 on the CUDA cores, bf16 and TF32 on the
# tensor cores; HBM3 bytes. The card's power limit is printed beside every share.
PEAK_FLOPS = {"f32": 67e12, "bf16": 989e12, "tf32": 495e12}
PEAK_BYTES = 3.35e12
ITEM = {"f32": 4, "bf16": 2}
DTYPES = {"float32": "f32", "bfloat16": "bf16"}


def dt_of(dtype: str) -> str:
    """"float32" / "bfloat16" (or "f32" / "bf16") -> "f32" / "bf16"."""
    return DTYPES.get(dtype, dtype)


def effective_peak_flops(dtype: str) -> float:
    """FLOP/s of work in `dtype` at full accuracy on the tensor cores:
    float32 as 3xTF32 (495e12 / 3), bf16 at its own rate."""
    dt = dt_of(dtype)
    return PEAK_FLOPS["tf32"] / 3 if dt == "f32" else PEAK_FLOPS[dt]


def blocks(height: int, width: int) -> tuple:
    """The nb1d blocks of one forward at height x width: (name, C, dilation,
    rap, H, W, count); at 512 x 1024 the smoke script's BLOCKS."""
    h4, w4, h8, w8, h2, w2 = height // 4, width // 4, height // 8, width // 8, height // 2, width // 2
    return (
        ("enc64_d1_rap", 64, 1, True, h4, w4, 5),
        ("enc128_d2_rap", 128, 2, True, h8, w8, 2),
        ("enc128_d4_rap", 128, 4, True, h8, w8, 2),
        ("enc128_d8_rap", 128, 8, True, h8, w8, 2),
        ("enc128_d16_rap", 128, 16, True, h8, w8, 2),
        ("dec64_d1", 64, 1, False, h4, w4, 2),
        ("dec16_d1", 16, 1, False, h2, w2, 2),
    )


def _bound(flops: int, nbytes: int, dt: str) -> dict:
    t_ops, t_bytes = flops / PEAK_FLOPS[dt], nbytes / PEAK_BYTES
    return {"ops_ms": t_ops * 1e3, "bytes_ms": t_bytes * 1e3, "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def block_bound(n: int, spec, dt: str) -> dict:
    """Least time for one K1 block: each input byte read once and each output
    byte written once (x, weights, per-channel vectors; out), against the
    FLOPs of the two conv pairs, at the card's peak rates for the type. In
    fp32 also `bound_3xtf32_ms`: the same FLOPs as 3xTF32 on the tensor
    cores against the same bytes."""
    _, c, _, rap, h, w, _ = spec
    px, item = n * h * w, ITEM[dt]
    flops = px * (28 if rap else 24) * c * c  # 2 x (3C^2 + 3C^2 [+ C^2]) MACs per pixel
    nbytes = item * (2 * px * c + 12 * c * c + (2 * c * c if rap else 0)) + 4 * 6 * c
    t_ops, t_bytes = flops / PEAK_FLOPS[dt], nbytes / PEAK_BYTES
    out = {"flops": flops, "bytes": nbytes, "bound_ms": max(t_ops, t_bytes) * 1e3,
           "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
    if dt == "f32":
        out["bound_3xtf32_ms"] = max(3 * flops / PEAK_FLOPS["tf32"], t_bytes) * 1e3
    return out


def pair_bound(n: int, c: int, h: int, w: int, rap: bool, kind: str, dt: str = "f32") -> dict:
    """Least time of one K2 ("fwd") or K3 ("bwd") call with activations of type
    dt: FLOPs at the type's peak against bytes read and written once. K2:
    6C^2 MACs per pixel (+C^2 RAP), reads x and the weights, writes y and the
    float32 stats. K3: recompute c, dc, du, dw31, dw13 (5 x 3C^2 MACs, +2C^2
    RAP), reads u, gy and the weights, writes du and the float32 weight
    gradients. In fp32 also `bound_3xtf32_ms`: the same FLOPs done as 3xTF32
    on the tensor cores against the same bytes."""
    px, item = n * h * w, ITEM[dt]
    macs = (6 + rap if kind == "fwd" else 15 + 2 * rap) * c * c
    acts = 2 if kind == "fwd" else 3
    weights = (6 + rap) * c * c
    flops = 2 * px * macs
    nbytes = item * (acts * px * c + weights) + 4 * (weights * (kind == "bwd") + 4 * c)
    out = {"flops": flops, "bytes": nbytes, **_bound(flops, nbytes, dt)}
    if dt == "f32":
        out["bound_3xtf32_ms"] = max(3 * flops / PEAK_FLOPS["tf32"], nbytes / PEAK_BYTES) * 1e3
    if kind == "bwd":
        out["kinds"] = k3_kind_bounds(n, c, h, w, rap, dt)
    return out


def k3_kind_bounds(n: int, c: int, h: int, w: int, rap: bool, dt: str = "f32") -> dict:
    """K3's FLOPs and least time split by its launch kinds, each with the
    activation passes its own design moves (each read or written once):
    dc recomputes c (3C^2 MACs per pixel) and takes colconv^T (3C^2),
    reading u and gy and writing c and dc; du is rowconv^T (3C^2, +C^2 RAP),
    reading dc and gy and writing du; wgrad is dw31, dw13 (6C^2, +C^2 drap),
    reading u, c, dc and gy and writing the float32 gradients. The kinds'
    FLOPs sum to pair_bound's."""
    px, item, cc = n * h * w, ITEM[dt], c * c
    kinds = {"dc": (6 * cc, 4, 6 * cc, 4 * c), "du": ((3 + rap) * cc, 3, (3 + rap) * cc, 0),
             "wgrad": ((6 + rap) * cc, 4, 0, 4 * ((6 + rap) * cc + c))}
    out = {}
    for kind, (macs, passes, weights, f32_bytes) in kinds.items():
        flops, nbytes = 2 * px * macs, item * (passes * px * c + weights) + f32_bytes
        out[kind] = {"flops": flops, "bytes": nbytes, **_bound(flops, nbytes, dt)}
    return out


def _accurate_ms(b: dict, dt: str) -> float:
    """A bound dict's least time of work at the type's accuracy: float32 as
    3xTF32, bf16 at its own rate."""
    return b["bound_3xtf32_ms"] if dt == "f32" else b["bound_ms"]


def k1_forward_bound_ms(n: int, height: int, width: int, dtype: str) -> float:
    """K1's least time over the 17 blocks of one eval forward of n images."""
    dt = dt_of(dtype)
    return sum(spec[-1] * _accurate_ms(block_bound(n, spec, dt), dt)
               for spec in blocks(height, width))


def student_pass_bound(n: int, height: int, width: int, kind: str, dtype: str) -> float:
    """pair_bound of K2 ("fwd") or K3 ("bwd") summed over the 34 pair calls
    (17 blocks x 2) of one training forward or backward, in ms."""
    dt = dt_of(dtype)
    return sum(2 * count * _accurate_ms(pair_bound(n, c, h, w, rap, kind, dt), dt)
               for _, c, _, rap, h, w, count in blocks(height, width))


# The K4 glue (ops/nb1d_train.Nb1dTrain outside K2/K3: BN statistics and affine, dropout, the
# residual, the BN backward): the least bytes it moves, each [N, C, H, W] activation read or
# written once per pass its forward and backward need. Forward, one pass: read y2 and x, write
# out (3). Backward, five passes: BN2's reductions (read out, g_out, y2: 3), BN2's apply (the
# same three, write g_y2: 4), BN1's reductions (read dm, y1: 2), BN1's apply (the same two,
# write g_y1: 3), dx = relu'(out) g_out + dx_c (read out, g_out, dx_c, write dx: 4). A block's
# dropout mask and per-channel vectors are [N, C] and [C]: left out.
GLUE_FWD_ACTS, GLUE_BWD_ACTS = 3, 3 + 4 + 2 + 3 + 4


def glue_bound(n: int, height: int, width: int, dtype: str) -> dict:
    """K4's byte bound over the 17 blocks of one forward: ms per forward
    without backward (a train-mode teacher) and per forward with backward (a
    student), at PEAK_BYTES."""
    item = ITEM[dt_of(dtype)]
    act = sum(count * n * c * h * w * item for _, c, _, _, h, w, count in blocks(height, width))
    return {"activation_bytes_per_forward": act,
            "fwd_ms": GLUE_FWD_ACTS * act / PEAK_BYTES * 1e3,
            "fwd_bwd_ms": (GLUE_FWD_ACTS + GLUE_BWD_ACTS) * act / PEAK_BYTES * 1e3}


def share(bound_ms: float, measured_ms) -> float | None:
    """100 x bound / measured: the share of the roofline; None where nothing
    was measured."""
    if not measured_ms or measured_ms <= 0:
        return None
    return 100.0 * bound_ms / measured_ms


# ---------------------------------------------------------------------------
# model FLOPs
# ---------------------------------------------------------------------------

def forward_macs(height: int, width: int, num_classes: int) -> int:
    """Multiply-adds of every conv and transposed conv of one ERFNet-RAP
    forward of one image on a head of `num_classes` classes (a transposed
    conv: input pixels x Cin x Cout x taps). Pooling, BN and the losses are
    not counted."""
    h2, w2, h4, w4, h8, w8 = height // 2, width // 2, height // 4, width // 4, height // 8, width // 8
    macs = h2 * w2 * 13 * 3 * 9            # initial block: conv 3 -> 13, 3x3 s2
    macs += h4 * w4 * 48 * 16 * 9          # Down(16 -> 64)
    macs += h8 * w8 * 64 * 64 * 9          # Down(64 -> 128)
    for _, c, _, rap, h, w, count in blocks(height, width):
        macs += count * h * w * (14 if rap else 12) * c * c  # 4 x 3 taps (+ 2 1x1 adapters)
    macs += h8 * w8 * 128 * 64 * 9         # Up(128 -> 64), transposed 3x3 s2
    macs += h4 * w4 * 64 * 16 * 9          # Up(64 -> 16)
    macs += h2 * w2 * 16 * num_classes * 4  # output conv, transposed 2x2 s2
    return macs


def pass_flops(n: int, height: int, width: int, num_classes: int, backward: bool) -> int:
    """FLOPs of one forward of n images on a head of `num_classes` classes,
    with its backward where `backward`: the input- and weight-gradient
    products of every conv, twice the forward's. No recomputation is
    counted."""
    return 2 * n * forward_macs(height, width, num_classes) * (3 if backward else 1)


# ---------------------------------------------------------------------------
# device time by the module that launched it
# ---------------------------------------------------------------------------

# The port's own kernels by name (left out of the families, reported as K1 / K2 / K3)
K1_KERNELS = ("nb1d_pair_tf32_kernel", "nb1d_pair_mma_kernel")
K2_KERNELS = ("fwd_pair_mma_kernel", "fwd_pair_bf16_kernel")
K3_KERNELS = ("bwd_dc_kernel", "bwd_du_kernel", "bwd_wgrad_kernel", "k3_c_dc_bf16_kernel",
              "k3_du_bf16_kernel", "k3_wgrad_bf16_kernel")
PARTIAL_SUM_KERNEL = "namespace)::reduce_kernel("  # K2's and K3's fixed-order sums
OWN_KERNELS = ("nb1d_pair_", "fwd_pair_mma_kernel", "bwd_dc_kernel", "bwd_du_kernel",
               "bwd_wgrad_kernel", "fwd_pair_bf16_kernel", "k3_c_dc_bf16_kernel",
               "k3_du_bf16_kernel", "k3_wgrad_bf16_kernel", PARTIAL_SUM_KERNEL)
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
DATA_FAMILY = "data take and augment"
FAMILIES = (
    ("cuDNN conv and its backward", ("convolution", "cudnn")),
    ("Adam", ("train/optim.py",)),
    ("losses over the logits", ("losses.py",)),
    ("K1 operands (teacher's BN fold, weight stacks)", ("ops/nb1d_infer.py",)),
    ("BN and dropout glue, K2/K3 operands", ("ops/nb1d_train.py", "ops/norm.py",
                                              "ops/dropout.py")),
    ("model glue (layout, pooling, concat)", ("mdilss_tpu_torch/models/",)),
    ("gradient accumulation", ("AccumulateGrad",)),
    ("confusion matrix (iou_train)", ("metrics.py", "_train_cm")),
    ("the teacher's buffers saved and restored", ("_teacher_mode",)),
    (DATA_FAMILY, ("data/transforms.py", "take_rows")),
    ("other", ("mdilss_tpu_torch/",)),
)
FAMILY_BY_KERNEL_NAME = (("cuDNN conv and its backward", ("conv", "cudnn", "xmma", "implicit",
                                                          "dgrad", "wgrad", "fprop")),)
GLUE_FAMILY = "BN and dropout glue, K2/K3 operands"
CUDNN_FAMILY = "cuDNN conv and its backward"


def family_of(names) -> str:
    for fam, pats in FAMILIES:
        if any(p in n for n in names for p in pats):
            return fam
    return "unattributed"


def _end(e: dict) -> float:
    return e["ts"] + e.get("dur", 0.0)


def ms_by_family(events: list[dict], top: int = 3) -> tuple[dict, dict, dict]:
    """(device ms by family, the `top` kernels of each family, counts) of the
    device work outside K1/K2/K3 in a chrome trace's `traceEvents`: each
    device event is placed where it was launched, by its runtime call (the
    trace's "correlation" argument), else the torch op of the same "External
    id"; the torch ops and Python frames around that point on the launching
    thread name it, and for an op of the backward so do those around the
    forward op that made its autograd node. It goes to the first family one
    of whose patterns is in one of those names; what no launch or name
    places goes by its own name (FAMILY_BY_KERNEL_NAME), else to
    "unattributed". counts: device events, those whose launch was found,
    those placed by a name around it."""
    device, launch, spans = [], {}, {}
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, args = e.get("cat", ""), e.get("args") or {}
        if cat in DEVICE_CATS:
            if not any(p in e["name"] for p in OWN_KERNELS):
                device.append(e)
        elif cat in ("cuda_runtime", "cuda_driver"):
            if "correlation" in args:
                launch[args["correlation"]] = (e["tid"], e["ts"])
        elif cat in ("cpu_op", "python_function", "user_annotation"):
            spans.setdefault(e["tid"], []).append(e)
    op_by_ext, fwd_by_seq = {}, {}
    for ss in spans.values():
        ss.sort(key=lambda e: (e["ts"], -e.get("dur", 0.0)))  # outer before inner
        for e in ss:
            if e["cat"] != "cpu_op":
                continue
            args = e.get("args") or {}
            op_by_ext.setdefault(args.get("External id"), e)
            seq = args.get("Sequence number", -1)
            if (seq >= 0 and not e["name"].startswith("autograd::engine")
                    and (seq not in fwd_by_seq or e["ts"] < fwd_by_seq[seq]["ts"])):
                fwd_by_seq[seq] = e

    def around(points):
        """key -> the spans around each (tid, ts, key), outermost first"""
        out, by_tid = {}, {}
        for tid, ts, key in points:
            by_tid.setdefault(tid, []).append((ts, key))
        for tid, pts in by_tid.items():
            ss, stack, i = spans.get(tid, []), [], 0
            for ts, key in sorted(pts, key=lambda p: p[0]):
                while i < len(ss) and ss[i]["ts"] <= ts:
                    while stack and _end(stack[-1]) < ss[i]["ts"]:
                        stack.pop()
                    stack.append(ss[i])
                    i += 1
                out[key] = [e for e in stack if _end(e) >= ts]
        return out

    points = []
    for k, e in enumerate(device):
        args = e.get("args") or {}
        at = launch.get(args.get("correlation"))
        op = op_by_ext.get(args.get("External id")) if at is None else None
        if op is not None:
            at = (op["tid"], op["ts"])
        if at is not None:
            points.append((*at, k))
    chains = around(points)
    fwd_points = []
    for k, chain in chains.items():
        for e in chain:
            seq = (e.get("args") or {}).get("Sequence number", -1)
            if e["name"].startswith("autograd::engine::evaluate_function") and seq in fwd_by_seq:
                f = fwd_by_seq[seq]
                fwd_points.append((f["tid"], f["ts"], k))
                break
    fwd_chains = around(fwd_points)

    names_ms: dict[str, dict[str, float]] = {}
    placed = 0
    for k, e in enumerate(device):
        names = [s["name"] for s in chains.get(k, []) + fwd_chains.get(k, [])]
        fam = family_of(names)
        if fam == "unattributed":
            fam = next((f for f, pats in FAMILY_BY_KERNEL_NAME
                        if any(p in e["name"].lower() for p in pats)), fam)
        else:
            placed += 1
        d = names_ms.setdefault(fam, {})
        d[e["name"]] = d.get(e["name"], 0.0) + e.get("dur", 0.0) / 1e3
    order = [f for f, _ in FAMILIES] + ["unattributed"]
    ms = {f: sum(names_ms[f].values()) for f in order if f in names_ms}
    fam_top = {f: [[k[:90], v] for k, v in sorted(names_ms[f].items(), key=lambda kv: -kv[1])[:top]]
               for f in ms}
    counts = {"device_events": len(device), "launch_found": len(points), "placed_by_name": placed}
    return ms, fam_top, counts
