"""Shared helpers of the PyTorch-port tests (tests/test_torch_*.py): JAX
models with randomised BatchNorm, moved into the port through the weight
bridge, so both packages run the same weights on the same inputs; and the
3xTF32 arithmetic of the port's fp32 kernels emulated on the CPU (`tf32_rna`,
`split`, the conv pair in its kernels' order)."""
import numpy as np
import torch

import jax
import jax.numpy as jnp

from mdilss_tpu.ops.norm import BNState


def randomize_bn(params, state, rng):
    """Replace every BN scale/bias and running mean/var by random values
    (scale, var in [0.5, 1.5]; bias, mean ~ N(0, 0.1)), so eval-mode BN and
    its fold are exercised instead of the identity init."""
    def uni(a):
        return jnp.asarray(rng.uniform(0.5, 1.5, np.shape(a)).astype(np.float32))

    def nrm(a):
        return jnp.asarray(rng.normal(0.0, 0.1, np.shape(a)).astype(np.float32))

    def walk_p(t):
        if isinstance(t, dict):
            if set(t) == {"scale", "bias"}:
                return {"scale": uni(t["scale"]), "bias": nrm(t["bias"])}
            return {k: walk_p(v) for k, v in t.items()}
        if isinstance(t, list):
            return [walk_p(v) for v in t]
        return t

    def walk_s(t):
        if isinstance(t, BNState):
            return BNState(mean=nrm(t.mean), var=uni(t.var))
        if isinstance(t, dict):
            return {k: walk_s(v) for k, v in t.items()}
        if isinstance(t, list):
            return [walk_s(v) for v in t]
        return t

    return walk_p(params), walk_s(state)


def to_nchw(x_nhwc: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x_nhwc)).permute(0, 3, 1, 2)


def rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def cm_near_ties(got_cm, want_cm, jax_logits, port_logits, labels, tie: float = 1e-4) -> int:
    """Hold the port's confusion matrix to JAX's where their argmaxes are
    decided, and return the number of near-tie pixels. The two packages'
    logits differ in the last bits (and, after an Adam step, by its sign
    noise), so an argmax may flip where JAX's top-2 gap is within
    max(`tie`, 4x the RMS logit difference); each flip moves two entries by
    one, so the matrices agree to within 2 per near-tie pixel, exactly when
    there are none."""
    jax_logits, port_logits = np.asarray(jax_logits), np.asarray(port_logits)
    got, want = np.asarray(got_cm, np.int64), np.asarray(want_cm, np.int64)
    top2 = np.sort(jax_logits, axis=-1)[..., -2:]
    noise = float(np.sqrt(np.mean((port_logits.astype(np.float64) - jax_logits) ** 2)))
    ties = int((top2[..., 1] - top2[..., 0] <= max(tie, 4 * noise)).sum())
    assert got.sum() == want.sum() == np.asarray(labels).size
    assert np.abs(got - want).sum() <= 2 * ties, (got, want, ties)
    return ties


def port_train_logits(model, x: np.ndarray, task: int, masks) -> np.ndarray:
    """The port's training-mode logits of head `task` on a copy of `model`
    (the model's BN running statistics stay as they are)."""
    import copy

    twin = copy.deepcopy(model).train()
    with torch.no_grad():
        return twin(torch.from_numpy(x), task, masks).numpy()


# ---- the fp32 kernels' arithmetic (csrc/tf32_pair.cuh) --------------------------------------
# TF32 keeps float32's exponent and 10 mantissa bits. `tf32_rna` emulates cvt.rna.tf32.f32
# (round to nearest, ties away from zero) on the float32 bits, with the integer rounding the
# kernels use. Each operand splits as hi = rna(x), lo = rna(x - hi); a product of TF32 values is
# exact in float32 (11 x 11 significant bits), so float32 matmuls of the split operands give the
# tensor cores' products, summed in float32.

def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (ties away from zero), as float32."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def pair_emulated(x, w31s, b31, w13s, rap, pre, d: int, one_pass: bool = False):
    """The conv pair of K2 and of K1's fp32 kernel (tf32_pair.cuh's mainloop) in their order:
    y [N, H, W, C] and K2's stats [2, C] (float64) on x [N, H, W, C] float32.

    Every operand split hi/lo with tf32_rna, each K chunk of 32 input channels (16 at C = 16)
    summed in a fresh float32 accumulator and added to a running float32 sum; stage A
    (c = relu(rowconv_d(u) + b31), kept in float32) over the row taps, stage B (y = colconv_d(c))
    over the column taps, then RAP on u; the stats as float32 sums over one CTA tile (TM = 256 /
    128 columns at C = 16 / 64: here one per image row) added in float64. `one_pass`: one TF32
    product (hi x hi) in place of three."""
    import torch.nn.functional as F

    n, h, w, c = x.shape
    kc = min(c, 32)

    def gemm(blocks):
        acc = torch.zeros(n, h, w, c)
        for a, b in blocks:
            for i in range(0, c, kc):
                (ah, al), (bh, bl) = split(a[..., i:i + kc].contiguous()), split(b[i:i + kc])
                acc = acc + (ah @ bh if one_pass else al @ bh + ah @ bl + ah @ bh)
        return acc

    u = x if pre is None else torch.relu(x * pre[0] + pre[1])
    up = F.pad(u, (0, 0, 0, 0, d, d))  # zero rows above and below
    cc = torch.relu(gemm([(up[:, k * d:k * d + h], w31s[k * c:(k + 1) * c]) for k in range(3)])
                    + b31)
    cp = F.pad(cc, (0, 0, d, d))  # zero columns left and right
    blocks = [(cp[:, :, k * d:k * d + w], w13s[k * c:(k + 1) * c]) for k in range(3)]
    y = gemm(blocks + ([(u, rap)] if rap is not None else []))
    part = torch.stack([y.sum(2), y.square().sum(2)])  # [2, N, H, C]: one sum per CTA, float32
    return y, part.double().sum((1, 2))


def nb1d_fp32_emulated(x, ops, dilated: int, one_pass: bool = False) -> torch.Tensor:
    """K1's fp32 block (two launches of nb1d_pair_tf32_kernel) in its order on x [N, H, W, C]
    float32: each pair through `pair_emulated` with no pre-stage, the epilogue relu(fma(a, y,
    b) [+ res]) in float32 (the fma rounded once, through float64), m kept in float32."""
    def epilogue(y, a, b, res=None):
        z = (a.double() * y.double() + b.double()).float()
        return torch.relu(z if res is None else z + res)

    y1, _ = pair_emulated(x, ops.w31a, ops.b31a, ops.w13a, ops.rap1, None, 1, one_pass)
    m = epilogue(y1, ops.a1, ops.b1)
    y2, _ = pair_emulated(m, ops.w31b, ops.b31b, ops.w13b, ops.rap2, None, dilated, one_pass)
    return epilogue(y2, ops.a2, ops.b2, x)


def jax_augment_draws(key, n: int):
    """The flip / tx / ty that the JAX package's augment_batch draws from
    `key` (mdilss_tpu/data/transforms.py:124-127), as the port's
    `draw_augment` returns them."""
    import jax

    k_flip, k_tx, k_ty = jax.random.split(key, 3)
    flip = jax.random.bernoulli(k_flip, 0.5, (n,))
    tx = jax.random.randint(k_tx, (n,), -2, 3)
    ty = jax.random.randint(k_ty, (n,), -2, 3)
    return tuple(torch.from_numpy(np.array(a)) for a in (flip, tx, ty))


# ---- the Trainer against the JAX package's (test_torch_trainer_jax*.py) ---------------------

TRAINER_TINY = dict(synthetic=True, synthetic_size=4, batch_size=2, height=32, width=64,
                    num_workers=2)
# protocol -> (student classes, teacher classes, epochs)
TRAINER_CASES = {
    "step1": ((20,), None, 2),
    "step2": ((20, 20), (20,), 1),
    "step3": ((20, 20, 27), (20, 20), 1),
}


def _recording(step, out: list):
    """`step` that also appends each call's losses (floats) to `out`."""
    def wrapped(*args):
        ts, m = step(*args)
        out.append({k: float(v) for k, v in m.items() if k != "cm"})
        return ts, m

    return wrapped


def trainer_parity(protocol: str, tmp_path, monkeypatch) -> None:
    """Train `protocol` at TRAINER_TINY with the JAX package's Trainer and the
    port's, from the same initial weights (JAX's init with random BN, into the
    port through `ckpt.from_jax`) and teacher, and compare.

    Both packages make the same synthetic data, batches and dropout masks
    (default_rng((seed + 1, epoch))); the augment draws are the JAX Trainer's,
    replayed from its key splits (mdilss_tpu/train/loop.py:80-81, :432;
    transforms.py:124-127) and fed to the port's Trainer in place of its
    generator's.

    Tolerances, as tests/test_torch_train_step.py holds trajectories: the
    first batch's loss, ce and kld 1e-4 relative (nothing has moved the two
    packages' weights apart yet); every later batch's, and the per-epoch
    means, 1e-3. Adam's first steps move each trained weight by ~lr, and
    where a gradient is small against its float32 noise between the two
    packages (this BN+relu stack's gradient moves ~2% under a 1e-7 input
    change) its sign, and so the move, differs: step 3's second batch (after
    two Adam steps) then differs by 3.4e-4 in ce. Val loss after each epoch
    1e-4 (an eval forward averages those moves out); the final
    weights' val confusion matrices within 2 counts per near-tie pixel
    (`cm_near_ties`); the LR columns equal to JAX's (both round the poly
    factor's power correctly to float32); the same metrics.jsonl keys,
    automated_log.txt layout
    and best epoch. Run with `pytest -s`, it prints each batch's and each
    epoch's relative differences and the LR columns."""
    import json
    import re

    import jax
    import jax.numpy as jnp

    from mdilss_tpu import config as JC
    from mdilss_tpu.metrics import confusion_matrix as jax_confusion_matrix
    from mdilss_tpu.models import erfnet_rap
    from mdilss_tpu.train import steps as jsteps
    from mdilss_tpu.train.loop import Trainer as JaxTrainer
    from mdilss_tpu_torch import config as PC
    from mdilss_tpu_torch.ckpt import from_jax
    from mdilss_tpu_torch.data import transforms
    from mdilss_tpu_torch.models import ERFNetRAP
    from mdilss_tpu_torch.train.loop import Trainer

    nc, teacher_nc, epochs = TRAINER_CASES[protocol]
    tiny = TRAINER_TINY
    rng = np.random.default_rng(0)
    params, bn = randomize_bn(*erfnet_rap.init(jax.random.key(1), list(nc), len(nc)), rng)
    init_state = from_jax(params, bn)  # before the JAX steps donate (delete) these arrays
    j_teacher = p_teacher = None
    if teacher_nc is not None:
        tp, tb = randomize_bn(*erfnet_rap.init(jax.random.key(2), list(teacher_nc),
                                               len(teacher_nc)), rng)
        p_teacher = ERFNetRAP(list(teacher_nc), len(teacher_nc), device="cpu")
        p_teacher.load_state_dict(from_jax(tp, tb), strict=True)
        j_teacher = jsteps.ModelState(tp, tb)
    kw = dict(num_epochs=epochs, eval_old_every=1, **tiny)
    jtr = JaxTrainer(getattr(JC, protocol)(savedir=str(tmp_path / "jax"), **kw),
                     teacher=j_teacher, init_params=params, init_bn=bn)
    cur = jtr.cfg.datasets[jtr.cfg.current_task]
    j_batches, p_batches = [], []
    jtr.train_steps[cur] = _recording(jtr.train_steps[cur], j_batches)
    jtr.fit()

    key = jax.random.split(jax.random.key(0))[0]  # the JAX Trainer's self.rng
    draws = []
    for _ in range(epochs * tiny["synthetic_size"] // tiny["batch_size"]):
        key, k_aug, _ = jax.random.split(key, 3)
        draws.append(jax_augment_draws(k_aug, tiny["batch_size"]))
    draws = iter(draws)
    monkeypatch.setattr(transforms, "draw_augment", lambda gen, n: next(draws))
    ptr = Trainer(getattr(PC, protocol)(savedir=str(tmp_path / "port"), **kw),
                  teacher=p_teacher, init_state=init_state, device="cpu")
    ptr.train_steps[cur] = _recording(ptr.train_steps[cur], p_batches)
    ptr.fit()
    assert next(draws, None) is None  # every replayed draw was used

    def rel(a, b):
        return abs(a - b) / abs(b)

    assert len(p_batches) == len(j_batches) > 1
    for i, (g, w) in enumerate(zip(p_batches, j_batches)):
        assert set(g) == set(w)
        print(f"[trainer_parity {protocol}] batch {i + 1}, relative to JAX: "
              + ", ".join(f"{k} {rel(g[k], w[k]):.2e}" for k in sorted(w)))
        for k in w:
            assert rel(g[k], w[k]) <= (1e-4 if i == 0 else 1e-3), (i, k, g[k], w[k])

    def rows(path):
        with open(path) as f:
            return [json.loads(line) for line in f]

    got, want = rows(tmp_path / "port/metrics.jsonl"), rows(tmp_path / "jax/metrics.jsonl")
    assert [list(r) for r in got] == [list(r) for r in want]
    for i, (g, w) in enumerate(zip(got, want)):
        assert g["epoch"] == w["epoch"] == i + 1
        print(f"[trainer_parity {protocol}] epoch {i + 1}, relative to JAX: "
              + ", ".join(f"{k} {rel(g[k], w[k]):.2e}" for k in w
                          if k.startswith(("train_", "val_loss_"))) + f"; lr_ds {g['lr_ds']!r} "
              f"(JAX {w['lr_ds']!r})")
        for k in ("train_loss", "train_ce", "train_kld"):
            if k in w:
                assert rel(g[k], w[k]) <= 1e-3, (i, k, g[k], w[k])
        for k in (k for k in w if k.startswith("val_loss_")):
            assert rel(g[k], w[k]) <= 1e-4, (i, k, g[k], w[k])
        for k in ("lr_ds", "lr_shared"):
            assert g[k] == w[k], (i, k, g[k], w[k])
    row = re.compile(r"^\d+(\t\t-?\d+\.\d{4}){4}\t\t\d+\.\d{8}$")
    for name in ("automated_log.txt", "best.txt"):
        with open(tmp_path / "port" / name) as f:
            g = f.read()
        with open(tmp_path / "jax" / name) as f:
            w = f.read()
        if name == "best.txt":
            assert g.split(",")[0] == w.split(",")[0]  # "Best epoch is N"
            continue
        g, w = g.split("\n"), w.split("\n")
        assert g[0] == w[0] and len(g) == len(w) == 1 + epochs
        assert all(row.match(line) for line in g[1:]), g

    # the final weights' val confusion matrices, on the val batches
    from mdilss_tpu_torch.data.transforms import prepare_batch

    fwd = jax.jit(lambda p, s, x, t: erfnet_rap.apply(p, s, x, t, training=False)[0],
                  static_argnums=3)
    for t, d in enumerate(ptr.cfg.datasets):
        for imgs, lbls, valid in ptr.val_loaders[d]:
            assert valid.all()
            x, y = prepare_batch(torch.from_numpy(imgs), torch.from_numpy(lbls),
                                 num_classes=nc[t])
            j_logits = np.asarray(fwd(jtr.ts.params, jtr.ts.bn, jnp.asarray(x.numpy()), t))
            _, p_cm = ptr.eval_steps[d](ptr.ts.model, x, y)
            j_cm = jax_confusion_matrix(jnp.asarray(j_logits.argmax(-1)),
                                        jnp.asarray(y.numpy()), num_classes=nc[t])
            cm_near_ties(p_cm, j_cm, j_logits, ptr.ts.model(x, t).numpy(), y)


# ---- the ablation models (test_torch_ablations*.py) ---------------------------------------------

ABLATION_VARIANTS = ("bn", "onlyrap", "ras", "rcm")


def random_wt(tree, rng):
    """`tree` with every RCM matrix (`wt1` / `wt2` leaf, any leading axes
    [..., C, C]) replaced by I + N(0, 0.3^2 / C), not symmetric."""
    if isinstance(tree, dict):
        return {k: (jnp.asarray((np.eye(v.shape[-1]) + 0.3 / np.sqrt(v.shape[-1])
                                 * rng.standard_normal(v.shape)).astype(np.float32))
                    if k in ("wt1", "wt2") else random_wt(v, rng)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [random_wt(v, rng) for v in tree]
    return tree


def ablation_jax_model(variant: str, classes, seed: int):
    """An ablation model's JAX (params, state) from `seed`: random BN and Wt."""
    from mdilss_tpu.models import erfnet_ablations

    rng = np.random.default_rng(seed)
    params, state = randomize_bn(*erfnet_ablations.init(
        jax.random.key(seed), list(classes), len(classes), variant=variant), rng)
    return random_wt(params, rng), state


def ablation_port_model(variant: str, params, state):
    """The port's model of `variant` holding JAX's weights (strict load)."""
    from mdilss_tpu_torch.ckpt import from_jax
    from mdilss_tpu_torch.models import ERFNetAblation

    model = ERFNetAblation([int(np.shape(d["output_conv"]["b"])[0]) for d in params["decoders"]],
                           len(params["decoders"]), variant, device="cpu")
    model.load_state_dict(from_jax(params, state), strict=True)
    return model


# ---- bf16 training (test_torch_bf16_*.py) ---------------------------------------------------
# The error budget: each bf16 output of the port must lie at most BF16_K times as far from the
# port's float64 plain path as the JAX package's bf16 output lies, plus BF16_EPS (relative L2).
# The two packages round at different points (the port accumulates in float32 and rounds once
# per stage, where JAX rounds each tap of a 1x3 conv and the RAP term to bf16), but both meet the
# same relu band: the bf16 rounding of u and c moves elements near a relu's kink to its other
# side, which moves the gradients through that relu by a few percent in relative L2 in both, by
# amounts that differ between the two only in which elements flip (port / JAX 0.2-1.1 at
# 2x16x32). BF16_EPS is the float32 floor of outputs that neither rounds to bf16 (a weight
# gradient of bf16 products summed in float32).
# A whole model's training forward at random weights amplifies bf16's rounding through its
# ~40 BN+relu layers: at 2x32x64 the bf16 logits of both packages lie 15-60% (relative L2) from
# float64, the port's 10-25% nearer. A loss is one number, a mean over those logits, so its
# error is one draw of that noise (measured 1e-4 to 1e-2 relative in both packages) and the
# port's may be the larger draw: a loss gets BF16_EPS_LOSS = 2^-6 as its floor. The many-element
# outputs of a step carry the comparison: the running statistics, and each trained
# parameter's move divided by its LR (`lr_moves`; one Adam step moves an element by about
# -lr * sign(gradient), so this measures how often the gradient's sign is wrong).
BF16_K, BF16_EPS, BF16_EPS_LOSS = 1.5, 1e-5, 2.0 ** -6


def bf16_exact(a) -> np.ndarray:
    """float32 values that bf16 represents exactly (`a` rounded to bf16), so
    the float64 reference and both bf16 paths start from the same numbers."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16).float().numpy()


def bf16_exact_tree(tree):
    """A JAX tree of float32 leaves with every leaf rounded to bf16 values."""
    return jax.tree.map(lambda a: jnp.asarray(bf16_exact(a)), tree)


def within_budget(name: str, port, jax_out, ref, k: float = BF16_K,
                  eps: float = BF16_EPS) -> None:
    """rel_l2(port, ref) <= k * rel_l2(jax_out, ref) + eps; prints both and
    the direct port-vs-JAX relative L2 (under `pytest -s`)."""
    port, jax_out, ref = (np.asarray(a, np.float64) for a in (port, jax_out, ref))
    e_port, e_jax = rel_l2(port, ref), rel_l2(jax_out, ref)
    print(f"[bf16] {name}: port vs float64 {e_port:.3e}, JAX vs float64 {e_jax:.3e}, "
          f"port vs JAX {rel_l2(port, jax_out):.3e}")
    assert e_port <= k * e_jax + eps, (name, e_port, e_jax)


def lr_moves(model, before: dict, lr: dict, after: dict | None = None) -> np.ndarray:
    """Each trained parameter's move over a step (from `before` to `after`, or
    to the model's current value) divided by its LR, flat, in the model's
    parameter order."""
    after = dict(model.named_parameters()) if after is None else after
    return np.concatenate([
        ((after[k].detach().double() - before[k].double()) / lr[k]).numpy().ravel()
        for k, _ in model.named_parameters() if lr[k] > 0])


REPO = __import__("pathlib").Path(__file__).resolve().parents[1]


def torchrun(args: list, *, nproc: int = 2, env: dict | None = None):
    """Start `python -m torch.distributed.run --standalone --nproc_per_node
    nproc ARGS` from the repository root (the port importable, one thread
    per rank) -> the Popen, its output piped; `finish` waits for it."""
    import os
    import subprocess
    import sys

    run_env = {**os.environ, "OMP_NUM_THREADS": "1", **(env or {})}
    run_env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in run_env.get("PYTHONPATH", "").split(os.pathsep) if p])
    return subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc_per_node={nproc}", *map(str, args)],
        cwd=REPO, env=run_env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def finish(proc, timeout: float = 600) -> str:
    """Wait for a `torchrun` process; its output, or fail with it."""
    out, _ = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, out[-6000:]
    return out
