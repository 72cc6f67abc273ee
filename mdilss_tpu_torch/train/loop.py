"""Epoch-loop trainer for every protocol of the reference (port of
mdilss_tpu/train/loop.py):

  step1      train_RAPFT_step1.py     — RAP model (or one of the four ablation
                                        models, or SegFormerRAP), everything
                                        trainable, CE
  step2      train_new_task_step2.py  — +1 task, old task slices frozen, CE + KLD
                                        against the eval-mode teacher
  step3      train_new_task_step3.py  — +1 task, two KLDs; two-phase (a CE Adam
                                        step, then a KLD Adam step) with the
                                        train-mode teacher, or the fused step-2 form
  multitask  train_multi_task.py      — joint baseline: one CE step per domain in
                                        turn over min(len) batches of each
  ft / fe    main_ftp1_enc_newbn.py / main_FT2_flexible_new.py — the new head
                                        (and, for ft, the encoder) on the last
                                        domain, the old heads frozen
  singletask the single-task ERFNet baseline (one head, CE)

Per epoch, as the reference: poly LR by epoch; validation of the current task
every `eval_every` epochs (and the final one), old tasks every
`eval_old_every` (step 2, step 3, multitask, ft, fe); best-checkpoint
selection on the current task's val IoU (multitask: the mean over the
domains validated; fallback -val_loss, train_new_task_step2.py:358-363), only
among evaluated epochs; `automated_log.txt` rows; a checkpoint every epoch,
with true resume.

The data: a dataset on disk or a synthetic source, batched by `Loader`
(host threads) and either cached on the device (`DeviceCache`, or
`HybridCache` for the part that fits) or streamed through
`device_prefetch`; augment runs on the device. The train and eval steps are
`train/steps.py`'s, which run K1/K2/K3 on the card and their plain versions
on the CPU.

Deliberate differences from the JAX package: the augment draws come from one
CPU `torch.Generator` seeded from `cfg.seed` (the checkpoint carries its
state) in place of JAX's split keys, and the port's steps take no key;
initial weights are torch's initialisation seeded from `cfg.seed`;
confusion matrices are int64 on the device and summed there; checkpoints
are torch files (`ckpt/torch_io.py`); a model that does not fit the protocol
raises, and so does `fused_train` with an ablation model (the JAX package's
fused paths cover the RAP and plain encoders only,
mdilss_tpu/models/topology.py:197-200). `remat=True` gives every step maker
`remat` and `remat_prev` (JAX's Trainer rematerialises the previous-task forwards
whatever `remat` is); the trained state is the same either way.

`model="segformer_b5_rap"` runs SegFormer-B5 with ERFNet-RAP's incremental
rule (`models.segformer_rap`) through step1 / step2 / step3 and the same
steps; its dropout masks are the model's own (`make_dropout_masks`), and
`check_segformer` refuses what it does not cover (fused_train, remat,
bfloat16, the spatial axis, sides not multiples of 32; a mesh of more than
one rank raises in the Trainer).

A dataset cache that cannot be built (the card's memory full, say) is
skipped as JAX skips it: the Trainer prints why, streams that dataset and
charges nothing to the budget.

Sharded (the JAX Trainer's mesh arms, mdilss_tpu/train/loop.py:189-265):
the Trainer builds its mesh from `cfg.batch_size` and `cfg.spatial_shards`
(`parallel.make_mesh`: one process per card under torchrun; S =
spatial_shards must divide the world, JAX's ValueError; the mesh the first
D * S ranks, D = gcd(batch_size, world / S)). Each rank of the mesh decodes
and caches the images of its data index and trains on its block of every
global batch: every rank draws the global batch's augment and dropout masks
and keeps its data index's images (and masks), augments them at full height
and keeps its spatial index's rows of the images and labels, so the
generators' states agree on every rank and in the checkpoint; validation
batches split the same way. The steps sum the gradients and reduce BN and
the metrics, and the convs exchange row halos (`train/steps.py`), so every
rank holds the same weights and history. Only rank 0 writes the run's files
(opts, checkpoints, best/, the logs, a profile), and the mesh waits for it
after each checkpoint; every rank loads on resume. The device caches on a
mesh hold 1/D of the dataset each (the rows of the data index, whole
images, the same on each spatial rank, JAX's `P("data")`): the budget is
multiplied by D and each cache charged 1/D of its bytes, and a dataset that
would need a hybrid cache streams; the ranks agree on each cache, or all
stream. Ranks outside the mesh build nothing and return rank 0's result
from `fit`. `fused_train` on more than one rank raises ValueError, as JAX
refuses it; the port's blocks run the fused kernels on a mesh all the same
(their statistics reduced in the glue, `ops.nb1d_train`). The image height
must split into S slabs at every level of the encoder, H % (8 S) == 0, or
the Trainer raises ValueError (GSPMD pads uneven shards; the port does
not).

`compute_dtype="bfloat16"` trains as the JAX package's bf16 Trainer does:
augment writes bf16 images, and every train and eval forward (student,
teacher and validation) runs in bf16, so activations and logits are bf16
(K1/K2/K3's bf16 kernels on the card), while the parameters, Adam's state,
the BN statistics, the weight gradients, the losses and the checkpoints stay
float32.
"""
from __future__ import annotations

import json
import os
import time
import zlib

import numpy as np
import torch
import torch.distributed as dist

from .. import resolve_device
from ..ckpt import torch_io
from ..config import ABLATION_MODELS, SEGFORMER_MODELS, TrainConfig
from ..data import transforms
from ..data.class_weights import CLASS_WEIGHTS
from ..data.device_cache import DeviceCache, HybridCache, cache_bytes, plan_cache
from ..data.loader import LearnableSource, Loader, SyntheticSource, device_prefetch
from ..data.sources import make_source
from ..losses import kld_corrected, kld_faithful
from ..metrics import IoUEvaluator
from ..models import ERFNetAblation, ERFNetMultiHead, ERFNetRAP, SegFormerRAP
from ..models.erfnet_ablations import REFERENCE_NAMES
from ..models.segformer_rap import SIZE_MULTIPLE as SEGFORMER_SIZE_MULTIPLE
from ..models.topology import make_dropout_masks, shard_dropout_masks
from ..parallel.mesh import (active, all_reduce_, barrier, broadcast_object, make_mesh,
                             replicate, shard_height, shard_rows)
from ..utils.logging import MetricLogger, getColorEntry
from ..utils.profiling import StepTracer, span
from . import steps
from .masks import ablation_lr_tree, multihead_lr_tree, rap_lr_tree
from .optim import poly_lr_factor

RAP_PROTOCOLS = ("step1", "step2", "step3")
# the models those protocols train: the reference step-1 factory
# (train_RAPFT_step1.py:451-460), and SegFormerRAP by the name of its preset
RAP_MODELS = ("erfnet_RA_parallel", *ABLATION_MODELS, *SEGFORMER_MODELS)
MULTIHEAD_PROTOCOLS = ("multitask", "ft", "fe", "singletask")
# the trainer's model names -> the multi-head models' kinds (state-dict grammar)
MULTIHEAD_MODELS = {"erfnet_multi_task": "multi_task", "erfnet_ftp1": "ftp1",
                    "erfnet_ftp2": "ftp2"}
# the protocols that validate the other domains every `eval_old_every` epochs
OLD_EVAL_PROTOCOLS = ("step2", "step3", "multitask", "ft", "fe")


def check_supported(cfg: TrainConfig) -> None:
    """Raise ValueError for a model that does not fit the protocol, an
    ablation model with `fused_train`, a compute_dtype other than float32
    and bfloat16, or a SegFormer run with what it does not cover
    (`check_segformer`)."""
    if cfg.model not in RAP_MODELS and cfg.model not in MULTIHEAD_MODELS:
        raise ValueError(f"unknown model {cfg.model!r}")
    if cfg.protocol not in RAP_PROTOCOLS + MULTIHEAD_PROTOCOLS:
        raise ValueError(f"unknown protocol {cfg.protocol!r}")
    if (cfg.protocol in RAP_PROTOCOLS) != (cfg.model in RAP_MODELS):
        raise ValueError(
            f"protocol {cfg.protocol!r} with model {cfg.model!r}: {RAP_PROTOCOLS} train "
            f"{RAP_MODELS}, {MULTIHEAD_PROTOCOLS} the multi-head models "
            f"{tuple(MULTIHEAD_MODELS)}")
    if cfg.fused_train and cfg.model in ABLATION_MODELS:
        raise ValueError(
            f"fused_train with model {cfg.model!r}: the fused paths cover the rap/plain "
            f"encoders only, not {REFERENCE_NAMES[cfg.model]!r}")
    steps.compute_dtype_of(cfg.compute_dtype)  # float32 or bfloat16, else ValueError
    if cfg.model in SEGFORMER_MODELS:
        check_segformer(cfg)


def check_segformer(cfg: TrainConfig) -> None:
    """ValueError for what a SegFormerRAP run does not cover: the fused
    training blocks and remat (ERFNet's), bfloat16, the spatial axis, and
    images whose sides are not multiples of 32. A mesh of more than one rank
    raises in the Trainer."""
    refused = {"fused_train": cfg.fused_train, "remat": cfg.remat,
               f"compute_dtype={cfg.compute_dtype!r}": cfg.compute_dtype != "float32",
               f"spatial_shards={cfg.spatial_shards}": cfg.spatial_shards != 1}
    for what, on in refused.items():
        if on:
            raise ValueError(f"{what} with model {cfg.model!r}: a SegFormer run is float32 on "
                             f"one process, without remat or the fused ERFNet blocks")
    if cfg.height % SEGFORMER_SIZE_MULTIPLE or cfg.width % SEGFORMER_SIZE_MULTIPLE:
        raise ValueError(f"model {cfg.model!r} takes heights and widths that are multiples of "
                         f"{SEGFORMER_SIZE_MULTIPLE}, not {cfg.height} x {cfg.width}")


# the encoder's three downsamplers halve the rows: each level's rows split evenly
SPATIAL_MULTIPLE = 8


def check_height(cfg: TrainConfig, spatial: int) -> None:
    """ValueError unless the image height splits into `spatial` slabs at
    every level of the encoder (a deliberate deviation: GSPMD pads uneven
    shards)."""
    if spatial > 1 and cfg.height % (SPATIAL_MULTIPLE * spatial):
        raise ValueError(
            f"--spatial-shards {spatial} needs a height divisible by "
            f"{SPATIAL_MULTIPLE * spatial} ({SPATIAL_MULTIPLE} x the shards: the encoder's "
            f"three downsamplers halve the rows of every slab), not {cfg.height}")


def task_stacked_model(model: str, num_classes) -> torch.nn.Module:
    """A model of the step protocols on the CPU, one task per class count:
    ERFNetRAP for erfnet_RA_parallel, SegFormerRAP (B5) for a SegFormer name
    (`SEGFORMER_MODELS`), else the ablation model of that name;
    the model's initialisation from the global RNG."""
    nc = list(num_classes)
    if model == "erfnet_RA_parallel":
        return ERFNetRAP(nc, len(nc), device="cpu")
    if model in SEGFORMER_MODELS:
        return SegFormerRAP(nc, len(nc), device="cpu")
    return ERFNetAblation(nc, len(nc), REFERENCE_NAMES[model], device="cpu")


def init_model(cfg: TrainConfig) -> torch.nn.Module:
    """The configuration's model on the CPU, in torch's default initialisation
    seeded from `cfg.seed` (the global RNG left as it was): ERFNetRAP or an
    ablation model with one task per class count, or the multi-head model of
    `cfg.model`."""
    check_supported(cfg)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(cfg.seed)
        if cfg.model in RAP_MODELS:
            return task_stacked_model(cfg.model, cfg.num_classes)
        return ERFNetMultiHead(list(cfg.num_classes), kind=MULTIHEAD_MODELS[cfg.model],
                               device="cpu")


class Trainer:
    """`Trainer(cfg, teacher=..., init_state=..., device=None).fit()`.

    `device` None -> the CUDA card (raises without one; cuda:LOCAL_RANK under
    torchrun); "cpu" runs the plain versions (gloo under torchrun). A
    `cfg.spatial_shards` that does not divide the processes raises JAX's
    ValueError, as does a height that does not split (`check_height`).
    `init_state`: the student's initial weights as a reference-grammar state
    dict of the configuration's model (`ckpt.from_jax`,
    `ckpt.torch_io.load_state`); None -> `init_model`.
    `teacher`: the previous step's model (an ERFNetRAP or ablation model
    with the previous tasks' heads), required by step2 and step3; it is moved to the device
    and never updated. `train/protocols.build_trainer` builds both from
    the previous step's checkpoint.
    """

    def __init__(self, cfg: TrainConfig, *, teacher: torch.nn.Module | None = None,
                 init_state: dict | None = None, device=None):
        check_supported(cfg)
        if cfg.protocol in ("step2", "step3") and teacher is None:
            raise ValueError(f"protocol {cfg.protocol} distils from a teacher: pass teacher=")
        self.cfg = cfg
        self.mesh = make_mesh(cfg.batch_size, spatial=cfg.spatial_shards,
                              device=resolve_device(device))
        self.device = self.mesh.device
        check_height(cfg, self.mesh.spatial)
        if cfg.model in SEGFORMER_MODELS and self.mesh.size > 1:
            raise ValueError(f"model {cfg.model!r} trains on one process: a mesh of "
                             f"{self.mesh.size} ranks is not covered")
        if cfg.fused_train and self.mesh.size > 1:
            # JAX's refusal (mdilss_tpu/train/loop.py:257-265); the port's blocks
            # reduce their statistics in the glue and run the kernels all the same
            raise ValueError(
                "--fused-train is single-device only (in-kernel BN batch stats are not "
                "mesh-reduced); drop spatial_shards/extra devices or disable fused_train")
        self._writer = self.mesh.rank == 0  # only rank 0 writes the run's files
        if self._writer:
            os.makedirs(cfg.savedir, exist_ok=True)
            with open(os.path.join(cfg.savedir, "opts.txt"), "w") as f:
                f.write(cfg.to_json())

        model = init_model(cfg)
        if init_state is not None:
            model.load_state_dict(init_state, strict=True)
        if not self.mesh.member:  # outside the mesh: fit() waits for rank 0's result
            return
        self.ts = steps.init_train_state(replicate(model.to(self.device), self.mesh))
        # the model's own keep-masks where it draws them (SegFormerRAP), else ERFNet's
        draw = getattr(model, "make_dropout_masks", None)
        self._dropout_masks = ((lambda n: draw(self._np_rng, n)) if draw is not None else
                               (lambda n: shard_dropout_masks(make_dropout_masks(self._np_rng, n),
                                                              self.mesh)))
        self.teacher = None if teacher is None else replicate(teacher.to(self.device), self.mesh)

        if self._writer:
            with open(os.path.join(cfg.savedir, "model.txt"), "w") as f:
                sizes = {k: list(p.shape) for k, p in model.named_parameters()}
                f.write(json.dumps(sizes, indent=1))

        self.aug_gen = torch.Generator(device="cpu").manual_seed(cfg.seed)
        self._build_data()
        self._build_steps()
        self.logger = MetricLogger(cfg.savedir) if self._writer else None
        sync = (lambda: torch.cuda.synchronize(self.device)) if self.device.type == "cuda" else None
        self._tracer = StepTracer(cfg.profile_dir if self._writer else None,
                                  n=cfg.profile_steps, sync=sync)
        self.best_acc = -np.inf
        self.start_epoch = 1
        self._step_count = 0
        self._sync_loss = None
        barrier(self.mesh)  # rank 0's directory exists before anyone resumes or writes
        if cfg.resume:
            self._try_resume()

    # ------------------------------------------------------------------
    def _source(self, name: str, subset: str):
        cfg = self.cfg
        if cfg.synthetic or name not in cfg.data_roots:
            cls = LearnableSource if cfg.synthetic_kind == "learnable" else SyntheticSource
            nc = cfg.num_classes[cfg.datasets.index(name)]
            # stable across processes (python's str hash is salted)
            seed = zlib.crc32(f"{name}/{subset}".encode()) % 2**31
            return cls(nc, n=cfg.synthetic_size, height=cfg.height, width=cfg.width, seed=seed)
        return make_source(name, cfg.data_roots[name], subset)

    def _build_data(self):
        cfg = self.cfg

        shard = (self.mesh.data_index, self.mesh.data)  # whole images of this data index

        def mk(name, subset, shuffle):
            return Loader(self._source(name, subset), batch_size=cfg.batch_size,
                          height=cfg.height, width=cfg.width, shuffle=shuffle,
                          num_threads=cfg.num_workers, seed=cfg.seed, shard=shard)

        cur = cfg.datasets[cfg.current_task]
        trained = cfg.datasets if cfg.protocol == "multitask" else (cur,)
        self.train_loaders = {d: mk(d, "train", True) for d in trained}
        self.val_loaders = {d: mk(d, "val", False) for d in cfg.datasets}
        self._train_caches: dict = {}
        self._val_caches: dict = {}
        self._cache_budget = self._device_cache_budget()

    def _device_cache_budget(self) -> int:
        """Byte budget of one device for the device-resident dataset caches:
        half of the card's memory (`torch.cuda.mem_get_info`'s total), 1 GiB
        on the CPU, an explicit integer, or 0 ("off"); the smallest over the
        mesh's ranks, so they plan the same caches."""
        budget = self._own_cache_budget()
        if active(self.mesh):
            t = torch.tensor([budget], dtype=torch.int64, device=self.device)
            budget = int(all_reduce_(t, self.mesh, dist.ReduceOp.MIN).item())
        return budget

    def _own_cache_budget(self) -> int:
        if self.cfg.device_cache == "off":
            return 0
        if self.cfg.device_cache != "auto":
            try:
                return int(self.cfg.device_cache)
            except ValueError:
                raise ValueError(
                    f"device_cache={self.cfg.device_cache!r}: expected 'auto', 'off', or an "
                    "integer byte budget (e.g. '8589934592' for 8 GiB; suffixed forms like "
                    "'8GiB' are not parsed)"
                ) from None
        if self.device.type == "cuda":
            # leave half for the parameters, optimizer and activations of the step
            return torch.cuda.mem_get_info(self.device)[1] // 2
        return 1 << 30

    def _cache_for(self, dataset: str, subset: str):
        """Device cache for (dataset, subset) if caching is on and at least a
        batch of it fits; the budget is claimed greedily, streaming otherwise,
        and streaming too where building the cache raises (JAX's fallback,
        mdilss_tpu/train/loop.py:206-222)."""
        caches = self._train_caches if subset == "train" else self._val_caches
        if dataset in caches:
            return caches[dataset]
        ld = (self.train_loaders if subset == "train" else self.val_loaders).get(dataset)
        if ld is None:
            caches[dataset] = None
            return None
        # on a mesh each rank holds 1/D of the rows: the budget multiplies by D
        # (mdilss_tpu/train/loop.py:189-222)
        d = self.mesh.data if active(self.mesh) else 1
        mode, rows = plan_cache(ld.source, height=ld.height, width=ld.width,
                                budget_bytes=self._cache_budget * d, batch_size=ld.batch_size)
        if mode == "stream" or (mode == "hybrid" and d > 1):
            # hybrid is single-device only; a meshed run over the sharded
            # budget streams (and says so)
            if mode == "hybrid":
                print(f"device cache for {dataset}/{subset}: dataset exceeds even the "
                      f"mesh-sharded budget; streaming")
            caches[dataset] = None
            return None
        try:
            if mode == "full":
                cache = DeviceCache(ld, device=self.device, mesh=self.mesh)
            else:
                print(f"device cache for {dataset}/{subset}: partial — {rows}/{len(ld.source)} "
                      f"rows cached ({100 * rows // len(ld.source)}%), remainder streams")
                cache = HybridCache(ld, rows, device=self.device)
        except Exception as e:  # e.g. the card's memory: stream this dataset
            print(f"device cache for {dataset}/{subset} disabled: {e}")
            cache = None
        if d > 1:  # a mesh cache takes every rank in every batch: all build it, or none
            ok = torch.tensor([cache is not None], dtype=torch.int32, device=self.device)
            if not all_reduce_(ok, self.mesh, dist.ReduceOp.MIN).item() and cache is not None:
                print(f"device cache for {dataset}/{subset} disabled: another rank's failed")
                cache = None
        if cache is not None:
            self._cache_budget -= cache_bytes(rows, ld.height, ld.width) // d
        caches[dataset] = cache
        return cache

    def _weight(self, dataset: str) -> np.ndarray:
        nc = self.cfg.num_classes[self.cfg.datasets.index(dataset)]
        if dataset in CLASS_WEIGHTS and len(CLASS_WEIGHTS[dataset]) == nc:
            return CLASS_WEIGHTS[dataset]
        # a non-standard class count (synthetic runs) or no precomputed table
        # (IDD_union / VOC12): uniform weights, the ignore class zeroed
        if dataset not in CLASS_WEIGHTS:
            print(f"note: no precomputed class-weight table for '{dataset}'; training with "
                  f"uniform weights (ignore class zeroed)")
        w = np.ones(nc, np.float32)
        w[-1] = 0.0
        return w

    def _lr_tree(self) -> dict[str, float]:
        cfg, model = self.cfg, self.ts.model
        if cfg.protocol in RAP_PROTOCOLS:
            kw = dict(current_task=cfg.current_task, shared_lr=cfg.shared_lr_value(),
                      ds_lr=cfg.lr)
            if cfg.model in ABLATION_MODELS:
                return ablation_lr_tree(model, variant=REFERENCE_NAMES[cfg.model], **kw)
            return rap_lr_tree(model, **kw)
        if cfg.protocol in ("multitask", "singletask"):
            return multihead_lr_tree(model, encoder_lr=cfg.shared_lr_value(), decoder_lr=cfg.lr)
        # ft / fe: the old heads frozen; the encoder trains only in ft
        dec_lrs = [0.0] * len(cfg.datasets)
        dec_lrs[cfg.current_task] = cfg.lr
        return multihead_lr_tree(model, encoder_lr=cfg.lr if cfg.protocol == "ft" else 0.0,
                                 decoder_lrs=dec_lrs)

    def _build_steps(self):
        cfg = self.cfg
        kld_fn = kld_faithful if cfg.kld == "faithful" else kld_corrected
        cur = cfg.current_task
        cur_ds = cfg.datasets[cur]
        common = dict(lr_tree=self._lr_tree(), num_epochs=cfg.num_epochs,
                      weight_decay=cfg.weight_decay, iou_train=cfg.iou_train,
                      compute_dtype=cfg.compute_dtype, remat=cfg.remat, mesh=self.mesh)
        prev = tuple(range(cur - 1, -1, -1))  # newest to oldest, the reference's order
        distill = dict(current_task=cur, prev_tasks=prev, class_weight=self._weight(cur_ds),
                       lambda_c=cfg.lambda_c, kld_fn=kld_fn, remat_prev=cfg.remat, **common)
        # one train step per trained domain: the current one, or every domain (multitask)
        if cfg.protocol == "multitask":
            self.train_steps = {
                d: steps.make_ce_step(task=t, class_weight=self._weight(d), **common)
                for t, d in enumerate(cfg.datasets)}
        elif cfg.protocol in ("step1",) + MULTIHEAD_PROTOCOLS:
            self.train_steps = {cur_ds: steps.make_ce_step(
                task=cur, class_weight=self._weight(cur_ds), **common)}
        elif cfg.protocol == "step2" or not cfg.two_phase:
            self.train_steps = {cur_ds: steps.make_distill_step(**distill)}
        else:
            self.train_steps = {cur_ds: steps.make_two_phase_distill_step(
                teacher_dropout=cfg.teacher_dropout, **distill)}
        self.eval_steps = {
            d: steps.make_eval_step(task=t, class_weight=self._weight(d),
                                    num_classes=cfg.num_classes[t],
                                    compute_dtype=cfg.compute_dtype, mesh=self.mesh)
            for t, d in enumerate(cfg.datasets)
        }

    # ------------------------------------------------------------------
    def _try_resume(self):
        ckpt_dir = os.path.join(self.cfg.savedir, "ckpt")
        if torch_io.latest_epoch(ckpt_dir) is None:
            print("resume requested but no checkpoint found; starting fresh")
            return
        self.ts, epoch, self.best_acc, aug_state = torch_io.restore(ckpt_dir, self.ts)
        self.aug_gen.set_state(aug_state)
        self.start_epoch = epoch + 1
        print(f"resumed from epoch {epoch} (best_acc {self.best_acc:.4f})")

    def _save(self, subdir: str, epoch: int) -> None:
        """Rank 0 writes the checkpoint; the mesh waits for it."""
        if self._writer:
            torch_io.save(os.path.join(self.cfg.savedir, subdir), epoch, self.ts,
                          best_acc=self.best_acc, aug_state=self.aug_gen.get_state())
        barrier(self.mesh)

    # ------------------------------------------------------------------
    def _train_batches(self, dataset: str, epoch: int):
        """`dataset`'s training batches of `epoch` on the device:
        (images uint8, labels uint8, valid)."""
        cache = self._cache_for(dataset, "train")
        if cache is not None:
            return cache.epoch_batches(epoch)
        ld = self.train_loaders[dataset]
        ld.set_epoch(epoch)
        return device_prefetch(ld, device=self.device)

    def train_epoch(self, epoch: int) -> dict:
        cfg = self.cfg
        t0 = time.time()
        # the dropout-mask RNG is (seed, epoch)-keyed: a resumed run draws the
        # same mask stream an uninterrupted run draws for this epoch
        self._np_rng = np.random.default_rng((cfg.seed + 1, epoch))
        losses = {k: [] for k in ("loss", "ce", "kld")}
        cms = {d: [] for d in cfg.datasets}
        if cfg.protocol == "multitask":
            # the domains in turn, one batch each, over the shortest domain's batches
            iters = {d: iter(self._train_batches(d, epoch)) for d in cfg.datasets}
            try:
                for _ in range(min(len(ld) for ld in self.train_loaders.values())):
                    for t, d in enumerate(cfg.datasets):
                        imgs, lbls, _ = next(iters[d])
                        self._one_batch(d, t, imgs, lbls, epoch, losses, cms[d])
            finally:
                for it in iters.values():
                    it.close()
        else:
            cur = cfg.current_task
            d = cfg.datasets[cur]
            for imgs, lbls, _ in self._train_batches(d, epoch):
                self._one_batch(d, cur, imgs, lbls, epoch, losses, cms[d])
        # the epoch's device scalars are reduced on the device and fetched
        # once per key here, not once per batch
        out = {f"train_{k}": torch.stack(v).mean().item() for k, v in losses.items() if v}
        ious = []
        for t, d in enumerate(cfg.datasets):
            if not cms[d]:
                continue
            nc = cfg.num_classes[t]
            ev = IoUEvaluator(nc, nc - 1)
            ev.add_confusion(torch.stack(cms[d]).sum(0))
            if ev._cm.sum():
                iou, _ = ev.get_iou()
                out[f"train_iou_{d}"] = iou
                ious.append(iou)
        if ious:
            out["train_iou"] = float(np.mean(ious))
        out["epoch_seconds"] = time.time() - t0
        return out

    def _one_batch(self, dataset: str, task: int, imgs, lbls, epoch: int, losses: dict,
                   cms: list):
        cfg = self.cfg
        self._tracer.tick()
        with span("batch"):
            # the global batch's draws on every rank, this rank's images of them,
            # augmented whole (a translate moves rows across the slabs), then its rows
            n = imgs.shape[0] * (self.mesh.data if active(self.mesh) else 1)
            flip, tx, ty = (shard_rows(t, self.mesh)
                            for t in transforms.draw_augment(self.aug_gen, n))
            x, y = transforms.augment_batch(imgs, lbls, flip, tx, ty,
                                            num_classes=cfg.num_classes[task],
                                            out_dtype=steps.compute_dtype_of(cfg.compute_dtype))
            x, y = shard_height(x, self.mesh, 1), shard_height(y, self.mesh, 1)
            step = self.train_steps[dataset]
            if cfg.protocol in ("step2", "step3"):
                n_fwd = 1 + cfg.current_task
                if cfg.protocol == "step3" and cfg.two_phase and cfg.teacher_dropout:
                    # the teacher's forwards draw their own masks, after the student's
                    n_fwd += cfg.current_task
                masks = [self._dropout_masks(n) for _ in range(n_fwd)]
                self.ts, m = step(self.ts, self.teacher, x, y, masks, epoch)
            else:
                self.ts, m = step(self.ts, x, y, self._dropout_masks(n), epoch)
            # device scalars until the epoch's end: reading one here would wait
            # for the step every batch
            for k in losses:
                if k in m:
                    losses[k].append(m[k])
            if "cm" in m:
                cms.append(m["cm"])
            # bounded pipeline: every 16 steps, read the loss saved at the
            # previous sync point (long finished), so at most ~32 steps are queued
            # and the device never waits for the host
            self._step_count += 1
            if self._step_count % 16 == 0:
                if self._sync_loss is not None:
                    with span("wait.pipeline"):
                        self._sync_loss.item()
                self._sync_loss = m["loss"]

    def evaluate(self, dataset: str, epoch: int) -> tuple[float, float]:
        """(mean val loss, val mIoU) of one domain."""
        t = self.cfg.datasets.index(dataset)
        nc = self.cfg.num_classes[t]
        estep = self.eval_steps[dataset]
        cache = self._cache_for(dataset, "val")
        batches = (cache.epoch_batches(0, shuffle=False) if cache is not None
                   else device_prefetch(self.val_loaders[dataset], device=self.device))
        losses, cms = [], []
        for imgs, lbls, valid in batches:
            with span("batch"):
                x, y = transforms.prepare_batch(imgs, lbls, num_classes=nc)
                # padded images -> all-ignore labels: they count in neither CE nor IoU
                valid = torch.as_tensor(valid).to(self.device, non_blocking=True)
                y = torch.where(valid[:, None, None], y, nc - 1)
                loss, cm = estep(self.ts.model, shard_height(x, self.mesh, 1),
                                 shard_height(y, self.mesh, 1))
                losses.append(loss)
                cms.append(cm)
                if len(cms) % 16 == 0 and len(cms) >= 32:
                    with span("wait.pipeline"):
                        losses[-17].item()  # lagged sync: bounds the queued batches
        if not cms:
            return 0.0, 0.0
        ev = IoUEvaluator(nc, nc - 1)
        ev.add_confusion(torch.stack(cms).sum(0))
        miou, _ = ev.get_iou()
        return torch.stack(losses).mean().item(), miou

    # ------------------------------------------------------------------
    def fit(self, stop_after: int | None = None) -> dict:
        """Run the epoch loop from `start_epoch`. `stop_after` ends the run
        after that epoch's checkpoint is written (an interruption; the LR
        schedule is keyed to cfg.num_epochs, so a resume must use the same
        config). Under torchrun every rank returns rank 0's result."""
        if not self.mesh.member:
            return broadcast_object(None, self.mesh)
        cfg = self.cfg
        cur_ds = cfg.datasets[cfg.current_task]
        history = {}
        for epoch in range(self.start_epoch, cfg.num_epochs + 1):
            row = dict(epoch=epoch, **self.train_epoch(epoch))

            # the final epoch always evaluates, so a run shorter than the
            # cadence still writes best/
            evaluated = epoch % cfg.eval_every == 0 or epoch == cfg.num_epochs
            if evaluated:
                val_loss, val_iou = self.evaluate(cur_ds, epoch)
                row[f"val_loss_{cur_ds}"] = val_loss
                row[f"val_acc_{cur_ds}"] = val_iou
                if self._writer:
                    print(f"epoch {epoch}: val {cur_ds} IoU "
                          f"{getColorEntry(val_iou)}{val_iou * 100:.2f}\033[0m%")
            else:
                val_loss, val_iou = 0.0, 0.0

            if cfg.protocol in OLD_EVAL_PROTOCOLS and epoch % cfg.eval_old_every == 0:
                for d in cfg.datasets:
                    if d != cur_ds:
                        row[f"val_loss_{d}"], row[f"val_acc_{d}"] = self.evaluate(d, epoch)

            # only evaluated epochs compete for best, as the reference compares
            # val-IoU epochs only (train_RAPFT_step1.py:347-352); multitask's
            # is the mean val IoU over the domains validated this epoch
            # (train_multi_task.py:304-308)
            if not evaluated:
                current_acc = None
            elif cfg.protocol == "multitask":
                accs = [v for k, v in row.items() if k.startswith("val_acc_")]
                current_acc = float(np.mean(accs))
            else:
                current_acc = val_iou if val_iou != 0 else -val_loss
            is_best = current_acc is not None and current_acc > self.best_acc
            if is_best:
                self.best_acc = current_acc

            # the optimizer's LRs this epoch; the automated_log column carries
            # the DS group's, the last param group the reference's usedLr loop
            # ends on (train_RAPFT_step1.py:274-276)
            poly = poly_lr_factor(epoch, cfg.num_epochs)
            row["lr_ds"] = cfg.lr * poly
            row["lr_shared"] = cfg.shared_lr_value() * poly

            if self._writer:
                self.logger.log(row)
                self.logger.automated_log_row(
                    epoch, row.get("train_loss", 0.0), row.get(f"val_loss_{cur_ds}", 0.0),
                    row.get("train_iou", 0.0), row.get(f"val_acc_{cur_ds}", 0.0), row["lr_ds"])
            self._save("ckpt", epoch)
            if is_best:
                if self._writer:
                    with open(os.path.join(cfg.savedir, "best.txt"), "w") as f:
                        f.write(f"Best epoch is {epoch}, with Val-IoU= {current_acc:.4f}")
                self._save("best", epoch)
            history = row
            if stop_after is not None and epoch >= stop_after:
                break
        self._tracer.stop()
        return broadcast_object(history, self.mesh)
