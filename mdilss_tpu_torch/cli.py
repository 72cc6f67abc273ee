"""Command-line interface: `python -m mdilss_tpu_torch <command> ...` (port of
mdilss_tpu/cli.py, with its command names, options and defaults).

  step1 / step2 / step3  the RAP protocol's steps (train_RAPFT_step1.py,
                         train_new_task_step2.py, train_new_task_step3.py), of
                         ERFNet-RAP or (--model) one of the four ablation models
                         or segformer_b5_rap (SegFormer-B5, per-domain LayerNorms,
                         adapters and heads; `eval --kind segformer_b5_rap`)
  multitask / single / ft  the baselines (train_multi_task.py; the single-task
                         ERFNet; main_ftp1_enc_newbn.py / main_FT2_flexible_new.py)
  pipeline               step1 -> step2 -> step3 [+ the baselines] through
                         <savedir>/<stage>/best (trainer_OURS.sh:49-63)
  eval                   per-domain mIoU of a checkpoint (Evaluation_Notebook)
  convert                .pth.tar -> a checkpoint directory of the port, and back
                         with --export
  weights                class weights over train labels (cal_class_weights.py)
  parity-check           every recorded setting of expected_miou.json from a
                         checkpoint directory, one pass/fail JSON report
  tsne / predict         latent-space t-SNE plot, colorized prediction maps
                         (the reference's notebooks)
  export                 per-head serving artifacts (torch.export, .pt2 per
                         platform: cuda, cpu)

Deviations from the JAX package's CLI: `--device {cuda,cpu}` (default cuda;
without a card it raises) in place of `--platform`; no
`--compilation-cache` (XLA's); each `--data-root NAME=PATH` is checked and a
bad one exits with a usage message naming it; `export --platforms` takes cuda
and cpu (a torch.export program is traced on one device) and defaults to
cuda. `bench` exits non-zero naming the port's benchmark, `python3
benchmark/run.py` (JAX's `--bench-*` options have no counterpart). An ablation
`--kind` reads the port's checkpoint directories only (those models have no
torch grammar), and exits naming that for anything else.

Sharded training: the JAX package's single process takes every visible
device (its ('data', 'spatial') mesh); the port takes one process per card,
launched by torchrun, e.g. `python -m torch.distributed.run --standalone
--nproc_per_node 8 -m mdilss_tpu_torch step2 --spatial-shards 2 ...`. The
training commands and `pipeline` then build the mesh from the environment
(`parallel.make_mesh`: NCCL on cuda:LOCAL_RANK, or gloo with `--device
cpu`): `--spatial-shards S` must divide the processes (JAX's error), each
image's rows split over S of them (the height a multiple of 8 S) and the
batch over gcd(batch, processes / S); rank 0 writes the run's files and
prints the result line, and every rank trains the same weights. A plain
`python -m mdilss_tpu_torch` trains on one card, where `--spatial-shards`
other than 1 raises JAX's error.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from . import config as C
from .models.erfnet_multihead import KINDS as MULTIHEAD_KINDS

DEVICES = ("cuda", "cpu")
_CKPT_KINDS = ("rap", *MULTIHEAD_KINDS)  # the kinds with a reference state-dict grammar
_KINDS = _CKPT_KINDS + C.ABLATION_MODELS
# the reference step-1 trainer's model factory (train_RAPFT_step1.py:451-460), and
# SegFormer-B5 with ERFNet-RAP's incremental rule
_MODELS = ("erfnet_RA_parallel", *C.ABLATION_MODELS, *C.SEGFORMER_MODELS)
_BENCH = ("bench: the port's benchmark is `python3 benchmark/run.py --workload NAME --seed N "
         "--seconds S --trace 0|1`, run from the root of a checkout (`--list` names its "
         "cells); the JAX package's --bench-* options have no counterpart")


def _name_path(kv: str) -> tuple[str, str]:
    name, sep, path = kv.partition("=")
    if not (sep and name and path):
        raise argparse.ArgumentTypeError(
            f"{kv!r}: expected NAME=PATH, e.g. cityscapes=/data/cityscapes")
    return name, path


def _add_data_root(p: argparse.ArgumentParser, **kw) -> None:
    p.add_argument("--data-root", action="append", default=[], metavar="NAME=PATH",
                   type=_name_path, **kw)


def _add_device(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", choices=DEVICES, default="cuda",
                   help="run on the CUDA card (default; raises without one) or on the "
                        "CPU's plain versions")


def _add_common(p: argparse.ArgumentParser):
    _add_device(p)
    p.add_argument("--savedir", default="runs/dev")
    p.add_argument("--state", help="init checkpoint (.pth.tar or a checkpoint directory)")
    p.add_argument("--num-epochs", type=int, default=150)
    p.add_argument("--batch-size", type=int, default=6)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--width", type=int, default=1024)
    p.add_argument("--lr", type=float, default=5e-4)
    p.add_argument("--shared-lr", type=float, default=None)
    p.add_argument("--lambdac", type=float, default=0.1)
    p.add_argument("--kld", choices=("faithful", "corrected"), default="faithful")
    p.add_argument("--num-workers", type=int, default=8)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--iou-train", action="store_true",
                   help="compute train IoU in the train step (reference --iouTrain)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--remat", action="store_true",
                   help="recompute the training forwards' activations in the backward instead "
                        "of keeping them: less device memory, more compute, the same result")
    p.add_argument("--fused-train", action="store_true",
                   help="accepted: the training blocks always run the fused kernels on the card")
    p.add_argument("--no-device-cache", action="store_true",
                   help="disable the device-resident uint8 dataset cache")
    p.add_argument("--spatial-shards", type=int, default=1,
                   help="shard each image's rows over this many processes (under torchrun; "
                        "must divide the process count, and 8x it the height)")
    p.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32",
                   help="compute type of the forwards (bfloat16: bf16 activations and "
                        "kernels; parameters, optimizer state and losses stay float32)")
    p.add_argument("--synthetic", action="store_true", help="synthetic data smoke run")
    p.add_argument("--synthetic-size", type=int, default=24)
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler chrome trace of a few train steps here, "
                        "the program's spans over it")
    _add_data_root(p, help="dataset root, e.g. --data-root cityscapes=/data/cs (repeatable)")


def _common_kwargs(args) -> dict:
    return dict(
        savedir=args.savedir, state=args.state, num_epochs=args.num_epochs,
        batch_size=args.batch_size, height=args.height, width=args.width,
        lr=args.lr, shared_lr=args.shared_lr, lambda_c=args.lambdac, kld=args.kld,
        num_workers=args.num_workers, resume=args.resume, seed=args.seed,
        iou_train=args.iou_train, remat=args.remat, compute_dtype=args.dtype,
        synthetic=args.synthetic, fused_train=args.fused_train,
        device_cache="off" if args.no_device_cache else "auto",
        synthetic_size=args.synthetic_size, data_roots=dict(args.data_root),
        profile_dir=args.profile_dir, spatial_shards=args.spatial_shards,
    )


def _add_analysis_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("ckpt")
    p.add_argument("--kind", choices=_KINDS, default="rap")
    p.add_argument("--dataset", default="cityscapes")
    p.add_argument("--subset", default="val")
    p.add_argument("--task", type=int, default=0)
    p.add_argument("--num-classes", type=int, nargs="+", default=None)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--width", type=int, default=1024)
    p.add_argument("--synthetic", action="store_true")
    _add_data_root(p)
    _add_device(p)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="mdilss_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p1 = sub.add_parser("step1", help="RAP-FT step 1 on Cityscapes")
    p1.add_argument("--pretrained-encoder", help="ImageNet encoder .pth.tar")
    p1.add_argument("--model", choices=_MODELS, default="erfnet_RA_parallel")
    _add_common(p1)

    p2 = sub.add_parser("step2", help="incremental step 2 with distillation")
    p2.add_argument("--order", choices=("CS_BDD", "CS_IDD"), default="CS_BDD")
    p2.add_argument("--model", choices=_MODELS, default="erfnet_RA_parallel")
    _add_common(p2)

    p3 = sub.add_parser("step3", help="incremental step 3 (two KLD terms)")
    p3.add_argument("--order", choices=("CS_BDD_IDD", "CS_IDD_BDD"), default="CS_BDD_IDD")
    p3.add_argument("--single-phase", action="store_true",
                    help="fused single-backward variant instead of the faithful two-phase step")
    p3.add_argument("--teacher-dropout", action="store_true",
                    help="live Dropout2d on the teacher's KD forwards (the reference's "
                         "train-mode model_old)")
    p3.add_argument("--model", choices=_MODELS, default="erfnet_RA_parallel")
    _add_common(p3)

    pm = sub.add_parser("multitask", help="joint multi-task baseline")
    pm.add_argument("--pretrained-encoder", help="ImageNet encoder .pth.tar (the reference "
                    "passes it as --state, train_multi_task.py:414-423)")
    _add_common(pm)

    ps = sub.add_parser("single", help="independent single-task ERFNet baseline")
    ps.add_argument("--dataset", default="cityscapes",
                    choices=("cityscapes", "BDD", "IDD", "IDD_union", "VOC12"))
    ps.add_argument("--pretrained-encoder", help="ImageNet encoder .pth.tar "
                    "(main.py --pretrainedEncoder, trainer_single_task.sh:46)")
    _add_common(ps)

    pf = sub.add_parser("ft", help="fine-tuning baselines (2 or 3 heads)")
    pf.add_argument("--heads", type=int, choices=(2, 3), default=None)
    pf.add_argument("--order", choices=tuple(sorted(C.FT_ORDERS)), default=None,
                    help="domain chain (last = the domain being fine-tuned); defaults "
                         "to CS_BDD (2 heads) / CS_BDD_IDD (3 heads)")
    pf.add_argument("--feature-extraction", action="store_true",
                    help="train only the new head (FE) instead of encoder+head (FT)")
    _add_common(pf)

    pl = sub.add_parser("pipeline", help="chain step1 -> step2 -> step3 through "
                        "<savedir>/<stage>/best (trainer_OURS.sh:49-63 as one command)")
    pl.add_argument("--order", choices=("CS_BDD_IDD", "CS_IDD_BDD"), default="CS_BDD_IDD")
    pl.add_argument("--pretrained-encoder", help="ImageNet encoder .pth.tar for step 1 "
                    "and the baselines")
    pl.add_argument("--with-baselines", action="store_true",
                    help="also run the single -> ft chain and the joint multitask baseline")
    pl.add_argument("--stages", nargs="+", default=["step1", "step2", "step3"],
                    choices=("step1", "step2", "step3"))
    _add_common(pl)

    pe = sub.add_parser("eval", help="evaluate a checkpoint per domain")
    pe.add_argument("ckpt")
    pe.add_argument("--kind", choices=_KINDS + tuple(C.SEGFORMER_MODELS), default="rap")
    pe.add_argument("--datasets", nargs="+", default=["cityscapes", "BDD", "IDD"])
    pe.add_argument("--num-classes", type=int, nargs="+", default=None,
                    help="per-head class counts (default: read from the checkpoint's heads)")
    pe.add_argument("--batch-size", type=int, default=1)
    pe.add_argument("--height", type=int, default=512)
    pe.add_argument("--width", type=int, default=1024)
    pe.add_argument("--synthetic", action="store_true")
    _add_data_root(pe)
    pe.add_argument("--expect", metavar="SETTING", default=None,
                    help="compare against the reference record (expected_miou.json, e.g. "
                         "step3_CS_BDD_IDD); exits nonzero when a domain deviates beyond "
                         "--expect-tol")
    pe.add_argument("--expect-tol", type=float, default=0.5,
                    help="tolerance in mIoU percentage points (default 0.5)")
    pe.add_argument("--f64", action="store_true",
                    help="float64 forward on the CPU's plain path (needs --device cpu)")
    _add_device(pe)

    pt = sub.add_parser("tsne", help="latent-space t-SNE plot (Plot_Tsne_Notebook)")
    _add_analysis_common(pt)
    pt.add_argument("--which", choices=("encoder", "penultimate", "logits"), default="encoder")
    pt.add_argument("--out", default="tsne_plots/tsne.png")
    pt.add_argument("--n-samples", type=int, default=20000)
    pt.add_argument("--first-image", action="store_true",
                    help="use the first val image instead of the notebook's 17-unique-labels "
                         "diversity pick")

    pp = sub.add_parser("predict", help="write colorized prediction maps")
    _add_analysis_common(pp)
    pp.add_argument("--out-dir", default="predictions")
    pp.add_argument("--max-images", type=int, default=None)
    pp.add_argument("--save-gt", action="store_true")

    pw = sub.add_parser("weights", help="compute class weights over train labels "
                                        "(cal_class_weights.py workflow)")
    pw.add_argument("--dataset", default="cityscapes")
    pw.add_argument("--subset", default="train")
    pw.add_argument("--q", type=float, default=1.1,
                    help="w = 1/ln(q + p); reference used 1.1 (decoder), 1.2 (encoder)")
    pw.add_argument("--height", type=int, default=512)
    pw.add_argument("--width", type=int, default=1024)
    pw.add_argument("--max-images", type=int, default=None)
    _add_data_root(pw)

    px = sub.add_parser("export", help="per-head self-contained serving artifacts "
                        "(torch.export; weights in the file, no model code needed to serve)")
    px.add_argument("ckpt", help=".pth.tar or a checkpoint directory")
    px.add_argument("out_dir")
    px.add_argument("--kind", choices=_KINDS, default="rap")
    px.add_argument("--num-classes", type=int, nargs="+", default=None,
                    help="per-head class counts (default: read from the checkpoint's heads)")
    px.add_argument("--tasks", type=int, nargs="+", default=None,
                    help="head indices to export (default: all)")
    px.add_argument("--batch-size", type=int, default=1,
                    help="0 exports a symbolic batch dimension")
    px.add_argument("--height", type=int, default=512)
    px.add_argument("--width", type=int, default=1024)
    px.add_argument("--output", choices=("logits", "labels"), default="logits",
                    help="'labels' bakes the argmax in (int32 maps)")
    px.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16")
    px.add_argument("--platforms", nargs="+", choices=DEVICES, default=["cuda"],
                    help="one artifact per head per platform, traced on that device")

    py = sub.add_parser("parity-check", help="evaluate ALL recorded reference settings "
                        "(expected_miou.json) from a checkpoint directory and emit one "
                        "pass/fail JSON report")
    py.add_argument("ckpt_root", help="directory holding the checkpoints (optionally with a "
                    "parity_manifest.json)")
    _add_data_root(py)
    py.add_argument("--settings", nargs="+", default=None,
                    help="subset of settings (default: all nine)")
    py.add_argument("--tol", type=float, default=0.5,
                    help="per-domain tolerance in mIoU points (default 0.5)")
    py.add_argument("--out", default=None, help="also write the report JSON here")
    py.add_argument("--synthetic", action="store_true",
                    help="dry-run the full command path on synthetic sources (every gate "
                         "then fails; for testing the runbook)")
    py.add_argument("--batch-size", type=int, default=1)
    py.add_argument("--height", type=int, default=512)
    py.add_argument("--width", type=int, default=1024)
    py.add_argument("--f64", action="store_true",
                    help="float64 forward on the CPU's plain path (needs --device cpu)")
    _add_device(py)

    pc = sub.add_parser("convert", help="a .pth.tar -> a checkpoint directory of this "
                                        "package, or back with --export")
    pc.add_argument("src")
    pc.add_argument("dst")
    pc.add_argument("--kind", default="rap", choices=_CKPT_KINDS)
    pc.add_argument("--nb-tasks", type=int, default=1,
                    help="tasks to keep of a rap or multi_task file (the first ones)")
    pc.add_argument("--num-classes", type=int, nargs="+", default=None,
                    help="per-task class counts (export direction; default: read from the "
                         "checkpoint's heads)")
    pc.add_argument("--export", action="store_true",
                    help="reverse direction: a checkpoint directory -> a reference-format "
                         ".pth.tar")

    sub.add_parser("bench", help="names the port's benchmark, benchmark/run.py, and exits")
    return parser


def _eval(parser, args) -> None:
    from .evaluate import check_expected, evaluate_checkpoint

    if args.f64 and args.device != "cpu":
        parser.error("eval --f64 runs on the CPU's plain path: add --device cpu")
    results = evaluate_checkpoint(
        args.ckpt, kind=args.kind, datasets=args.datasets, num_classes=args.num_classes,
        data_roots=dict(args.data_root), batch_size=args.batch_size, height=args.height,
        width=args.width, synthetic=args.synthetic,
        compute_dtype="float64" if args.f64 else "float32", device=args.device,
    )
    print(json.dumps({k: round(v, 4) for k, v in results.items()}))
    if args.expect:
        ok, report = check_expected(results, args.expect, tolerance_points=args.expect_tol)
        print(report)
        if not ok:
            raise SystemExit(1)


def _parity_check(parser, args) -> None:
    from .parity import run_parity_check

    if args.f64 and args.device != "cpu":
        parser.error("parity-check --f64 runs on the CPU's plain path: add --device cpu")
    report = run_parity_check(
        args.ckpt_root, data_roots=dict(args.data_root), settings=args.settings,
        tolerance_points=args.tol, synthetic=args.synthetic, batch_size=args.batch_size,
        height=args.height, width=args.width,
        compute_dtype="float64" if args.f64 else "float32", device=args.device,
    )
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
    print(json.dumps(report))
    if not report["ok"]:
        raise SystemExit(1)


def _analysis(args) -> None:
    """tsne / predict: head --task of a checkpoint over --dataset (or synthetic data)."""
    from .analysis.names import NAMES_BY_DATASET
    from .data.loader import SyntheticSource
    from .data.sources import make_source
    from .evaluate import infer_num_classes, load_checkpoint

    roots = dict(args.data_root)
    if args.num_classes is None:
        args.num_classes = infer_num_classes(args.ckpt)
        print(f"inferred num_classes {args.num_classes} from {args.ckpt}")
    nc = args.num_classes[args.task]
    model = load_checkpoint(args.ckpt, kind=args.kind, num_classes=args.num_classes,
                            device=args.device)
    if args.synthetic or args.dataset not in roots:
        source = SyntheticSource(nc, n=8, height=args.height, width=args.width)
    else:
        source = make_source(args.dataset, roots[args.dataset], args.subset)
    kw = dict(task=args.task, num_classes=nc, height=args.height, width=args.width,
              device=args.device)
    if args.cmd == "tsne":
        from .analysis.tsne import run_tsne

        out = run_tsne(
            model, source, out_path=args.out, which=args.which, n_samples=args.n_samples,
            class_names=NAMES_BY_DATASET.get(args.dataset, NAMES_BY_DATASET["cityscapes"]),
            select=(lambda labels, n: True) if args.first_image else None, **kw,
        )
        print(json.dumps({"image": out["image"], "plot": out["plot"],
                          "n_points": int(len(out["labels"]))}))
    else:
        from .analysis.predict import save_predictions

        written = save_predictions(model, source, out_dir=args.out_dir,
                                   max_images=args.max_images, save_gt=args.save_gt, **kw)
        print(json.dumps({"written": len(written), "out_dir": args.out_dir}))


def _export(args) -> None:
    from .serving import export_checkpoint

    meta = export_checkpoint(
        args.ckpt, kind=args.kind, num_classes=args.num_classes, out_dir=args.out_dir,
        tasks=args.tasks, height=args.height, width=args.width,
        batch_size=args.batch_size or None, output=args.output, compute_dtype=args.dtype,
        platforms=tuple(args.platforms),
    )
    print(json.dumps(meta))


def _weights(parser, args) -> None:
    from .data.class_weights import compute_class_weights
    from .data.sources import make_source
    from .data.transforms import decode_pair

    roots = dict(args.data_root)
    if args.dataset not in roots:
        parser.error(f"weights --dataset {args.dataset} needs --data-root {args.dataset}=PATH")
    source = make_source(args.dataset, roots[args.dataset], args.subset)
    pairs = source.pairs[: args.max_images]

    def labels():
        for ip, lp in pairs:
            yield decode_pair(ip, lp, height=args.height, width=args.width,
                              label_map=source.label_map)[1]

    w = compute_class_weights(labels(), source.num_classes, q=args.q)
    print(json.dumps({"dataset": args.dataset, "n_images": len(pairs),
                      "weights": [round(float(v), 6) for v in w]}))


def _convert(args) -> None:
    import torch

    from .ckpt import torch_io
    from .evaluate import infer_num_classes, load_checkpoint

    if args.export:
        # a checkpoint directory -> the reference's checkpoint dict
        # (train_RAPFT_step1.py:364-370) with DataParallel's `module.` keys
        ncls = args.num_classes or infer_num_classes(args.src)
        model = load_checkpoint(args.src, kind=args.kind, num_classes=ncls, device="cpu")
        torch.save({"epoch": 0, "arch": args.kind,
                    "state_dict": {"module." + k: v for k, v in model.state_dict().items()},
                    "best_acc": 0.0, "optimizer": {}}, args.dst)
    else:
        from .ckpt.surgery import keep_tasks
        from .models import ERFNetMultiHead, ERFNetRAP
        from .train.steps import init_train_state

        sd = torch_io.load_state(args.src, args.kind)
        if args.kind in ("rap", "multi_task"):
            sd = keep_tasks(sd, args.nb_tasks)
        ncls = torch_io.heads_num_classes(sd, args.src)
        model = (ERFNetRAP(ncls, len(ncls), device="cpu") if args.kind == "rap"
                 else ERFNetMultiHead(ncls, kind=args.kind, device="cpu"))
        model.load_state_dict(sd, strict=True)
        torch_io.save(args.dst, 0, init_train_state(model), best_acc=0.0,
                      aug_state=torch.Generator().get_state())
    print(f"converted {args.src} -> {args.dst}")


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)

    if args.cmd == "bench":
        raise SystemExit(_BENCH)
    if getattr(args, "kind", None) in C.ABLATION_MODELS and not os.path.isdir(args.ckpt):
        raise SystemExit(f"{args.cmd} --kind {args.kind}: {args.ckpt} is not a checkpoint "
                         f"directory of this package; the ablation models have no torch "
                         f"checkpoint grammar (no reference .pth.tar exists), so they load "
                         f"from the port's checkpoint directories (<savedir>/best) only")
    if args.cmd == "eval":
        return _eval(parser, args)
    if args.cmd == "parity-check":
        return _parity_check(parser, args)
    if args.cmd in ("tsne", "predict"):
        return _analysis(args)
    if args.cmd == "export":
        return _export(args)
    if args.cmd == "weights":
        return _weights(parser, args)
    if args.cmd == "convert":
        return _convert(args)

    import torch.distributed as dist

    from .train.protocols import build_trainer

    # the process group a run under torchrun makes (the Trainer's mesh) is left at its end
    joined = dist.is_initialized()
    kw = _common_kwargs(args)
    if args.cmd == "pipeline":
        from .train.pipeline import run_pipeline

        savedir = kw.pop("savedir")
        state = kw.pop("state")
        results = run_pipeline(
            order=args.order, savedir=savedir, common=kw, state=state,
            pretrained_encoder=args.pretrained_encoder, with_baselines=args.with_baselines,
            stages=tuple(args.stages), device=args.device,
        )
        _result({stage: {k: v for k, v in row.items() if isinstance(v, (int, float))}
                 for stage, row in results.items()}, leave=not joined)
        return
    if args.cmd == "step1":
        cfg = C.step1(pretrained_encoder=args.pretrained_encoder, model=args.model, **kw)
    elif args.cmd == "step2":
        cfg = C.step2(order=args.order, model=args.model, **kw)
    elif args.cmd == "step3":
        if args.teacher_dropout and args.single_phase:
            raise SystemExit("--teacher-dropout requires the faithful two-phase step "
                             "(drop --single-phase)")
        cfg = C.step3(order=args.order, two_phase=not args.single_phase,
                      teacher_dropout=args.teacher_dropout, model=args.model, **kw)
    elif args.cmd == "multitask":
        cfg = C.multitask(pretrained_encoder=args.pretrained_encoder, **kw)
    elif args.cmd == "single":
        cfg = C.singletask(dataset=args.dataset, pretrained_encoder=args.pretrained_encoder,
                           **kw)
    elif args.cmd == "ft":
        cfg = C.ft_step(n_heads=args.heads, order=args.order,
                        finetune=not args.feature_extraction, **kw)
    else:
        raise SystemExit(f"unknown command {args.cmd}")
    final = build_trainer(cfg, device=args.device).fit()
    _result({k: v for k, v in final.items() if isinstance(v, (int, float))}, leave=not joined)


def _result(row: dict, leave: bool) -> None:
    """Print the run's result line (rank 0 only under torchrun); `leave`: the
    run made the process group, and leaves it."""
    import torch.distributed as dist

    if not dist.is_initialized() or dist.get_rank() == 0:
        print(json.dumps(row))
    if leave and dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
