"""Shared CLI plumbing of the example mains (counterpart of
``bigdl_tpu/examples/common.py``): the flags every example takes, the
logging set-up and the flags' wiring into the ``Optimizer``.  The port
runs on one device, ``--device`` (default ``cuda``)."""

from __future__ import annotations

import argparse
import logging

import torch

_VISUALIZATION = "ROADMAP.md queue 1, item 13 (visualization)"


def _positive_int(s: str) -> int:
    n = int(s)
    if n <= 0:
        raise argparse.ArgumentTypeError(f"must be positive, got {n}")
    return n


def base_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("-f", "--folder", default=None,
                   help="dataset directory (omit with --synthetic)")
    p.add_argument("-b", "--batch-size", type=int, default=128)
    p.add_argument("-e", "--max-epoch", type=int, default=5)
    p.add_argument("-r", "--learning-rate", type=float, default=0.05)
    p.add_argument("--checkpoint", default=None,
                   help="directory for per-epoch checkpoints")
    p.add_argument("--keep-checkpoints", type=_positive_int, default=None,
                   metavar="N",
                   help="keep the newest N good checkpoint generations "
                        "(default: one overwritten checkpoint file)")
    p.add_argument("--state", default=None,
                   help="checkpoint file to resume from")
    p.add_argument("--summary-dir", default=None,
                   help="TensorBoard event-file directory (not ported "
                        "yet)")
    p.add_argument("--synthetic", type=_positive_int, default=None,
                   metavar="N",
                   help="train on N synthetic samples instead of files")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute with float32 master weights")
    p.add_argument("--cache-device", action="store_true",
                   help="cache the dataset in device memory")
    p.add_argument("--device-prefetch", type=_positive_int, default=None,
                   metavar="N",
                   help="stage batch N+1 on the device while step N runs")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("-q", "--quiet", action="store_true")
    return p


def setup(args, app_name: str):
    """Logging, and the refusal of what is not there: no dataset, and
    ``--summary-dir`` (the reference's TensorBoard summaries)."""
    logging.basicConfig(
        level=logging.WARNING if args.quiet else logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s - %(message)s")
    if not args.folder and args.synthetic is None:
        raise SystemExit(
            f"{app_name}: provide --folder DATA_DIR or --synthetic N")
    if args.summary_dir:
        raise NotImplementedError(
            f"--summary-dir is not ported yet ({_VISUALIZATION})")


def apply_common(opt, args):
    """Wire the flags every example shares into the Optimizer."""
    from bigdl_tpu_torch.optim import Trigger
    if args.bf16:
        opt.set_compute_dtype(torch.bfloat16)
    if args.checkpoint:
        opt.set_checkpoint(args.checkpoint, Trigger.every_epoch(),
                           keep_n=args.keep_checkpoints)
    if args.device_prefetch:
        opt.set_device_prefetch(args.device_prefetch)
    if args.state:
        opt.resume(args.state)
    return opt
