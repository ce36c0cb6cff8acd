"""Training-throughput CLI (counterpart of ``bigdl_tpu/examples/perf.py``,
``bigdl-tpu-perf``), for every model the reference offers: ``lenet``,
``resnet50``, ``inception-v1``, ``inception-v2``, ``vgg16``,
``transformer-lm`` and ``ptb-lstm``:

    python -m bigdl_tpu_torch.examples.perf --model lenet -b 256 \\
        --iterations 50
    python -m bigdl_tpu_torch.examples.perf --model inception-v1 -b 128 \\
        --bf16
    python -m bigdl_tpu_torch.examples.perf --model ptb-lstm -b 32 \\
        --seq-len 20 --vocab-size 10000 --hidden-size 200 --num-layers 2

    python -m bigdl_tpu_torch.examples.perf --model resnet50 --fused \\
        --bf16 -b 128 --image-size 224 --classes 1000
    python -m bigdl_tpu_torch.examples.perf --model transformer-lm \\
        --seq-len 2048 -b 8 --hidden-size 512 --num-layers 6 \\
        --num-heads 8 --vocab-size 32000 --bf16 --iterations 10 --epochs 4
    python -m bigdl_tpu_torch.examples.perf --int8-infer [--bf16]

Drives the port's ``Optimizer.optimize()`` on synthetic batches cached
on the device and prints one JSON line: records/s and ms/iteration from
the Optimizer's completion-to-completion window timings, the first
window (kernel build and warm-up) excluded, as the reference computes
them.  The reference's FLOP keys come from XLA's cost analysis, which
has no counterpart here yet (ROADMAP.md queue 1, item 10).  The modes
not ported yet raise ``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
from torch import nn

from bigdl_tpu_torch.dataset import DataSet, MiniBatch
from bigdl_tpu_torch.models import (Inception_v1, Inception_v2, LeNet5,
                                    PTBModel, Vgg_16, resnet50,
                                    transformer_lm)
from bigdl_tpu_torch.nn.criterion import ClassNLLCriterion, \
    CrossEntropyCriterion
from bigdl_tpu_torch.optim import SGD, Optimizer, Trigger

__all__ = ["MODELS", "FlatLM", "build", "parse_args", "train",
           "bench_int8_inference", "main"]

MODELS = ("lenet", "resnet50", "inception-v1", "inception-v2", "vgg16",
          "transformer-lm", "ptb-lstm")

# (flag, its parsed default, the ROADMAP item of the mode it selects)
_MODES = (
    ("input_pipeline", None, "ROADMAP.md queue 1, item 13 (the edges: "
     "dataset loaders)"),
    ("real_jpeg_train", 0, "ROADMAP.md queue 1, item 13 (the edges: "
     "dataset loaders)"),
    ("generate", 0, "ROADMAP.md queue 1, item 6 (GPU measurement "
     "harness)"),
)


class FlatLM(nn.Module):
    """Wraps a [B, T, V]-output LM to emit [B*T, V] for the flat-target
    criteria (the reference's ``_flat_lm``; the submodule is named
    ``lm`` as there, so reference weights load by name)."""

    def __init__(self, lm):
        super().__init__()
        self.lm = lm

    def forward(self, x):
        out = self.lm(x)
        return out.reshape(-1, out.shape[-1])


def build(name: str, args):
    """→ (model, criterion, make_batch(batch_size) → (x, y)); synthetic
    batches from ``numpy.random.default_rng(0)``, as the reference makes
    them."""
    rng = np.random.default_rng(0)
    gen = dict(generator=torch.Generator().manual_seed(0),
               device=args.device)
    size = args.image_size

    def image_batch(b):
        return (rng.normal(size=(b, size, size, 3)).astype(np.float32),
                rng.integers(1, args.classes + 1, size=(b,)))

    if name == "lenet":
        def mnist_batch(b):
            return (rng.normal(size=(b, 28, 28, 1)).astype(np.float32),
                    rng.integers(1, 11, size=(b,)))
        return LeNet5(10, **gen), ClassNLLCriterion(), mnist_batch
    if name == "resnet50":
        return (resnet50(args.classes, fused=args.fused, **gen),
                CrossEntropyCriterion(), image_batch)
    # both inception towers end in log_softmax: ClassNLL takes the
    # log-probabilities as they are
    if name == "inception-v1":
        return (Inception_v1(args.classes, **gen), ClassNLLCriterion(),
                image_batch)
    if name == "inception-v2":
        return (Inception_v2(args.classes, **gen), ClassNLLCriterion(),
                image_batch)
    if name == "vgg16":
        return (Vgg_16(args.classes, **gen), CrossEntropyCriterion(),
                image_batch)
    if name not in ("transformer-lm", "ptb-lstm"):
        raise SystemExit(f"unknown --model {name!r}")

    def token_batch(b):
        return (rng.integers(
                    1, args.vocab_size + 1,
                    size=(b, args.seq_len)).astype(np.int32),
                rng.integers(1, args.vocab_size + 1,
                             size=(b * args.seq_len,)).astype(np.int32))

    if name == "ptb-lstm":
        # the reference's PTB word LM (example/languagemodel/
        # PTBModel.scala), ClassNLL on the flattened [B*T] targets
        lm = PTBModel(args.vocab_size, hidden_size=args.hidden_size,
                      num_layers=args.num_layers, **gen)
        return FlatLM(lm), ClassNLLCriterion(), token_batch
    # synthetic batches are contiguous (tokens 1..V, no padding):
    # padded_inputs=False keeps the causal mask inside the kernels
    lm = transformer_lm(
        vocab_size=args.vocab_size, hidden_size=args.hidden_size,
        num_layers=args.num_layers, num_heads=args.num_heads,
        filter_size=4 * args.hidden_size, max_len=args.seq_len,
        remat=args.remat, padded_inputs=False, **gen)
    return FlatLM(lm), CrossEntropyCriterion(), token_batch


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Benchmark the Optimizer training loop on a model")
    p.add_argument("--model", default="resnet50", choices=MODELS)
    p.add_argument("--input-pipeline", metavar="FOLDER", default=None)
    p.add_argument("-b", "--batch-size", type=int, default=32)
    p.add_argument("--iterations", type=int, default=20,
                   help="iterations per timed epoch")
    p.add_argument("--epochs", type=int, default=4,
                   help="total epochs (the first window pays the build)")
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--classes", type=int, default=1000)
    p.add_argument("--seq-len", type=int, default=128)
    p.add_argument("--vocab-size", type=int, default=1000)
    p.add_argument("--hidden-size", type=int, default=256)
    p.add_argument("--num-layers", type=int, default=4)
    p.add_argument("--num-heads", type=int, default=4)
    p.add_argument("--remat", action="store_true")
    p.add_argument("--real-jpeg-train", type=int, default=0, metavar="N")
    p.add_argument("--fused", action="store_true",
                   help="resnet50: the fused conv+BN bottleneck path "
                        "(kernels #8-#11 on the card)")
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--learning-rate", type=float, default=0.01)
    p.add_argument("--generate", type=int, default=0, metavar="N")
    p.add_argument("--int8-infer", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    return p.parse_args(argv)


def train(args):
    """Train as ``main`` does; returns ``(result dict, Optimizer)``."""
    for flag, default, item in _MODES:
        if getattr(args, flag) != default:
            raise NotImplementedError(
                f"--{flag.replace('_', '-')} is not ported yet ({item})")
    return run(args, *build(args.model, args))


def run(args, model, criterion, make_batch, configure=None):
    """The timed training of :func:`train` on a model already built (by
    :func:`build`, and perhaps reconfigured, as chip_smoke.py arms
    sequence parallelism on the LM), with ``configure(optimizer)``
    called before it trains (for example to
    ``set_iterations_per_dispatch``, which has no CLI flag: the
    reference's perf has none)."""
    x, y = make_batch(args.batch_size)
    # one shared host buffer per epoch slot: the device cache holds it once
    data = DataSet.array(
        [MiniBatch(x, y) for _ in range(args.iterations)],
        shuffle=False).cache_on_device(args.device)
    opt = (Optimizer(model, data, criterion, seed=0)
           .set_optim_method(SGD(args.learning_rate, momentum=0.9,
                                 dampening=0.0))
           .set_end_when(Trigger.max_epoch(args.epochs))
           .set_log_interval(args.iterations))
    if args.bf16:
        opt.set_compute_dtype(torch.bfloat16)
    if configure is not None:
        configure(opt)
    t0 = time.perf_counter()
    opt.optimize()
    total = time.perf_counter() - t0

    # steady state: every window after the first, aggregated over their
    # span (completion to completion, so the device really finished)
    steady = opt.window_timings[1:]
    if steady:
        step_s = sum(dt for _, dt, _ in steady) / sum(
            n for n, _, _ in steady)
    else:  # single window: wall time includes the build; flagged below
        step_s = total / args.iterations
    out = {
        "model": args.model,
        "batch_size": args.batch_size,
        "records_per_sec": round(args.batch_size / step_s, 2),
        "ms_per_iteration": round(step_s * 1e3, 3),
        "windows_timed": len(steady),
        "compile_plus_first_window_s": round(
            opt.window_timings[0][1] if opt.window_timings else total, 2),
        "bf16": bool(args.bf16),
    }
    if not steady:
        out["warning"] = ("single dispatch window: time includes the "
                          "kernel build; run more iterations/epochs for "
                          "steady-state numbers")
    return out, opt


def _inference_s(model, x, reps: int) -> float:
    """Seconds a forward of ``model`` on ``x``: on the card CUDA events
    around ``reps`` forwards, then a readback of the last output; on the
    host the host clock around the same."""
    with torch.no_grad():
        model(x).cpu()                       # warm-up, forced completion
        if x.is_cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                out = model(x)
            end.record()
            out.cpu()
            return start.elapsed_time(end) / 1e3 / reps
        t0 = time.perf_counter()
        for _ in range(reps):
            out = model(x)
        out.cpu()
        return (time.perf_counter() - t0) / reps


def bench_int8_inference(args, reps: int = 10):
    """Float-against-int8 inference time of one batch of the model (the
    reference's ``bench_int8_inference``, its result keys): the f32 model,
    or with ``--bf16`` its bf16 cast (the int8 copy is quantized from the
    f32 model and gets the same input), against its int8 copy."""
    from bigdl_tpu_torch.core.module import cast_floating
    from bigdl_tpu_torch.nn.quantized import Quantizer

    model, _, make_batch = build(args.model, args)
    model.train(False)
    x_np, _ = make_batch(args.batch_size)
    x = torch.as_tensor(x_np, device=args.device)
    qmodel = Quantizer.quantize(model)
    if args.bf16:
        model = cast_floating(model, torch.bfloat16)
        x = cast_floating(x, torch.bfloat16)
    t_base = _inference_s(model, x, reps)
    t_int8 = _inference_s(qmodel, x, reps)
    base = "bf16" if args.bf16 else "fp32"
    return {
        "model": args.model,
        "mode": "int8-infer",
        "batch_size": args.batch_size,
        "baseline_dtype": base,
        f"{base}_ms": round(t_base * 1e3, 3),
        "int8_ms": round(t_int8 * 1e3, 3),
        "int8_speedup": round(t_base / t_int8, 3),
        f"{base}_img_per_sec": round(args.batch_size / t_base, 1),
        "int8_img_per_sec": round(args.batch_size / t_int8, 1),
        "device": str(x.device),
    }


def main(argv=None, emit=True):
    args = parse_args(argv)
    if args.int8_infer:
        out = bench_int8_inference(args)
    else:
        out, _ = train(args)
    if emit:
        print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
