"""Does torch.profiler keep every device event of a training run?

On one NVIDIA GPU, from the repo's root: ``python3 chip_trace_probe.py
[runs]``.  Traces three runs of chip_smoke.py's paths ``runs`` times
each way, in turn: the LM of the dispatch phase in windows of an epoch
(CUDA graph replays), and short eager SP LM and ResNet-50 runs as
``profile_steps`` makes them.  "bare" is ``torch.profiler`` as those runs were traced before
``chip_smoke.traced()`` (the device synchronized, no wait on the host);
"ticked" adds TICKS marker kernels before the run and TICKS after it,
TICK_S apart, and prints when each was launched on the host and when
each that the trace kept started on the device; "framed" goes through
``traced()``.  For each trace it prints its device events, #1-#3's
launches against a step's worth for each step the device ran (the LM's
warm-up step and replays), its marker kernels (start after the trace's
start, length) and the device events of length 0: events missing from
one trace and not another are events it lost.
"""
from __future__ import annotations

import argparse
import sys
import time
from contextlib import contextmanager

import torch
from torch.autograd import DeviceType

import chip_smoke as cs


TICKS, TICK_S = 40, 0.025


@contextmanager
def ticked(launched):
    """torch.profiler over the block with TICKS marker kernels before it
    and TICKS after it, TICK_S apart on the host, each one's launch time
    on the host's clock appended to ``launched``."""
    from torch.profiler import ProfilerActivity, profile

    def ticks():
        for _ in range(TICKS):
            torch.cuda.synchronize()
            launched.append(time.time_ns())
            torch.cuda._sleep(1)
            time.sleep(TICK_S)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ticks()
        yield prof
        ticks()
        torch.cuda.synchronize()


def spin_starts(device):
    return [e.start_ns() for e in device if cs.MARKER in e.name()]


@contextmanager
def bare():
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        yield prof


def lm_graph():
    from bigdl_tpu_torch.examples import perf
    args, model, criterion, make_batch = cs.dispatch_model("lm")

    def run():
        _, opt = perf.run(args, model, criterion, make_batch,
                          configure=cs.dispatch_of(args.iterations,
                                                   cs.mark_captures))
        return opt
    return run, cs.DISPATCH_PATHS["lm"][1]


def short(path):
    """A short eager run of the path, as profile_steps makes it."""
    from bigdl_tpu_torch.examples import perf
    args, model, criterion, make_batch = cs.dispatch_model(path)
    few = argparse.Namespace(**{**vars(args), "iterations": cs.BUSY_ITERS,
                                "epochs": cs.BUSY_EPOCHS})

    def run():
        return perf.run(few, model, criterion, make_batch)[1]
    return run, cs.DISPATCH_PATHS[path][1]


def probe(label, make, how):
    run, per_step = make()
    launched = []
    frame = {"bare": bare, "framed": cs.traced,
             "ticked": lambda: ticked(launched)}[how]
    with frame() as prof:
        opt = run()
        torch.cuda.synchronize()
    kineto = prof.profiler.kineto_results
    start = kineto.trace_start_ns()
    device = [e for e in kineto.events()
              if e.device_type() == DeviceType.CUDA]
    first = min(e.start_ns() for e in device if cs.MARKER not in e.name())
    spins = sorted((e.start_ns() - start, e.duration_ns())
                   for e in device if cs.MARKER in e.name()
                   and how != "ticked")
    # traced()'s warm-up markers, summed up
    lead = [t for t, _ in spins if t < first - start]
    spins = [(t, d) for t, d in spins if t >= first - start]
    zero = [e.name()[:40] for e in device if e.duration_ns() == 0]
    events = sorted((e for e in prof.events()
                     if e.device_type == DeviceType.CUDA
                     and "HtoD" not in e.name),
                    key=lambda e: e.time_range.start)
    framed = ""
    if how == "ticked":
        # which ticks the trace kept, by the launch each one's device
        # start follows most closely, and how far it follows it
        others = [e.start_ns() for e in device if cs.MARKER not in e.name()]
        kept = {}
        for t in spin_starts(device):
            if t < min(others) or t > max(others):
                i = min(range(len(launched)),
                        key=lambda j: abs(t - launched[j]))
                kept[i] = t - launched[i]
        head = sorted(i for i in kept if i < TICKS)
        tail = sorted(i - TICKS for i in kept if i >= TICKS)
        lag = [v / 1e6 for v in kept.values()]
        framed = (f"; ticks kept: {len(head)}/{TICKS} before the run "
                  f"(lost {[i for i in range(TICKS) if i not in head]}), "
                  f"{len(tail)}/{TICKS} after it (lost "
                  f"{[i for i in range(TICKS) if i not in tail]}); device "
                  f"start - host launch {min(lag):.3f} to {max(lag):.3f} ms")
    if how == "framed":
        try:
            cs.framed_events(prof)
            framed = "; frames found"
        except RuntimeError as e:
            framed = f"; framed_events raised: {e}"
    stats = getattr(opt, "dispatch_stats", {})
    # every step the device ran: the warm-up step before a capture too
    steps = cs.device_steps(opt, stats.get("replays")
                            or cs.BUSY_ITERS * cs.BUSY_EPOCHS)
    counted = cs.kernel_launches(events)
    print(f"{label} {how}: {len(events)} device events; "
          + ", ".join(f"{n} {counted[n]}/{c * steps}"
                      for n, c in per_step.items())
          + (f"; {len(lead)} warm-up markers from {lead[0] / 1e6:.3f} to "
             f"{lead[-1] / 1e6:.3f} ms" if lead else "")
          + "; markers (ms after the trace's start, us long) "
          + ", ".join(f"({s / 1e6:.3f}, {d / 1e3:.3f})" for s, d in spins)
          + f"; {len(zero)} events 0 long {zero[:4]}{framed}",
          flush=True)


def main() -> int:
    runs = int(sys.argv[1]) if len(sys.argv) > 1 else 6
    cs.phase_device()
    cs.phase_build()
    with cs.deterministic():
        for _ in range(runs):
            for label, make in (("lm graph", lm_graph),
                                ("sp short", lambda: short("sp")),
                                ("resnet short", lambda: short("resnet"))):
                for how in ("bare", "ticked", "framed"):
                    probe(label, make, how)
    return 0


if __name__ == "__main__":
    sys.exit(main())
