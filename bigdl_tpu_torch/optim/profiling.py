"""Per-module timing and the profiler (counterpart of
``bigdl_tpu/optim/profiling.py``).

``module_forward_times`` runs one eager forward with every submodule's
``forward`` wrapped in a timer that waits for the module's output on its
device, so a container's time includes its children's, as the
reference's ``getTimes``; ``times_by_module_type`` groups the records;
``profile_trace`` brackets a block with ``torch.profiler`` and writes its
Chrome trace.  The reference's telemetry histogram of these timings is
ROADMAP.md queue 1, item 10 (telemetry and health).
"""

from __future__ import annotations

import logging
import os
import time
from contextlib import contextmanager
from typing import Dict, List, Tuple

import torch

__all__ = ["module_forward_times", "times_by_module_type", "profile_trace"]

logger = logging.getLogger("bigdl_tpu_torch.optim")

# sentinel: "the module had NO instance-level forward before patching"
_ABSENT = object()


def _synchronize(out):
    """Wait for every CUDA tensor in ``out`` (the reference's
    ``block_until_ready``); a CPU tensor is ready when it is returned."""
    if torch.is_tensor(out):
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
    elif isinstance(out, dict):
        for v in out.values():
            _synchronize(v)
    elif isinstance(out, (list, tuple)):
        for v in out:
            _synchronize(v)


@contextmanager
def _timed(model, records: List):
    """Temporarily wrap every submodule's forward with a blocking timer;
    the prior instance-level ``forward`` (a user's patch, another tool's
    wrapper), or its absence, is put back exactly."""
    patched = []
    for path, mod in model.named_modules():
        orig = mod.forward
        prior = mod.__dict__.get("forward", _ABSENT)

        def make(orig=orig, path=path, mod=mod):
            def timed_forward(*a, **k):
                t0 = time.perf_counter()
                out = orig(*a, **k)
                _synchronize(out)
                records.append((path, type(mod).__name__,
                                time.perf_counter() - t0))
                return out
            return timed_forward

        object.__setattr__(mod, "forward", make())
        patched.append((mod, prior))
    try:
        yield
    finally:
        for mod, prior in patched:
            if prior is _ABSENT:
                try:
                    object.__delattr__(mod, "forward")
                except AttributeError:
                    pass
            else:
                object.__setattr__(mod, "forward", prior)


def module_forward_times(model, *inputs) -> List[Tuple[str, str, float]]:
    """Run one eager forward and return [(path, type, seconds)] per
    submodule, outermost last (the reference's ``getTimes``)."""
    records: List[Tuple[str, str, float]] = []
    with _timed(model, records), torch.no_grad():
        model.forward(*inputs)
    return records


def times_by_module_type(records) -> Dict[str, Tuple[int, float]]:
    """Aggregate records as type -> (count, total_seconds) (the
    reference's ``getTimesGroupByModuleType``)."""
    out: Dict[str, Tuple[int, float]] = {}
    for _path, tname, sec in records:
        cnt, tot = out.get(tname, (0, 0.0))
        out[tname] = (cnt + 1, tot + sec)
    return out


def _profiler():
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=activities)


@contextmanager
def profile_trace(logdir: str):
    """Profile the block with ``torch.profiler`` (host and, on the card,
    device activity) and write its Chrome trace to
    ``logdir/trace.json``; yields the profiler.

    A profiler left running by a capture that died between its start
    and its stop does not block a new one (torch's start takes over), so
    the reference's reclaim-and-retry has nothing to do here.  Start and
    stop are always paired, and a failing stop or export never masks the
    block's own exception."""
    prof = _profiler()
    prof.start()
    try:
        yield prof
    finally:
        try:
            prof.stop()
            os.makedirs(logdir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
        except Exception:
            logger.warning("torch.profiler stop or export failed",
                           exc_info=True)
