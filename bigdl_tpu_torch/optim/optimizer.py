"""The single-device ``Optimizer`` façade (counterpart of
``bigdl_tpu/optim/optimizer.py``: the setters, the flat unsharded branch
of ``_build_step``, ``_validate`` and the loop of ``_optimize_once`` with
its ``consume_window`` and ``safe_window``).

``Optimizer(model, dataset, criterion).optimize()`` trains in place.
Each step zeroes the gradients, runs the forward and the criterion,
calls ``backward()``, then per optim-method group adds the layers'
regularizers, clips and lets the group's method update the float32
master parameters in place under ``no_grad``, as the reference's step
does.  The loop's state (``epoch``, ``neval``, ``records``, ``loss``,
``score``, ``is_epoch_end``) advances exactly as the reference's, so a
``Trigger`` sees the same states; validation runs eagerly in eval mode
under ``no_grad`` where its trigger fires, and its first result is the
``score``, which every method's ``Plateau`` schedule is then told.

Losses stay on the device.  Every ``log_interval`` steps the window is
read back: its losses are stacked and copied to pinned host memory
without blocking, followed by an event; the read waits on that event,
which pins the completion time, and then reads the host copy.
``window_timings`` holds ``(iterations, completion-to-completion
seconds, data seconds)`` per window, as the reference's does; the first
window also bears the kernels' build and the library warm-up.  Where no
trigger reads the loss, the reads run on a ``bigdl-loss-drain`` thread
over a queue of 4 windows (the reference's asynchronous loss drain), so
the loop goes on queueing steps while a window's read waits; the loop
waits for the drain before a validation, a checkpoint and its end, and
a failed attempt's drain is stopped, its queued windows discarded.

``set_device_prefetch(n)`` copies each host batch to the device on a
producer thread ``n`` batches ahead of the step
(``data/device_prefetch.py``); single-step dispatch only.

``set_iterations_per_dispatch(k)`` runs k steps per dispatch with the
reference's windows: ``safe_window`` trims a window so that validation
and the end trigger fire on the iteration they would with k=1; a
loss-reading trigger forces k=1; a window shorter than k, or whose
batches differ in shape, runs single steps.  On the card a window
replays a captured ``torch.cuda.CUDAGraph`` of the whole step (forward,
criterion, backward, regularizers, clipping, update), captured once per
batch shape after a warm-up step on a side stream whose effects are
undone.  What the host changes every step goes in through state the
graph reads, written before each replay: the batch (copied into static
inputs), each group's step scalars (its method's learning rate and
whatever else moves with the step, as Adam's bias corrections: 0-dim
float32 tensors the host fills from the step counter and epoch, eager
steps reading their own set) and the dropout stream (the
generator, registered with the graph, reseeded per iteration, and the
twins a ``remat`` model's recomputes replay from, registered too and
seeded per iteration with the offsets the warm-up step recorded:
``core.module.ReplayStreams``).  Each
replay's loss is copied into its own slot of the window's buffer; no
host read happens between the replays.  A capture that fails raises.
The kernels' wrappers count what their Python launches, the warm-up
step's and the capture's, and not the replays (the device runs those).
On the CPU a window's steps run eagerly, one at a time.

``set_compute_dtype(torch.bfloat16)`` computes what the reference's
``cast_floating`` does: every floating parameter AND buffer is cast for
the forward (``torch.func.functional_call`` with cast copies, so the
gradients reach the float32 masters through the casts), floating inputs
are cast too, and the output is cast back to float32 before the
criterion.  ``torch.autocast`` would not: it keeps softmax, layer norm
and ``log_softmax`` in float32 and rounds elsewhere.  A buffer the
forward assigns (a BatchNorm's running statistics in train mode) is
copied back into the model's buffer after the backward, in float32 as
the reference's ``cast_floating(new_rest, float32)`` keeps it, so the
buffers keep their storage (which a captured graph reads and writes).

``set_checkpoint(path, trigger, keep_n=)`` writes checkpoints in the
reference's format (``utils/file.py``): the parameters and buffers nested
by the reference's names with their keys sorted, as ``jax.tree_util``
writes them, each group's state lists in the model's parameter order
(the reference's ``param_paths``, which is not the sorted order), the
counters as int32 and the loop's scalars, with the input pipeline's
position beside them; a checkpoint trigger ends a dispatch window, and
the write follows a flush of the losses, with one copy of the
parameters and states to the host per dtype.  ``resume(path)`` restores
the parameters, the persistent buffers, every group's state with its
step counter ``t`` and the loop's ``epoch``, ``neval``, ``records``,
``loss`` and ``score``; the step's dropout seed is a function of
``neval``, so there is no generator state to restore.  A mid-epoch
checkpoint resumes at the next batch (the consumed ones skipped), an
epoch-boundary one replays the next epoch from its start.
``optimize()`` retries a transient failure from the newest good
checkpoint (``set_failure_retry``), starting from nothing of the failed
attempt: its captured graphs, pending losses and optim states are
dropped and rebuilt.  SIGTERM sets a flag; at the next step boundary the
loop writes a final checkpoint and returns with ``preempted`` set.
With no checkpoint set a step does no new host work.

What the slice does not need raises ``NotImplementedError`` naming its
ROADMAP item; nothing is silently ignored.
"""

from __future__ import annotations

import logging
import queue
import random
import signal
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.func import functional_call

from bigdl_tpu_torch.core.module import ReplayStreams, cast_floating, \
    forward_context
from bigdl_tpu_torch.data.device_prefetch import DevicePrefetch
from bigdl_tpu_torch.data.pipeline import (
    PIPELINE_STATE_VERSION, PipelineState, dataset_seed, epoch_iter,
    skip_batches, supports_epoch,
)
from bigdl_tpu_torch.interop.jax_params import (
    load_jax_buffers, load_jax_parameters, nest_jax_parameters,
    state_buffers,
)
from bigdl_tpu_torch.optim.methods import SGD, OptimMethod, Plateau
from bigdl_tpu_torch.optim.metrics import Metrics
from bigdl_tpu_torch.optim.regularizer import leaf_reg_specs
from bigdl_tpu_torch.optim.trigger import Trigger
from bigdl_tpu_torch.optim.validation import ValidationMethod, \
    ValidationResult
from bigdl_tpu_torch.utils import chaos
from bigdl_tpu_torch.utils.file import CheckpointManager, \
    load_checkpoint, load_pipeline_state

logger = logging.getLogger("bigdl_tpu_torch.optim")

__all__ = ["Optimizer"]

_TELEMETRY = "ROADMAP.md queue 1, item 10 (telemetry and health)"
_PARALLEL = "ROADMAP.md queue 1, item 11 (parallelism)"


# programming errors: a retry from a checkpoint would run the same code
# into the same wall, so they re-raise at once; everything else (OSError,
# RuntimeError and with it a CUDA error, chaos.FaultInjected) is transient
_NON_RETRYABLE = (ValueError, TypeError, KeyError, IndexError,
                  AttributeError, NameError, AssertionError,
                  NotImplementedError, ZeroDivisionError, ImportError,
                  SyntaxError)


def _is_transient(e: BaseException) -> bool:
    return not isinstance(e, _NON_RETRYABLE)


def _not_ported(name: str, item: str):
    def setter(self, *args, **kwargs):
        raise NotImplementedError(f"Optimizer.{name} is not ported yet "
                                  f"({item})")
    setter.__name__ = name
    setter.__doc__ = f"Not ported yet ({item}): raises."
    return setter


def _step_seed(seed: int, neval: int) -> int:
    """The step's generator seed, a pure function of (seed, iteration)
    (the reference folds the iteration into its key)."""
    return int(np.random.SeedSequence([int(seed), int(neval)])
               .generate_state(1)[0])


def _stage(value, device):
    """Host arrays to the device; device tensors pass through."""
    if isinstance(value, (tuple, list)):
        return type(value)(_stage(v, device) for v in value)
    return torch.as_tensor(value).to(device)


def _copy_into(dst, src):
    """Copy the staged ``src`` into the static tensors ``dst``."""
    if isinstance(dst, (tuple, list)):
        for d, s in zip(dst, src):
            _copy_into(d, s)
    else:
        dst.copy_(src)


def _clone(value):
    if isinstance(value, (tuple, list)):
        return type(value)(_clone(v) for v in value)
    return value.clone()


def _batch_sig(batch) -> Tuple:
    """Shapes and dtypes of a batch's input and target leaves."""
    def leaves(v):
        if isinstance(v, (tuple, list)):
            return [x for e in v for x in leaves(e)]
        return [(tuple(np.shape(v)), str(getattr(v, "dtype", type(v))))]
    return tuple(leaves(batch.get_input()) + leaves(batch.get_target()))


def _batched(dataset, batch_size: int, seed: Optional[int]):
    """``dataset`` (or a list of Samples, shuffled by ``seed`` unless it
    is None) through ``SampleToMiniBatch(batch_size)``."""
    from bigdl_tpu_torch.dataset.dataset import LocalDataSet
    from bigdl_tpu_torch.dataset.transformer import SampleToMiniBatch
    if isinstance(dataset, (list, tuple)):
        dataset = LocalDataSet(list(dataset), shuffle=seed is not None,
                               seed=seed)
    return dataset.transform(SampleToMiniBatch(batch_size))


def _state_tensors(value) -> List[torch.Tensor]:
    """Every tensor in an optim state (dicts and lists of tensors)."""
    if torch.is_tensor(value):
        return [value]
    if isinstance(value, dict):
        return [t for v in value.values() for t in _state_tensors(v)]
    if isinstance(value, (tuple, list)):
        return [t for v in value for t in _state_tensors(v)]
    return []


def _to_host(tensors: List[torch.Tensor]) -> List[np.ndarray]:
    """Each tensor as a numpy array of its own (bf16 and f16 widened to
    f32: numpy has neither), with one device-to-host copy per dtype."""
    out: List[Optional[np.ndarray]] = [None] * len(tensors)
    by_dtype: Dict[Tuple, List[Tuple[int, torch.Tensor]]] = {}
    for i, t in enumerate(tensors):
        t = t.detach()
        if t.dtype in (torch.bfloat16, torch.float16):
            t = t.float()
        by_dtype.setdefault((t.dtype, t.device), []).append((i, t))
    for items in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for _, t in items]).cpu().numpy()
        offset = 0
        for i, t in items:
            out[i] = flat[offset:offset + t.numel()].reshape(t.shape)
            offset += t.numel()
    return out


def _host_state(value, arrays):
    """An optim state with its tensors taken from ``arrays`` (in
    ``_state_tensors`` order) and its counters as int32 arrays, as the
    reference's states hold them."""
    if torch.is_tensor(value):
        return next(arrays)
    if isinstance(value, dict):
        return {k: _host_state(v, arrays) for k, v in value.items()}
    if isinstance(value, (tuple, list)):
        return type(value)(_host_state(v, arrays) for v in value)
    if isinstance(value, int) and not isinstance(value, bool):
        return np.asarray(value, np.int32)
    return value


def _sorted_keys(tree):
    """A nested dict with its keys sorted at every level, as the
    reference's ``jax.tree_util.tree_map`` writes its parameters."""
    if isinstance(tree, dict):
        return {k: _sorted_keys(tree[k]) for k in sorted(tree)}
    return tree


@torch.no_grad()
def _copy_array(t: torch.Tensor, a, what: str):
    a = np.asarray(a)
    if tuple(a.shape) != tuple(t.shape):
        raise ValueError(f"{what}: shape {tuple(a.shape)} does not match "
                         f"{tuple(t.shape)}")
    t.copy_(torch.tensor(a, dtype=t.dtype))


def _fill_state(fresh: Dict[str, Any], saved: Dict[str, Any],
                what: str) -> Dict[str, Any]:
    """``fresh`` (a group's ``init_state``) with the checkpoint's values
    copied in."""
    keys = sorted(saved) if isinstance(saved, dict) else saved
    if keys != sorted(fresh):
        raise ValueError(f"{what}: the checkpoint's state keys {keys} do "
                         f"not match {sorted(fresh)}")
    for key, value in fresh.items():
        got = saved[key]
        if torch.is_tensor(value):
            _copy_array(value, got, f"{what}[{key!r}]")
        elif isinstance(value, list):
            if len(got) != len(value):
                raise ValueError(f"{what}[{key!r}]: {len(got)} entries, "
                                 f"not {len(value)}")
            for j, t in enumerate(value):
                _copy_array(t, got[j], f"{what}[{key!r}][{j}]")
        elif isinstance(value, int):
            fresh[key] = int(np.asarray(got))
        else:
            raise TypeError(f"{what}[{key!r}]: cannot restore a "
                            f"{type(value).__name__}")
    return fresh


class _StepGraph:
    """One captured step: the graph, its static inputs, step-scalar
    tensors and loss, and the offsets its recomputes replay from."""

    def __init__(self, graph, x, y, scalars, loss, offsets):
        self.graph, self.x, self.y = graph, x, y
        self.scalars, self.loss = scalars, loss
        self.offsets = offsets


def _loss_readback(losses: List[torch.Tensor]):
    """The window's losses on the host and the event that their copy is
    done (None on the CPU): one stack, one copy into pinned memory
    without blocking."""
    values = torch.stack(losses)
    if not values.is_cuda:
        return values, None
    host = torch.empty(values.shape, dtype=values.dtype, pin_memory=True)
    host.copy_(values, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


class Optimizer:
    """``Optimizer(model, dataset, criterion).optimize()`` on one device
    (the model's).  ``batch_size`` batches a dataset (or a list, then
    shuffled by ``seed``) of raw ``Sample``s with ``SampleToMiniBatch``.
    ``seed`` keys the generator that train-mode dropout draws from, one
    fresh stream per iteration."""

    def __init__(self, model: torch.nn.Module, dataset, criterion,
                 batch_size: Optional[int] = None, *, seed: int = 0):
        if batch_size is not None:
            # a list is shuffled by ``seed``, as the reference's by its
            # process seed
            dataset = _batched(dataset, batch_size, seed)
        self.model = model
        self.dataset = dataset
        self.criterion = criterion
        self.seed = int(seed)
        self.optim_method: OptimMethod = SGD()
        self.optim_methods: Optional[Dict[str, OptimMethod]] = None
        self.end_when: Trigger = Trigger.max_epoch(1)
        self.val_trigger: Optional[Trigger] = None
        self.val_dataset = None
        self.val_methods: Optional[List[ValidationMethod]] = None
        self.grad_clip_const: Optional[Tuple[float, float]] = None
        self.grad_clip_norm: Optional[float] = None
        self.compute_dtype: Optional[torch.dtype] = None
        self.log_interval: Optional[int] = None  # None = auto
        self.iters_per_dispatch = 1
        self.metrics = Metrics()
        self.state: Dict[str, Any] = {"epoch": 1, "neval": 1,
                                      "records": 0, "loss": float("nan"),
                                      "score": float("-inf")}
        self._last_val_neval = -1
        self.window_timings: List[Tuple[int, float, float]] = []
        # (neval, loss) of every iteration, as read back per window (the
        # reference writes each to its log and its train summary)
        self.loss_history: List[Tuple[int, float]] = []
        # neval of every validation, with its results by method
        self.validation_history: List[Tuple[int, Dict[str,
                                                      ValidationResult]]] = []
        # the dispatch of the last optimize(), over its attempts: steps
        # run singly, steps run inside windows, graphs captured and their
        # replays
        self.dispatch_stats: Dict[str, int] = {}
        self.checkpoint_path: Optional[str] = None
        self.checkpoint_trigger: Optional[Trigger] = None
        self.overwrite_checkpoint = True
        self.checkpoint_keep_n: Optional[int] = None
        self._ckpt_mgr: Optional[CheckpointManager] = None
        self._resume_from: Optional[str] = None
        self._last_ckpt_neval = -1
        self.retry_times = 5
        self.retry_interval_s = 120.0
        self.retry_backoff_s = 1.0
        self.retry_backoff_cap_s = 60.0
        self.retry_jitter = 0.25
        # SIGTERM sets the flag; the loop acts on it at a step boundary
        self._preempt_requested = False
        self.preempted = False
        # batches stepped in the current epoch (the sidecar's offset) and
        # the last batch's size
        self._epoch_offset = 0
        self._last_global_batch: Optional[int] = None
        # batches staged ahead on the device (None: off)
        self.device_prefetch_ahead: Optional[int] = None
        # the running attempt's prefetcher and loss drain, stopped on
        # every failure path
        self._active_dp = None
        self._flushq: Optional[queue.Queue] = None
        self._flush_thread: Optional[threading.Thread] = None

    # ---- configuration (the reference's setters) -------------------------

    def set_optim_method(self, method: OptimMethod) -> "Optimizer":
        self.optim_method = method
        return self

    def set_optim_methods(self, methods: Dict[str, OptimMethod]) \
            -> "Optimizer":
        """Per-submodule optim methods keyed by a module's ``name`` or a
        parameter path prefix (the reference's ``setOptimMethods``); each
        group keeps its own method and state."""
        self.optim_methods = dict(methods)
        return self

    def set_end_when(self, trigger: Trigger) -> "Optimizer":
        self.end_when = trigger
        return self

    def set_validation(self, trigger: Trigger, dataset,
                       methods: Sequence[ValidationMethod],
                       batch_size: Optional[int] = None) -> "Optimizer":
        """Validate on ``dataset`` with ``methods`` where ``trigger``
        fires; ``batch_size`` batches raw ``Sample``s."""
        if batch_size is not None:
            dataset = _batched(dataset, batch_size, None)
        self.val_trigger = trigger
        self.val_dataset = dataset
        self.val_methods = list(methods)
        return self

    def set_gradient_clipping_by_l2_norm(self, clip_norm: float) \
            -> "Optimizer":
        """Scale each group's gradients by min(1, clip_norm / ||g||)."""
        self.grad_clip_norm = float(clip_norm)
        return self

    def set_constant_gradient_clipping(self, min_v: float, max_v: float) \
            -> "Optimizer":
        """Clamp every gradient entry into [min_v, max_v]."""
        self.grad_clip_const = (float(min_v), float(max_v))
        return self

    def disable_gradient_clipping(self) -> "Optimizer":
        self.grad_clip_const = None
        self.grad_clip_norm = None
        return self

    def set_compute_dtype(self, dtype) -> "Optimizer":
        """Compute in ``dtype`` (bfloat16) over float32 master weights."""
        if dtype not in (None, torch.float32, torch.bfloat16):
            raise ValueError(f"compute dtype {dtype} is not supported: "
                             "use torch.bfloat16 (or None for float32)")
        self.compute_dtype = None if dtype == torch.float32 else dtype
        return self

    def set_log_interval(self, n: int) -> "Optimizer":
        """Read the losses back every ``n`` iterations."""
        self.log_interval = int(n)
        return self

    def set_iterations_per_dispatch(self, k: int) -> "Optimizer":
        """Run up to ``k`` consecutive steps per dispatch: on the card,
        replays of a CUDA graph of the whole step (see the module's
        docstring); the weights, losses and trigger iterations are those
        of k=1."""
        self.iters_per_dispatch = max(1, int(k))
        return self

    def set_checkpoint(self, path: str, trigger: Trigger,
                       is_overwrite: bool = True, sharded: bool = False,
                       keep_n: Optional[int] = None) -> "Optimizer":
        """Checkpoint into the directory ``path`` where ``trigger`` fires.
        ``keep_n`` keeps that many good generations and deletes older
        ones (numbered checkpoints, so ``is_overwrite`` is off).  Every
        checkpoint commits atomically under a CRC manifest; a retry walks
        back past torn or uncommitted generations.  ``sharded=True``
        (orbax directories) raises."""
        if sharded:
            raise NotImplementedError("sharded checkpoints are not ported "
                                      f"yet ({_PARALLEL})")
        self.checkpoint_path = path
        self.checkpoint_trigger = trigger
        self.overwrite_checkpoint = is_overwrite and keep_n is None
        self.checkpoint_keep_n = keep_n
        self._ckpt_mgr = None
        return self

    def resume(self, checkpoint_file: str) -> "Optimizer":
        """Start ``optimize()`` from a checkpoint: parameters, buffers,
        optim states and the loop's position (same topology)."""
        self._resume_from = checkpoint_file
        return self

    def set_device_prefetch(self, n_ahead: int = 1) -> "Optimizer":
        """Copy batch N+1 to the device on a producer thread while step N
        runs (:class:`~bigdl_tpu_torch.data.DevicePrefetch`): the host's
        copy leaves the loop, at the cost of ``n_ahead`` more batches on
        the device.  Off by default; ``n_ahead=0`` turns it off.  Ignored,
        with a warning, under ``iterations_per_dispatch > 1``, whose
        windows stage their batches themselves."""
        n = int(n_ahead)
        if n < 0:
            raise ValueError("set_device_prefetch: n_ahead must be >= 0")
        self.device_prefetch_ahead = n or None
        return self

    def set_failure_retry(self, times: int, interval_s: float = 120.0,
                          backoff_s: Optional[float] = None,
                          backoff_cap_s: Optional[float] = None,
                          jitter: Optional[float] = None) -> "Optimizer":
        """Retry a transient failure from the newest good checkpoint, up
        to ``times`` times; the count starts again when more than
        ``interval_s`` passed since the previous failure.  Between
        retries the loop sleeps ``backoff_s * 2**attempt`` (at most
        ``backoff_cap_s``) times 1 ± ``jitter``.  Programming errors
        (ValueError, TypeError, ...) re-raise at once."""
        self.retry_times = int(times)
        self.retry_interval_s = float(interval_s)
        if backoff_s is not None:
            self.retry_backoff_s = float(backoff_s)
        if backoff_cap_s is not None:
            self.retry_backoff_cap_s = float(backoff_cap_s)
        if jitter is not None:
            self.retry_jitter = float(jitter)
        return self

    set_mesh = _not_ported("set_mesh", _PARALLEL)
    set_partition_plan = _not_ported("set_partition_plan", _PARALLEL)
    set_gradient_sync = _not_ported("set_gradient_sync", _PARALLEL)
    set_profiler = _not_ported("set_profiler", _TELEMETRY)
    set_health_watchdog = _not_ported("set_health_watchdog", _TELEMETRY)
    set_fleet_monitor = _not_ported("set_fleet_monitor", _TELEMETRY)
    set_debug_server = _not_ported("set_debug_server", _TELEMETRY)
    set_train_summary = _not_ported("set_train_summary", _TELEMETRY)
    set_val_summary = _not_ported("set_val_summary", _TELEMETRY)

    # ---- optim-method groups ---------------------------------------------

    def _group_indices(self, paths: List[str]) \
            -> List[Tuple[str, List[int]]]:
        """Assign each parameter (by dotted path) to an optim-method
        group: a key matches a path prefix or the ``name`` of a module
        (its class name unless set), the first key that matches wins."""
        if not self.optim_methods:
            return [("__default__", list(range(len(paths))))]
        name_prefixes: Dict[str, List[str]] = {}
        for prefix, mod in self.model.named_modules():
            name = getattr(mod, "name", type(mod).__name__)
            name_prefixes.setdefault(name, []).append(prefix)
        groups: Dict[str, List[int]] = {k: [] for k in self.optim_methods}
        for i, p in enumerate(paths):
            target = None
            for key in self.optim_methods:
                prefixes = [key] + name_prefixes.get(key, [])
                if any(p == pre or p.startswith(pre + ".")
                       for pre in prefixes if pre):
                    target = key
                    break
            if target is None:
                raise ValueError(f"setOptimMethods: no optim method covers "
                                 f"parameter '{p}'")
            groups[target].append(i)
        return [(k, v) for k, v in groups.items() if v]

    # ---- the step ----------------------------------------------------------

    def _forward(self, x):
        """(the model's output in float32, computed in the compute dtype;
        {buffer: the value the forward assigned it})."""
        dtype = self.compute_dtype
        buffers = dict(self.model.named_buffers())
        if dtype is None and not buffers:
            return self.model(x), {}
        tensors = dict(self.model.named_parameters())
        tensors.update(buffers)
        if dtype is not None:
            tensors = cast_floating(tensors, dtype)
            x = cast_floating(x, dtype)
        given = {name: tensors[name] for name in buffers}
        out = functional_call(self.model, tensors, (x,))
        if dtype is not None:
            out = out.float()
        # functional_call writes what the forward assigned into ``tensors``
        return out, {buffers[name]: tensors[name].detach()
                     for name in buffers if tensors[name] is not given[name]}

    def _clip(self, grads):
        """Clip one group's gradients (the reference's ``clip``)."""
        if self.grad_clip_const is not None:
            lo, hi = self.grad_clip_const
            grads = [g.clamp(lo, hi) for g in grads]
        if self.grad_clip_norm is not None:
            total = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
            # a true division: a float over a tensor multiplies by the
            # reciprocal
            scale = torch.clamp(torch.div(self._clip_norm_t, total + 1e-12),
                                max=1.0)
            grads = [g * scale for g in grads]
        return grads

    def _step(self, x, y, generator, scalars):
        """One training step with each group's step scalars
        ``scalars[i]`` (0-dim tensors); returns the loss, on the device.
        Runs no host read of a device value, so a CUDA graph can capture
        it."""
        params = self._params
        for p in params:
            p.grad = None
        with forward_context(generator=generator, streams=self._streams):
            out, assigned = self._forward(x)
        loss = self.criterion(out, y)
        loss.backward()
        with torch.no_grad():
            # into the buffers' storage, after the backward: a kernel's
            # autograd Function may have saved the old value
            for buf, value in assigned.items():
                buf.copy_(value)
            for gi, (idxs, method, state) in enumerate(zip(
                    self._group_idx, self._methods, self._opt_states)):
                ps = [params[i] for i in idxs]
                gs = [torch.zeros_like(p) if p.grad is None else p.grad
                      for p in ps]
                if self._specs is not None:
                    gs = [_regularized(g, p, self._specs[i])
                          for g, p, i in zip(gs, ps, idxs)]
                method.apply(self._clip(gs), ps, state, *scalars[gi])
        return loss.detach()

    def _scalar_tensors(self, device) -> List[List[torch.Tensor]]:
        """A 0-dim float32 tensor for each step scalar of each group."""
        return [[torch.zeros((), device=device)
                 for _ in m.step_scalars(s, self.state["epoch"])]
                for m, s in zip(self._methods, self._opt_states)]

    def _fill_scalars(self, tensors, epoch):
        """Write each group's step scalars of the coming step (its counter
        ``t`` and ``epoch``), computed on the host, into ``tensors``."""
        for ts, m, s in zip(tensors, self._methods, self._opt_states):
            for t, v in zip(ts, m.step_scalars(s, epoch)):
                t.fill_(v)

    def _advance_counters(self):
        for s in self._opt_states:
            s["t"] += 1

    def _single_step(self, batch, generator, device, epoch, neval):
        x = _stage(batch.get_input(), device)
        y = _stage(batch.get_target(), device)
        generator.manual_seed(_step_seed(self.seed, neval))
        self._fill_scalars(self._scalars, epoch)
        loss = self._step(x, y, generator, self._scalars)
        self._advance_counters()
        return loss

    def _replay_window(self, group, generator, device, epoch):
        """The steps of a full window on the card as replays of the
        batch shape's graph; returns their device losses."""
        base = self.state["neval"]
        staged = [(_stage(b.get_input(), device),
                   _stage(b.get_target(), device)) for b in group]
        sig = _batch_sig(group[0])
        sg = self._graphs.get(sig)
        if sg is None:
            sg = self._graphs[sig] = self._capture(staged[0], generator,
                                                   device, epoch)
        losses = torch.empty(len(group), device=device)
        for i, (x, y) in enumerate(staged):
            _copy_into(sg.x, x)
            _copy_into(sg.y, y)
            self._fill_scalars(sg.scalars, epoch)
            seed = _step_seed(self.seed, base + i)
            generator.manual_seed(seed)
            self._streams.seed(seed, sg.offsets)
            sg.graph.replay()
            losses[i].copy_(sg.loss)
            self._advance_counters()
        self.dispatch_stats["replays"] += len(group)
        return [losses[i] for i in range(len(group))]

    def _capture(self, staged, generator, device, epoch) -> _StepGraph:
        """Capture the step for this batch shape: a warm-up step on a side
        stream (builds the kernels, sets up the libraries' workspaces and
        autograd) whose effects on the parameters, buffers and optim
        states are then undone, and the capture itself."""
        keep = [*self._params, *self.model.buffers(),
                *_state_tensors(self._opt_states)]
        saved = [t.detach().clone() for t in keep]
        x, y = _clone(staged[0]), _clone(staged[1])
        scalars = self._scalar_tensors(device)
        self._fill_scalars(scalars, epoch)
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            generator.manual_seed(_step_seed(self.seed, self.state["neval"]))
            self._step(x, y, generator, scalars)
        torch.cuda.current_stream(device).wait_stream(side)
        with torch.no_grad():
            for t, s in zip(keep, saved):
                t.copy_(s)
        del saved
        for p in self._params:
            p.grad = None
        # where each recompute's stream stood in the warm-up step
        offsets = list(self._streams.offsets)
        graph = torch.cuda.CUDAGraph()
        for g in (generator, *self._streams.twins):
            graph.register_generator_state(g)
        with torch.cuda.graph(graph):
            loss = self._step(x, y, generator, scalars)
        self.dispatch_stats["captures"] += 1
        return _StepGraph(graph, x, y, scalars, loss, offsets)

    # ---- validation --------------------------------------------------------

    def _validate(self) -> Dict[str, ValidationResult]:
        results: Optional[List[ValidationResult]] = None
        device = self._params[0].device
        for batch in self.val_dataset.data(train=False):
            out = self.model(_stage(batch.get_input(), device))
            y = _stage(batch.get_target(), device)
            batch_results = [m.to_result(*m.batch_stats(out, y))
                             for m in self.val_methods]
            results = batch_results if results is None else [
                a + b for a, b in zip(results, batch_results)]
        if results is None:
            raise ValueError(
                "validation dataset produced no batches (empty split, or "
                "fewer samples than one batch)")
        out = {}
        for m, r in zip(self.val_methods, results):
            out[m.fmt] = r
            logger.info("%s is %s", m.fmt, r)
        return out

    def _want_validate(self) -> bool:
        return (self.val_trigger is not None
                and self.val_trigger(self.state)
                and self._last_val_neval != self.state["neval"])

    def _want_checkpoint(self) -> bool:
        return (self.checkpoint_trigger is not None
                and self.checkpoint_trigger(self.state)
                and self._last_ckpt_neval != self.state["neval"])

    def _maybe_validate_checkpoint(self):
        """Validate, then checkpoint, where their triggers fire, each at
        most once an iteration (the reference decides both before either
        runs)."""
        do_ckpt = self._want_checkpoint()
        self._maybe_validate()
        if do_ckpt:
            self._last_ckpt_neval = self.state["neval"]
            path = self._write_checkpoint()
            logger.info("checkpoint written to %s", path)

    def _maybe_validate(self):
        """Validate where the trigger fires, at most once an iteration;
        the first method's result becomes the ``score``."""
        if not self._want_validate():
            return
        self._last_val_neval = self.state["neval"]
        self.model.eval()
        try:
            with torch.no_grad(), self.metrics.time("validation time"):
                results = self._validate()
        finally:
            self.model.train()
        self.validation_history.append((self.state["neval"], results))
        if results:
            self.state["score"] = next(iter(results.values())).result()[0]
            self._on_score()

    def _on_score(self):
        """Tell every ``Plateau`` schedule the new score (the reference's
        hook after validation); the next step's rate is read from it."""
        for m in ([self.optim_method] if not self.optim_methods
                  else self.optim_methods.values()):
            sched = getattr(m, "schedule", None)
            if isinstance(sched, Plateau):
                sched.on_metric(self.state["score"])

    # ---- the loop ----------------------------------------------------------

    def _safe_window(self, sizes: List[int]) -> int:
        """The largest window <= len(sizes) in which no trigger fires
        before its last iteration (the reference's ``safe_window``); a
        loss-reading trigger forces 1."""
        trigs = [t for t in (self.end_when, self.val_trigger,
                             self.checkpoint_trigger) if t is not None]
        if any(getattr(t, "needs_loss", False) for t in trigs):
            return 1
        st = dict(self.state)
        st["is_epoch_end"] = False
        for i, n in enumerate(sizes):
            st["records"] += n
            st["neval"] += 1
            if any(t(st) for t in trigs):
                return i + 1
        return len(sizes)

    # ---- failure retry, preemption, checkpoints ---------------------------

    def optimize(self) -> torch.nn.Module:
        """Train until ``end_when`` fires; returns the model, trained in
        place.  A transient failure is retried from the newest good
        checkpoint (``set_failure_retry``) after a backoff; a programming
        error, or a failure with no retry or checkpoint left, re-raises.
        SIGTERM ends the run at the next step boundary with a final
        checkpoint and ``preempted`` set."""
        retries_left = self.retry_times
        last_failure = None
        attempt = 0
        self.dispatch_stats = {"single_steps": 0, "window_steps": 0,
                               "captures": 0, "replays": 0}
        self.window_timings = []
        self.loss_history = []
        self.validation_history = []
        restore_signal = self._install_preemption_handler()
        try:
            while True:
                try:
                    return self._optimize_once()
                except KeyboardInterrupt:
                    raise
                except Exception as e:
                    # no thread of the failed attempt outlives it; its
                    # graphs hold its static tensors
                    self._stop_device_prefetch()
                    self._stop_flush_worker()
                    self._graphs = {}
                    if not _is_transient(e):
                        logger.error(
                            "training failed with non-retryable %s: %s "
                            "(a programming error: a retry would hit the "
                            "same wall)", type(e).__name__, e)
                        raise
                    now = time.perf_counter()
                    if last_failure is not None \
                            and now - last_failure > self.retry_interval_s:
                        retries_left = self.retry_times
                        attempt = 0
                    last_failure = now
                    ckpt = self._latest_checkpoint()
                    if retries_left <= 0 or ckpt is None:
                        raise
                    retries_left -= 1
                    delay = self._backoff_delay(attempt)
                    attempt += 1
                    logger.warning(
                        "training failed (%s: %s); resuming from %s in "
                        "%.1fs (%d retr%s left)", type(e).__name__, e,
                        ckpt, delay, retries_left,
                        "y" if retries_left == 1 else "ies")
                    if delay > 0:
                        time.sleep(delay)
                    self._resume_from = ckpt
        finally:
            restore_signal()
            self._stop_device_prefetch()

    def _stop_device_prefetch(self):
        """Close a failed attempt's prefetcher (none: nothing to do): its
        producer would otherwise hold ``n_ahead`` batches on the device
        while the retry starts its own."""
        dp, self._active_dp = self._active_dp, None
        if dp is not None:
            dp.close()

    def _stop_flush_worker(self):
        """Stop the loss drain (none: nothing to do) so that a failed
        attempt's drain does not race the retry's.  Its queued windows
        are discarded first: the queue is bounded, so a blocking put of
        the stop mark could wait behind a drain stuck in a read."""
        q, t = self._flushq, self._flush_thread
        self._flushq = self._flush_thread = None
        if q is not None:
            while True:
                try:
                    q.get_nowait()
                    q.task_done()
                except queue.Empty:
                    break
            try:
                q.put_nowait(None)
            except queue.Full:
                pass  # the drain is stuck in a read; it is a daemon
        if t is not None:
            t.join(timeout=30.0)

    def _ckpt_manager(self) -> CheckpointManager:
        if self._ckpt_mgr is None \
                or self._ckpt_mgr.directory != self.checkpoint_path:
            self._ckpt_mgr = CheckpointManager(self.checkpoint_path,
                                               keep_n=self.checkpoint_keep_n)
        return self._ckpt_mgr

    def _latest_checkpoint(self) -> Optional[str]:
        """The newest checkpoint that is committed and intact (not the
        newest file: a crash mid-checkpoint leaves that one torn)."""
        if not self.checkpoint_path:
            return None
        try:
            return self._ckpt_manager().latest_good()
        except Exception:
            logger.warning("could not determine the latest good checkpoint "
                           "in %s", self.checkpoint_path, exc_info=True)
            return None

    def _backoff_delay(self, attempt: int) -> float:
        base = min(self.retry_backoff_s * (2.0 ** attempt),
                   self.retry_backoff_cap_s)
        j = self.retry_jitter
        return max(base * random.uniform(1.0 - j, 1.0 + j), 0.0)

    def _install_preemption_handler(self):
        """SIGTERM (a preemption notice) sets a flag that the loop honours
        at the next step boundary with a final checkpoint and a clean
        return.  Returns the function that puts the previous handler
        back; off the main thread there is none to install."""
        self._preempt_requested = False
        self.preempted = False
        if threading.current_thread() is not threading.main_thread():
            return lambda: None

        def handler(signum, frame):
            logger.warning(
                "received signal %d (preemption notice): requesting a "
                "final checkpoint at the next step boundary", signum)
            self._preempt_requested = True

        prev = signal.signal(signal.SIGTERM, handler)
        # None: a handler not installed from Python, which cannot be put
        # back; the default disposition stands in for it
        return lambda: signal.signal(
            signal.SIGTERM, signal.SIG_DFL if prev is None else prev)

    def _checkpoint_payload(self):
        """(model state, optim states, the loop's scalars) in the
        reference's tree, on the host."""
        named = list(self.model.named_parameters())
        buffers = list(state_buffers(self.model).items())
        host = iter(_to_host([t for _, t in named] + [t for _, t in buffers]
                             + _state_tensors(self._opt_states)))
        model_state = {
            "params": _sorted_keys(nest_jax_parameters(
                {n: next(host) for n, _ in named})),
            "buffers": _sorted_keys(nest_jax_parameters(
                {n: next(host) for n, _ in buffers}))}
        optim = [_host_state(s, host) for s in self._opt_states]
        scalars = {k: v for k, v in self.state.items()
                   if isinstance(v, (int, float))}
        return model_state, optim, scalars

    def _pipeline_snapshot(self) -> Dict[str, Any]:
        """The input pipeline's position written with every checkpoint;
        ``generation`` ties it to its payload (a generation is its
        neval)."""
        snap = PipelineState(
            seed=dataset_seed(self.dataset), epoch=self.state["epoch"],
            offset=self._epoch_offset,
            # at an epoch boundary records still hold the finished
            # epoch's total while the snapshot names the next epoch
            global_offset=(self.state["records"] if self._epoch_offset > 0
                           else 0),
            process_count=1, global_batch=self._last_global_batch) \
            .snapshot()
        snap["generation"] = int(self.state["neval"])
        return snap

    def _write_checkpoint(self) -> str:
        """One generation through the CheckpointManager: one copy of the
        parameters, buffers and states to the host per dtype, the atomic
        payload, its sidecar and manifest, retention."""
        with self.metrics.time("checkpoint time"):
            model_state, optim, scalars = self._checkpoint_payload()
            return self._ckpt_manager().save(
                model_state, optim, scalars, generation=self.state["neval"],
                overwrite=self.overwrite_checkpoint,
                pipeline_state=self._pipeline_snapshot())

    def _preemption_checkpoint(self):
        """The final checkpoint SIGTERM asks for, outside the trigger's
        schedule; a failed write is logged, not raised (the periodic
        checkpoint still exists)."""
        if not self.checkpoint_path:
            logger.warning("preemption: no checkpoint path set; exiting "
                           "without a final checkpoint")
            return
        if self._last_ckpt_neval == self.state["neval"]:
            return  # this boundary is checkpointed already
        self._last_ckpt_neval = self.state["neval"]
        try:
            path = self._write_checkpoint()
            logger.info("preemption checkpoint written to %s", path)
        except Exception:
            logger.exception("preemption checkpoint failed")

    def _restore(self, path: str) -> Optional[Dict[str, Any]]:
        """Load ``path`` into the model, the optim states and the loop's state;
        returns the checkpoint's pipeline position (or None)."""
        with self.metrics.time("checkpoint load time"):
            model_state, optim, scalars = load_checkpoint(path)
            load_jax_parameters(self.model, model_state["params"])
            load_jax_buffers(self.model, model_state.get("buffers", {}))
            if len(optim) != len(self._opt_states):
                raise ValueError(f"{path}: {len(optim)} optim states, but "
                                 f"the run has {len(self._opt_states)} "
                                 "method groups")
            # each group's lists are in the model's parameter order (the
            # reference's param_paths), not the file's sorted dict order
            for g, (fresh, saved) in enumerate(zip(self._opt_states,
                                                   optim)):
                _fill_state(fresh, saved, f"optim state {g}")
        self.state.update(scalars)
        # the iterations from here on run again: their validations and
        # checkpoints belong to this attempt
        self._last_val_neval = self._last_ckpt_neval = -1
        logger.info("resumed from %s at epoch %s iteration %s", path,
                    self.state["epoch"], self.state["neval"])
        return load_pipeline_state(path)

    def _pipeline_restore_plan(self, ps: Dict[str, Any], epoch: int) -> int:
        """How many batches of ``epoch`` to skip for a sample-accurate
        resume: the sidecar's offset, or 0 (replay the epoch from its
        start) where it cannot be applied faithfully: another version,
        another generation (a stale sidecar), another epoch (an epoch
        boundary), another topology, another seed, or a dataset whose
        order is not replayable."""
        try:
            if int(ps.get("version", -1)) != PIPELINE_STATE_VERSION:
                logger.warning("pipeline state version %s unsupported "
                               "(want %d); replaying the epoch from its "
                               "start", ps.get("version"),
                               PIPELINE_STATE_VERSION)
                return 0
            gen = ps.get("generation")
            if gen is not None and int(gen) != int(self.state["neval"]):
                logger.warning(
                    "pipeline state generation %s != the restored "
                    "iteration %s (stale sidecar from an interrupted "
                    "overwrite commit?); replaying the epoch from its "
                    "start", gen, self.state["neval"])
                return 0
            if int(ps.get("epoch", -1)) != int(epoch):
                return 0
            offset = int(ps.get("offset", 0))
            pc = ps.get("process_count")
            pc = None if pc is None else int(pc)
        except (TypeError, ValueError):
            logger.warning("malformed pipeline state %r; replaying the "
                           "epoch from its start", ps)
            return 0
        if pc not in (None, 1):
            logger.warning(
                "pipeline state written by %d processes: restoring onto "
                "another topology is not ported yet (%s); replaying the "
                "epoch from its start", pc, _PARALLEL)
            return 0
        if offset <= 0:
            return 0
        seed_now = dataset_seed(self.dataset)
        if int(ps.get("seed", seed_now)) != seed_now:
            logger.warning(
                "pipeline state seed %s != the dataset's seed %d: the "
                "epoch order differs, so skipping %d batches would drop "
                "the wrong samples; replaying the epoch from its start",
                ps.get("seed"), seed_now, offset)
            return 0
        if not supports_epoch(self.dataset):
            logger.warning("dataset.data() takes no epoch keyword, so its "
                           "order is not replayable; replaying the epoch "
                           "from its start")
            return 0
        return offset

    # ---- the loop ----------------------------------------------------------

    def _optimize_once(self) -> torch.nn.Module:
        model = self.model.train()
        # frozen parameters (core.module.freeze) get no update and no
        # optim state; the forward and the checkpoint's "params" still
        # hold them, as the reference's remainder does.  Read once an
        # attempt: a captured graph fixes what it updates
        named = [(n, p) for n, p in model.named_parameters()
                 if p.requires_grad]
        if not named:
            raise ValueError("the model has no trainable parameters")
        self._params = [p for _, p in named]
        device = self._params[0].device
        groups = self._group_indices([n for n, _ in named])
        self._group_idx = [idxs for _, idxs in groups]
        self._methods = ([self.optim_method] if not self.optim_methods
                         else [self.optim_methods[g] for g, _ in groups])
        self._opt_states = [m.init_state([self._params[i] for i in idxs])
                            for m, idxs in zip(self._methods,
                                               self._group_idx)]
        # a resume applies to the attempt it starts (a retry sets its own)
        path, self._resume_from = self._resume_from, None
        pipeline_restore = self._restore(path) if path else None
        self._scalars = self._scalar_tensors(device)
        specs = leaf_reg_specs(model)
        self._specs = (specs if any(s != (0.0, 0.0, 1.0) for s in specs)
                       else None)
        self._clip_norm_t = (None if self.grad_clip_norm is None else
                             torch.full((), self.grad_clip_norm,
                                        device=device))
        self._graphs: Dict[Tuple, _StepGraph] = {}
        generator = torch.Generator(device=device)
        self._streams = ReplayStreams()
        total_records = self.dataset.size()
        needs_loss = any(getattr(t, "needs_loss", False)
                         for t in (self.end_when, self.val_trigger,
                                   self.checkpoint_trigger)
                         if t is not None)
        interval = self.log_interval
        if interval is None:
            interval = 1 if needs_loss else 8
        elif needs_loss and interval > 1:
            logger.warning("log_interval=%d ignored: a loss-reading "
                           "trigger (minLoss) requires per-iteration loss "
                           "readback", interval)
            interval = 1
        k_req = self.iters_per_dispatch
        use_dp = bool(self.device_prefetch_ahead)
        if use_dp and k_req > 1:
            logger.warning("device prefetch disabled: "
                           "iterations_per_dispatch=%d stages its windows "
                           "itself", k_req)
            use_dp = False
        # read once an attempt: with nothing installed a step pays one
        # comparison
        faults = chaos.active()

        # pending: (neval, epoch, n_records, records_cum, loss_device)
        pending: List[Tuple] = []
        window = {"start": time.perf_counter(), "data_t": 0.0}
        # the reader's own: the completion of the window it read last
        read = {"last_ready": 0.0}
        wall_start = time.perf_counter()

        def consume(entries, values, event, start, data_t):
            """Read back and log one flushed window."""
            if event is not None:
                # the interpreter lock is released while it waits
                event.synchronize()
            t_ready = time.perf_counter()
            losses = values.tolist()
            # completion to completion: windows queued to the drain were
            # dispatched before the previous one completed
            window_dt = t_ready - max(start, read["last_ready"])
            read["last_ready"] = t_ready
            self.window_timings.append((len(entries), window_dt, data_t))
            per_iter = window_dt / len(entries)
            for (neval_i, epoch_i, n_i, cum_i, _), lf in zip(entries,
                                                            losses):
                logger.info(
                    "Epoch %d %d/%d][Iteration %d][Wall Clock %.3fs] "
                    "Trained %d records in %.4f seconds. Throughput is "
                    "%.1f records/second. Loss is %.4f.",
                    epoch_i, cum_i, total_records, neval_i,
                    time.perf_counter() - wall_start, n_i, per_iter,
                    n_i / max(per_iter, 1e-9), lf)
                self.loss_history.append((neval_i, lf))
            self.state["loss"] = losses[-1]

        # the asynchronous drain: nothing in the loop reads the loss
        flushq: Optional[queue.Queue] = None
        if not needs_loss:
            flushq = queue.Queue(maxsize=4)

            def drain():
                while True:
                    job = flushq.get()
                    if job is None:
                        flushq.task_done()
                        return
                    try:
                        consume(*job)
                    except Exception:
                        logger.exception("asynchronous loss readback "
                                         "failed")
                    finally:
                        flushq.task_done()

            self._flushq = flushq
            self._flush_thread = threading.Thread(
                target=drain, daemon=True, name="bigdl-loss-drain")
            self._flush_thread.start()

        def flush(sync=False):
            """Hand the pending window to the reader (the drain, where it
            runs); ``sync`` waits until every window handed over is
            read."""
            if pending:
                job = (list(pending),
                       *_loss_readback([e[-1] for e in pending]),
                       window["start"], window["data_t"])
                if flushq is not None:
                    flushq.put(job)
                else:
                    consume(*job)
                pending.clear()
                window["start"] = time.perf_counter()
                window["data_t"] = 0.0
            if sync and flushq is not None:
                flushq.join()

        saw_batches = False
        while not self.end_when(self.state):
            epoch = self.state["epoch"]
            epoch_start = time.perf_counter()
            skip = 0
            if pipeline_restore is not None:
                skip = self._pipeline_restore_plan(pipeline_restore, epoch)
                pipeline_restore = None  # it applies to one epoch only
            if skip <= 0:
                self.state["records"] = 0
            # else: a mid-epoch resume, whose restored records already
            # count the epoch's consumed samples
            self._epoch_offset = 0
            batches = iter(epoch_iter(self.dataset, epoch))
            if skip > 0:
                self._epoch_offset = skip_batches(batches, skip)
                saw_batches = True  # consumed before the failure
                logger.info("pipeline restore: skipped %d consumed "
                            "batch(es) of epoch %d, resuming at the next "
                            "batch", self._epoch_offset, epoch)
                if self._epoch_offset < skip:
                    logger.warning(
                        "pipeline restore: epoch %d has only %d batches "
                        "but the checkpoint consumed %d", epoch,
                        self._epoch_offset, skip)
            dp = None
            if use_dp:
                # after the restore's skip: _epoch_offset counts the
                # batches the loop consumed, not the ones staged ahead
                dp = DevicePrefetch(self.device_prefetch_ahead,
                                    device=device).apply(batches)
                batches = self._active_dp = dp
            lookahead: List = []
            stop = False
            while not stop:
                t_fetch = time.perf_counter()
                while len(lookahead) < k_req:
                    batch = next(batches, None)
                    if batch is None:
                        break
                    lookahead.append(batch)
                if not lookahead:
                    break
                saw_batches = True
                want = (self._safe_window([b.size() for b in lookahead])
                        if k_req > 1 else 1)
                group = [lookahead.pop(0)]
                if want > 1:
                    sig0 = _batch_sig(group[0])
                    while (lookahead and len(group) < want
                           and _batch_sig(lookahead[0]) == sig0):
                        group.append(lookahead.pop(0))
                if len(group) != k_req:
                    # a trimmed window or a ragged tail: single steps, so
                    # that only the k-step program exists besides them
                    lookahead[0:0] = group[1:]
                    group = group[:1]
                window["data_t"] += time.perf_counter() - t_fetch
                if faults is not None:
                    # before the dispatch, so an injected failure lands
                    # between steps as a real one would
                    for i in range(len(group)):
                        faults.on_step(self.state["neval"] + i)
                if len(group) > 1 and device.type == "cuda":
                    losses = self._replay_window(group, generator, device,
                                                 epoch)
                else:
                    losses = [self._single_step(
                        b, generator, device, epoch, self.state["neval"] + i)
                        for i, b in enumerate(group)]
                self.dispatch_stats["window_steps" if len(group) > 1
                                    else "single_steps"] += len(group)
                for b, loss in zip(group, losses):
                    n = b.size()
                    self._last_global_batch = n
                    self.state["records"] += n
                    pending.append((self.state["neval"], epoch, n,
                                    self.state["records"], loss))
                    if len(pending) >= interval:
                        flush()
                    self.state["neval"] += 1
                    self._epoch_offset += 1
                    self.state["is_epoch_end"] = False
                    if self._want_validate() or self._want_checkpoint():
                        # validation logs follow the iterations they
                        # validate, a checkpoint holds the loss, and their
                        # wall time is no step's
                        flush(sync=True)
                        self._maybe_validate_checkpoint()
                        window["start"] = time.perf_counter()
                    # no break: a window's updates are all applied, so
                    # its bookkeeping completes even if a custom end
                    # trigger fires inside it
                    stop = (stop or bool(self.end_when(self.state))
                            or self._preempt_requested)
            if dp is not None:
                dp.close()  # an early stop leaves the producer blocked
                self._active_dp = None
            if self._preempt_requested:
                # the step boundary SIGTERM asked for: a final checkpoint
                # and a clean return, the unfinished epoch not advanced
                flush(sync=True)
                self._preemption_checkpoint()
                self.preempted = True
                logger.warning("preemption: exiting training cleanly at "
                               "epoch %d iteration %d", epoch,
                               self.state["neval"])
                break
            self.state["epoch"] += 1
            self._epoch_offset = 0  # the boundary: next epoch, batch 0
            self.state["is_epoch_end"] = True
            flush(sync=self._want_validate() or self._want_checkpoint())
            logger.info("Epoch %d finished in %.2f s", epoch,
                        time.perf_counter() - epoch_start)
            if not saw_batches:
                raise ValueError("dataset produced no batches")
            self._maybe_validate_checkpoint()
            window["start"] = time.perf_counter()
        flush(sync=True)
        self._stop_flush_worker()
        self._graphs = {}
        return self.model

def _regularized(g, p, spec):
    """scale · (g + l1·sign(p) + l2·p) (the reference's ``apply_reg``)."""
    l1, l2, scale = spec
    if l1:
        g = g + l1 * torch.sign(p)
    if l2:
        g = g + l2 * p
    if scale != 1.0:
        g = g * scale
    return g
