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
``score``.

Losses stay on the device.  Every ``log_interval`` steps the window is
read back: first one blocking read of its LAST loss pins the completion
time, then the rest are read in one transfer.  ``window_timings`` holds
``(iterations, completion-to-completion seconds, data seconds)`` per
window, as the reference's does; the first window also bears the
kernels' build and the library warm-up.

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
inputs), each group's learning rate (a 0-dim float32 tensor the host
fills from its step counter and epoch) and the dropout stream (the
generator, registered with the graph, reseeded per iteration).  Each
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

What the slice does not need raises ``NotImplementedError`` naming its
ROADMAP item; nothing is silently ignored.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.func import functional_call

from bigdl_tpu_torch.core.module import forward_context
from bigdl_tpu_torch.optim.methods import SGD, OptimMethod
from bigdl_tpu_torch.optim.metrics import Metrics
from bigdl_tpu_torch.optim.regularizer import leaf_reg_specs
from bigdl_tpu_torch.optim.trigger import Trigger
from bigdl_tpu_torch.optim.validation import ValidationMethod, \
    ValidationResult

logger = logging.getLogger("bigdl_tpu_torch.optim")

__all__ = ["Optimizer"]

_LOOP_REST = ("ROADMAP.md queue 1, item 4 (the training loop, the rest: "
              "checkpoints, resume, retries and prefetch)")
_TELEMETRY = "ROADMAP.md queue 1, item 10 (telemetry and health)"
_PARALLEL = "ROADMAP.md queue 1, item 11 (parallelism)"


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


def _cast_floating(value, dtype):
    if isinstance(value, (tuple, list)):
        return type(value)(_cast_floating(v, dtype) for v in value)
    if torch.is_tensor(value) and value.is_floating_point():
        return value.to(dtype)
    return value


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


class _StepGraph:
    """One captured step: the graph, its static inputs, learning-rate
    tensors and loss."""

    def __init__(self, graph, x, y, lrs, loss):
        self.graph, self.x, self.y = graph, x, y
        self.lrs, self.loss = lrs, loss


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
        # the dispatch of the last optimize(): steps run singly, steps
        # run inside windows, graphs captured and their replays
        self.dispatch_stats: Dict[str, int] = {}

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

    set_checkpoint = _not_ported("set_checkpoint", _LOOP_REST)
    resume = _not_ported("resume", _LOOP_REST)
    set_failure_retry = _not_ported("set_failure_retry", _LOOP_REST)
    set_device_prefetch = _not_ported("set_device_prefetch", _LOOP_REST)
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
            tensors = {name: _cast_floating(t, dtype)
                       for name, t in tensors.items()}
            x = _cast_floating(x, dtype)
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

    def _step(self, x, y, generator, lrs):
        """One training step with each group's learning rate ``lrs[i]``
        (a float or a 0-dim tensor); returns the loss, on the device.
        Runs no host read of a device value, so a CUDA graph can capture
        it."""
        params = self._params
        for p in params:
            p.grad = None
        with forward_context(generator=generator):
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
                method.apply(self._clip(gs), ps, state, lrs[gi])
        return loss.detach()

    def _lrs(self, epoch) -> List[float]:
        return [m.current_lr(s, epoch)
                for m, s in zip(self._methods, self._opt_states)]

    def _advance_counters(self):
        for s in self._opt_states:
            s["t"] += 1

    def _single_step(self, batch, generator, device, epoch, neval):
        x = _stage(batch.get_input(), device)
        y = _stage(batch.get_target(), device)
        generator.manual_seed(_step_seed(self.seed, neval))
        loss = self._step(x, y, generator, self._lrs(epoch))
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
            for t, lr in zip(sg.lrs, self._lrs(epoch)):
                t.fill_(lr)
            generator.manual_seed(_step_seed(self.seed, base + i))
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
        lrs = [torch.zeros((), device=device) for _ in self._methods]
        for t, lr in zip(lrs, self._lrs(epoch)):
            t.fill_(lr)
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            generator.manual_seed(_step_seed(self.seed, self.state["neval"]))
            self._step(x, y, generator, lrs)
        torch.cuda.current_stream(device).wait_stream(side)
        with torch.no_grad():
            for t, s in zip(keep, saved):
                t.copy_(s)
        del saved
        for p in self._params:
            p.grad = None
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(generator)
        with torch.cuda.graph(graph):
            loss = self._step(x, y, generator, lrs)
        self.dispatch_stats["captures"] += 1
        return _StepGraph(graph, x, y, lrs, loss)

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

    # ---- the loop ----------------------------------------------------------

    def _safe_window(self, sizes: List[int]) -> int:
        """The largest window <= len(sizes) in which no trigger fires
        before its last iteration (the reference's ``safe_window``); a
        loss-reading trigger forces 1."""
        trigs = [t for t in (self.end_when, self.val_trigger)
                 if t is not None]
        if any(getattr(t, "needs_loss", False) for t in trigs):
            return 1
        st = dict(self.state)
        st["is_epoch_end"] = False
        for i, n in enumerate(sizes):
            st["records"] += n
            st["neval"] += 1
            if ((self.val_trigger is not None and self.val_trigger(st))
                    or self.end_when(st)):
                return i + 1
        return len(sizes)

    def optimize(self) -> torch.nn.Module:
        """Train until ``end_when`` fires; returns the model, trained in
        place."""
        model = self.model.train()
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
        specs = leaf_reg_specs(model)
        self._specs = (specs if any(s != (0.0, 0.0, 1.0) for s in specs)
                       else None)
        self._clip_norm_t = (None if self.grad_clip_norm is None else
                             torch.full((), self.grad_clip_norm,
                                        device=device))
        self._graphs: Dict[Tuple, _StepGraph] = {}
        self.dispatch_stats = {"single_steps": 0, "window_steps": 0,
                               "captures": 0, "replays": 0}
        generator = torch.Generator(device=device)
        total_records = self.dataset.size()
        needs_loss = any(getattr(t, "needs_loss", False)
                         for t in (self.end_when, self.val_trigger)
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

        # pending: (neval, epoch, n_records, records_cum, loss_device)
        pending: List[Tuple] = []
        window = {"start": time.perf_counter(), "data_t": 0.0,
                  "last_ready": 0.0}
        self.window_timings = []
        self.loss_history = []
        self.validation_history = []
        wall_start = time.perf_counter()

        def flush():
            if not pending:
                return
            # pin the completion with one blocking read of the window's
            # LAST loss: a stack of the window would be a device op
            pending[-1][-1].item()
            t_ready = time.perf_counter()
            losses = torch.stack([e[-1] for e in pending]).tolist()
            window_dt = t_ready - max(window["start"], window["last_ready"])
            window["last_ready"] = t_ready
            self.window_timings.append((len(pending), window_dt,
                                        window["data_t"]))
            per_iter = window_dt / len(pending)
            for (neval_i, epoch_i, n_i, cum_i, _), lf in zip(pending,
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
            pending.clear()
            window["start"] = time.perf_counter()
            window["data_t"] = 0.0

        saw_batches = False
        while not self.end_when(self.state):
            epoch = self.state["epoch"]
            epoch_start = time.perf_counter()
            self.state["records"] = 0
            batches = iter(self.dataset.data(train=True, epoch=epoch))
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
                    self.state["records"] += n
                    pending.append((self.state["neval"], epoch, n,
                                    self.state["records"], loss))
                    if len(pending) >= interval:
                        flush()
                    self.state["neval"] += 1
                    self.state["is_epoch_end"] = False
                    if self._want_validate():
                        # validation logs follow the iterations they
                        # validate, and its wall time is no step's
                        flush()
                        self._maybe_validate()
                        window["start"] = time.perf_counter()
                    # no break: a window's updates are all applied, so
                    # its bookkeeping completes even if a custom end
                    # trigger fires inside it
                    stop = stop or bool(self.end_when(self.state))
            self.state["epoch"] += 1
            self.state["is_epoch_end"] = True
            flush()
            logger.info("Epoch %d finished in %.2f s", epoch,
                        time.perf_counter() - epoch_start)
            if not saw_batches:
                raise ValueError("dataset produced no batches")
            self._maybe_validate()
            window["start"] = time.perf_counter()
        flush()
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
