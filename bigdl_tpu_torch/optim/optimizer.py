"""The single-device core of the ``Optimizer`` façade (counterpart of
``bigdl_tpu/optim/optimizer.py``: the setters, the flat unsharded branch
of ``_build_step`` and the loop of ``_optimize_once`` with its
``consume_window``).

``Optimizer(model, dataset, criterion).optimize()`` trains in place.
Each step zeroes the gradients, runs the forward and the criterion,
calls ``backward()`` and lets the optim method update the float32 master
parameters in place under ``no_grad``.  The driver state (``epoch``,
``neval``, ``records``, ``loss``, ``is_epoch_end``) advances exactly as
the reference's, so a ``Trigger`` sees the same states.

Losses stay on the device.  Every ``log_interval`` steps the window is
read back: first one blocking read of its LAST loss pins the completion
time, then the rest are read in one transfer.  ``window_timings`` holds
``(iterations, completion-to-completion seconds, data seconds)`` per
window, as the reference's does; the first window also bears the
kernels' build and the library warm-up.

``set_compute_dtype(torch.bfloat16)`` computes what the reference's
``cast_floating`` does: every floating parameter AND buffer is cast for
the forward (``torch.func.functional_call`` with cast copies, so the
gradients reach the float32 masters through the casts), floating inputs
are cast too, and the output is cast back to float32 before the
criterion.  ``torch.autocast`` would not: it keeps softmax, layer norm
and ``log_softmax`` in float32 and rounds elsewhere.  A buffer the
forward assigns (a BatchNorm's running statistics in train mode) is
carried back into the model's float32 buffer after the step, detached:
float32 of the value computed under the compute dtype, as the
reference's ``cast_floating(new_rest, float32)`` keeps it.

What the slice does not need raises ``NotImplementedError`` naming its
ROADMAP item; nothing is silently ignored.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.func import functional_call

from bigdl_tpu_torch.core.module import forward_context
from bigdl_tpu_torch.optim.methods import SGD, OptimMethod
from bigdl_tpu_torch.optim.trigger import Trigger

logger = logging.getLogger("bigdl_tpu_torch.optim")

__all__ = ["Optimizer"]

_LOOP_REST = "ROADMAP.md queue 1, item 4 (the training loop, the rest)"
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


def _cast_floating(value, dtype):
    if isinstance(value, (tuple, list)):
        return type(value)(_cast_floating(v, dtype) for v in value)
    if torch.is_tensor(value) and value.is_floating_point():
        return value.to(dtype)
    return value


class Optimizer:
    """``Optimizer(model, dataset, criterion).optimize()`` on one device
    (the model's).  ``seed`` keys the generator that train-mode dropout
    draws from, one fresh stream per iteration."""

    def __init__(self, model: torch.nn.Module, dataset, criterion,
                 batch_size: Optional[int] = None, *, seed: int = 0):
        if batch_size is not None:
            raise NotImplementedError(
                "Optimizer(batch_size=...) batches raw samples with "
                f"SampleToMiniBatch, which is not ported yet ({_LOOP_REST}); "
                "pass a dataset of MiniBatches")
        self.model = model
        self.dataset = dataset
        self.criterion = criterion
        self.seed = int(seed)
        self.optim_method: OptimMethod = SGD()
        self.end_when: Trigger = Trigger.max_epoch(1)
        self.compute_dtype: Optional[torch.dtype] = None
        self.log_interval: Optional[int] = None  # None = auto
        self.state: Dict[str, Any] = {"epoch": 1, "neval": 1,
                                      "records": 0, "loss": float("nan"),
                                      "score": float("-inf")}
        self.window_timings: List[Tuple[int, float, float]] = []
        # (neval, loss) of every iteration, as read back per window (the
        # reference writes each to its log and its train summary)
        self.loss_history: List[Tuple[int, float]] = []

    # ---- configuration (the reference's setters) -------------------------

    def set_optim_method(self, method: OptimMethod) -> "Optimizer":
        self.optim_method = method
        return self

    def set_end_when(self, trigger: Trigger) -> "Optimizer":
        self.end_when = trigger
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

    set_optim_methods = _not_ported("set_optim_methods", _LOOP_REST)
    set_validation = _not_ported("set_validation", _LOOP_REST)
    set_checkpoint = _not_ported("set_checkpoint", _LOOP_REST)
    resume = _not_ported("resume", _LOOP_REST)
    set_gradient_clipping_by_l2_norm = _not_ported(
        "set_gradient_clipping_by_l2_norm", _LOOP_REST)
    set_constant_gradient_clipping = _not_ported(
        "set_constant_gradient_clipping", _LOOP_REST)
    set_iterations_per_dispatch = _not_ported(
        "set_iterations_per_dispatch", _LOOP_REST)
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

    # ---- the step ----------------------------------------------------------

    def _forward(self, x):
        """The model's output in float32, computed in the compute dtype."""
        dtype = self.compute_dtype
        if dtype is None:
            return self.model(x)
        buffers = dict(self.model.named_buffers())
        cast = {name: _cast_floating(t, dtype) for name, t in
                (*self.model.named_parameters(), *buffers.items())}
        given = {name: cast[name] for name in buffers}
        out = functional_call(self.model, cast,
                              (_cast_floating(x, dtype),)).float()
        # functional_call writes what the forward assigned into ``cast``
        with torch.no_grad():
            for name, buf in buffers.items():
                if cast[name] is not given[name]:
                    buf.copy_(cast[name].detach())
        return out

    def _step(self, params, opt_state, x, y, generator, epoch):
        """One training step; returns the loss, still on the device."""
        for p in params:
            p.grad = None
        with forward_context(generator=generator):
            out = self._forward(x)
        loss = self.criterion(out, y)
        loss.backward()
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in params]
        self.optim_method.update(grads, params, opt_state, epoch)
        return loss.detach()

    # ---- the loop ----------------------------------------------------------

    def optimize(self) -> torch.nn.Module:
        """Train until ``end_when`` fires; returns the model, trained in
        place."""
        model = self.model.train()
        params = [p for p in model.parameters() if p.requires_grad]
        if not params:
            raise ValueError("the model has no trainable parameters")
        device = params[0].device
        opt_state = self.optim_method.init_state(params)
        generator = torch.Generator(device=device)
        total_records = self.dataset.size()
        needs_loss = getattr(self.end_when, "needs_loss", False)
        interval = self.log_interval
        if interval is None:
            interval = 1 if needs_loss else 8
        elif needs_loss and interval > 1:
            logger.warning("log_interval=%d ignored: a loss-reading "
                           "trigger (minLoss) requires per-iteration loss "
                           "readback", interval)
            interval = 1

        # pending: (neval, epoch, n_records, records_cum, loss_device)
        pending: List[Tuple] = []
        window = {"start": time.perf_counter(), "data_t": 0.0,
                  "last_ready": 0.0}
        self.window_timings = []
        self.loss_history = []
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
            stop = False
            while not stop:
                t_fetch = time.perf_counter()
                batch = next(batches, None)
                if batch is None:
                    break
                saw_batches = True
                x = _stage(batch.get_input(), device)
                y = _stage(batch.get_target(), device)
                generator.manual_seed(_step_seed(self.seed,
                                                 self.state["neval"]))
                window["data_t"] += time.perf_counter() - t_fetch
                loss = self._step(params, opt_state, x, y, generator, epoch)
                n = batch.size()
                self.state["records"] += n
                pending.append((self.state["neval"], epoch, n,
                                self.state["records"], loss))
                if len(pending) >= interval:
                    flush()
                self.state["neval"] += 1
                self.state["is_epoch_end"] = False
                stop = bool(self.end_when(self.state))
            self.state["epoch"] += 1
            self.state["is_epoch_end"] = True
            flush()
            logger.info("Epoch %d finished in %.2f s", epoch,
                        time.perf_counter() - epoch_start)
            if not saw_batches:
                raise ValueError("dataset produced no batches")
            window["start"] = time.perf_counter()
        flush()
        return self.model
