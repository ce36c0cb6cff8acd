"""Optimization methods and learning-rate schedules (counterpart of
``bigdl_tpu/optim/methods.py``: every schedule and every method).

The reference's methods are pure ``update(grads, params, state) ->
(params, state)`` transforms compiled into the step.  The port updates
the parameters and the state tensors IN PLACE under ``no_grad`` (no
second copy of either) and returns the same list and state dict, so the
reference's calling convention still reads the same.  The step counter
``state["t"]`` is a host int.

What the reference computes on the device from the step counter and the
epoch (the learning rate of every schedule, Adam's bias corrections
``1 - beta^t``, LBFGS's ``t > 0``) the port computes on the host in
float32, in the reference's order of operations: these are a method's
**step scalars** (``step_scalars(state, epoch)``, the learning rate
first).  ``update`` is ``apply(grads, params, state, *step_scalars)`` and
the counter's increment.  ``apply`` takes each scalar as a float or as a
0-dim float32 tensor: the ``Optimizer`` passes tensors, which its
captured CUDA graph reads and the host refills before each replay, so no
value that moves with the step is baked into the graph.  A tensor also
keeps the reference's true division where a scalar divides a tensor
(on the card, a division by a Python float multiplies by its
reciprocal).

Every schedule returns the float32 value the reference's jitted step
computes, as a Python float.  ``pow`` and ``exp`` are numpy's, which may
differ from XLA's by one ulp.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

__all__ = [
    "OptimMethod", "SGD", "Adam", "ParallelAdam", "Adagrad", "Adadelta",
    "Adamax", "RMSprop", "Ftrl", "LarsSGD", "LBFGS",
    "Default", "Step", "MultiStep", "EpochStep", "EpochDecay", "Poly",
    "Exponential", "NaturalExp", "Warmup", "SequentialSchedule", "Plateau",
    "EpochSchedule", "Regime", "LearningRateSchedule",
]

_f = np.float32


def _lr(value) -> float:
    return float(_f(value))


def _over(step, constant):
    """``step / constant`` as the reference's jitted step computes it: XLA
    folds a division by a constant into a product with the constant's
    float32 reciprocal."""
    return _f(step) * (_f(1) / _f(constant))


# --------------------------------------------------------------------------
# Learning rate schedules: float32 on the host, as the reference's traced
# step computes them (an int32 step over a Python int is a float32
# quotient, folded into a product with the reciprocal; a Python float is
# a weak float32)
# --------------------------------------------------------------------------

class LearningRateSchedule:
    """lr(base_lr, step, epoch) -> float32 value; pure function of
    progress (``Plateau`` also of the metrics it was told)."""

    def __call__(self, base_lr, step, epoch):
        raise NotImplementedError


class Default(LearningRateSchedule):
    """lr / (1 + step*decay) (the reference's SGD.Default)."""

    def __init__(self, learning_rate_decay: float = 0.0):
        self.decay = learning_rate_decay

    def __call__(self, base_lr, step, epoch):
        return _lr(_f(base_lr) / (_f(1.0) + _f(step) * _f(self.decay)))


class Step(LearningRateSchedule):
    """lr * gamma^(floor(step/step_size))."""

    def __init__(self, step_size: int, gamma: float):
        self.step_size, self.gamma = step_size, gamma

    def __call__(self, base_lr, step, epoch):
        n = np.floor(_over(step, self.step_size))
        return _lr(_f(base_lr) * np.power(_f(self.gamma), n))


class MultiStep(LearningRateSchedule):
    """lr * gamma^(#milestones passed)."""

    def __init__(self, step_sizes, gamma: float):
        self.step_sizes = tuple(step_sizes)
        self.gamma = gamma

    def __call__(self, base_lr, step, epoch):
        passed = _f(sum(1 for s in self.step_sizes if step >= s))
        return _lr(_f(base_lr) * np.power(_f(self.gamma), passed))


class EpochStep(LearningRateSchedule):
    """lr * gamma^(floor(epoch/step_size))."""

    def __init__(self, step_size: int, gamma: float):
        self.step_size, self.gamma = step_size, gamma

    def __call__(self, base_lr, step, epoch):
        n = np.floor(_over(epoch, self.step_size))
        return _lr(_f(base_lr) * np.power(_f(self.gamma), n))


class EpochDecay(LearningRateSchedule):
    """lr * 0.1^decay_fn(epoch); ``decay_fn`` is a host function of the
    epoch."""

    def __init__(self, decay_fn: Callable[[int], float]):
        self.decay_fn = decay_fn

    def __call__(self, base_lr, step, epoch):
        return _lr(_f(base_lr) * np.power(_f(0.1), _f(self.decay_fn(epoch))))


class Poly(LearningRateSchedule):
    """lr * (1 - step/max_iteration)^power, 0 past max."""

    def __init__(self, power: float, max_iteration: int):
        self.power, self.max_iteration = power, max_iteration

    def __call__(self, base_lr, step, epoch):
        frac = np.clip(_over(step, self.max_iteration), _f(0.0), _f(1.0))
        return _lr(_f(base_lr) * np.power(_f(1.0) - frac, _f(self.power)))


class Exponential(LearningRateSchedule):
    """lr * decay_rate^(step/decay_step), optionally staircased."""

    def __init__(self, decay_step: int, decay_rate: float,
                 stair_case: bool = False):
        self.decay_step, self.decay_rate = decay_step, decay_rate
        self.stair_case = stair_case

    def __call__(self, base_lr, step, epoch):
        p = _over(step, self.decay_step)
        if self.stair_case:
            p = np.floor(p)
        return _lr(_f(base_lr) * np.power(_f(self.decay_rate), p))


class NaturalExp(LearningRateSchedule):
    """lr * exp(-gamma * floor(step/decay_step))."""

    def __init__(self, decay_step: int, gamma: float):
        self.decay_step, self.gamma = decay_step, gamma

    def __call__(self, base_lr, step, epoch):
        n = np.floor(_over(step, self.decay_step))
        return _lr(_f(base_lr) * np.exp(_f(-self.gamma) * n))


class Warmup(LearningRateSchedule):
    """Linear ramp by delta per step (composed inside
    ``SequentialSchedule``)."""

    def __init__(self, delta: float):
        self.delta = delta

    def __call__(self, base_lr, step, epoch):
        return _lr(_f(base_lr) + _f(self.delta) * _f(step))


class SequentialSchedule(LearningRateSchedule):
    """Chain schedules, each active for its iteration budget: a stage sees
    its local step clipped into [0, budget] and, as its base, the final
    rate of the stage before it; past the last stage the last stage's
    final rate holds."""

    def __init__(self, iteration_per_epoch: int = 1):
        self.entries = []  # (schedule, max_iter)
        self.iteration_per_epoch = iteration_per_epoch

    def add(self, schedule: LearningRateSchedule, max_iteration: int):
        self.entries.append((schedule, max_iteration))
        return self

    def __call__(self, base_lr, step, epoch):
        offset = 0
        for sched, budget in self.entries:
            if step < offset + budget:
                local = min(max(step - offset, 0), budget)
                return sched(base_lr, local, epoch)
            # this stage is done: the next one starts from its final rate
            base_lr = sched(base_lr, budget, epoch)
            offset += budget
        return _lr(base_lr)


class Plateau(LearningRateSchedule):
    """Reduce the rate when a monitored metric stops improving.  Host
    state: the ``Optimizer`` calls ``on_metric(score)`` after every
    validation; ``__call__`` returns the factor-adjusted rate, which the
    next step (or graph replay) reads."""

    def __init__(self, monitor: str = "score", factor: float = 0.1,
                 patience: int = 10, mode: str = "min", epsilon: float = 1e-4,
                 cooldown: int = 0, min_lr: float = 0.0):
        self.monitor, self.factor, self.patience = monitor, factor, patience
        self.mode, self.epsilon = mode, epsilon
        self.cooldown, self.min_lr = cooldown, min_lr
        self.current_factor = 1.0
        self._best = None
        self._wait = 0
        self._cooldown_left = 0

    def on_metric(self, value: float):
        improved = (self._best is None
                    or (self.mode == "min" and value < self._best - self.epsilon)
                    or (self.mode == "max" and value > self._best + self.epsilon))
        if self._cooldown_left > 0:
            self._cooldown_left -= 1
        if improved:
            self._best = value
            self._wait = 0
        elif self._cooldown_left == 0:
            self._wait += 1
            if self._wait >= self.patience:
                self.current_factor *= self.factor
                self._wait = 0
                self._cooldown_left = self.cooldown

    def __call__(self, base_lr, step, epoch):
        # both Python floats in the reference: the product in float64,
        # then the maximum of two weak float32s
        return _lr(max(_f(base_lr * self.current_factor), _f(self.min_lr)))


class EpochSchedule(LearningRateSchedule):
    """Per-epoch regimes: the rate of the last regime whose [start, end]
    holds the epoch, else the base rate."""

    def __init__(self, regimes):
        self.regimes = list(regimes)  # [(start_epoch, end_epoch, lr)]

    def __call__(self, base_lr, step, epoch):
        lr = base_lr
        for start, end, r_lr in self.regimes:
            if start <= epoch <= end:
                lr = r_lr
        return _lr(lr)


class Regime:
    def __init__(self, start_epoch, end_epoch, config):
        self.start_epoch, self.end_epoch, self.config = \
            start_epoch, end_epoch, config


# --------------------------------------------------------------------------
# OptimMethods
# --------------------------------------------------------------------------

def _zeros(params):
    return [torch.zeros_like(p) for p in params]


def _tree_copy(value):
    if isinstance(value, dict):
        return {k: _tree_copy(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_tree_copy(v) for v in value)
    return value


class OptimMethod:
    """Base update rule: ``init_state(params)`` then ``update(grads,
    params, state, epoch) -> (params, state)``, which is ``apply(grads,
    params, state, *step_scalars(state, epoch))`` and one step of
    ``state["t"]``."""

    def init_state(self, params: List[torch.Tensor]) -> Dict[str, Any]:
        return {"t": 0}

    def current_lr(self, state, epoch=0) -> float:
        """The learning rate of the step ``state["t"]``, on the host."""
        raise NotImplementedError

    def step_scalars(self, state, epoch=0) -> List[float]:
        """The float32 scalars of the step ``state["t"]`` that ``apply``
        reads, computed on the host; the learning rate first."""
        return [self.current_lr(state, epoch)]

    def apply(self, grads, params, state, *scalars):
        """Update ``params`` and the tensors of ``state`` in place with the
        step's scalars (floats or 0-dim float32 tensors)."""
        raise NotImplementedError

    def update(self, grads, params, state, epoch=0):
        device = params[0].device
        scalars = [torch.tensor(s, dtype=torch.float32, device=device)
                   for s in self.step_scalars(state, epoch)]
        self.apply(grads, params, state, *scalars)
        state["t"] += 1
        return params, state

    def get_learning_rate(self, state):
        return getattr(self, "learning_rate", None)

    def state_dict(self, state):
        """A copy of ``state``'s structure over the same tensors (the
        reference's ``tree_map`` identity)."""
        return _tree_copy(state)


class _Scheduled(OptimMethod):
    """A method whose rate is its schedule's at the step."""

    def current_lr(self, state, epoch=0) -> float:
        return self.schedule(self.learning_rate, state["t"], epoch)


class _Decayed(OptimMethod):
    """A method whose rate is lr / (1 + t * decay), as Adagrad's and
    RMSprop's."""

    def current_lr(self, state, epoch=0) -> float:
        return Default(self.learning_rate_decay)(
            self.learning_rate, state["t"], epoch)


def _decayed(g, p, weight_decay):
    return g + weight_decay * p if weight_decay > 0 else g


class SGD(_Scheduled):
    """SGD with momentum, dampening, nesterov, weight decay and any
    schedule (``Default(learning_rate_decay)`` unless given)."""

    def __init__(self, learning_rate: float = 1e-3,
                 learning_rate_decay: float = 0.0,
                 weight_decay: float = 0.0,
                 momentum: float = 0.0,
                 dampening: Optional[float] = None,
                 nesterov: bool = False,
                 learning_rate_schedule: Optional[LearningRateSchedule] = None):
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay
        self.momentum = momentum
        self.dampening = momentum if dampening is None else dampening
        self.nesterov = nesterov
        self.schedule = learning_rate_schedule or Default(learning_rate_decay)
        if nesterov and (momentum <= 0 or self.dampening != 0):
            raise ValueError(
                "Nesterov momentum requires momentum > 0 and dampening = 0")

    def init_state(self, params):
        s: Dict[str, Any] = {"t": 0}
        if self.momentum > 0:
            s["velocity"] = _zeros(params)
        return s

    @torch.no_grad()
    def apply(self, grads, params, state, lr):
        for i, (g, p) in enumerate(zip(grads, params)):
            g = _decayed(g, p, self.weight_decay)
            if self.momentum > 0:
                vel = state["velocity"][i]
                vel.mul_(self.momentum).add_((1 - self.dampening) * g)
                g = g + self.momentum * vel if self.nesterov else vel
            p.sub_(lr * g)


class Adam(_Scheduled):
    """Adam with bias correction; its step scalars are the rate and
    ``1 - beta1^t``, ``1 - beta2^t`` at ``t = state["t"] + 1``."""

    def __init__(self, learning_rate: float = 1e-3,
                 learning_rate_decay: float = 0.0,
                 beta1: float = 0.9, beta2: float = 0.999,
                 epsilon: float = 1e-8, weight_decay: float = 0.0,
                 learning_rate_schedule: Optional[LearningRateSchedule] = None):
        self.learning_rate = learning_rate
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.weight_decay = weight_decay
        self.schedule = learning_rate_schedule or Default(learning_rate_decay)

    def init_state(self, params):
        return {"t": 0, "m": _zeros(params), "v": _zeros(params)}

    def step_scalars(self, state, epoch=0):
        t = _f(state["t"] + 1)
        return [self.current_lr(state, epoch),
                float(_f(1) - np.power(_f(self.beta1), t)),
                float(_f(1) - np.power(_f(self.beta2), t))]

    @torch.no_grad()
    def apply(self, grads, params, state, lr, bc1, bc2):
        b1, b2 = self.beta1, self.beta2
        for i, (g, p) in enumerate(zip(grads, params)):
            g = _decayed(g, p, self.weight_decay)
            m, v = state["m"][i], state["v"][i]
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g * g)
            p.sub_(lr * (m / bc1) / (torch.sqrt(v / bc2) + self.epsilon))


class ParallelAdam(Adam):
    """The reference's multi-threaded Adam exists to parallelize the
    elementwise update across cores; here it is Adam."""


class Adagrad(_Decayed):
    def __init__(self, learning_rate: float = 1e-3,
                 learning_rate_decay: float = 0.0,
                 weight_decay: float = 0.0):
        self.learning_rate = learning_rate
        self.learning_rate_decay = learning_rate_decay
        self.weight_decay = weight_decay

    def init_state(self, params):
        return {"t": 0, "accum": _zeros(params)}

    @torch.no_grad()
    def apply(self, grads, params, state, lr):
        for i, (g, p) in enumerate(zip(grads, params)):
            g = _decayed(g, p, self.weight_decay)
            a = state["accum"][i]
            a.add_(g * g)
            p.sub_(lr * g / (torch.sqrt(a) + 1e-10))


class Adadelta(OptimMethod):
    def __init__(self, decay_rate: float = 0.9, epsilon: float = 1e-10):
        self.rho, self.epsilon = decay_rate, epsilon
        self.learning_rate = 1.0

    def init_state(self, params):
        return {"t": 0, "accum": _zeros(params),
                "delta_accum": _zeros(params)}

    def current_lr(self, state, epoch=0) -> float:
        return self.learning_rate

    @torch.no_grad()
    def apply(self, grads, params, state, lr):
        rho, eps = self.rho, self.epsilon
        for i, (g, p) in enumerate(zip(grads, params)):
            a, d = state["accum"][i], state["delta_accum"][i]
            a.mul_(rho).add_((1 - rho) * g * g)
            delta = g * torch.sqrt(d + eps) / torch.sqrt(a + eps)
            d.mul_(rho).add_((1 - rho) * delta * delta)
            p.sub_(delta)


def flushed(value: float) -> float:
    """``value`` as float32 arithmetic with subnormals flushed to zero
    sees it (XLA on the CPU flushes them; torch and CUDA keep them)."""
    return 0.0 if abs(_f(value)) < np.finfo(np.float32).tiny else value


class Adamax(OptimMethod):
    """Adamax; its step scalars are the rate and ``lr / (1 - beta1^t)``.
    Its default epsilon, 1e-38, is below float32's smallest normal: the
    reference's XLA flushes it to zero, so the port takes it as
    :func:`flushed` makes it (a gradient entry that is exactly 0 from the
    first step then gives 0 / 0, as in the reference)."""

    def __init__(self, learning_rate: float = 0.002,
                 beta1: float = 0.9, beta2: float = 0.999,
                 epsilon: float = 1e-38):
        self.learning_rate = learning_rate
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def init_state(self, params):
        return {"t": 0, "m": _zeros(params), "u": _zeros(params)}

    def current_lr(self, state, epoch=0) -> float:
        return _lr(self.learning_rate)

    def step_scalars(self, state, epoch=0):
        bc = _f(1) - np.power(_f(self.beta1), _f(state["t"] + 1))
        return [self.current_lr(state, epoch),
                float(_f(self.learning_rate) / bc)]

    @torch.no_grad()
    def apply(self, grads, params, state, lr, step_size):
        eps = flushed(self.epsilon)
        for i, (g, p) in enumerate(zip(grads, params)):
            m, u = state["m"][i], state["u"][i]
            m.mul_(self.beta1).add_((1 - self.beta1) * g)
            u.copy_(torch.maximum(self.beta2 * u, torch.abs(g) + eps))
            p.sub_(step_size * m / u)


class RMSprop(_Decayed):
    def __init__(self, learning_rate: float = 1e-2,
                 learning_rate_decay: float = 0.0,
                 decay_rate: float = 0.99, epsilon: float = 1e-8):
        self.learning_rate = learning_rate
        self.learning_rate_decay = learning_rate_decay
        self.rho, self.epsilon = decay_rate, epsilon

    def init_state(self, params):
        return {"t": 0, "accum": _zeros(params)}

    @torch.no_grad()
    def apply(self, grads, params, state, lr):
        for i, (g, p) in enumerate(zip(grads, params)):
            a = state["accum"][i]
            a.mul_(self.rho).add_((1 - self.rho) * g * g)
            p.sub_(lr * g / (torch.sqrt(a) + self.epsilon))


class Ftrl(OptimMethod):
    """Follow-the-regularized-leader."""

    def __init__(self, learning_rate: float = 1e-3,
                 learning_rate_power: float = -0.5,
                 initial_accumulator_value: float = 0.1,
                 l1_regularization_strength: float = 0.0,
                 l2_regularization_strength: float = 0.0,
                 l2_shrinkage_regularization_strength: float = 0.0):
        self.learning_rate = learning_rate
        self.lr_power = learning_rate_power
        self.init_accum = initial_accumulator_value
        self.l1 = l1_regularization_strength
        self.l2 = l2_regularization_strength
        self.l2_shrinkage = l2_shrinkage_regularization_strength

    def init_state(self, params):
        return {"t": 0,
                "accum": [torch.full_like(p, self.init_accum)
                          for p in params],
                "linear": _zeros(params)}

    def current_lr(self, state, epoch=0) -> float:
        return _lr(self.learning_rate)

    @torch.no_grad()
    def apply(self, grads, params, state, lr):
        lp = self.lr_power
        for i, (g, p) in enumerate(zip(grads, params)):
            a, lin = state["accum"][i], state["linear"][i]
            g_shrink = g + 2 * self.l2_shrinkage * p
            new_a = a + g * g
            pow_new = torch.pow(new_a, -lp)
            sigma = (pow_new - torch.pow(a, -lp)) / lr
            lin.add_(g_shrink).sub_(sigma * p)
            quad = pow_new / lr + 2 * self.l2
            l_reg = torch.clamp(lin, -self.l1, self.l1)
            p.copy_((l_reg - lin) / quad)
            a.copy_(new_a)


class LarsSGD(SGD):
    """Layer-wise adaptive rate scaling: a per-leaf trust ratio
    ||w|| / (||g|| + 1e-12) (of the decayed gradient) scales it; always
    carries a velocity, even at momentum 0."""

    def __init__(self, learning_rate: float = 1e-3,
                 trust_coefficient: float = 0.001,
                 momentum: float = 0.5,
                 weight_decay: float = 5e-4,
                 learning_rate_schedule: Optional[LearningRateSchedule] = None):
        super().__init__(learning_rate, momentum=momentum,
                         weight_decay=0.0, dampening=0.0,
                         learning_rate_schedule=learning_rate_schedule)
        self.trust = trust_coefficient
        self.lars_weight_decay = weight_decay

    def init_state(self, params):
        return {"t": 0, "velocity": _zeros(params)}

    @torch.no_grad()
    def apply(self, grads, params, state, lr):
        wd = self.lars_weight_decay
        for i, (g, p) in enumerate(zip(grads, params)):
            g = g + wd * p
            w_norm = torch.linalg.vector_norm(p.reshape(-1))
            g_norm = torch.linalg.vector_norm(g.reshape(-1))
            trust = torch.where((w_norm > 0) & (g_norm > 0),
                                self.trust * w_norm / (g_norm + 1e-12),
                                torch.ones_like(w_norm))
            vel = state["velocity"][i]
            vel.mul_(self.momentum).add_(lr * (g * trust))
            p.sub_(vel)


class LBFGS(OptimMethod):
    """L-BFGS with a fixed history of ``n_correction`` pairs over the
    parameters flattened in their list order (the reference's
    ``ravel_pytree`` of the group's list); no line search: a step of
    ``learning_rate``.  Its step scalars are the rate and ``t > 0`` (1.0
    or 0.0).  Holds two (history, n) float32 matrices: meant for small
    models."""

    def __init__(self, max_iter: int = 20, max_eval: Optional[float] = None,
                 tolerance_fun: float = 1e-5, tolerance_x: float = 1e-9,
                 n_correction: int = 10, learning_rate: float = 1.0,
                 line_search=None):
        self.history = n_correction
        self.learning_rate = learning_rate

    def init_state(self, params):
        n = sum(p.numel() for p in params)
        m = self.history
        kw = dict(dtype=torch.float32, device=params[0].device)
        return {"t": 0,
                "s": torch.zeros((m, n), **kw), "y": torch.zeros((m, n), **kw),
                "rho": torch.zeros((m,), **kw),
                "prev_flat": torch.zeros((n,), **kw),
                "prev_grad": torch.zeros((n,), **kw)}

    def current_lr(self, state, epoch=0) -> float:
        return _lr(self.learning_rate)

    def step_scalars(self, state, epoch=0):
        return [self.current_lr(state, epoch), 1.0 if state["t"] > 0 else 0.0]

    @torch.no_grad()
    def apply(self, grads, params, state, lr, started):
        flat = torch.cat([p.reshape(-1) for p in params])
        gflat = torch.cat([g.reshape(-1) for g in grads])
        s_hist, y_hist, rho = state["s"], state["y"], state["rho"]
        s_new = flat - state["prev_flat"]
        y_new = gflat - state["prev_grad"]
        ys = torch.dot(y_new, s_new)
        valid = (torch.as_tensor(started, device=ys.device) > 0) & (ys > 1e-10)
        s_hist.copy_(torch.where(valid, torch.cat([s_hist[1:], s_new[None]]),
                                 s_hist))
        y_hist.copy_(torch.where(valid, torch.cat([y_hist[1:], y_new[None]]),
                                 y_hist))
        rho_new = torch.where(ys > 1e-10, 1.0 / ys, torch.zeros_like(ys))
        rho.copy_(torch.where(valid, torch.cat([rho[1:], rho_new[None]]), rho))

        # the two-loop recursion over the whole history, newest first
        q = gflat
        alphas = []
        for i in range(self.history - 1, -1, -1):
            a = rho[i] * torch.dot(s_hist[i], q)
            q = q - a * y_hist[i]
            alphas.append((i, a))
        gamma = torch.where(valid, ys / (torch.dot(y_new, y_new) + 1e-12),
                            torch.ones_like(ys))
        r = gamma * q
        for i, a in reversed(alphas):
            b = rho[i] * torch.dot(y_hist[i], r)
            r = r + s_hist[i] * (a - b)

        new_flat = flat - lr * r
        state["prev_flat"].copy_(flat)
        state["prev_grad"].copy_(gflat)
        offset = 0
        for p in params:
            n = p.numel()
            p.copy_(new_flat[offset:offset + n].view_as(p))
            offset += n
