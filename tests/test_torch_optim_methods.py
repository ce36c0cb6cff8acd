"""The port's ``optim/methods.py`` against the JAX package's, on the CPU:
every method's parameters and state after 5 updates from the same
numpy-seeded parameters and gradients, every schedule's rate over steps
and epochs (``SequentialSchedule`` at its stage boundaries, ``Plateau``
on a planted score sequence), Adamax's zero gradient, 3-step
``Optimizer`` runs of a small MLP with Adam, Adagrad and LBFGS in both
packages (weights carried by ``interop/jax_params.py``), the Plateau hook
after validation, the step scalars a captured step reads, and a
checkpoint's save -> resume with Adam and LBFGS.

Restates ``tests/test_optim.py`` :54 (the torch oracle), :69, :78, :90,
:107 and :379 against the port.

Tolerances: parameters and state rtol 1e-5, atol 1e-6 after 5 updates
(LBFGS's history and Ftrl's accumulators rtol 1e-4, atol 1e-5: a dot
product over every entry, and ``pow`` against XLA's); the torch oracle
rtol 1e-4, atol 1e-5 as at :65-66; the Optimizer runs rtol 1e-4, atol
2e-5 (``tests/test_torch_optimizer_loop.py``'s atol 1e-5 doubled for
Adam's per-entry normalisation, RUN_TOL).  A schedule's rate
within one float32 ulp of the reference's jitted value (numpy's ``pow``
and ``exp`` against XLA's); equal where no transcendental is involved.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu import optim as joptim
from bigdl_tpu.optim import methods as jm
from bigdl_tpu_torch import nn as pnn
from bigdl_tpu_torch.interop import flatten_jax_parameters
from bigdl_tpu_torch.optim import Optimizer, Trigger
from bigdl_tpu_torch.optim import methods as pm

from chip_smoke import PlantedScore
from test_torch_optimizer_loop import _pair, _pipeline
from test_torch_rnn import one_torch_thread  # noqa: F401

STATE_TOL = dict(rtol=1e-5, atol=1e-6)
LOOSE_TOL = dict(rtol=1e-4, atol=1e-5)
# the Optimizer runs: Adam divides each entry by its own gradient's
# magnitude, so an entry whose gradient the reference's 8-device sum
# rounds apart moves by up to 1.12e-5 (measured: 1 of 25088 entries)
RUN_TOL = dict(rtol=1e-4, atol=2e-5)
SHAPES = [(5, 7), (7,), (3,)]

# name: (reference method, port method); every method of the reference's
# __all__ (ParallelAdam is Adam in both)
METHODS = {
    "sgd": (lambda m: m.SGD(0.1, momentum=0.9, dampening=0.1,
                            weight_decay=1e-2, learning_rate_decay=0.3)),
    "sgd_nesterov": (lambda m: m.SGD(0.1, momentum=0.9, dampening=0.0,
                                     nesterov=True)),
    "adam": (lambda m: m.Adam(0.01, learning_rate_decay=0.1,
                              weight_decay=1e-2)),
    "parallel_adam": (lambda m: m.ParallelAdam(0.02)),
    "adagrad": (lambda m: m.Adagrad(0.05, learning_rate_decay=0.2,
                                    weight_decay=1e-2)),
    "adadelta": (lambda m: m.Adadelta(0.9, 1e-6)),
    "adamax": (lambda m: m.Adamax(0.05)),
    "rmsprop": (lambda m: m.RMSprop(0.01, learning_rate_decay=0.1,
                                    decay_rate=0.9)),
    "ftrl": (lambda m: m.Ftrl(0.5, l1_regularization_strength=0.01,
                              l2_regularization_strength=0.02,
                              l2_shrinkage_regularization_strength=0.03)),
    "lars": (lambda m: m.LarsSGD(0.1, trust_coefficient=0.02)),
    "lars_momentum_0": (lambda m: m.LarsSGD(0.1, momentum=0.0)),
    "lbfgs": (lambda m: m.LBFGS(n_correction=3, learning_rate=0.2)),
    "sgd_poly": (lambda m: m.SGD(0.1, momentum=0.5, learning_rate_schedule=(
        m.SequentialSchedule(2).add(m.Warmup(0.05), 2)
        .add(m.Poly(0.5, 4), 4)))),
}
LOOSE = {"lbfgs", "ftrl"}


def _rnd(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


def _quad_grads(params):
    """Gradients of sum(c * p^2) with c in (0.5, 1.5] per tensor: a
    function LBFGS's curvature pairs can follow."""
    return [(2.0 * (1.0 + 0.5 * (i % 2 + 1) / 2)) * p
            for i, p in enumerate(params)]


def _grads(step, params, name):
    if name == "lbfgs":
        return _quad_grads(params)
    return [_rnd(s, 100 * step + i) for i, s in enumerate(SHAPES)]


def _leaves(state):
    """{key: [arrays]} of a state (a list state in order, a tensor as
    one entry); the counter apart."""
    out = {}
    for k, v in state.items():
        if k == "t":
            continue
        vs = v if isinstance(v, (list, tuple)) else [v]
        out[k] = [np.asarray(x.detach().cpu() if torch.is_tensor(x) else x)
                  for x in vs]
    return out


def _run_reference(method, n_steps, name):
    params = [jnp.asarray(_rnd(s, i)) for i, s in enumerate(SHAPES)]
    state = method.init_state(params)
    update = jax.jit(lambda g, p, s: method.update(g, p, s, 1))
    for step in range(n_steps):
        grads = _grads(step, [np.asarray(p) for p in params], name)
        params, state = update([jnp.asarray(g) for g in grads], params,
                               state)
    return [np.asarray(p) for p in params], state


def _run_port(method, n_steps, name):
    params = [torch.tensor(_rnd(s, i)) for i, s in enumerate(SHAPES)]
    state = method.init_state(params)
    for step in range(n_steps):
        grads = _grads(step, [p.numpy() for p in params], name)
        method.update([torch.tensor(g) for g in grads], params, state,
                      epoch=1)
    return [p.numpy() for p in params], state


@pytest.mark.parametrize("name", sorted(METHODS))
def test_every_method_matches_the_reference_after_5_updates(name):
    want_p, want_s = _run_reference(METHODS[name](jm), 5, name)
    got_p, got_s = _run_port(METHODS[name](pm), 5, name)
    tol = LOOSE_TOL if name in LOOSE else STATE_TOL
    for i, (g, w) in enumerate(zip(got_p, want_p)):
        np.testing.assert_allclose(g, w, **tol, err_msg=f"param {i}")
    assert got_s["t"] == int(want_s["t"]) == 5
    got, want = _leaves(got_s), _leaves(want_s)
    assert sorted(got) == sorted(want)
    for k in want:
        assert len(got[k]) == len(want[k]), k
        for i, (g, w) in enumerate(zip(got[k], want[k])):
            np.testing.assert_allclose(g, w, **tol, err_msg=f"{k}[{i}]")


def test_every_reference_name_is_exported():
    import bigdl_tpu_torch.optim as popt
    assert set(jm.__all__) <= set(pm.__all__)
    assert all(hasattr(popt, n) for n in jm.__all__)
    covered = {type(METHODS[n](pm)).__name__ for n in METHODS}
    methods = {n for n in jm.__all__ if isinstance(getattr(jm, n), type)
               and issubclass(getattr(jm, n), jm.OptimMethod)
               and n != "OptimMethod"}
    assert methods <= covered, methods - covered


def test_adamax_zero_gradient_entry_follows_the_reference():
    """Adamax's epsilon 1e-38 is below float32's smallest normal: the
    reference's XLA flushes it, so an entry whose first gradient is
    exactly 0 gets u = 0 and m / u = 0 / 0 = NaN in both packages."""
    g = np.array([0.0, 0.5, -1.0], np.float32)
    p0 = np.array([1.0, 2.0, 3.0], np.float32)
    jmeth = jm.Adamax(0.05)
    jp = [jnp.asarray(p0)]
    js = jmeth.init_state(jp)
    pmeth = pm.Adamax(0.05)
    pp = [torch.tensor(p0)]
    ps = pmeth.init_state(pp)
    for _ in range(2):
        jp, js = jax.jit(lambda g_, p_, s_: jmeth.update(g_, p_, s_))(
            [jnp.asarray(g)], jp, js)
        pmeth.update([torch.tensor(g)], pp, ps)
    want = np.asarray(jp[0])
    assert np.isnan(want[0]) and np.isfinite(want[1:]).all()
    np.testing.assert_allclose(pp[0].numpy(), want, equal_nan=True,
                               **STATE_TOL)
    np.testing.assert_allclose(ps["u"][0].numpy(), np.asarray(js["u"][0]),
                               **STATE_TOL)
    assert pm.flushed(1e-38) == 0.0 and pm.flushed(1e-8) == 1e-8


# ---- schedules ---------------------------------------------------------

SCHEDULES = {
    "default": lambda m: m.Default(0.37),
    "step": lambda m: m.Step(3, 0.7),
    "multistep": lambda m: m.MultiStep([2, 5, 9], 0.3),
    "epoch_step": lambda m: m.EpochStep(2, 0.5),
    "epoch_decay": lambda m: m.EpochDecay(lambda e: e // 2),
    "poly": lambda m: m.Poly(0.5, 11),
    "exponential": lambda m: m.Exponential(4, 0.9),
    "exponential_stair": lambda m: m.Exponential(4, 0.9, stair_case=True),
    "natural_exp": lambda m: m.NaturalExp(3, 0.35),
    "warmup": lambda m: m.Warmup(0.013),
    "sequential": lambda m: m.SequentialSchedule(3).add(m.Warmup(0.02), 4)
    .add(m.Poly(0.5, 6), 6).add(m.Exponential(2, 0.8), 3),
    "plateau": lambda m: m.Plateau(factor=0.5, patience=2, min_lr=0.01),
    "epoch_schedule": lambda m: m.EpochSchedule(
        [(1, 2, 0.05), (3, 4, 0.02)]),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_every_schedule_matches_the_reference_over_steps(name):
    """The rate at steps 0..16 and epochs 1..5, against the reference's
    schedule jitted over an int32 step and epoch, as its Optimizer's
    step traces it; within one float32 ulp."""
    ref = jax.jit(lambda s, e: jnp.asarray(SCHEDULES[name](jm)(0.17, s, e),
                                           jnp.float32))
    port = SCHEDULES[name](pm)
    got, want = [], []
    for epoch in range(1, 6):
        for step in range(17):
            got.append(port(0.17, step, epoch))
            want.append(float(ref(jnp.int32(step), jnp.int32(epoch))))
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_array_max_ulp(got, want, maxulp=1)
    assert np.all(got.astype(np.float64) == [float(np.float32(v))
                                             for v in got])


def test_sequential_schedule_hands_each_stage_its_predecessors_final_rate():
    seq = pm.SequentialSchedule(1).add(pm.Warmup(0.1), 3) \
        .add(pm.Poly(1.0, 4), 4)
    peak = pm.Warmup(0.1)(1.0, 3, 0)
    assert seq(1.0, 2, 0) == pm.Warmup(0.1)(1.0, 2, 0)
    assert seq(1.0, 3, 0) == pm.Poly(1.0, 4)(peak, 0, 0) == peak
    assert seq(1.0, 5, 0) == pm.Poly(1.0, 4)(peak, 2, 0)
    # past the last stage: its final rate
    assert seq(1.0, 7, 0) == seq(1.0, 50, 0) == pm.Poly(1.0, 4)(peak, 4, 0)


def test_plateau_on_a_planted_score_sequence():
    """Two reductions and a cooldown, the factor and the rate after each
    score equal to the reference's."""
    scores = [1.0, 0.9, 0.95, 0.95, 0.95, 0.95, 0.95, 0.8, 0.85, 0.85]
    ref = jm.Plateau(factor=0.5, patience=2, cooldown=2, min_lr=0.02)
    port = pm.Plateau(factor=0.5, patience=2, cooldown=2, min_lr=0.02)
    factors = []
    for s in scores:
        ref.on_metric(s)
        port.on_metric(s)
        assert port.current_factor == ref.current_factor
        assert port(0.1, 0, 1) == float(jnp.asarray(ref(0.1, 0, 1),
                                                    jnp.float32))
        factors.append(port.current_factor)
    assert factors[2] == 1.0 and factors[3] == 0.5
    assert factors[5] == 0.5 and factors[6] == 0.25
    assert port(0.1, 0, 1) == pytest.approx(max(0.1 * factors[-1], 0.02))


# ---- tests/test_optim.py restated --------------------------------------

def _quad():
    return [torch.tensor([1.0, -2.0, 3.0])]


@pytest.mark.parametrize("method,torch_ctor", [
    (pm.SGD(0.1), lambda p: torch.optim.SGD(p, lr=0.1)),
    (pm.SGD(0.1, momentum=0.9, dampening=0.0),
     lambda p: torch.optim.SGD(p, 0.1, momentum=0.9)),
    (pm.SGD(0.1, momentum=0.9, dampening=0.0, nesterov=True),
     lambda p: torch.optim.SGD(p, 0.1, momentum=0.9, nesterov=True)),
    (pm.SGD(0.1, weight_decay=0.01),
     lambda p: torch.optim.SGD(p, 0.1, weight_decay=0.01)),
    (pm.Adam(0.01), lambda p: torch.optim.Adam(p, 0.01)),
    (pm.Adagrad(0.05), lambda p: torch.optim.Adagrad(p, 0.05, eps=1e-10)),
    (pm.RMSprop(0.01, decay_rate=0.9),
     lambda p: torch.optim.RMSprop(p, 0.01, alpha=0.9)),
    (pm.Adadelta(0.9, 1e-6),
     lambda p: torch.optim.Adadelta(p, lr=1.0, rho=0.9, eps=1e-6)),
])
def test_optim_methods_match_torch(method, torch_ctor):
    params = _quad()
    state = method.init_state(params)
    tw = params[0].clone().requires_grad_(True)
    topt = torch_ctor([tw])
    for _ in range(5):
        method.update([2.0 * params[0]], params, state)
        topt.zero_grad()
        (tw ** 2).sum().backward()
        topt.step()
    np.testing.assert_allclose(params[0].numpy(), tw.detach().numpy(),
                               rtol=1e-4, atol=1e-5)


def test_adamax_converges():
    method = pm.Adamax(0.05)
    params = _quad()
    state = method.init_state(params)
    for _ in range(200):
        method.update([2.0 * params[0]], params, state)
    assert float((params[0] ** 2).sum()) < 1e-2


@pytest.mark.parametrize("method", [
    pm.Ftrl(0.5), pm.LarsSGD(0.1, trust_coefficient=0.02),
    pm.LBFGS(learning_rate=0.2)], ids=lambda m: type(m).__name__)
def test_ftrl_and_lars_and_lbfgs_decrease_loss(method):
    params = _quad()
    state = method.init_state(params)
    start = float((params[0] ** 2).sum())
    for _ in range(30):
        method.update([2.0 * params[0]], params, state)
    assert float((params[0] ** 2).sum()) < start


def test_lr_schedules():
    s = pm.Step(10, 0.5)
    assert s(1.0, 0, 0) == 1.0 and s(1.0, 10, 0) == 0.5
    assert s(1.0, 25, 0) == 0.25
    ms = pm.MultiStep([5, 15], 0.1)
    assert ms(1.0, 4, 0) == pytest.approx(1.0)
    assert ms(1.0, 5, 0) == pytest.approx(0.1)
    assert ms(1.0, 20, 0) == pytest.approx(0.01)
    p = pm.Poly(2.0, 100)
    assert p(1.0, 0, 0) == pytest.approx(1.0)
    assert p(1.0, 50, 0) == pytest.approx(0.25)
    assert p(1.0, 100, 0) == pytest.approx(0.0)
    seq = pm.SequentialSchedule().add(pm.Warmup(0.1), 10) \
        .add(pm.Poly(1.0, 100), 100)
    assert seq(1.0, 5, 0) == pytest.approx(1.5)


def test_plateau_schedule():
    pl = pm.Plateau(factor=0.5, patience=2, mode="min")
    for v in [1.0, 0.9, 0.95, 0.95, 0.95]:
        pl.on_metric(v)
    assert pl.current_factor == pytest.approx(0.5)


def test_lars_momentum_zero_no_crash():
    m = pm.LarsSGD(0.1, momentum=0.0)
    params = _quad()
    state = m.init_state(params)
    m.update([2.0 * params[0]], params, state)
    assert "velocity" in state
    assert np.isfinite(params[0].numpy()).all()


def test_sgd_takes_every_schedule():
    for name, make in SCHEDULES.items():
        sgd = pm.SGD(0.1, learning_rate_schedule=make(pm))
        assert sgd.current_lr({"t": 3}, epoch=2) == make(pm)(0.1, 3, 2), name


def test_get_learning_rate_and_state_dict():
    m = pm.Adam(0.03)
    state = m.init_state(_quad())
    assert m.get_learning_rate(state) == 0.03
    copy = m.state_dict(state)
    assert copy is not state and copy["m"] is not state["m"]
    assert copy["m"][0] is state["m"][0] and copy["t"] == 0


# ---- the Optimizer ------------------------------------------------------

OPT_METHODS = {
    "adam": lambda m: m.Adam(0.01),
    "adagrad": lambda m: m.Adagrad(0.05, weight_decay=5e-4),
    "lbfgs": lambda m: m.LBFGS(n_correction=4, learning_rate=0.05),
}


@pytest.mark.parametrize("name", sorted(OPT_METHODS))
def test_optimizer_steps_match_the_reference(name):
    """3 steps of a 784-32-10 MLP through each package's Optimizer from
    the same weights and batches."""
    ref, port = _pair()
    ref_opt = joptim.Optimizer(ref, _pipeline("ref", n=96),
                               jnn.ClassNLLCriterion()) \
        .set_optim_method(OPT_METHODS[name](joptim)) \
        .set_end_when(joptim.Trigger.max_iteration(3))
    port_opt = Optimizer(port, _pipeline("port", n=96),
                         pnn.ClassNLLCriterion()) \
        .set_optim_method(OPT_METHODS[name](pm)) \
        .set_end_when(Trigger.max_iteration(3))
    ref_opt.optimize()
    port_opt.optimize()
    want = flatten_jax_parameters(ref.parameters())
    for n, p in port.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n], **RUN_TOL,
                                   err_msg=n)
    assert port_opt.state["neval"] == ref_opt.state["neval"] == 4
    np.testing.assert_allclose(port_opt.state["loss"],
                               ref_opt.state["loss"], rtol=1e-4)


PLANTED = [1.0, 0.9, 0.95, 0.95, 0.95, 0.95, 0.95, 0.95]


def _plateau_run(hook=True):
    """16 SGD steps under a Plateau(0.5, patience 2, cooldown 2), a
    validation every 2 iterations scoring PLANTED, in windows of 2;
    returns the rate each step read and the schedule."""
    _, port = _pair()
    plateau = pm.Plateau(factor=0.5, patience=2, cooldown=2)
    opt = Optimizer(port, _pipeline("port", n=512), pnn.ClassNLLCriterion()) \
        .set_optim_method(pm.SGD(0.1, learning_rate_schedule=plateau)) \
        .set_end_when(Trigger.max_iteration(16)) \
        .set_validation(Trigger.several_iteration(2),
                        _pipeline("port", n=32), [PlantedScore(PLANTED)]) \
        .set_iterations_per_dispatch(2)
    if not hook:
        opt._on_score = lambda: None
    rates = []
    step = opt._step

    def recording(x, y, generator, scalars):
        rates.append(float(scalars[0][0]))
        return step(x, y, generator, scalars)
    opt._step = recording
    opt.optimize()
    return rates, plateau


def test_plateau_reads_the_validation_score():
    """The Optimizer tells a Plateau schedule every validation's score
    (reductions after the 4th and 7th, a cooldown between), and the next
    step reads the reduced rate; without the hook the rate never moves."""
    rates, plateau = _plateau_run()
    assert plateau.current_factor == 0.25
    f = np.float32
    # a trigger reads neval after the step's increment: the 4th
    # validation follows step 7, the 7th step 13
    assert rates == [float(f(0.1))] * 7 + [float(f(0.05))] * 6 \
        + [float(f(0.025))] * 3
    unhooked, still = _plateau_run(hook=False)
    assert still.current_factor == 1.0
    assert unhooked == [float(f(0.1))] * 16


def test_step_scalars_are_what_the_update_reads():
    """Adam's step scalars: the rate and the two bias corrections at
    t + 1, in float32; LBFGS's t > 0; Adamax's lr / (1 - beta1^t)."""
    adam = pm.Adam(0.01, beta1=0.8, beta2=0.99)
    s = adam.step_scalars({"t": 4}, 1)
    assert s[1] == float(np.float32(1) - np.float32(0.8) ** np.float32(5))
    assert s[2] == float(np.float32(1) - np.float32(0.99) ** np.float32(5))
    assert pm.LBFGS().step_scalars({"t": 0}) == [1.0, 0.0]
    assert pm.LBFGS().step_scalars({"t": 2}) == [1.0, 1.0]
    amax = pm.Adamax(0.002).step_scalars({"t": 0})
    assert amax[1] == float(np.float32(0.002) / (np.float32(1) -
                                                 np.float32(0.9)))


@pytest.mark.parametrize("name", ["adam", "lbfgs"])
def test_checkpoint_save_resume_round_trip(tmp_path, name):
    """Train 2 epochs writing every-epoch checkpoints; resume the first in
    a fresh Optimizer: it ends on the uninterrupted run's weights and
    state bit for bit, and the reference's reader finds in the file the
    state its own method would hold (keys and shapes)."""
    from bigdl_tpu.utils.file import load_checkpoint

    def run(ckpt=None, resume=None):
        _, port = _pair()
        opt = Optimizer(port, _pipeline("port", n=96),
                        pnn.ClassNLLCriterion()) \
            .set_optim_method(OPT_METHODS[name](pm)) \
            .set_end_when(Trigger.max_epoch(2))
        if ckpt is not None:
            opt.set_checkpoint(str(ckpt), Trigger.every_epoch(), keep_n=3)
        if resume is not None:
            opt.resume(resume)
        opt.optimize()
        return port, opt

    whole, whole_opt = run(tmp_path)
    first = min((p for p in tmp_path.iterdir() if p.name.endswith(".npz")),
                key=lambda p: int(p.name.split(".")[1]))
    _, optim, scalars = load_checkpoint(str(first))
    ref_state = OPT_METHODS[name](jm).init_state(
        [jnp.zeros(p.shape) for p in whole.parameters()])
    assert sorted(optim[0]) == sorted(ref_state)
    assert jax.tree_util.tree_map(np.shape, optim[0]) == \
        jax.tree_util.tree_map(np.shape, ref_state)
    assert int(np.asarray(optim[0]["t"])) == 3
    resumed, resumed_opt = run(resume=str(first))
    for (n, a), b in zip(whole.named_parameters(), resumed.parameters()):
        assert torch.equal(a, b), n
    for a, b in zip(_leaves(whole_opt._opt_states[0]).items(),
                    _leaves(resumed_opt._opt_states[0]).items()):
        assert all(np.array_equal(x, y) for x, y in zip(a[1], b[1])), a[0]
    assert resumed_opt.state["neval"] == whole_opt.state["neval"]


def test_optimizer_windows_equal_single_steps_for_every_method():
    """Every method through the Optimizer on the CPU in windows of 2 (one
    step at a time through the same step-scalar tensors): a finite loss,
    and the weights of k=1 bit for bit."""
    for name in sorted(METHODS):
        runs = []
        for k in (1, 2):
            _, port = _pair()
            opt = Optimizer(port, _pipeline("port", n=160),
                            pnn.ClassNLLCriterion()) \
                .set_optim_method(METHODS[name](pm)) \
                .set_end_when(Trigger.max_iteration(5)) \
                .set_iterations_per_dispatch(k)
            opt.optimize()
            runs.append([p.detach().clone() for p in port.parameters()])
            assert np.isfinite(opt.state["loss"]), name
        assert all(torch.equal(a, b) for a, b in zip(*runs)), name
