"""The port's asynchronous loss drain on the CPU (the reference's
``bigdl-loss-drain``, ``bigdl_tpu/optim/optimizer.py``): where no trigger
reads the loss, each window's losses are read and logged on a drain
thread.  The async run and the sync one (``end_when`` OR'ed with a
``Trigger.min_loss`` that never fires) give the same ``loss_history``,
the same number of ``window_timings`` and the same parameters, exactly:
the drain changes where the losses are read, not what is computed.  A
checkpoint written under the drain holds its own iteration's loss; no
drain thread outlives a retried or a failed ``optimize()``; and
``state["loss"]`` is the last logged loss when ``optimize()`` returns.
Imports no JAX.
"""

import logging
import threading

import numpy as np
import pytest
import torch

from bigdl_tpu_torch import nn as pnn
from bigdl_tpu_torch.dataset import DataSet, Sample, SampleToMiniBatch
from bigdl_tpu_torch.dataset.transformer import Transformer
from bigdl_tpu_torch.optim import SGD, Optimizer, Trigger
from bigdl_tpu_torch.utils import chaos
from bigdl_tpu_torch.utils.file import CheckpointManager, load_checkpoint

DRAIN = "bigdl-loss-drain"


@pytest.fixture(autouse=True)
def _chaos_reset():
    chaos.reset()
    yield
    chaos.reset()


def _drains():
    return [t for t in threading.enumerate()
            if t.name == DRAIN and t.is_alive()]


def _samples(n=64, dim=6, classes=4, seed=0):
    rng = np.random.default_rng(seed)
    return [Sample(rng.normal(size=(dim,)).astype(np.float32),
                   int(rng.integers(1, classes + 1))) for _ in range(n)]


def _model(seed=0, dim=6, classes=4):
    kw = dict(generator=torch.Generator().manual_seed(seed), device="cpu")
    return pnn.Sequential(pnn.Linear(dim, 8, **kw), pnn.ReLU(),
                          pnn.Linear(8, classes, **kw), pnn.LogSoftMax())


def _opt(epochs=2, interval=1, sync=False, data=None):
    data = data or DataSet.array(_samples(), seed=5).transform(
        SampleToMiniBatch(8))
    end = Trigger.max_epoch(epochs)
    if sync:
        end = Trigger.or_(end, Trigger.min_loss(-1.0))
    return (Optimizer(_model(), data, pnn.ClassNLLCriterion())
            .set_optim_method(SGD(0.1, momentum=0.9, dampening=0.0))
            .set_end_when(end).set_log_interval(interval))


def _run(sync, caplog, **kw):
    opt = _opt(sync=sync, **kw)
    caplog.clear()
    with caplog.at_level(logging.INFO, "bigdl_tpu_torch.optim"):
        opt.optimize()
    readers = {r.threadName for r in caplog.records
               if "Loss is" in r.getMessage()}
    assert not _drains()
    return opt, readers


def test_async_and_sync_runs_are_the_same_run(caplog):
    a, a_readers = _run(False, caplog)
    s, s_readers = _run(True, caplog)
    assert a_readers == {DRAIN} and DRAIN not in s_readers
    assert len(a.loss_history) == 16
    assert a.loss_history == s.loss_history
    assert len(a.window_timings) == len(s.window_timings) == 16
    assert a.dispatch_stats == s.dispatch_stats
    assert all(torch.equal(p, q) for p, q in zip(a.model.parameters(),
                                                 s.model.parameters()))


def test_windows_of_several_iterations_drain_in_order(caplog):
    opt, readers = _run(False, caplog, epochs=3, interval=3)
    assert readers == {DRAIN}
    assert [n for n, _ in opt.loss_history] == list(range(1, 25))
    # windows of 3, cut at each epoch's end (8 iterations an epoch)
    assert [n for n, _, _ in opt.window_timings] == [3, 3, 2] * 3


def test_state_loss_is_the_last_logged_loss(caplog):
    opt, _ = _run(False, caplog, interval=5)
    assert opt.state["loss"] == opt.loss_history[-1][1]
    assert opt.loss_history[-1][0] == opt.state["neval"] - 1


def test_a_checkpoint_under_the_drain_holds_its_own_loss(tmp_path):
    opt = _opt(epochs=2, interval=4)
    opt.set_checkpoint(str(tmp_path), Trigger.several_iteration(3),
                       keep_n=10)
    opt.optimize()
    losses = dict(opt.loss_history)
    mgr = CheckpointManager(str(tmp_path))
    written = sorted(tmp_path.glob("checkpoint.*.npz"))
    assert len(written) >= 4
    for path in written:
        _, _, scalars = load_checkpoint(str(path))
        neval = int(scalars["neval"])
        # written after iteration neval - 1, holding that iteration's loss
        assert float(scalars["loss"]) == losses[neval - 1], path.name
    assert mgr.latest_good() is not None


def test_no_drain_outlives_a_crash_and_its_retry(tmp_path):
    clean = _opt(epochs=3, interval=2)
    clean.optimize()
    chaos.install(fail_at_step=11)
    opt = (_opt(epochs=3, interval=2)
           .set_checkpoint(str(tmp_path), Trigger.every_epoch())
           .set_failure_retry(2, backoff_s=0.0, jitter=0.0))
    opt.optimize()
    assert not _drains()
    assert opt._flushq is None and opt._flush_thread is None
    for key in ("epoch", "neval", "records", "loss"):
        assert opt.state[key] == clean.state[key], key
    # resumed at iteration 9 (the first epoch's checkpoint): the last 16
    # losses are the uninterrupted run's from there
    assert [x for x in opt.loss_history if x[0] > 8][-16:] == \
        [x for x in clean.loss_history if x[0] > 8]


class _FailAfter(Transformer):
    """Raises a programming error once ``n`` batches went through."""

    def __init__(self, n):
        self.n = n

    def apply(self, it):
        for i, b in enumerate(it):
            if i == self.n:
                raise TypeError("a bad batch")
            yield b


def test_no_drain_outlives_a_non_retryable_error():
    data = DataSet.array(_samples(), seed=5).transform(
        SampleToMiniBatch(8)).transform(_FailAfter(5))
    opt = _opt(epochs=1, interval=2, data=data) \
        .set_failure_retry(2, backoff_s=0.0, jitter=0.0)
    with pytest.raises(TypeError, match="a bad batch"):
        opt.optimize()
    assert not _drains()
    assert opt._flushq is None and opt._flush_thread is None
