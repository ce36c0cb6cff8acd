"""The port's prefetch stages on the CPU: tests/test_prefetch.py (all
eleven) restated against ``bigdl_tpu_torch.dataset.prefetch``, and
tests/test_data_pipeline.py's ``TestDevicePrefetch`` and
``TestOffByDefault`` against ``bigdl_tpu_torch.data.DevicePrefetch`` and
``Optimizer.set_device_prefetch`` on ``device="cpu"``; besides, prefetch
under ``iterations_per_dispatch > 1`` warns and stages as before, and no
producer thread outlives ``optimize()``.  Losses with prefetch on and
off are compared exactly: the same batches reach the same steps.
Imports no JAX.
"""

import logging
import threading
import time

import numpy as np
import pytest
import torch

from bigdl_tpu_torch import nn as pnn
from bigdl_tpu_torch.data import DevicePrefetch
from bigdl_tpu_torch.data import device_prefetch as dp_mod
from bigdl_tpu_torch.dataset import DataSet, MiniBatch, Sample, \
    SampleToMiniBatch
from bigdl_tpu_torch.dataset.prefetch import ParallelMap, Prefetch
from bigdl_tpu_torch.optim import SGD, Optimizer, Trigger
from bigdl_tpu_torch.optim import optimizer as opt_mod
from bigdl_tpu_torch.utils import chaos


@pytest.fixture(autouse=True)
def _chaos_reset():
    chaos.reset()
    yield
    chaos.reset()


def _threads(name):
    return [t for t in threading.enumerate() if t.name == name
            and t.is_alive()]


# --------------------------------------------------------------------------
# tests/test_prefetch.py
# --------------------------------------------------------------------------

def test_prefetch_preserves_stream():
    out = list(Prefetch(3)(iter(range(100))))
    assert out == list(range(100))


def test_prefetch_propagates_upstream_exception():
    def bad():
        yield 1
        yield 2
        raise ValueError("decode failed")

    it = Prefetch(2)(bad())
    assert next(it) == 1
    assert next(it) == 2
    with pytest.raises(ValueError, match="decode failed"):
        next(it)


def test_prefetch_early_drop_stops_producer():
    produced = []

    def src():
        for i in range(10_000):
            produced.append(i)
            yield i

    it = Prefetch(2)(src())
    for _ in range(3):
        next(it)
    it.close()
    time.sleep(0.3)
    n = len(produced)
    time.sleep(0.3)
    assert len(produced) == n
    assert n < 100


def test_prefetch_producer_exits_when_consumer_drops_after_exhaustion():
    before = {t.ident for t in threading.enumerate()}
    it = Prefetch(1)(iter(range(3)))
    next(it)
    time.sleep(0.2)   # the producer fills the queue and reaches the end
    it.close()
    deadline = time.time() + 5.0
    while time.time() < deadline:
        leaked = [t for t in threading.enumerate()
                  if t.ident not in before and t.is_alive()]
        if not leaked:
            break
        time.sleep(0.05)
    assert not leaked, f"prefetch producer thread leaked: {leaked}"


def test_prefetch_never_advanced_generator_starts_no_thread():
    before = threading.active_count()
    it = Prefetch(2)(iter(range(100)))
    time.sleep(0.1)
    assert threading.active_count() == before
    it.close()
    assert threading.active_count() == before


def test_parallel_map_early_close_cancels_queued_work():
    started = []

    def fn(i):
        started.append(i)
        time.sleep(0.05)
        return i

    it = ParallelMap(fn, workers=2, queue_factor=4)(iter(range(1000)))
    next(it)
    it.close()
    time.sleep(0.3)
    n = len(started)
    time.sleep(0.3)
    assert len(started) == n
    assert n <= 2 * (1 + 4) + 2


def test_prefetch_overlaps_producer_and_consumer():
    """50 ms to produce and 50 ms to consume each of 6 items: 600 ms in
    turn, well under 500 ms overlapped."""
    def src():
        for i in range(6):
            time.sleep(0.05)
            yield i

    t0 = time.perf_counter()
    for _ in Prefetch(2)(src()):
        time.sleep(0.05)
    assert time.perf_counter() - t0 < 0.5


def test_parallel_map_order_and_concurrency():
    active, peak = [], []
    lock = threading.Lock()

    def fn(i):
        with lock:
            active.append(i)
            peak.append(len(active))
        time.sleep(0.02)
        with lock:
            active.remove(i)
        return i * i

    out = list(ParallelMap(fn, workers=4)(iter(range(40))))
    assert out == [i * i for i in range(40)]
    assert max(peak) > 1


def test_parallel_map_propagates_fn_exception_in_order():
    def fn(i):
        if i == 5:
            raise RuntimeError("boom")
        return i

    got = []
    with pytest.raises(RuntimeError, match="boom"):
        for v in ParallelMap(fn, workers=3)(iter(range(10))):
            got.append(v)
    assert got == [0, 1, 2, 3, 4]


def test_parallel_map_bounds_in_flight():
    submitted = []

    def fn(i):
        submitted.append(i)
        time.sleep(0.01)
        return i

    pm = ParallelMap(fn, workers=2, queue_factor=1)
    it = pm(iter(range(1000)))
    next(it)
    assert len(submitted) <= pm.in_flight + 1
    it.close()


def test_pipeline_integration_with_dataset():
    data = DataSet.array(list(range(32)), shuffle=False) \
        .transform(ParallelMap(lambda x: np.float32(x) * 2, workers=3)) \
        .transform(Prefetch(2))
    got = list(data.data(train=False))
    assert got == [np.float32(i) * 2 for i in range(32)]


# --------------------------------------------------------------------------
# tests/test_data_pipeline.py: TestDevicePrefetch, TestOffByDefault
# --------------------------------------------------------------------------

def _indexed_samples(n=32, dim=6, classes=4):
    """Sample i's feature is the constant i."""
    return [Sample(np.full((dim,), i, np.float32), (i % classes) + 1)
            for i in range(n)]


def _model(seed=0, dim=6, classes=4):
    kw = dict(generator=torch.Generator().manual_seed(seed), device="cpu")
    return pnn.Sequential(pnn.Linear(dim, 8, **kw), pnn.ReLU(),
                          pnn.Linear(8, classes, **kw), pnn.LogSoftMax())


def _pipeline(samples, batch=8):
    return DataSet.array(samples, seed=21).transform(SampleToMiniBatch(batch))


def _train(dataset, *, epochs=3, ckpt=None, retry=False, seed=17):
    opt = (Optimizer(_model(seed), dataset, pnn.ClassNLLCriterion())
           .set_optim_method(SGD(0.1))
           .set_end_when(Trigger.max_epoch(epochs)))
    if ckpt is not None:
        opt.set_checkpoint(str(ckpt), Trigger.several_iteration(1))
    if retry:
        opt.set_failure_retry(3, interval_s=300, backoff_s=0.01,
                              backoff_cap_s=0.02)
    return opt


class TestDevicePrefetch:
    def test_batch_n_plus_1_device_resident_before_n_drained(self):
        batches = [MiniBatch(np.full((8, 6), i, np.float32),
                             np.ones((8,), np.int64)) for i in range(6)]
        it = DevicePrefetch(2, device="cpu").apply(iter(batches))
        b0 = next(it)  # step 0 running; nothing else consumed
        deadline = time.time() + 10
        while it.occupancy() < 2 and time.time() < deadline:
            time.sleep(0.005)
        assert it.occupancy() >= 2, \
            "batch N+1 was not staged while batch N was outstanding"
        assert isinstance(b0.get_input(), torch.Tensor)
        assert b0.get_input().device.type == "cpu"
        rest = list(it)
        assert len(rest) == 5 and it.staged_total == 6
        np.testing.assert_array_equal(rest[0].get_input()[:, 0].numpy(),
                                      np.full((8,), 1.0))

    def test_prefetch_on_off_identical_losses(self):
        def run(dp):
            opt = _train(_pipeline(_indexed_samples()), epochs=2, seed=23)
            if dp:
                opt.set_device_prefetch(2)
            opt.optimize()
            assert not _threads("bigdl-device-prefetch")
            return opt.loss_history, [p.detach() for p in
                                      opt.model.parameters()]

        (off, p_off), (on, p_on) = run(False), run(True)
        assert on == off and len(on) == 8
        assert all(torch.equal(a, b) for a, b in zip(p_off, p_on))

    def test_prefetch_closed_on_crash_and_retry(self, tmp_path):
        clean = _train(_pipeline(_indexed_samples()), epochs=3, seed=25)
        clean.optimize()
        chaos.install(fail_at_step=6)
        opt = _train(_pipeline(_indexed_samples()), epochs=3, seed=25,
                     ckpt=tmp_path, retry=True)
        opt.set_device_prefetch(2)
        opt.optimize()
        assert opt._active_dp is None  # the crashed attempt's is closed
        assert not _threads("bigdl-device-prefetch")
        for key in ("epoch", "neval", "records"):
            assert opt.state[key] == clean.state[key], key
        assert all(torch.equal(a, b) for a, b in zip(
            clean.model.parameters(), opt.model.parameters()))

    def test_upstream_error_relayed_to_consumer(self):
        def boom():
            yield from _pipeline(_indexed_samples(8)).data(train=False)
            raise RuntimeError("decode failed")

        it = DevicePrefetch(1, device="cpu").apply(boom())
        with pytest.raises(RuntimeError, match="decode failed"):
            list(it)


def _count_staging(monkeypatch):
    calls = []
    real = opt_mod._stage

    def counting(value, device):
        calls.append(1)
        return real(value, device)
    monkeypatch.setattr(opt_mod, "_stage", counting)
    return calls


class TestOffByDefault:
    def test_unused_subsystem_constructs_nothing_and_stages_as_before(
            self, monkeypatch):
        """Without set_device_prefetch no DevicePrefetch is made, and the
        loop stages each batch's input and target once a step."""
        def forbidden(*a, **k):
            raise AssertionError("DevicePrefetch constructed without "
                                 "set_device_prefetch")

        monkeypatch.setattr(dp_mod.DevicePrefetch, "apply", forbidden)
        calls = _count_staging(monkeypatch)
        opt = _train(_pipeline(_indexed_samples()), epochs=2, seed=27)
        opt.optimize()
        assert len(calls) == 2 * (opt.state["neval"] - 1)

    def test_prefetch_under_windows_warns_and_stages_as_before(
            self, monkeypatch, caplog):
        """Windows of 4 stage their batches themselves (on the card, into
        the graph's static inputs): prefetch is disabled with the
        reference's warning, and the run is the one without it."""
        def run(prefetch):
            opt = _train(_pipeline(_indexed_samples()), epochs=2, seed=27)
            opt.set_iterations_per_dispatch(4)
            if prefetch:
                opt.set_device_prefetch(2)
            opt.optimize()
            return opt

        plain = run(False)
        calls = _count_staging(monkeypatch)

        def forbidden(*a, **k):
            raise AssertionError("DevicePrefetch constructed under "
                                 "iterations_per_dispatch > 1")
        monkeypatch.setattr(dp_mod.DevicePrefetch, "apply", forbidden)
        with caplog.at_level(logging.WARNING, "bigdl_tpu_torch.optim"):
            opt = run(True)
        assert any("device prefetch disabled" in r.getMessage()
                   for r in caplog.records)
        assert len(calls) == 2 * (opt.state["neval"] - 1)
        assert opt.dispatch_stats == plain.dispatch_stats
        assert opt.loss_history == plain.loss_history
