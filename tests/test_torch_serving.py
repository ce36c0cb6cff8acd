"""The port's one-shot serving (``bigdl_tpu_torch.serving``: ModelServer's
``backend=`` plane, BatchScheduler, MetricsRegistry, admission and
bucketing) on the CPU: the one-shot tests of ``tests/test_serving.py``
restated, every served row held against the JAX package's forward of the
same weights.

Left out, with their ROADMAP.md items: the int8 backend and its accuracy
gate (``nn/quantized.py``, item 9b); the ``python -m bigdl_tpu.serving``
CLI cases (``serving/__main__.py``, item 8f); the HTTP front ends
(``examples/serve.py``, item 12); the model zoo (item 9b); TensorBoard
publication (``visualization/``, item 13: ``publish`` raises here).

Wall-clock bounds that can fail on a loaded machine are held by their end
state instead: a lone request is served at all (only its deadline can
close its batch), a timed-out admission leaves the queue as it was.

Tolerances: rows rtol 1e-5, atol 1e-6 against the reference (float32,
the sums in another order); counts exactly.
"""

import math
import os
import signal as sg
import sys
import threading
import time
from collections import Counter

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.serving import batching as jbatching
from bigdl_tpu.utils import set_seed
from bigdl_tpu.visualization.proto import make_histogram
from bigdl_tpu_torch import nn as pnn
from bigdl_tpu_torch.core.module import Module
from bigdl_tpu_torch.interop import load_jax_parameters
from bigdl_tpu_torch.optim import PredictionService
from bigdl_tpu_torch.optim.predictor import jit_forward
from bigdl_tpu_torch.serving import (
    MetricsRegistry, ModelServer, QueueFullError, RequestSheddedError,
    ServerClosedError, bucket_sizes, install_shutdown_signals, pick_bucket,
    split_outputs, stack_requests,
)

ROWS = dict(rtol=1e-5, atol=1e-6)
CPU = dict(device="cpu")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def pair():
    set_seed(3)
    ref = jnn.Sequential(jnn.Linear(4, 8), jnn.ReLU(), jnn.Linear(8, 3),
                         jnn.LogSoftMax())
    gen = dict(generator=torch.Generator().manual_seed(0), device="cpu")
    port = pnn.Sequential(pnn.Linear(4, 8, **gen), pnn.ReLU(),
                          pnn.Linear(8, 3, **gen), pnn.LogSoftMax())
    return ref, load_jax_parameters(port, _np(ref.parameters()))


def _forward_batch(ref, xs):
    return np.asarray(ref.clone().eval_mode().forward(
        jnp.stack([jnp.asarray(x) for x in xs])))


def _samples(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(4,)).astype(np.float32) for _ in range(n)]


class CountingBackend:
    """Counts the backend's runs; optionally gated so that a test can
    hold the scheduler inside a run while it fills the queue."""

    def __init__(self, model, gated: bool = False):
        m, fn = jit_forward(model, "cpu")
        self._run = lambda x: fn(m, x).numpy()
        self.calls = 0
        self.batch_rows = []
        self.entered = threading.Event()
        self.gate = threading.Event()
        if not gated:
            self.gate.set()

    def __call__(self, x):
        self.entered.set()
        assert self.gate.wait(timeout=30), "backend gate never released"
        self.calls += 1
        self.batch_rows.append(np.asarray(x).shape[0])
        return self._run(x)


# ---- bucketing primitives ---------------------------------------------------

def test_bucket_sizes_powers_of_two():
    assert bucket_sizes(8) == (1, 2, 4, 8)
    assert bucket_sizes(1) == (1,)
    assert bucket_sizes(24) == (1, 2, 4, 8, 16, 24)  # non-pow2 terminal


def test_pick_bucket_smallest_fit():
    b = bucket_sizes(16)
    assert pick_bucket(1, b) == 1
    assert pick_bucket(3, b) == 4
    assert pick_bucket(16, b) == 16
    with pytest.raises(ValueError):
        pick_bucket(17, b)


def test_stack_and_split_ragged_padding():
    xs = [np.full((3,), i, np.float32) for i in range(3)]
    batch = stack_requests(xs, bucket=4)
    assert batch.shape == (4, 3)
    # the pad row repeats the last real sample, as _pad_batch does
    np.testing.assert_array_equal(batch[3], batch[2])
    np.testing.assert_array_equal(batch, jbatching.stack_requests(xs, 4))
    rows = split_outputs(batch, 3)
    assert len(rows) == 3
    np.testing.assert_array_equal(rows[1], xs[1])


def test_stack_tuple_samples():
    xs = [(np.full((2,), i, np.float32), np.full((5,), -i, np.float32))
          for i in range(3)]
    cols = stack_requests(xs, bucket=4)
    assert isinstance(cols, tuple) and len(cols) == 2
    assert cols[0].shape == (4, 2) and cols[1].shape == (4, 5)
    rows = split_outputs(cols, 3)
    assert rows[2][0][0] == 2 and rows[2][1][0] == -2
    for got, want in zip(rows, jbatching.split_outputs(
            jbatching.stack_requests(xs, 4), 3)):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


# ---- coalescing and its metrics ---------------------------------------------

def test_concurrent_requests_coalesce_and_metrics_account(pair):
    ref, port = pair
    backend = CountingBackend(port)
    n, max_batch = 12, 4
    server = ModelServer(backend, max_batch=max_batch,
                         batch_timeout_ms=500.0, **CPU)
    xs = _samples(n, 0)
    outs = [None] * n
    errs = []

    def work(i):
        try:
            outs[i] = server.submit(xs[i], timeout=30)
        except Exception as e:  # pragma: no cover
            errs.append(e)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(n)]
    [t.start() for t in threads]
    [t.join() for t in threads]
    server.shutdown()
    assert not errs
    # every request served in at most ceil(N / max_batch) runs
    assert backend.calls <= math.ceil(n / max_batch)
    np.testing.assert_allclose(np.stack(outs), _forward_batch(ref, xs),
                               **ROWS)
    snap = server.metrics.snapshot()
    assert snap["requests"] == n
    lat = snap["latency_ms"]
    assert lat["p50"] > 0 and lat["p99"] >= lat["p50"] > 0
    occ = snap["occupancy"]
    assert sum(size * count for size, count in occ.items()) == n
    assert sum(occ.values()) == snap["batches"] == backend.calls
    assert server.admitted_outstanding() == 0


def test_submit_many_coalesces_from_one_caller(pair):
    ref, port = pair
    backend = CountingBackend(port)
    server = ModelServer(backend, max_batch=8, batch_timeout_ms=200.0, **CPU)
    xs = _samples(8, 1)
    outs = server.submit_many(xs, timeout=30)
    server.shutdown()
    assert backend.calls <= 1  # 8 samples, one full bucket-8 run
    np.testing.assert_allclose(np.stack(outs), _forward_batch(ref, xs),
                               **ROWS)


# ---- the scheduler's deadline and ragged shapes ------------------------------

def test_lone_request_served_at_timeout(pair):
    _, port = pair
    backend = CountingBackend(port)
    server = ModelServer(backend, max_batch=8, batch_timeout_ms=20.0, **CPU)
    # no second request ever arrives: only the deadline closes the batch
    y = server.submit(np.ones((4,), np.float32), timeout=30)
    server.shutdown()
    assert y.shape == (3,)
    assert server.metrics.occupancy_histogram() == {1: 1}
    assert backend.batch_rows == [1]


def test_undersized_batch_pads_to_bucket_and_drops(pair):
    ref, port = pair
    backend = CountingBackend(port)
    server = ModelServer(backend, max_batch=8, batch_timeout_ms=100.0, **CPU)
    xs = _samples(3, 2)
    outs = server.submit_many(xs, timeout=30)
    server.shutdown()
    assert len(outs) == 3
    assert 4 in backend.batch_rows   # 3 requests ride a padded bucket of 4
    assert server.metrics.padded_waste() > 0
    np.testing.assert_allclose(np.stack(outs), _forward_batch(ref, xs),
                               **ROWS)


# ---- admission control ------------------------------------------------------

def _gated_server(port, policy, capacity=2):
    backend = CountingBackend(port, gated=True)
    server = ModelServer(backend, max_batch=1, batch_timeout_ms=0.0,
                         queue_capacity=capacity, admission=policy, **CPU)
    return backend, server


def _fill(server, backend, capacity):
    """One request held inside the backend + ``capacity`` queued."""
    x = np.ones((4,), np.float32)
    futs = [server.submit_async(x)]
    assert backend.entered.wait(timeout=10)
    for _ in range(capacity):
        futs.append(server.submit_async(x))
    deadline = time.perf_counter() + 10
    while server.queue_depth() < capacity:
        assert time.perf_counter() < deadline
        time.sleep(0.005)
    return x, futs


def test_queue_full_reject_policy(pair):
    backend, server = _gated_server(pair[1], "reject", capacity=2)
    x, futs = _fill(server, backend, 2)
    with pytest.raises(QueueFullError):
        server.submit_async(x)
    assert server.metrics.snapshot()["rejected"] == 1
    assert server.admitted_outstanding() == 3
    backend.gate.set()
    server.shutdown(drain=True)
    for f in futs:
        assert f.result(timeout=10).shape == (3,)


def test_queue_full_shed_oldest_policy(pair):
    backend, server = _gated_server(pair[1], "shed_oldest", capacity=2)
    x, futs = _fill(server, backend, 2)
    late = server.submit_async(2 * x)
    # the OLDEST queued request (futs[1]; futs[0] is already running) is
    # shed for the newcomer
    with pytest.raises(RequestSheddedError):
        futs[1].result(timeout=10)
    assert server.metrics.snapshot()["shed"] == 1
    backend.gate.set()
    server.shutdown(drain=True)
    assert futs[0].result(timeout=10).shape == (3,)
    assert futs[2].result(timeout=10).shape == (3,)
    assert late.result(timeout=10).shape == (3,)


def test_queue_full_block_policy_waits_for_space(pair):
    backend, server = _gated_server(pair[1], "block", capacity=1)
    x, futs = _fill(server, backend, 1)
    done = threading.Event()
    extra = []

    def blocked_submit():
        extra.append(server.submit_async(x))
        done.set()

    t = threading.Thread(target=blocked_submit)
    t.start()
    time.sleep(0.05)
    assert not done.is_set(), "a blocking submit waits on a full queue"
    backend.gate.set()   # the scheduler drains, space frees, it is admitted
    assert done.wait(timeout=10)
    t.join()
    server.shutdown(drain=True)
    assert extra[0].result(timeout=10).shape == (3,)


def test_submit_timeout_bounds_blocked_admission(pair):
    """submit(x, timeout=N) gives up when the queue stays full under the
    block policy (a wedged backend): QueueFullError, and the queue and
    the admitted count as they were."""
    backend, server = _gated_server(pair[1], "block", capacity=1)
    x, futs = _fill(server, backend, 1)
    with pytest.raises(QueueFullError):
        server.submit(x, timeout=0.3)
    assert server.queue_depth() == 1 and server.admitted_outstanding() == 2
    backend.gate.set()
    server.shutdown(drain=True)
    for f in futs:
        assert f.result(timeout=10).shape == (3,)


# ---- shutdown -----------------------------------------------------------------

def test_shutdown_drains_queued_requests(pair):
    backend, server = _gated_server(pair[1], "block", capacity=4)
    x, futs = _fill(server, backend, 4)
    stopper = threading.Thread(target=server.shutdown,
                               kwargs={"drain": True, "timeout": 30})
    stopper.start()
    backend.gate.set()
    stopper.join(timeout=30)
    assert not stopper.is_alive()
    for f in futs:   # every admitted request is still served
        assert f.result(timeout=10).shape == (3,)
    with pytest.raises(ServerClosedError):
        server.submit(x)
    assert server.admitted_outstanding() == 0


def test_shutdown_discard_fails_queued_requests(pair):
    backend, server = _gated_server(pair[1], "block", capacity=3)
    x, futs = _fill(server, backend, 3)
    stopper = threading.Thread(target=server.shutdown,
                               kwargs={"drain": False, "timeout": 30})
    stopper.start()
    backend.gate.set()
    stopper.join(timeout=30)
    assert futs[0].result(timeout=10).shape == (3,)  # in flight: finishes
    for f in futs[1:]:
        with pytest.raises(ServerClosedError):
            f.result(timeout=10)


def test_backend_error_propagates_to_futures():
    def broken(x):
        raise RuntimeError("device on fire")

    server = ModelServer(broken, max_batch=2, batch_timeout_ms=5.0, **CPU)
    fut = server.submit_async(np.ones((4,), np.float32))
    with pytest.raises(RuntimeError, match="device on fire"):
        fut.result(timeout=10)
    # the scheduler survives a failing batch and runs the next one
    fut2 = server.submit_async(np.ones((4,), np.float32))
    with pytest.raises(RuntimeError):
        fut2.result(timeout=10)
    server.shutdown()
    assert server.metrics.snapshot()["requests"] == 0


# ---- backends: a module, a PredictionService, tuple outputs -----------------

def test_module_backend_and_warmup(pair):
    ref, port = pair
    server = ModelServer(port, max_batch=4, batch_timeout_ms=5.0, **CPU)
    server.warmup(np.zeros((4,), np.float32))
    # warmup never touches the request metrics
    assert server.metrics.snapshot()["requests"] == 0
    y = server.submit(np.ones((4,), np.float32), timeout=30)
    server.shutdown()
    want = _forward_batch(ref, [np.ones((4,), np.float32)])[0]
    np.testing.assert_allclose(y, want, **ROWS)
    assert port.training   # the server runs an eval-mode clone


def test_prediction_service_serve_frontend(pair):
    ref, port = pair
    svc = PredictionService(port, concurrency=2, **CPU)
    server = svc.serve(max_batch=4, batch_timeout_ms=10.0)
    xs = _samples(6, 5)
    outs = server.submit_many(xs, timeout=30)
    server.shutdown()
    np.testing.assert_allclose(np.stack(outs), _forward_batch(ref, xs),
                               **ROWS)


def test_tuple_output_model_through_both_backends():
    """A two-head model (heads of different widths) round-trips per
    request through the module and the PredictionService backends."""
    from bigdl_tpu.core.module import Module as JModule

    class JTwoHead(JModule):
        def __init__(self):
            super().__init__()
            self.a = jnn.Linear(4, 3)
            self.b = jnn.Linear(4, 5)

        def forward(self, x):
            return self.a(x), self.b(x)

    class TwoHead(Module):
        def __init__(self):
            super().__init__()
            gen = dict(generator=torch.Generator(), device="cpu")
            self.a = pnn.Linear(4, 3, **gen)
            self.b = pnn.Linear(4, 5, **gen)

        def forward(self, x):
            return self.a(x), self.b(x)

    set_seed(9)
    ref = JTwoHead()
    model = load_jax_parameters(TwoHead(), _np(ref.parameters()))
    xs = _samples(3, 10)
    wa, wb = (np.asarray(a) for a in ref.clone().eval_mode().forward(
        jnp.stack([jnp.asarray(x) for x in xs])))
    for backend in (model, PredictionService(model, **CPU)):
        server = ModelServer(backend, max_batch=2, batch_timeout_ms=10.0,
                             **CPU)
        outs = server.submit_many(xs, timeout=30)
        server.shutdown()
        for i, (ya, yb) in enumerate(outs):
            assert ya.shape == (3,) and yb.shape == (5,)
            np.testing.assert_allclose(ya, wa[i], **ROWS)
            np.testing.assert_allclose(yb, wb[i], **ROWS)


def test_backend_of_another_kind_or_device_is_refused(pair, monkeypatch):
    with pytest.raises(TypeError, match="cannot serve a int"):
        ModelServer(3, **CPU)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="runs on cpu"):
        ModelServer(PredictionService(pair[1], **CPU), device="cuda")


# ---- metrics ------------------------------------------------------------------

def test_metrics_registry_empty_snapshot():
    reg = MetricsRegistry()
    snap = reg.snapshot()
    assert snap["requests"] == 0
    assert snap["latency_ms"]["p99"] == 0.0
    assert snap["padded_waste"] == 0.0
    with pytest.raises(NotImplementedError, match="item 13"):
        reg.publish(None, 0)


def test_occupancy_histogram_in_the_weighted_form(pair):
    """(``test_weighted_histogram_matches_expanded``) the snapshot keeps
    the occupancy as {real rows: batches}, the weighted form the
    reference's ``publish`` writes: through the reference's
    ``make_histogram`` it equals the histogram of every batch's real
    rows, expanded."""
    _, port = pair
    backend = CountingBackend(port)
    server = ModelServer(backend, max_batch=8, batch_timeout_ms=1.0, **CPU)
    for burst in (3, 7, 1, 8, 2, 3):
        server.submit_many(_samples(burst, burst), timeout=30)
    server.shutdown()
    occ = server.metrics.occupancy_histogram()
    assert sum(occ.values()) == len(backend.batch_rows) == \
        server.metrics.snapshot()["batches"]
    sizes = sorted(occ)
    weighted = make_histogram(np.asarray(sizes, np.float64),
                              weights=[occ[s] for s in sizes])
    expanded = make_histogram(np.concatenate(
        [np.full(c, s, np.float64) for s, c in occ.items()]))
    assert weighted.num == expanded.num == len(backend.batch_rows)
    assert weighted.sum == expanded.sum == 24
    assert weighted.sum_squares == expanded.sum_squares
    assert weighted.bucket == expanded.bucket
    # a batch of n real rows ran at the bucket that fits n
    buckets = bucket_sizes(8)
    assert Counter(backend.batch_rows) == Counter(
        pick_bucket(n, buckets) for n, c in occ.items() for _ in range(c))


def test_soak_mixed_concurrency_fifo_order(pair):
    """Many bursts from many threads: every result matches the oracle (no
    row handed to another request under sustained load)."""
    ref, port = pair
    server = ModelServer(port, max_batch=8, batch_timeout_ms=2.0,
                         queue_capacity=256, **CPU)
    xs = _samples(200, 8)
    outs = [None] * len(xs)

    def work(lo, hi):
        for i in range(lo, hi):
            outs[i] = server.submit(xs[i], timeout=60)

    threads = [threading.Thread(target=work, args=(i * 25, (i + 1) * 25))
               for i in range(8)]
    [t.start() for t in threads]
    [t.join() for t in threads]
    server.shutdown()
    np.testing.assert_allclose(np.stack(outs), _forward_batch(ref, xs),
                               **ROWS)
    assert server.metrics.snapshot()["requests"] == 200


# ---- cancelled futures ----------------------------------------------------------

def test_cancelled_future_does_not_kill_scheduler(pair):
    """A future cancelled while queued is dropped at dispatch; it does not
    raise InvalidStateError inside the single scheduler thread."""
    backend, server = _gated_server(pair[1], "block", capacity=4)
    x, futs = _fill(server, backend, 3)
    assert futs[1].cancel()   # still queued: cancellable
    backend.gate.set()
    assert futs[0].result(timeout=10).shape == (3,)
    assert futs[2].result(timeout=10).shape == (3,)
    assert futs[3].result(timeout=10).shape == (3,)
    assert server.submit(x, timeout=10).shape == (3,)
    server.shutdown()


def test_shed_of_cancelled_future_does_not_crash_submitter(pair):
    backend, server = _gated_server(pair[1], "shed_oldest", capacity=2)
    x, futs = _fill(server, backend, 2)
    assert futs[1].cancel()          # the oldest queued request, cancelled
    late = server.submit_async(x)    # sheds the cancelled one: no crash
    backend.gate.set()
    server.shutdown(drain=True)
    assert late.result(timeout=10).shape == (3,)


def test_discard_shutdown_with_cancelled_future(pair):
    backend, server = _gated_server(pair[1], "block", capacity=2)
    x, futs = _fill(server, backend, 2)
    assert futs[1].cancel()
    stopper = threading.Thread(target=server.shutdown,
                               kwargs={"drain": False, "timeout": 30})
    stopper.start()
    backend.gate.set()
    stopper.join(timeout=30)
    assert not stopper.is_alive()   # close() survived the cancelled future
    with pytest.raises(ServerClosedError):
        futs[2].result(timeout=10)


# ---- lifecycle ----------------------------------------------------------------

def test_model_server_generator_failure_does_not_leak_scheduler():
    """A bad generator does not leave the one-shot scheduler thread, already
    started, running with no handle to stop it."""
    before = set(threading.enumerate())
    with pytest.raises(TypeError, match="incremental-decode"):
        ModelServer(lambda x: np.asarray(x), max_batch=2,
                    generator=object(), **CPU)
    leaked = [t for t in set(threading.enumerate()) - before
              if "serving" in t.name]
    for t in leaked:
        t.join(5.0)
    assert not any(t.is_alive() for t in leaked), leaked


def test_backend_and_generator_together(pair):
    """One server, both planes: a one-shot request and a generation, and
    admitted_outstanding over both."""
    from bigdl_tpu_torch.models import transformer_lm
    lm = transformer_lm(vocab_size=20, hidden_size=16, num_layers=1,
                        num_heads=2, filter_size=32, max_len=32,
                        generator=torch.Generator().manual_seed(0),
                        device="cpu").eval()
    server = ModelServer(pair[1], max_batch=2, generator=lm, slots=2, **CPU)
    fut = server.submit_generate_async(np.array([3, 4, 5], np.int32), 3)
    y = server.submit(np.ones((4,), np.float32), timeout=30)
    row = fut.result(timeout=60)
    server.shutdown()
    assert y.shape == (3,) and row.shape == (6,)
    np.testing.assert_array_equal(row, lm.generate(
        np.array([[3, 4, 5]]), 3)[0].numpy())
    assert server.admitted_outstanding() == 0


def test_shutdown_signal_unwinds_into_drain():
    """SIGTERM raises KeyboardInterrupt in the main thread, so the caller's
    shutdown(drain=True) runs and every admitted request is answered."""
    server = ModelServer(lambda x: np.asarray(x) * 2.0, max_batch=4,
                         batch_timeout_ms=1.0, **CPU)
    restore = install_shutdown_signals(server, signals=(sg.SIGTERM,))
    try:
        futs = [server.submit_async(np.full((3,), i, np.float32))
                for i in range(4)]
        with pytest.raises(KeyboardInterrupt):
            os.kill(os.getpid(), sg.SIGTERM)
            # a bytecode boundary to deliver it on
            for _ in range(1000):
                time.sleep(0.001)
        server.shutdown(drain=True)
        for i, f in enumerate(futs):
            np.testing.assert_allclose(f.result(timeout=5),
                                       np.full((3,), 2.0 * i))
        with pytest.raises(ServerClosedError):
            server.submit_async(np.zeros((3,), np.float32))
    finally:
        restore()
    assert sg.getsignal(sg.SIGTERM) is sg.SIG_DFL


def test_kernel_counts_are_exact_under_threads(monkeypatch):
    """Threads calling one model at once (a PredictionService) count every
    launch of #1: the wrapper's count and route count under one lock.
    The launch itself is stubbed (there is no card here); the counting
    is the wrapper's own."""
    from bigdl_tpu_torch.ops import attention_kernels as ak
    monkeypatch.setattr(ak, "_check_inputs", lambda *a: None)
    monkeypatch.setattr(ak, "_launch_fwd", lambda q, *a: (q, None))
    monkeypatch.setattr(ak.flash_attention_fwd, "launches", 0)
    monkeypatch.setattr(ak.flash_attention_fwd, "routes",
                        {"tensor_core": 0, "scalar": 0})
    monkeypatch.setattr(ak.flash_attention_fwd, "kernels",
                        dict.fromkeys(ak.FWD_KERNELS, 0))
    q = torch.zeros(1, 1, 1, 4)
    threads, calls = 16, 2000

    def work():
        for _ in range(calls):
            ak.flash_attention_fwd(q, q, q, scale=1.0)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=work) for _ in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(w.is_alive() for w in workers)
    assert ak.flash_attention_fwd.launches == threads * calls
    assert ak.flash_attention_fwd.routes == {"tensor_core": 0,
                                             "scalar": threads * calls}
    assert ak.flash_attention_fwd.kernels == dict(
        ak.flash_attention_fwd.kernels, decode=threads * calls) and \
        sum(ak.flash_attention_fwd.kernels.values()) == threads * calls
