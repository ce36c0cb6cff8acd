"""The port's single-flight prefill dedup, prefill-role engine,
``DisaggregatedEngine``, deadlines, abandoned-slot cancels, ``kill`` and
the KV cache's ``dtype=``, restating against the port
``tests/test_router.py``'s dedup, prefill-role and disaggregated tests
(the telemetry family test waived: telemetry is ROADMAP queue 1, item
10) and ``tests/test_reliability.py``'s deadline and abandoned-slot
tests.  The port's weights are the JAX reference's, loaded through
``load_jax_parameters``; every row is held token for token against the
JAX ``generate()`` and, where the test runs one, the JAX engine's row.
"""

import threading
import time
from concurrent.futures import TimeoutError as FuturesTimeout

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from bigdl_tpu.models import transformer_lm as jax_transformer_lm
from bigdl_tpu.serving import DisaggregatedEngine as JaxDisaggregatedEngine
from bigdl_tpu.serving import GenerationScheduler as JaxGenerationScheduler
from bigdl_tpu.utils import set_seed
from bigdl_tpu_torch.interop import load_jax_parameters
from bigdl_tpu_torch.models import transformer_lm
from bigdl_tpu_torch.serving import (
    Deadline, DeadlineExceededError, DisaggregatedEngine,
    GenerationScheduler, ModelServer, ReplicaDeadError, ServerClosedError,
    deadline_error,
)

VOCAB, MAX_LEN = 50, 64
CFG = dict(vocab_size=VOCAB, hidden_size=64, num_layers=2, num_heads=4,
           filter_size=128, max_len=MAX_LEN)
ENGINE_THREAD = "bigdl-torch-serving-generation"


@pytest.fixture(scope="module")
def models():
    set_seed(0)
    ref = jax_transformer_lm(**CFG).eval_mode()
    port = transformer_lm(**CFG, generator=torch.Generator().manual_seed(0),
                          device="cpu").eval()
    load_jax_parameters(port, jax.tree_util.tree_map(np.asarray,
                                                     ref.parameters()))
    return ref, port


def solo(ref, prompt, max_new):
    return np.asarray(ref.generate(jnp.asarray(prompt, jnp.int32)[None],
                                   int(max_new)))[0]


# ---------------------------------------------------------------------------
# single-flight prefill dedup
# ---------------------------------------------------------------------------

def test_identical_cold_burst_prefills_once(models):
    """An 8-way identical cold burst: one leader prefills, 7 followers
    park on its claim; the reference's engine counts the same."""
    ref, port = models
    rng = np.random.default_rng(11)
    p = rng.integers(1, VOCAB, 17).astype(np.int32)   # region = 2 granules
    kw = dict(slots=8, prefix_cache_bytes=1 << 24, prefix_granularity=8,
              prefill_chunk=8)
    stats = []
    for eng in (JaxGenerationScheduler(ref, **kw),
                GenerationScheduler(port, device="cpu", **kw)):
        try:
            rows = [f.result(60) for f in
                    [eng.submit_async(p, 4) for _ in range(8)]]
            stats.append(eng.stats())
        finally:
            eng.shutdown()
        oracle = solo(ref, p, 4)
        assert all(np.array_equal(r, oracle) for r in rows)
    want, st = stats
    assert st["prefill_dedup_leaders"] == 1
    assert st["prefill_dedup_followers"] == 7
    assert st["prefill_calls"] == 2
    assert st["prefix_cache"]["inserts"] == 2
    assert st["prefix_cache"]["hits"] >= 7
    assert st["prefix_cache"]["inflight_prefills"] == 0
    for key in ("prefill_dedup_leaders", "prefill_dedup_followers",
                "prefill_calls", "prefix_chunks_copied"):
        assert st[key] == want[key], key


def test_dedup_shared_prefix_longer_follower(models):
    """A longer prompt sharing the leader's prefix parks, then prefills
    only its own suffix chunks."""
    ref, port = models
    rng = np.random.default_rng(12)
    prefix = rng.integers(1, VOCAB, 17).astype(np.int32)
    longer = np.concatenate(
        [prefix[:-1], rng.integers(1, VOCAB, 17).astype(np.int32)])
    eng = GenerationScheduler(port, slots=4, prefix_cache_bytes=1 << 24,
                              prefix_granularity=8, prefill_chunk=8,
                              start=False, device="cpu")
    try:
        f1 = eng.submit_async(prefix, 4)
        f2 = eng.submit_async(longer, 4)
        eng.start()
        r1, r2 = f1.result(60), f2.result(60)
        st = eng.stats()
    finally:
        eng.shutdown()
    np.testing.assert_array_equal(r1, solo(ref, prefix, 4))
    np.testing.assert_array_equal(r2, solo(ref, longer, 4))
    assert st["prefill_dedup_followers"] >= 1
    assert st["prefix_chunks_copied"] >= 2


def test_dedup_leader_failure_promotes_follower(models, monkeypatch):
    """The leader's prefill fails: its claims release and a parked
    follower claims and leads, so the burst completes minus the leader."""
    ref, port = models
    eng = GenerationScheduler(port, slots=4, prefix_cache_bytes=1 << 24,
                              prefix_granularity=8, prefill_chunk=8,
                              device="cpu")
    rng = np.random.default_rng(13)
    p = rng.integers(1, VOCAB, 17).astype(np.int32)
    fired = {"n": 0}
    orig = eng.pool.chunk_prefill_into

    def flaky(toks, slot, index):
        if fired["n"] == 0:
            fired["n"] += 1
            raise RuntimeError("injected prefill fault")
        return orig(toks, slot, index)

    monkeypatch.setattr(eng.pool, "chunk_prefill_into", flaky)
    try:
        futs = [eng.submit_async(p, 4) for _ in range(3)]
        results, errors = [], 0
        for f in futs:
            try:
                results.append(f.result(60))
            except RuntimeError:
                errors += 1
        assert errors == 1, "exactly the leader fails"
        oracle = solo(ref, p, 4)
        assert len(results) == 2
        assert all(np.array_equal(r, oracle) for r in results)
        assert eng.stats()["prefix_cache"]["inflight_prefills"] == 0
    finally:
        eng.shutdown()


# ---------------------------------------------------------------------------
# disaggregated prefill -> decode
# ---------------------------------------------------------------------------

def test_disaggregated_handoff_bit_identical(models):
    """Disaggregated rows equal the single engine's, the reference's
    disaggregated engine's and the JAX generate(), across mixed lengths
    (sub-granule prompts skip the prefill tier)."""
    ref, port = models
    rng = np.random.default_rng(15)
    prompts = [rng.integers(1, VOCAB, int(n)).astype(np.int32)
               for n in [3, 9, 17, 25, 33, 40, 17, 33]]
    budgets = [int(b) for b in rng.integers(2, 12, len(prompts))]
    kw = dict(decode_slots=4, prefill_slots=2, prefix_granularity=8,
              prefill_chunk=8)
    rows, stats = [], []
    for de in (JaxDisaggregatedEngine(ref, **kw),
               DisaggregatedEngine(port, device="cpu", **kw)):
        try:
            futs = [de.submit_generate_async(p, m)
                    for p, m in zip(prompts, budgets)]
            rows.append([f.result(120) for f in futs])
            stats.append(de.stats())
        finally:
            de.shutdown()
    single = GenerationScheduler(port, slots=4, prefill_chunk=8,
                                 prefix_cache_bytes=1 << 24,
                                 prefix_granularity=8, device="cpu")
    try:
        single_rows = [f.result(120) for f in
                       [single.submit_async(p, m)
                        for p, m in zip(prompts, budgets)]]
    finally:
        single.shutdown()
    for p, m, jr, dr, sr in zip(prompts, budgets, rows[0], rows[1],
                                single_rows):
        np.testing.assert_array_equal(dr, sr)
        np.testing.assert_array_equal(dr, jr)
        np.testing.assert_array_equal(dr, solo(ref, p, m))
    want, st = stats
    assert st["prefill_engine"]["requests_done"] >= 6
    assert st["prefill_engine"]["requests_done"] == \
        want["prefill_engine"]["requests_done"]
    assert st["handoffs"] == want["handoffs"] == len(prompts)
    assert st["prefix_cache"]["hits"] >= 6
    assert st["disaggregated"] and st["admitted_outstanding"] == 0


def test_disaggregated_decode_admits_only_cache_resident(models):
    """Once the prefill tier published a granularity-aligned region, the
    decode engine prefills nothing: its admission copies the chain."""
    ref, port = models
    rng = np.random.default_rng(16)
    p = rng.integers(1, VOCAB, 33).astype(np.int32)   # region 32 = 4 x 8
    de = DisaggregatedEngine(port, decode_slots=2, prefill_slots=2,
                             prefix_granularity=8, prefill_chunk=8,
                             device="cpu")
    try:
        row = de.submit_generate_async(p, 4).result(120)
        st = de.stats()
    finally:
        de.shutdown()
    np.testing.assert_array_equal(row, solo(ref, p, 4))
    assert st["prefill_calls"] == 0, \
        "the decode engine ran prefill work the prefill tier owned"
    assert st["prefix_chunks_copied"] == 4
    assert st["prefill_engine"]["prefill_calls"] > 0


def test_disaggregated_retries_an_evicted_prefix(models):
    """A budget of two chunks cannot keep a 4-chunk region resident: the
    handoff retries through the prefill tier, then decode serves it
    anyway, and the row is still right."""
    ref, port = models
    rng = np.random.default_rng(17)
    p = rng.integers(1, VOCAB, 33).astype(np.int32)
    chunk_bytes = 2 * 2 * 4 * 8 * 16 * 4 + 8     # 2 layers, K and V, pad
    de = DisaggregatedEngine(port, decode_slots=2, prefill_slots=2,
                             prefix_cache_bytes=2 * chunk_bytes,
                             prefix_granularity=8, prefill_chunk=8,
                             max_prefill_retries=1, device="cpu")
    try:
        row = de.submit_generate_async(p, 4).result(120)
        st = de.stats()
    finally:
        de.shutdown()
    np.testing.assert_array_equal(row, solo(ref, p, 4))
    assert st["prefill_engine_retries"] == 1
    assert st["prefix_cache"]["evictions"] > 0
    assert st["handoffs"] == 1


def test_prefill_role_engine_requires_cache_and_accepts_zero_budget(models):
    ref, port = models
    with pytest.raises(ValueError):
        GenerationScheduler(port, slots=2, role="prefill", start=False,
                            device="cpu")
    with pytest.raises(ValueError, match="role"):
        GenerationScheduler(port, slots=2, role="decode", start=False,
                            device="cpu")
    eng = GenerationScheduler(port, slots=2, role="prefill",
                              prefix_cache_bytes=1 << 24,
                              prefix_granularity=8, prefill_chunk=8,
                              device="cpu")
    try:
        rng = np.random.default_rng(17)
        p = rng.integers(1, VOCAB, 17).astype(np.int32)
        np.testing.assert_array_equal(eng.submit_async(p, 0).result(60), p)
        # a short prompt takes the bucketed prefill and still publishes
        q = rng.integers(1, VOCAB, 9).astype(np.int32)
        np.testing.assert_array_equal(eng.submit_async(q, 0).result(60), q)
        st = eng.stats()
        assert st["role"] == "prefill"
        assert st["decode_steps"] == 0
        assert st["prefix_cache"]["inserts"] == 3
        assert eng.pool.n_active() == 0
    finally:
        eng.shutdown()
    mixed = GenerationScheduler(port, slots=1, start=False, device="cpu")
    with pytest.raises(ValueError, match=">= 1"):
        mixed.submit_async(np.asarray([3], np.int32), 0)


# ---------------------------------------------------------------------------
# deadlines, abandoned slots and kill
# ---------------------------------------------------------------------------

def test_deadline_error_is_typed_and_stage_stamped():
    d = Deadline(1.0, now=10.0)
    assert not d.expired(now=10.5) and d.expired(now=11.0)
    e = d.error("decode", now=11.5)
    assert isinstance(e, DeadlineExceededError) and e.stage == "decode"
    assert "1.500s elapsed of a 1.000s budget" in str(e)
    assert deadline_error("queue", 2.0, 3.0).stage == "queue"
    with pytest.raises(ValueError):
        Deadline(0.0)


def test_deadline_expired_in_queue_is_rejected_at_admit(models):
    _, port = models
    eng = GenerationScheduler(port, slots=1, start=False, device="cpu")
    try:
        fut = eng.submit_async([2, 4, 6], 4,
                               deadline=Deadline(0.01, now=0.0))
        eng.start()
        with pytest.raises(DeadlineExceededError) as ei:
            fut.result(30)
        assert ei.value.stage == "queue"
    finally:
        eng.shutdown()


def test_deadline_expires_mid_generation_and_frees_slot(models):
    """A budget that expires after decode began: the sweep evicts the
    request typed at prefill or decode, and the slot serves the next."""
    ref, port = models
    server = ModelServer(generator=port, slots=1, device="cpu")
    try:
        prompt = np.array([2, 4, 6, 8], np.int32)
        started = threading.Event()

        def slow_stream(_tok):
            started.set()
            time.sleep(0.05)

        fut = server.submit_generate_async(
            prompt, 50, on_token=slow_stream, deadline=Deadline(0.25))
        started.wait(20.0)
        with pytest.raises(DeadlineExceededError) as ei:
            fut.result(timeout=30.0)
        assert ei.value.stage in ("prefill", "decode")
        out = server.submit_generate(prompt, 6, timeout=30.0)
        np.testing.assert_array_equal(out, solo(ref, prompt, 6))
    finally:
        server.shutdown(drain=False, timeout=10.0)


def test_abandoned_request_frees_slot(models):
    """A caller whose submit_generate times out walks away: its cancel
    frees the slot within a few paced iterations."""
    ref, port = models
    server = ModelServer(generator=port, slots=2, device="cpu")
    try:
        filler_started = threading.Event()

        def pace(_tok):
            filler_started.set()
            time.sleep(0.05)

        filler = server.submit_generate_async(
            np.array([9, 9, 9], np.int32), 60, on_token=pace)
        assert filler_started.wait(30.0)
        prompt = np.array([7, 3, 1, 9], np.int32)
        with pytest.raises(FuturesTimeout):
            server.submit_generate(prompt, 50, timeout=0.3)
        t0 = time.perf_counter()
        out = server.submit_generate(prompt, 2, timeout=30.0)
        elapsed = time.perf_counter() - t0
        np.testing.assert_array_equal(out, solo(ref, prompt, 2))
        assert elapsed < 1.5, \
            f"slot not reused promptly ({elapsed:.2f}s): leak"
        server.cancel_generate(filler)
    finally:
        server.shutdown(drain=False, timeout=10.0)


def test_kill_fails_residents_dead_and_queued_closed(models):
    """kill(): slot-resident requests fail with ReplicaDeadError (with the
    tokens they streamed delivered once), queued ones with
    ServerClosedError, and the engine thread exits."""
    _, port = models
    server = ModelServer(generator=port, slots=2, device="cpu")
    eng = server.generation
    streamed = [[], []]
    started = [threading.Event(), threading.Event()]

    def pace(i):
        def on_token(tok):
            streamed[i].append(tok)
            started[i].set()
            time.sleep(0.02)
        return on_token

    residents = [server.submit_generate_async(
        np.array([3 + i, 5, 7], np.int32), 40, on_token=pace(i))
        for i in range(2)]
    queued = [server.submit_generate_async(np.array([4, 4], np.int32), 4)
              for _ in range(3)]
    assert all(e.wait(30) for e in started)
    server.kill()
    for f in residents:
        with pytest.raises(ReplicaDeadError):
            f.result(30)
    for f in queued:
        with pytest.raises(ServerClosedError):
            f.result(30)
    eng._thread.join(30)
    assert not eng.alive
    assert not any(t.name == ENGINE_THREAD and t.is_alive()
                   and t is eng._thread for t in threading.enumerate())
    assert eng._pending is None and eng.pool._open_handle is None
    assert all(0 < len(s) < 40 for s in streamed)
    assert eng.admitted_outstanding() == 0
    with pytest.raises(ServerClosedError):
        eng.submit_async([1, 2], 2)
    server.shutdown()


def test_disaggregated_kill_stops_both_tiers(models):
    _, port = models
    de = DisaggregatedEngine(port, decode_slots=2, prefill_slots=2,
                             prefix_granularity=8, prefill_chunk=8,
                             device="cpu")
    de.kill(ReplicaDeadError("test kill"))
    for eng in (de.prefill, de.decode):
        eng._thread.join(30)
        assert not eng.alive
    with pytest.raises(ServerClosedError):
        de.submit_generate_async(np.arange(1, 20, dtype=np.int32), 2)
    de.shutdown()


# ---------------------------------------------------------------------------
# the KV cache's dtype
# ---------------------------------------------------------------------------

def test_bf16_kv_cache_engine_matches_the_reference(models):
    """A bfloat16 KV cache under the f32 model: the port's engine serves
    the rows the reference's ``dtype=jnp.bfloat16`` engine serves, with
    the prefix cache on (chunks stored in bf16)."""
    ref, port = models
    rng = np.random.default_rng(21)
    prefix = rng.integers(1, VOCAB, 16).astype(np.int32)
    prompts = [np.concatenate([prefix, rng.integers(1, VOCAB, int(n))
                               .astype(np.int32)]) for n in (1, 3, 9, 20)]
    prompts += [rng.integers(1, VOCAB, int(n)).astype(np.int32)
                for n in (2, 7)]
    kw = dict(slots=3, prefill_chunk=8, prefix_cache_bytes=1 << 24,
              prefix_granularity=8)
    rows = []
    engines = (JaxGenerationScheduler(ref, dtype=jnp.bfloat16,
                                      start=False, **kw),
               GenerationScheduler(port, dtype=torch.bfloat16, start=False,
                                   device="cpu", **kw))
    for eng in engines:
        try:
            futs = [eng.submit_async(p, 6) for p in prompts]
            eng.start()
            rows.append([f.result(120) for f in futs])
        finally:
            eng.shutdown()
    for i, (a, b) in enumerate(zip(*rows)):
        np.testing.assert_array_equal(b, a, err_msg=f"request {i}")
    pool = engines[1].pool
    assert pool.caches["layers"][0]["self"]["k"].dtype == torch.bfloat16
    assert engines[1].stats()["prefix_chunks_copied"] == \
        engines[0].stats()["prefix_chunks_copied"] > 0
    chunk = next(iter(engines[1]._prefix_cache._entries.values()))
    assert chunk.layers[0]["k"].dtype == torch.bfloat16
