"""The port's prefix KV cache and chunked prefill
(``bigdl_tpu_torch/serving/prefix_cache.py`` and the engine's cache
hooks), restating ``tests/test_prefix_cache.py`` against the port.

Each engine test feeds the same seeded prompts to the JAX package's
engine and the port's (weights loaded through ``load_jax_parameters``),
both started only after every request is queued, so both see the same
admission order.  It holds the rows equal token for token to each other
and to the JAX ``generate()``, the two caches' keys in LRU order and
their lookup, hit, miss, insert and eviction counts equal, and every
cached chunk's K/V equal to the reference's within atol 1e-4, rtol 1e-4
(f32) with the pad flags equal.

Waived: the telemetry families test (telemetry is not ported, ROADMAP
queue 1, item 10), the XLA compile-count assertions (the port compiles
no programs; its ``SlotPool.counts`` count copies and extracts by width
instead) and ``run_cadence_probe`` (a bench harness, item 6).  The
decode-must-not-disturb-inactive-rows pin is restated in
``tests/test_torch_generation.py``.
"""

import threading

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from bigdl_tpu.models import transformer_lm as jax_transformer_lm
from bigdl_tpu.serving import generation as jax_generation
from bigdl_tpu.serving.prefix_cache import PrefixKVCache as JaxPrefixKVCache
from bigdl_tpu.utils import set_seed
from bigdl_tpu_torch.interop import load_jax_parameters
from bigdl_tpu_torch.models import transformer_lm
from bigdl_tpu_torch.serving import (
    GenerationScheduler, PrefixKVCache, SlotPool, run_shared_prefix_workload,
)

VOCAB, MAX_LEN = 50, 64
CFG = dict(vocab_size=VOCAB, hidden_size=64, num_layers=2, num_heads=4,
           filter_size=128, max_len=MAX_LEN)
KV_TOL = dict(atol=1e-4, rtol=1e-4)
COUNTS = ("lookups", "hits", "misses", "chunks_hit", "bytes_reused",
          "inserts", "evictions", "entries", "resident_bytes",
          "inflight_prefills")


@pytest.fixture(scope="module")
def models():
    set_seed(0)
    ref = jax_transformer_lm(**CFG).eval_mode()
    port = transformer_lm(**CFG, generator=torch.Generator().manual_seed(0),
                          device="cpu").eval()
    load_jax_parameters(port, jax.tree_util.tree_map(np.asarray,
                                                     ref.parameters()))
    return ref, port


_JAX_SOLO = {}


def jax_solo(ref, prompt, max_new):
    key = (prompt.tobytes(), int(max_new))
    if key not in _JAX_SOLO:
        _JAX_SOLO[key] = np.asarray(ref.generate(
            jnp.asarray(prompt, jnp.int32)[None], int(max_new)))[0]
    return _JAX_SOLO[key]


def port_solo(port, prompt, max_new):
    return port.generate(np.asarray(prompt)[None], int(max_new))[0].numpy()


def serve_both(models, prompts, max_news, **kw):
    """Serve ``prompts`` through the reference engine and the port's with
    the same options, every request queued before either starts; the
    stats are each engine's whole-life counts after its shutdown.
    Returns (reference rows, port rows, reference stats, port stats,
    reference cache, port cache)."""
    ref, port = models
    out = []
    for make in (lambda: jax_generation.GenerationScheduler(
                     ref, start=False, **kw),
                 lambda: GenerationScheduler(port, start=False,
                                             device="cpu", **kw)):
        eng = make()
        try:
            futs = [eng.submit_async(p, m) for p, m in zip(prompts, max_news)]
            eng.start()
            rows = [f.result(timeout=180) for f in futs]
        finally:
            eng.shutdown()
        # whole-life counts, read after the shutdown: a pipelined engine
        # reads its last in-flight decode step in the drain, after the
        # last future has resolved
        stats = eng.stats()
        out.append((rows, stats, eng._prefix_cache, eng))
    (rr, rs, rc, re), (pr, ps, pc, pe) = out
    return rr, pr, rs, ps, rc, pc, re, pe


def assert_rows(models, prompts, max_news, ref_rows, port_rows):
    ref, port = models
    for i, (p, m, a, b) in enumerate(zip(prompts, max_news, ref_rows,
                                         port_rows)):
        want = jax_solo(ref, p, m)
        np.testing.assert_array_equal(a, want, err_msg=f"reference {i}")
        np.testing.assert_array_equal(b, want, err_msg=f"port {i}")
        np.testing.assert_array_equal(b, port_solo(port, p, m),
                                      err_msg=f"port solo {i}")


def assert_same_cache(ref_cache, port_cache):
    """Keys in LRU order, the counts, and every chunk's K/V and pad."""
    assert list(port_cache._entries) == list(ref_cache._entries)
    rs, ps = ref_cache.stats(), port_cache.stats()
    assert {k: ps[k] for k in COUNTS} == {k: rs[k] for k in COUNTS}
    for key, want in ref_cache._entries.items():
        got = port_cache._entries[key]
        assert got.index == want.index and got.nbytes == want.nbytes
        np.testing.assert_array_equal(got.pad.numpy(), np.asarray(want.pad))
        for g, w in zip(got.layers, want.layers):
            for name in ("k", "v"):
                assert g[name].is_contiguous()
                np.testing.assert_allclose(g[name].numpy(),
                                           np.asarray(w[name]), **KV_TOL)


# ---------------------------------------------------------------------------
# PrefixKVCache unit semantics, against the reference's cache
# ---------------------------------------------------------------------------

def _chunk(g=8, h=2, d=4, torch_side=True):
    if torch_side:
        return ([{"k": torch.zeros((h, g, d)), "v": torch.zeros((h, g, d))}],
                torch.zeros((g,), dtype=torch.bool))
    return ([{"k": np.zeros((h, g, d), np.float32),
              "v": np.zeros((h, g, d), np.float32)}], np.zeros((g,), bool))


def _unit_script(cache, torch_side):
    toks = np.arange(1, 25, dtype=np.int32)         # 3 granules
    out = [cache.match(toks), cache.missing_boundaries(toks)]
    cache.insert(toks, 1, *_chunk(torch_side=torch_side))
    cache.insert(toks, 2, *_chunk(torch_side=torch_side))
    out.append([c.index for c in cache.match(toks)])
    other = toks.copy()
    other[10] += 1
    out.append(len(cache.match(other)))
    cache.insert(toks, 3, *_chunk(torch_side=torch_side))
    out.append(len(cache.match(toks)))
    out.append(cache.match(np.arange(1, 5, dtype=np.int32)))
    return out


def test_prefix_cache_match_insert_and_lru_eviction():
    layers, pad = _chunk()
    nbytes = 2 * layers[0]["k"].numel() * 4 + pad.numel()
    assert nbytes == 2 * _chunk(torch_side=False)[0][0]["k"].nbytes + 8
    port = PrefixKVCache(byte_budget=2 * nbytes, granularity=8)
    ref = JaxPrefixKVCache(byte_budget=2 * nbytes, granularity=8)
    got, want = _unit_script(port, True), _unit_script(ref, False)
    assert got == want
    assert got[0] == [] and got[1] == [1, 2, 3] and got[2] == [0, 8]
    assert got[3] == 1 and got[4] >= 1 and got[5] == []
    assert list(port._entries) == list(ref._entries)
    assert port.stats() == ref.stats()
    st = port.stats()
    assert st["evictions"] == 1 and st["resident_bytes"] <= port.byte_budget


def test_prefix_chunk_bytes_from_metadata_only():
    """An entry's size comes from shapes and dtypes, as the reference's
    does, and equals it for the same shapes: K/V plus one byte a pad."""
    layers, pad = _chunk(g=64, h=8, d=64)
    port = PrefixKVCache(1 << 30, 64)
    ref = JaxPrefixKVCache(1 << 30, 64)
    toks = np.arange(1, 65, dtype=np.int32)
    got = port.insert(toks, 1, layers * 6, pad)
    want = ref.insert(toks, 1, _chunk(g=64, h=8, d=64,
                                      torch_side=False)[0] * 6,
                      np.zeros((64,), bool))
    assert got.nbytes == want.nbytes == 6 * 2 * 8 * 64 * 64 * 4 + 64


def test_prefix_cache_validation():
    with pytest.raises(ValueError, match="byte_budget"):
        PrefixKVCache(0, 8)
    with pytest.raises(ValueError, match="power of two"):
        PrefixKVCache(1 << 20, 12)
    cache = PrefixKVCache(8, 8)
    assert cache.insert(np.arange(1, 9, dtype=np.int32), 1,
                        *_chunk()) is None
    assert len(cache) == 0


def test_claim_registry_single_flight():
    cache = PrefixKVCache(1 << 20, 8)
    toks = np.arange(1, 25, dtype=np.int32)
    keys = [cache.boundary_key(toks, i) for i in (1, 2, 3)]
    a, b = object(), object()
    assert cache.claim_prefill(keys, a) == keys
    assert cache.claim_prefill(keys, b) == []
    assert cache.prefill_owner(keys[0]) is a
    cache.insert(toks, 1, *_chunk())          # resident: the claim is moot
    assert cache.prefill_owner(keys[0]) is None
    cache.release_prefill(a)
    assert cache.prefill_owner(keys[1]) is None
    assert cache.claim_prefill(keys, b) == keys[1:]
    assert cache.stats()["inflight_prefills"] == 2


# ---------------------------------------------------------------------------
# the slot pool's copy and extract
# ---------------------------------------------------------------------------

def test_kv_extract_returns_copies_and_round_trips(models):
    """kv_extract hands back contiguous copies, never views of the pool:
    a later occupant of the slot must not change a cached chunk.  Copied
    into another slot with kv_copy_into, the chunk reproduces the source
    slot's K/V and pad bit for bit."""
    _, port = models
    rng = np.random.default_rng(2)
    pool = SlotPool(port, slots=3, device="cpu")
    prompt = rng.integers(1, VOCAB + 1, 20).astype(np.int32)
    pool.prefill_into([prompt], [0], 32)
    for _ in range(3):
        pool.decode()
    want = [(c["self"]["k"][0, :, :16].clone(),
             c["self"]["v"][0, :, :16].clone())
            for c in pool.caches["layers"]]
    want_pad = pool.caches["pad"][0, :16].clone()
    layers, pad = pool.kv_extract(0, 0, 16)
    for lay, c in zip(layers, pool.caches["layers"]):
        for name in ("k", "v"):
            assert lay[name].is_contiguous()
            assert lay[name].untyped_storage().data_ptr() != \
                c["self"][name].untyped_storage().data_ptr()
    # the slot is reused by another prompt before the chunk is copied
    pool.release(0)
    other = rng.integers(1, VOCAB + 1, 20).astype(np.int32)
    pool.prefill_into([other], [0], 32)
    pool.kv_copy_into(2, layers, pad, 0)
    for (k, v), c in zip(want, pool.caches["layers"]):
        assert torch.equal(c["self"]["k"][2, :, :16], k)
        assert torch.equal(c["self"]["v"][2, :, :16], v)
        assert not torch.equal(c["self"]["k"][0, :, :16], k)
    assert torch.equal(pool.caches["pad"][2, :16], want_pad)
    assert pool.counts == {"kv_copy": {16: 1}, "kv_extract": {16: 1}}


def test_kv_cache_dtype_reaches_the_pool(models):
    _, port = models
    pool = SlotPool(port, slots=2, dtype=torch.bfloat16, device="cpu")
    assert pool.dtype == torch.bfloat16
    assert all(c["self"]["k"].dtype == torch.bfloat16
               for c in pool.caches["layers"])
    assert SlotPool(port, slots=1, device="cpu").caches["layers"][0][
        "self"]["k"].dtype == torch.float32


# ---------------------------------------------------------------------------
# engines: the port against the reference
# ---------------------------------------------------------------------------

def test_chunked_prefill_equivalence_straddling_boundaries(models):
    """Prefill regions on, one short of and past chunk boundaries
    (including the suffix-aligned overlapping final chunk)."""
    chunk = 8
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, VOCAB + 1, tp).astype(np.int32)
               for tp in (chunk - 1, chunk, chunk + 1, 2 * chunk,
                          2 * chunk + 3, 6 * chunk + 5)]
    news = [4] * len(prompts)
    rr, pr, rs, ps, *_ = serve_both(models, prompts, news, slots=2,
                                    prefill_chunk=chunk,
                                    prefill_chunk_budget=1)
    assert_rows(models, prompts, news, rr, pr)
    assert ps["prefill_calls"] == rs["prefill_calls"]
    assert ps["decode_steps"] == rs["decode_steps"]


def test_prefix_hit_longer_than_suffix_bucket(models):
    """A cached prefix longer than the remaining suffix's bucket: the copy
    seeds positions beyond where the suffix prefill writes."""
    rng = np.random.default_rng(4)
    prefix = rng.integers(1, VOCAB + 1, 32).astype(np.int32)
    p1 = np.concatenate([prefix, rng.integers(1, VOCAB + 1, 2)
                         .astype(np.int32)])
    p2 = np.concatenate([prefix, rng.integers(1, VOCAB + 1, 3)
                         .astype(np.int32)])
    kw = dict(slots=2, prefill_chunk=16, prefix_cache_bytes=1 << 24,
              prefix_granularity=8)
    ref, port = models
    engines = (jax_generation.GenerationScheduler(ref, **kw),
               GenerationScheduler(port, device="cpu", **kw))
    rows = []
    try:
        for eng in engines:
            rows.append([eng.submit(p, 4, timeout=120) for p in (p1, p2)])
    finally:
        for eng in engines:
            eng.shutdown()
    assert_rows(models, [p1, p2], [4, 4], rows[0], rows[1])
    st = engines[1].stats()
    assert st["prefix_cache"]["hits"] == 1
    assert st["prefix_chunks_copied"] == 4
    assert engines[1].pool.counts["kv_copy"] == {8: 4}
    assert_same_cache(engines[0]._prefix_cache, engines[1]._prefix_cache)


def test_cache_disabled_byte_identical_to_baseline_engine(models):
    """prefix_cache_bytes=None serves as the engine without a cache (no
    copy or extract, bucketed prefill only for prompts of one chunk), and
    the cache-enabled engine serves the same rows."""
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, VOCAB + 1, int(rng.integers(2, 20)))
               .astype(np.int32) for _ in range(8)]
    news = [5] * len(prompts)
    rr, pr, rs, ps, rc, pc, _, pe = serve_both(models, prompts, news,
                                               slots=3)
    assert_rows(models, prompts, news, rr, pr)
    assert pc is None and rc is None and ps["prefix_cache"] is None
    assert pe.pool.counts == {"kv_copy": {}, "kv_extract": {}}
    assert ps["prefill_calls"] == rs["prefill_calls"] > 0
    rr2, pr2, *_, rc2, pc2, _, pe2 = serve_both(
        models, prompts, news, slots=3, prefix_cache_bytes=1 << 24,
        prefix_granularity=8)
    for a, b in zip(pr, pr2):
        np.testing.assert_array_equal(a, b)
    assert_rows(models, prompts, news, rr2, pr2)
    assert_same_cache(rc2, pc2)


def test_eviction_under_byte_pressure_mid_stream(models):
    """A byte budget that cannot hold every prefix evicts while requests
    decode; rows stay right and the cache within budget."""
    _, port = models
    rng = np.random.default_rng(6)
    pool = SlotPool(port, slots=1, device="cpu")
    one_chunk = sum(2 * c["self"]["k"][0, :, :8].numel() * 4
                    for c in pool.caches["layers"]) + 8
    prompts = [rng.integers(1, VOCAB + 1, int(rng.integers(17, 40)))
               .astype(np.int32) for _ in range(10)]
    news = [4] * len(prompts)
    rr, pr, rs, ps, rc, pc, *_ = serve_both(
        models, prompts, news, slots=3, prefill_chunk=8,
        prefix_cache_bytes=3 * one_chunk, prefix_granularity=8)
    assert_rows(models, prompts, news, rr, pr)
    st = ps["prefix_cache"]
    assert st["evictions"] > 0
    assert st["resident_bytes"] <= st["byte_budget"]
    assert_same_cache(rc, pc)


def test_ttft_and_inter_token_reservoir_quantiles_in_stats(models):
    _, port = models
    rng = np.random.default_rng(8)
    prompts = [rng.integers(1, VOCAB + 1, int(rng.integers(2, 16)))
               .astype(np.int32) for _ in range(5)]
    eng = GenerationScheduler(port, slots=2, device="cpu")
    try:
        [f.result(120) for f in [eng.submit_async(p, 6) for p in prompts]]
        st = eng.stats()
    finally:
        eng.shutdown()
    assert st["queue_to_first_token_s_p50"] > 0
    assert st["queue_to_first_token_s_p99"] >= \
        st["queue_to_first_token_s_p50"]
    assert st["inter_token_s_p50"] > 0
    assert st["inter_token_s_p99"] >= st["inter_token_s_p50"]
    assert st["prefix_cache"] is None and eng.prefix_cache_stats() is None
    for key in ("prefix_chunks_copied", "prefill_dedup_leaders",
                "prefill_dedup_followers"):
        assert st[key] == 0
    assert st["role"] == "mixed"


def test_copies_and_extracts_at_one_width(models):
    """The counterpart of the compile-once pin: across many joins and
    leaves every copy and extract is one granule wide, and the two
    engines' caches agree."""
    rng = np.random.default_rng(10)
    prompts = [rng.integers(1, VOCAB + 1, int(rng.integers(10, 40)))
               .astype(np.int32) for _ in range(8)] * 2
    news = [4] * len(prompts)
    rr, pr, rs, ps, rc, pc, _, pe = serve_both(
        models, prompts, news, slots=2, prefill_chunk=8,
        prefix_cache_bytes=1 << 24, prefix_granularity=8)
    assert_rows(models, prompts, news, rr, pr)
    assert set(pe.pool.counts["kv_copy"]) == {8}
    assert set(pe.pool.counts["kv_extract"]) == {8}
    assert pe.pool.counts["kv_copy"][8] == ps["prefix_chunks_copied"]
    assert pe.pool.counts["kv_extract"][8] == ps["prefix_cache"]["inserts"]
    assert ps["prefix_chunks_copied"] == rs["prefix_chunks_copied"] > 0
    assert_same_cache(rc, pc)


# ---------------------------------------------------------------------------
# the acceptance harness at smoke scale
# ---------------------------------------------------------------------------

def test_shared_prefix_workload_harness(models):
    ref, port = models
    kw = dict(n_requests=6, prefix_len=24, tail=(2, 7), max_new=3,
              slots=2, prefix_cache_bytes=1 << 24, prefix_granularity=8,
              prefill_chunk=8, oracle_sample=1)
    out = run_shared_prefix_workload(port, device="cpu", **kw)
    want = jax_generation.run_shared_prefix_workload(ref, **kw)
    assert out["rows_equal_cache_vs_nocache"]
    assert out["greedy_equal_checked"]
    assert out["cache"]["prefix_cache"]["hits"] > 0
    assert out["nocache"]["prefix_cache"] is None
    assert out["ttft_p50_speedup"] > 0
    assert out["shared_fraction"] > 0.5
    assert out["shared_fraction"] == pytest.approx(want["shared_fraction"],
                                                   abs=1e-3)
    # the same seeded prompts, and the same rows as the JAX generate()
    for p, row in zip(out["prompts"], out["rows"]["cache"]):
        np.testing.assert_array_equal(row, jax_solo(ref, p, 3))
    for label in ("cache", "nocache"):
        assert out[label]["prefill_calls"] == want[label]["prefill_calls"]
        assert out[label]["prefix_chunks_copied"] == \
            want[label]["prefix_chunks_copied"]
    for key in ("lookups", "hits", "misses", "inserts", "evictions"):
        assert out["cache"]["prefix_cache"][key] == \
            want["cache"]["prefix_cache"][key]
    totals = out["cache"]["engine_totals"]
    assert totals["prefill_calls"] >= out["cache"]["prefill_calls"]


def test_shared_cache_is_thread_safe_under_two_writers():
    """Two threads inserting and matching on one cache (the disaggregated
    engines' sharing) keep its byte count and counters consistent."""
    cache = PrefixKVCache(byte_budget=6 * (2 * 2 * 8 * 4 * 4 + 8),
                          granularity=8)
    errors = []

    def worker(seed):
        rng = np.random.default_rng(seed)
        try:
            for _ in range(200):
                toks = rng.integers(1, 4, 24).astype(np.int32)
                cache.match(toks)
                for i in cache.missing_boundaries(toks):
                    cache.insert(toks, i, *_chunk())
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(s,)) for s in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not errors and not any(t.is_alive() for t in threads)
    st = cache.stats()
    assert st["resident_bytes"] == sum(e.nbytes
                                       for e in cache._entries.values())
    assert st["resident_bytes"] <= st["byte_budget"]
    assert st["lookups"] == st["hits"] + st["misses"] == 800
    assert st["inserts"] - st["evictions"] == st["entries"]
