"""The port's continuous-batching engine (bigdl_tpu_torch.serving): every
row served through ``GenerationScheduler`` or ``ModelServer`` equals the
port's solo ``generate()`` token for token, and the JAX package's
``generate()`` on the same weights, across mixed prompt lengths, prompts
longer than one prefill chunk, single-token prompts and rows that leave
at EOS.  Plus admission (block / reject / shed_oldest), drain on
shutdown, and the NotImplementedError of what this slice leaves out.
"""

import threading
import time

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from bigdl_tpu.models import transformer_lm as jax_transformer_lm
from bigdl_tpu.serving import batching as jax_batching
from bigdl_tpu.utils import set_seed
from bigdl_tpu_torch.interop import load_jax_parameters
from bigdl_tpu_torch.models import transformer_lm
from bigdl_tpu_torch.serving import (
    BoundedRequestQueue, Deadline, GenerationScheduler, ModelServer,
    QueueFullError, RequestSheddedError, ServerClosedError, SlotPool,
    bucket_sizes, pick_bucket, run_mixed_workload,
)

VOCAB, MAX_LEN = 128, 128
CFG = dict(vocab_size=VOCAB, hidden_size=64, num_layers=2, num_heads=4,
           filter_size=128, max_len=MAX_LEN)


@pytest.fixture(scope="module")
def models():
    set_seed(0)
    ref = jax_transformer_lm(**CFG).eval_mode()
    port = transformer_lm(**CFG, generator=torch.Generator().manual_seed(0),
                          device="cpu").eval()
    load_jax_parameters(port, jax.tree_util.tree_map(np.asarray,
                                                     ref.parameters()))
    return ref, port


def solo(port, prompt, max_new, eos_id=None):
    return port.generate(np.asarray(prompt)[None], max_new,
                         eos_id=eos_id)[0].numpy()


def _requests(seed, n, lens=(1, 40), news=(2, 10)):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(1, VOCAB + 1, int(rng.integers(*lens)))
               .astype(np.int32) for _ in range(n)]
    return prompts, [int(rng.integers(*news)) for _ in range(n)]


def _serve(engine, prompts, max_news):
    try:
        futs = [engine.submit_async(p, m) for p, m in zip(prompts, max_news)]
        return [f.result(timeout=120) for f in futs]
    finally:
        engine.shutdown()


def test_scheduler_rows_equal_solo_and_jax_generate(models):
    """Mixed lengths, with prompts over the 16-wide prefill chunk, a
    one-token prompt, and fewer slots than requests."""
    ref, port = models
    prompts, max_news = _requests(0, 9, lens=(2, 60))
    prompts[3] = prompts[3][:1]
    prompts[5] = np.random.default_rng(9).integers(1, VOCAB + 1, 70) \
        .astype(np.int32)
    rows = _serve(GenerationScheduler(port, slots=4, prefill_batch=2,
                                      prefill_chunk=16, device="cpu"),
                  prompts, max_news)
    assert any(len(p) > 16 for p in prompts)
    for i, (p, m, row) in enumerate(zip(prompts, max_news, rows)):
        assert row.dtype == np.int32 and row.shape == (len(p) + m,)
        np.testing.assert_array_equal(row, solo(port, p, m),
                                      err_msg=f"request {i}")
    # the JAX package's generate on the same weights, for the chunked
    # prompt (solo generate is held to it in test_torch_transformer_lm)
    want = np.asarray(ref.generate(jnp.asarray(prompts[5])[None],
                                   max_news[5]))[0]
    np.testing.assert_array_equal(rows[5], want)


def test_rows_leave_at_eos_without_disturbing_neighbours(models):
    _, port = models
    prompts, _ = _requests(1, 4)
    eos = int(solo(port, prompts[0], 3)[len(prompts[0])])
    rows = _serve(GenerationScheduler(port, slots=4, eos_id=eos,
                                      device="cpu"), prompts, [8] * 4)
    for p, row in zip(prompts, rows):
        np.testing.assert_array_equal(row, solo(port, p, 8, eos_id=eos))
    i0 = len(prompts[0])
    assert rows[0][i0] == eos and not rows[0][i0 + 1:].any()


def test_model_server_rows_and_streaming(models):
    _, port = models
    prompts, max_news = _requests(2, 5, lens=(2, 50))
    streamed = []
    server = ModelServer(generator=port, slots=3, device="cpu")
    try:
        fut = server.submit_generate_async(prompts[0], max_news[0],
                                           on_token=streamed.append)
        rows = server.submit_generate_many(prompts[1:], max_news[1:],
                                           timeout=120)
        first = fut.result(timeout=120)
        one = server.submit_generate(prompts[1], 3, timeout=120)
    finally:
        server.shutdown()
    assert streamed == list(first[len(prompts[0]):])
    for p, m, row in zip(prompts, max_news, [first] + rows):
        np.testing.assert_array_equal(row, solo(port, p, m))
    np.testing.assert_array_equal(one, solo(port, prompts[1], 3))
    with pytest.raises(ServerClosedError):
        server.submit_generate(prompts[0], 2)


def test_run_mixed_workload_checks_greedy_equality(models):
    _, port = models
    prompts, max_news = _requests(3, 6, lens=(2, 30))
    out = run_mixed_workload(port, prompts, max_news, slots=3,
                             prefill_chunk=8, device="cpu")
    assert out["greedy_equal_checked"] is True
    assert out["total_new_tokens"] == sum(max_news)


def test_decode_does_not_disturb_inactive_rows(models):
    """A pooled decode step writes every lane; an inactive lane writes at
    max_len-1, never into a neighbour's prefilled positions."""
    _, port = models
    pool = SlotPool(port, slots=3, device="cpu")
    p = np.arange(1, 12, dtype=np.int32)
    pool.chunk_prefill_into(p[:8], slot=1, index=0)
    before = [layer["self"]["k"][1, :, :8].clone()
              for layer in pool.caches["layers"]]
    pool.activate(0, 5, 0)
    pool.decode()
    for layer, k in zip(pool.caches["layers"], before):
        torch.testing.assert_close(layer["self"]["k"][1, :, :8], k,
                                   rtol=0, atol=0)


def test_reject_policy_raises_queue_full(models):
    _, port = models
    eng = GenerationScheduler(port, slots=1, queue_capacity=1,
                              admission="reject", start=False, device="cpu")
    fut = eng.submit_async([1, 2, 3], 2)
    with pytest.raises(QueueFullError):
        eng.submit_async([4, 5], 2)
    eng.start()
    eng.shutdown()
    assert fut.result(timeout=60).shape == (5,)


def test_shutdown_drains_queued_requests(models):
    _, port = models
    eng = GenerationScheduler(port, slots=1, start=False, device="cpu")
    futs = [eng.submit_async([3, 4, 5], 3) for _ in range(3)]
    eng.start()
    eng.shutdown(drain=True, timeout=60)
    assert all(f.result(timeout=1).shape == (6,) for f in futs)
    with pytest.raises(ServerClosedError):
        eng.submit_async([1], 1)


def test_unported_options_raise_not_implemented(models):
    _, port = models
    for kw in ({"prefix_cache_bytes": 1 << 20}, {"prefix_cache": object()},
               {"role": "prefill"}):
        with pytest.raises(NotImplementedError):
            GenerationScheduler(port, slots=1, start=False, device="cpu",
                                **kw)
    eng = GenerationScheduler(port, slots=1, start=False, device="cpu")
    with pytest.raises(NotImplementedError, match="deadline"):
        eng.submit_async([1, 2], 2, deadline=Deadline(5.0))
    with pytest.raises(NotImplementedError, match="backend"):
        ModelServer(backend=object(), device="cpu")


def test_validation_errors(models):
    _, port = models
    eng = GenerationScheduler(port, slots=1, start=False, device="cpu")
    with pytest.raises(ValueError, match="empty"):
        eng.submit_async([], 2)
    with pytest.raises(ValueError, match="max_len"):
        eng.submit_async(np.ones(MAX_LEN, np.int32), 1)
    with pytest.raises(ValueError, match="prefill_chunk"):
        GenerationScheduler(port, slots=1, prefill_chunk=1, start=False,
                            device="cpu")


# ---------------------------------------------------------------------------
# the port's own copies of admission and batching
# ---------------------------------------------------------------------------

class _Item:
    def __init__(self):
        from concurrent.futures import Future
        self.future = Future()
        self.t_enqueue = time.perf_counter()


def test_bounded_queue_policies():
    q = BoundedRequestQueue(1, policy="shed_oldest")
    a, b = _Item(), _Item()
    q.put(a)
    q.put(b)
    with pytest.raises(RequestSheddedError):
        a.future.result(timeout=1)
    assert q.get(timeout=0) is b

    q = BoundedRequestQueue(1, policy="block")
    q.put(_Item())
    with pytest.raises(QueueFullError):
        q.put(_Item(), timeout=0.05)
    got = []
    t = threading.Thread(target=lambda: got.append(q.get(timeout=5)))
    late = _Item()
    t.start()
    q.put(late, timeout=5)      # unblocks once the consumer took one
    t.join(5)
    assert len(got) == 1 and q.get(timeout=0) is late

    q = BoundedRequestQueue(2)
    c = _Item()
    q.put(c)
    assert q.close(discard=True) == [c]
    with pytest.raises(ServerClosedError):
        c.future.result(timeout=1)
    with pytest.raises(ServerClosedError):
        q.put(_Item())
    with pytest.raises(ValueError):
        BoundedRequestQueue(1, policy="lifo")


@pytest.mark.parametrize("n", [1, 2, 5, 24, 64, 100])
def test_buckets_match_the_reference(n):
    assert bucket_sizes(n) == tuple(jax_batching.bucket_sizes(n))
    for k in (1, n // 2 + 1, n):
        assert pick_bucket(k, bucket_sizes(n)) == \
            jax_batching.pick_bucket(k, jax_batching.bucket_sizes(n))
    with pytest.raises(ValueError):
        pick_bucket(n + 1, bucket_sizes(n))
