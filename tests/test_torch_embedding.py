"""The port's ``embedding/`` (the single-device half) and
``models/dlrm.py`` against the JAX package's, on the CPU.

Restates ``tests/test_embedding.py`` :108 (the owner shard and the
affinity key), :288 (per-table methods never alias), :322 (streaming
eval, interrupted and resumed through JSON, equals the one-shot sweep),
:347 (the state's checks), :361 (resume over a mixing source, and its
configuration check; ``data/mixing.py`` is not ported, so the mixture
is a small seeded one written here) and :506 (the zoo entry).
``WideAndDeep`` at 64 users x 32 items is held against the JAX model
with its weights carried across: the forward, and 4 ``Optimizer`` steps
(SGD, the tables on their own methods through ``hybrid_optim_methods``)
in both packages.  ``RecommenderScorer`` serves scored rows on the CPU.
The mesh half raises naming ROADMAP.md queue 1, item 11.

Tolerance: float32 rtol 1e-5, atol 1e-6 on the forward, eval metrics
and the trained parameters (``test_torch_rnn.OUT``); the losses rtol
1e-5.
"""

import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from bigdl_tpu import embedding as jemb
from bigdl_tpu import nn as jnn
from bigdl_tpu import optim as joptim
from bigdl_tpu.models import WideAndDeep as JWideAndDeep
from bigdl_tpu.utils import set_seed
from bigdl_tpu_torch import embedding as pemb
from bigdl_tpu_torch import models as pmodels
from bigdl_tpu_torch import nn as pnn
from bigdl_tpu_torch.dataset import DataSet, Sample, SampleToMiniBatch
from bigdl_tpu_torch.interop import flatten_jax_parameters
from bigdl_tpu_torch.optim import SGD, Optimizer, Trigger
from bigdl_tpu_torch.optim.validation import HitRatio

from test_torch_rnn import OUT, carry, gen, one_torch_thread  # noqa: F401


def _pair(users=64, items=32, embed=8, mlp=(16,), seed=8):
    set_seed(seed)
    ref = JWideAndDeep(users, items, embed_dim=embed, mlp_dims=mlp)
    port = pmodels.WideAndDeep(users, items, embed, mlp, **gen(seed))
    return ref, carry(ref, port)


def _ranking_rows(n_users=24, neg=7, seed=5):
    """[U, 1 + neg, 2] id rows: the positive item first, then negatives
    (test_embedding.py:309)."""
    rng = np.random.default_rng(seed)
    rows = np.zeros((n_users, 1 + neg, 2), np.int32)
    for u in range(n_users):
        rows[u, :, 0] = u + 1
        rows[u, :, 1] = rng.permutation(32)[:1 + neg] + 1
    return rows


# ---- the table ---------------------------------------------------------------

def test_table_is_the_reference_dense_lookup():
    """Clipped 1-based ids through the dense gather: the forward and the
    sparse gradient of the reference's unsharded table."""
    set_seed(3)
    ref = jemb.ShardedEmbeddingTable(64, 8)
    port = carry(ref, pemb.ShardedEmbeddingTable(64, 8, **gen(3)))
    ids = np.random.default_rng(2).integers(0, 70, size=(6, 4)) \
        .astype(np.int32)                       # 0 and > 64: clipped
    from bigdl_tpu.core.module import combine, partition
    params, rest = partition(ref)
    out, vjp = jax.vjp(lambda p: combine(p, rest).forward(ids), params)
    cot = np.random.default_rng(3).normal(size=out.shape).astype(np.float32)
    g_ref = np.asarray(vjp(jnp.asarray(cot))[0].weight)
    got = port(torch.tensor(ids))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(out))
    got.backward(torch.tensor(cot))
    np.testing.assert_array_equal(port.weight.grad.numpy(), g_ref)
    touched = np.zeros(64, bool)
    touched[np.clip(ids - 1, 0, 63)] = True
    assert np.all(port.weight.grad.numpy()[~touched] == 0.0)
    assert pemb.sharded_table.LAST_LOOKUP_SHAPES == {}


def test_owner_of_matches_affinity_key():
    """test_embedding.py:108: on one device every id is shard 0's, as the
    reference's unsharded owner_of gives it; the affinity key equals the
    reference's for 8 shards."""
    t = pemb.ShardedEmbeddingTable(64, 4, **gen())
    ref = jemb.ShardedEmbeddingTable(64, 4)
    uids = np.asarray([1, 8, 9, 33, 64, 200, 0, -3])
    np.testing.assert_array_equal(t.owner_of(uids).numpy(),
                                  np.asarray(ref.owner_of(uids)))
    assert t.n_shards == 1 and t.rows_per_shard == 64
    for uid in uids:
        for rows, shards in ((64, 8), (64, 1), (100, 7), (5, 9)):
            assert pemb.shard_affinity_key(uid, rows, shards) == \
                jemb.shard_affinity_key(uid, rows, shards)
    assert pemb.shard_affinity_key(17, 256, 8, model="wide_and_deep",
                                   table="item") == \
        "emb-wide_and_deep-item-s0"


def test_the_mesh_half_names_item_11():
    t = pemb.ShardedEmbeddingTable(8, 2, **gen())
    model = pmodels.wide_and_deep(**gen())
    for call in (lambda: t.set_mesh(None), lambda: model.set_mesh(None),
                 lambda: pemb.embedding_rules(model),
                 lambda: pemb.resolve_hybrid(model, None),
                 lambda: pemb.configure_hybrid(None)):
        with pytest.raises(NotImplementedError, match="item 11"):
            call()


def test_embedding_exports_every_reference_name():
    assert sorted(pemb.__all__) == sorted(jemb.__all__)
    from bigdl_tpu.embedding import hybrid as jh
    from bigdl_tpu_torch.embedding import hybrid as ph
    assert sorted(ph.__all__) == sorted(jh.__all__)


# ---- per-table methods ---------------------------------------------------------

def test_hybrid_optim_methods_split_never_aliases():
    """test_embedding.py:288, and the other two refusals of
    hybrid.py:129-166."""
    model = pmodels.WideAndDeep(64, 32, 8, (16,), **gen(1))
    methods = pemb.hybrid_optim_methods(model, SGD(0.5), SGD(0.1))
    assert set(methods) == {"user_table", "item_table", "wide_user",
                            "wide_item", "tower"}
    assert methods["user_table"].learning_rate == 0.5
    assert methods["tower"].learning_rate == 0.1
    owners = [id(m) for m in methods.values()]
    assert len(set(owners)) == len(owners), "method instances alias"
    assert set(pemb.sharded_tables(model)) == {
        "user_table", "item_table", "wide_user", "wide_item"}
    with pytest.raises(pemb.HybridPlanError, match="IS a single table"):
        pemb.hybrid_optim_methods(pemb.ShardedEmbeddingTable(8, 2, **gen()),
                                  SGD(1), SGD(1))

    class Owns(pnn.Module):
        def __init__(self):
            super().__init__()
            self.scale = torch.nn.Parameter(torch.ones(1))
    with pytest.raises(pemb.HybridPlanError, match="direct parameters"):
        pemb.hybrid_optim_methods(Owns(), SGD(1), SGD(1))
    nested = pnn.Sequential(pemb.ShardedEmbeddingTable(8, 2, **gen()),
                            pnn.Linear(2, 2, **gen()))
    with pytest.raises(pemb.HybridPlanError, match="mixes a nested"):
        pemb.hybrid_optim_methods(pnn.Sequential(nested), SGD(1), SGD(1))
    assert issubclass(pemb.HybridPlanError, ValueError)


# ---- WideAndDeep ------------------------------------------------------------------

def test_zoo_entry():
    """test_embedding.py:506, and the forward against the reference's
    with its weights carried across (a [B, 1 + neg, 2] slate too)."""
    m = pmodels.zoo("wide_and_deep", **gen())
    assert isinstance(m, pmodels.WideAndDeep)
    assert pmodels.zoo_sample_shape("wide_and_deep") == (2,)
    out = m(torch.tensor([[1, 1], [256, 128]], dtype=torch.int32))
    assert out.shape == (2, 1)
    assert torch.all((out >= 0) & (out <= 1))
    ref, port = _pair()
    for x in (np.asarray([[1, 1], [64, 32], [7, 30]], np.int32),
              _ranking_rows(4)):
        np.testing.assert_allclose(
            port(torch.tensor(x)).detach().numpy(),
            np.asarray(ref.forward(jnp.asarray(x))), **OUT)


def _wd_samples(n=32, seed=6):
    from bigdl_tpu_torch.dataset.movielens import synthetic_id_stream
    pairs, labels = next(synthetic_id_stream(
        n_users=64, n_items=32, batch_size=n, batches=1, seed=seed))
    return pairs, labels


def test_wide_and_deep_trains_as_the_reference():
    """4 Optimizer steps (batch 16 of the id stream, BCE, the tables on
    SGD(0.5) and the tower on SGD(0.05) through hybrid_optim_methods) in
    both packages from the same weights: the loss and every parameter."""
    from bigdl_tpu.dataset import SampleToMiniBatch as JBatch
    from bigdl_tpu.dataset.dataset import DataSet as JDataSet
    from bigdl_tpu.dataset.dataset import Sample as JSample
    pairs, labels = _wd_samples()
    ref, port = _pair()
    jds = JDataSet.array([JSample(p, l) for p, l in zip(pairs, labels)],
                         shuffle=False).transform(JBatch(16))
    pds = DataSet.array([Sample(p, l) for p, l in zip(pairs, labels)],
                        shuffle=False).transform(SampleToMiniBatch(16))
    ref_opt = (joptim.Optimizer(ref, jds, jnn.BCECriterion())
               .set_optim_methods(jemb.hybrid_optim_methods(
                   ref, joptim.SGD(0.5), joptim.SGD(0.05)))
               .set_end_when(joptim.Trigger.max_iteration(4)))
    port_opt = (Optimizer(port, pds, pnn.BCECriterion())
                .set_optim_methods(pemb.hybrid_optim_methods(
                    port, SGD(0.5), SGD(0.05)))
                .set_end_when(Trigger.max_iteration(4)))
    ref_opt.optimize()
    port_opt.optimize()
    assert port_opt.state["neval"] == ref_opt.state["neval"] == 5
    np.testing.assert_allclose(port_opt.state["loss"],
                               ref_opt.state["loss"], rtol=1e-5)
    want = flatten_jax_parameters(ref.parameters())
    assert set(want) == {n for n, _ in port.named_parameters()}
    for n, p in port.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n], **OUT,
                                   err_msg=n)


# ---- streaming eval ------------------------------------------------------------------

def _eval_model():
    return _pair(seed=8)


def test_streaming_eval_equals_oneshot_with_resume():
    """test_embedding.py:322, and the results equal to the reference's
    on the same weights."""
    ref, model = _eval_model()
    rows = _ranking_rows()
    oneshot, final_state = pemb.StreamingRecEval(
        model, batch_size=8, device="cpu").evaluate(rows)
    assert oneshot is not None and len(oneshot) == 2
    state, results = None, None
    for _ in range(10):
        ev = pemb.StreamingRecEval(model, batch_size=8, device="cpu")
        results, state = ev.evaluate(rows, state=state, max_batches=1)
        if results is not None:
            break
        state = json.loads(json.dumps(state))
    assert results is not None
    for a, b in zip(oneshot, results):
        assert a.result()[0] == b.result()[0], (a, b)
    assert state["partials"] == final_state["partials"]
    assert all(0.0 <= r.result()[0] <= 1.0 for r in oneshot)
    want, _ = jemb.StreamingRecEval(ref, batch_size=8).evaluate(rows)
    for a, b in zip(oneshot, want):
        np.testing.assert_allclose(a.result()[0], b.result()[0], **OUT)
        assert a.result()[1] == b.result()[1]


def test_streaming_eval_state_validation():
    """test_embedding.py:347, and a state that counts more batches than
    the epoch has."""
    _, model = _eval_model()
    rows = _ranking_rows(n_users=8)
    _, state = pemb.StreamingRecEval(model, batch_size=4,
                                     device="cpu").evaluate(
        rows, max_batches=1)
    with pytest.raises(ValueError, match="version"):
        pemb.StreamingRecEval(model, batch_size=4, device="cpu").evaluate(
            rows, state={**state, "version": 99})
    with pytest.raises(ValueError, match="same method list"):
        pemb.StreamingRecEval(model, methods=[HitRatio(5)], batch_size=4,
                              device="cpu").evaluate(rows, state=state)
    late = json.loads(json.dumps(state))
    late["pipeline"]["offset"] = 5
    with pytest.raises(ValueError, match="shrank"):
        pemb.StreamingRecEval(model, batch_size=4, device="cpu").evaluate(
            rows, state=late)


class _Mixed:
    """A seeded two-source mixture of minibatches (the shape of the
    reference's ``MixedDataSet`` that the evaluator reads: ``data(train,
    epoch)``, ``seed()`` and ``sampler_state()``)."""

    def __init__(self, children, weights, seed, batch=4):
        self.children, self.weights = children, list(weights)
        self._seed, self.batch = seed, batch

    def seed(self):
        return self._seed

    def sampler_state(self):
        return {"weights": self.weights, "seed": self._seed,
                "children": [len(c) for c in self.children]}

    def data(self, train=False, epoch=1):
        rng = np.random.default_rng([self._seed, epoch])
        its = [iter(c) for c in self.children]
        p = np.asarray(self.weights, float) / sum(self.weights)
        samples = []
        while True:
            try:
                samples.append(Sample(next(its[rng.choice(2, p=p)]), 1))
            except StopIteration:
                break
        yield from SampleToMiniBatch(self.batch).apply(iter(samples))


def test_streaming_eval_over_a_mixing_source_resumes():
    """test_embedding.py:361: resumed sweeps over a mixture equal the
    one-shot sweep; another mixture's configuration is refused."""
    _, model = _eval_model()

    def mixed(weights=(1, 1)):
        return _Mixed([_ranking_rows(12, seed=21), _ranking_rows(12, seed=22)],
                      weights, seed=77)

    oneshot, _ = pemb.StreamingRecEval(model, device="cpu").evaluate(mixed())
    results, state = None, None
    while results is None:
        results, state = pemb.StreamingRecEval(model, device="cpu").evaluate(
            mixed(), state=state, max_batches=2)
    for a, b in zip(oneshot, results):
        assert a.result()[0] == b.result()[0]
    _, mid = pemb.StreamingRecEval(model, device="cpu").evaluate(
        mixed(), max_batches=1)
    with pytest.raises(ValueError, match="mixing"):
        pemb.StreamingRecEval(model, device="cpu").evaluate(
            mixed((3, 1)), state=mid)


# ---- serving ---------------------------------------------------------------------------

def test_recommender_scorer_scores_rows_as_the_forward():
    """The scoring target on the CPU: warm-up, 12 requests (pairs and a
    slate) through submit_generate_async, each the model's forward of the
    row alone; the stats delegation; shutdown drains."""
    _, model = _pair()
    scorer = pemb.RecommenderScorer(model, max_batch=4, device="cpu")
    assert scorer.warmup(np.zeros(2, np.int32)) is scorer
    rng = np.random.default_rng(4)
    rows = [np.asarray([rng.integers(1, 65), rng.integers(1, 33)],
                       np.int32) for _ in range(12)]
    futs = [scorer.submit_generate_async(r, 1) for r in rows]
    with torch.no_grad():
        for r, f in zip(rows, futs):
            want = model(torch.tensor(r[None])).numpy()[0]
            np.testing.assert_allclose(np.asarray(f.result(30)), want, **OUT)
    stats = scorer.stats()
    assert stats["slots"] == 4 and stats["queue_depth"] == 0
    assert scorer.admitted_outstanding() == 0 and scorer.queue_depth() == 0
    scorer.shutdown()
