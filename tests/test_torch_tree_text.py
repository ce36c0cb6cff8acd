"""The port's ``nn/tree.py``, ``dataset/text.py`` and the text-classifier
and Tree-LSTM examples against the JAX package's, on the CPU.

``BinaryTreeLSTM`` is held forward and backward (the input's gradient and
every parameter's, eager ``jax.vjp``) on full, ragged and gate-free
trees; restates ``tests/test_sparse_tree_misc.py`` :106 (shapes and a
gradient through the tree), :130 (the reference jits it; here repeated
calls) and :279 (ragged padding carries the root to the last slot).  The
examples' data (``parse_sexpr``, ``trees_to_arrays``,
``_synthetic_trees``, ``synthetic_corpus``, ``load_folder``) equal the
reference's arrays; ``Tokenizer``, ``Dictionary`` and
``TextToLabeledSentence`` equal the reference's on a few sentences (no
reference test covers them); two optimizer steps of each example's model
and recipe in both packages from the same weights and batches.

Tolerance: float32 rtol 1e-5, atol 1e-6 on outputs, gradients, losses and
weights after the steps.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu import optim as joptim
from bigdl_tpu.dataset import DataSet as JDataSet
from bigdl_tpu.dataset import MiniBatch as JMiniBatch
from bigdl_tpu.dataset import SampleToMiniBatch as JSampleToMiniBatch
from bigdl_tpu.dataset import text as jtext
from bigdl_tpu.examples import text_classifier as jtc
from bigdl_tpu.examples import treelstm_sentiment as jts
from bigdl_tpu.utils import set_seed
from bigdl_tpu_torch import nn as pnn
from bigdl_tpu_torch.dataset import DataSet, MiniBatch, SampleToMiniBatch
from bigdl_tpu_torch.dataset import text as ptext
from bigdl_tpu_torch.examples import text_classifier as ptc
from bigdl_tpu_torch.examples import treelstm_sentiment as pts
from bigdl_tpu_torch.interop import flatten_jax_parameters
from bigdl_tpu_torch.optim import SGD, Optimizer, Trigger
from bigdl_tpu_torch.optim.methods import Adagrad

from test_torch_layers_9c import JTable, PTable, table
from test_torch_rnn import (OUT, assert_run, carry, gen,  # noqa: F401
                            one_torch_thread, rnd, run_both)


def _chain_tree():
    """3 leaves, 2 internal: ((l0 l1) l2), post-order slots."""
    children = np.full((5, 2), -1, np.int32)
    leaf_ids = np.full((5,), -1, np.int32)
    leaf_ids[0], leaf_ids[1] = 0, 1
    children[2] = [0, 1]
    leaf_ids[3] = 2
    children[4] = [2, 3]
    return children, leaf_ids


def _ragged():
    """Tree A fills 5 slots; tree B has 3 real nodes and 2 padding
    slots."""
    ch_a, lf_a = _chain_tree()
    ch_b = np.full((5, 2), -1, np.int32)
    lf_b = np.full((5,), -1, np.int32)
    lf_b[0], lf_b[1] = 0, 1
    ch_b[2] = [0, 1]
    return np.stack([ch_a, ch_b]), np.stack([lf_a, lf_b])


def _synthetic_batch(n_trees=4, n_nodes=15, n_tokens=8, seed=0):
    parsed = jts._synthetic_trees(n_trees, 40, n_nodes, seed)
    vocab = pts.vocabulary(parsed, 2000)
    toks, ch, leaf, _ = jts.trees_to_arrays(parsed, vocab, n_nodes, n_tokens)
    return toks, ch, leaf


TREES = [
    ("chain", lambda m, k: m.BinaryTreeLSTM(4, 6, **k),
     lambda: [rnd(2, 3, 4, seed=0), *(np.stack([a, a]) for a in
                                      _chain_tree())]),
    ("ragged", lambda m, k: m.BinaryTreeLSTM(3, 4, **k),
     lambda: [rnd(2, 3, 3, seed=8), *_ragged()]),
    ("no_output_gate", lambda m, k: m.BinaryTreeLSTM(3, 5, gate_output=False,
                                                     **k),
     lambda: [rnd(2, 3, 3, seed=9), *_ragged()]),
    ("synthetic", lambda m, k: m.BinaryTreeLSTM(5, 4, **k),
     lambda: [rnd(4, 8, 5, seed=10), *_synthetic_batch()[1:]]),
]


@pytest.mark.parametrize("name,make,inputs", TREES, ids=[c[0] for c in TREES])
def test_binary_tree_lstm_matches_reference(name, make, inputs):
    set_seed(sum(map(ord, name)))
    ref = JTable(make(jnn, {}), table)
    port = carry(ref, PTable(make(pnn, gen(1)), table))
    want, got = run_both(ref, port, inputs())
    assert_run(want, got, out=OUT, grad=OUT)
    np.testing.assert_allclose(got["dx"][0], want["dx"][0], **OUT)


def test_binary_tree_lstm_shapes_and_grad():
    """tests/test_sparse_tree_misc.py:106."""
    model = pnn.BinaryTreeLSTM(4, 6, **gen(3))
    children, leaf_ids = _chain_tree()
    x = torch.tensor(np.random.RandomState(0).randn(2, 3, 4),
                     dtype=torch.float32)
    ch = torch.tensor(np.stack([children, children]))
    lf = torch.tensor(np.stack([leaf_ids, leaf_ids]))
    out = model((x, ch, lf))
    assert tuple(out.shape) == (2, 5, 6)
    assert not torch.allclose(out[0, 4], out[0, 0])
    (out[:, 4] ** 2).sum().backward()
    assert model.comp_w.grad.abs().sum() > 0
    assert model.leaf_w.grad.abs().sum() > 0


def test_tree_lstm_repeated_calls():
    """tests/test_sparse_tree_misc.py:130 (the reference jits it)."""
    model = pnn.BinaryTreeLSTM(3, 4, **gen(4))
    children, leaf_ids = _chain_tree()
    x = torch.ones((1, 3, 3))
    with torch.no_grad():
        outs = [model((x, torch.tensor(children[None]),
                       torch.tensor(leaf_ids[None]))) for _ in range(2)]
    assert tuple(outs[0].shape) == (1, 5, 4)
    assert torch.equal(outs[0], outs[1])


def test_tree_lstm_ragged_padding_propagates_root():
    """tests/test_sparse_tree_misc.py:279: slot -1 holds each tree's
    root."""
    model = pnn.BinaryTreeLSTM(3, 4, **gen(13))
    ch, lf = _ragged()
    x = torch.tensor(np.random.RandomState(8).randn(2, 3, 3),
                     dtype=torch.float32)
    with torch.no_grad():
        out = model((x, torch.tensor(ch), torch.tensor(lf)))
    assert torch.equal(out[1, 3], out[1, 2])
    assert torch.equal(out[1, 4], out[1, 2])
    assert not torch.allclose(out[0, 4], out[0, 2])


def test_tree_lstm_reads_nothing_back_to_the_host():
    """No op of the forward or backward copies a value to the host (a
    ``.item()``, a tensor's truth value), so a CUDA graph can hold the
    loop."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Reads(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is torch.ops.aten._local_scalar_dense.default:
                self.ops.append(func)
            return func(*args, **(kwargs or {}))

    model = pnn.BinaryTreeLSTM(5, 4, **gen(5))
    toks, ch, leaf = (torch.tensor(a) for a in _synthetic_batch())
    x = torch.randn(4, 8, 5, requires_grad=True)
    with Reads() as reads:
        model((x, ch, leaf))[:, -1].sum().backward()
    assert reads.ops == []


def test_tree_lstm_protocol_needs_compose():
    with pytest.raises(NotImplementedError):
        pnn.TreeLSTM(3, 4)((torch.ones(1, 3, 3),
                            *(torch.tensor(a[None]) for a in _chain_tree())))


# ---- the examples' data ----------------------------------------------------------

SST = ["(3 (2 It) (4 (2 's) (4 good)))",
       "(1 (2 (2 A) (1 dull)) (2 film))",
       "  (4 (4 Great) (2 fun))  "]


def test_parse_sexpr_and_trees_to_arrays_equal_the_reference():
    for line in SST:
        assert pts.parse_sexpr(line) == jts.parse_sexpr(line)
    parsed = [pts.parse_sexpr(ln) for ln in SST]
    vocab = pts.vocabulary(parsed, 2000)
    for n_nodes, n_tokens in ((8, 4), (5, 3)):
        got = pts.trees_to_arrays(parsed, vocab, n_nodes, n_tokens)
        want = jts.trees_to_arrays(parsed, vocab, n_nodes, n_tokens)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="expected"):
        pts.parse_sexpr("(3 (2 a) (2 b)")


def test_synthetic_trees_equal_the_reference():
    got = pts._synthetic_trees(40, 2000, 128, seed=0)
    assert got == jts._synthetic_trees(40, 2000, 128, seed=0)
    vocab = pts.vocabulary(got, 2000)
    for g, w in zip(pts.trees_to_arrays(got, vocab, 128, 64),
                    jts.trees_to_arrays(got, vocab, 128, 64)):
        np.testing.assert_array_equal(g, w)


def test_synthetic_corpus_equals_the_reference():
    got, n = ptc.synthetic_corpus(50, 20, vocab=300, seed=3)
    want, m = jtc.synthetic_corpus(50, 20, vocab=300, seed=3)
    assert n == m and len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.feature, w.feature)
        assert g.label == w.label


def test_load_folder_equals_the_reference(tmp_path):
    docs = {"sport": ["The match was won, 3-1!", "A great goal."],
            "tech": ["New chips ship today.", "The chip is fast; fast."]}
    for cls, texts in docs.items():
        (tmp_path / cls).mkdir()
        for i, t in enumerate(texts):
            (tmp_path / cls / f"{i}.txt").write_text(t)
    got, n, d = ptc.load_folder(str(tmp_path), 6, 8)
    want, m, e = jtc.load_folder(str(tmp_path), 6, 8)
    assert n == m == 2 and d.word2idx == e.word2idx
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.feature, w.feature)
        assert g.label == w.label


SENTENCES = ["The cat sat on the mat.", "the dog, the cat!",
             "A mat? No: a rug.", "x"]


def test_text_pipeline_equals_the_reference():
    got = list(ptext.Tokenizer()(iter(SENTENCES)))
    assert got == list(jtext.Tokenizer()(iter(SENTENCES)))
    for size in (None, 4):
        d, e = ptext.Dictionary(got, size), jtext.Dictionary(got, size)
        assert d.word2idx == e.word2idx and d.idx2word == e.idx2word
        assert d.vocab_size() == e.vocab_size()
        assert d.indices(["the", "zebra"]) == e.indices(["the", "zebra"])
        mine = list(ptext.TextToLabeledSentence(d)(iter(got)))
        theirs = list(jtext.TextToLabeledSentence(e)(iter(got)))
        assert len(mine) == len(theirs) == 3
        for a, b in zip(mine, theirs):
            np.testing.assert_array_equal(a.feature, b.feature)
            np.testing.assert_array_equal(a.label, b.label)
    ids = ptext.synthetic_ptb(500, vocab=30, seed=2)
    np.testing.assert_array_equal(ids, jtext.synthetic_ptb(500, vocab=30,
                                                           seed=2))
    for g, w in zip(ptext.ptb_batches(ids, 4, 5),
                    jtext.ptb_batches(ids, 4, 5)):
        np.testing.assert_array_equal(g[0], w[0])
        np.testing.assert_array_equal(g[1], w[1])


def test_ptb_corpus_reader(tmp_path):
    for split in ("train", "valid", "test"):
        (tmp_path / f"ptb.{split}.txt").write_text("a b c\nb c d\n")
    got = ptext.load_ptb_corpus(str(tmp_path), vocab_size=4)
    want = jtext.load_ptb_corpus(str(tmp_path), vocab_size=4)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(FileNotFoundError):
        ptext.load_ptb_corpus(str(tmp_path / "none"))


# ---- two optimizer steps of each example in both packages --------------------------

def _held_after_steps(ref, port, ref_opt, port_opt, first):
    """Both runs' final losses and weights, and the first step's loss
    (``first``: each package's loss on its first batch before training),
    within float32 tolerance."""
    ref_first, port_first = first
    np.testing.assert_allclose(port_first, ref_first, **OUT)
    ref_opt.optimize()
    port_opt.optimize()
    assert port_opt.state["neval"] == ref_opt.state["neval"] == 3
    np.testing.assert_allclose(port_opt.loss_history[0][1], ref_first, **OUT)
    np.testing.assert_allclose(port_opt.state["loss"],
                               float(ref_opt.state["loss"]), **OUT)
    want = flatten_jax_parameters(jax.tree_util.tree_map(
        np.asarray, ref.parameters()))
    for n, p in port.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n], **OUT,
                                   err_msg=n)


def test_text_classifier_two_steps_match_the_reference():
    set_seed(5)
    vocab, seq, classes = 60, 24, 4
    ref = jtc.build_model(vocab + 1, classes, seq, embed_dim=8, filters=6)
    port = carry(ref, ptc.build_model(vocab + 1, classes, seq, embed_dim=8,
                                      filters=6, **gen(5)))
    samples, _ = ptc.synthetic_corpus(16, seq, vocab=vocab, seed=1)
    jsamples, _ = jtc.synthetic_corpus(16, seq, vocab=vocab, seed=1)
    x = np.stack([s.feature for s in samples[:8]])
    y = np.asarray([s.label for s in samples[:8]])
    first = (float(jnn.ClassNLLCriterion()(ref.eval_mode()(jnp.asarray(x)),
                                           jnp.asarray(y))),
             float(pnn.ClassNLLCriterion()(
                 port.eval()(torch.tensor(x)), torch.tensor(y)).detach()))
    ref_opt = joptim.Optimizer(
        ref, JDataSet.array(jsamples, shuffle=False)
        .transform(JSampleToMiniBatch(8)), jnn.ClassNLLCriterion()) \
        .set_optim_method(joptim.SGD(0.05)) \
        .set_end_when(joptim.Trigger.max_iteration(2))
    port_opt = Optimizer(
        port, DataSet.array(samples, shuffle=False)
        .transform(SampleToMiniBatch(8)), pnn.ClassNLLCriterion()) \
        .set_optim_method(SGD(0.05)) \
        .set_end_when(Trigger.max_iteration(2))
    _held_after_steps(ref, port, ref_opt, port_opt, first)


def test_treelstm_two_steps_match_the_reference():
    set_seed(6)
    parsed = pts._synthetic_trees(16, 40, 15, seed=0)
    vocab = pts.vocabulary(parsed, 40)
    toks, ch, leaf, y = pts.trees_to_arrays(parsed, vocab, 15, 8)
    ref = jts.build_model(len(vocab), 6, 5, 5)
    port = carry(ref, pts.build_model(len(vocab), 6, 5, 5, **gen(6)))
    parts = [(toks[s], ch[s], leaf[s], y[s])
             for s in (slice(0, 8), slice(8, 16))]
    x0 = parts[0][:3]
    first = (float(jnn.ClassNLLCriterion()(
        ref.eval_mode()(tuple(jnp.asarray(a) for a in x0)),
        jnp.asarray(parts[0][3]))),
        float(pnn.ClassNLLCriterion()(
            port.eval()(tuple(torch.tensor(a) for a in x0)),
            torch.tensor(parts[0][3])).detach()))
    ref_opt = joptim.Optimizer(
        ref, JDataSet.array([JMiniBatch(p[:3], p[3]) for p in parts],
                            shuffle=False), jnn.ClassNLLCriterion()) \
        .set_optim_method(joptim.Adagrad(0.05)) \
        .set_end_when(joptim.Trigger.max_iteration(2))
    port_opt = Optimizer(
        port, DataSet.array([MiniBatch(p[:3], p[3]) for p in parts],
                            shuffle=False), pnn.ClassNLLCriterion()) \
        .set_optim_method(Adagrad(0.05)) \
        .set_end_when(Trigger.max_iteration(2))
    _held_after_steps(ref, port, ref_opt, port_opt, first)


# ---- the example mains on the CPU ---------------------------------------------------

def test_text_classifier_main_learns(capsys):
    model = ptc.main(["--synthetic", "320", "-e", "3", "--seq-len", "30",
                      "--vocab-size", "200", "--embed-dim", "16",
                      "--device", "cpu", "-q"])
    assert isinstance(model, pnn.Sequential)
    score = float(capsys.readouterr().out.split(":")[-1])
    assert score > 0.5


def test_treelstm_main_learns():
    args = pts.parse_args(["--synthetic", "96", "-e", "4", "-b", "16",
                           "--max-nodes", "15", "--max-tokens", "8",
                           "--vocab-size", "40", "--embedding-dim", "8",
                           "--hidden-size", "8", "--device", "cpu", "-q"])
    _, opt = pts.train(args)
    losses = [v for _, v in opt.loss_history]
    assert len(losses) == 24 and np.isfinite(losses).all()
    assert np.mean(losses[-6:]) < np.mean(losses[:6])


def test_treelstm_main_reads_sst_files(tmp_path):
    (tmp_path / "train.txt").write_text("\n".join(SST * 4) + "\n")
    (tmp_path / "dev.txt").write_text("\n".join(SST) + "\n")
    args = pts.parse_args(["-f", str(tmp_path), "-e", "1", "-b", "4",
                           "--max-nodes", "8", "--max-tokens", "4",
                           "--device", "cpu", "-q"])
    _, opt = pts.train(args)
    assert opt.state["neval"] == 4 and opt.validation_history


def test_examples_refuse_what_is_not_there():
    with pytest.raises(SystemExit):
        pts.parse_args(["--synthetic", "8", "--max-nodes", "5"])
    with pytest.raises(SystemExit):
        ptc.main(["--device", "cpu"])
