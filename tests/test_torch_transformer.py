"""The port's encoder-decoder ``Transformer``, ``SequenceBeamSearch`` and
``TransformerLM.generate_beam`` against the JAX package's, on the CPU,
with the JAX models' parameters carried across by ``load_jax_parameters``
and inputs made with numpy from seeds.

The reference's attention runs its own dispatch on the CPU (the XLA
path; its Pallas kernel runs on the CPU only in interpret mode), the
port's its plain version.  Tolerances: logits within atol 1e-5 (float32
sums in another order through two layers, logits near 1), beam scores
within 1e-5, token sequences equal.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import bigdl_tpu.nn as jnn
from bigdl_tpu.models import transformer_lm as jax_transformer_lm
from bigdl_tpu.utils import set_seed
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.interop import load_jax_parameters
from bigdl_tpu_torch.models import transformer_lm
from bigdl_tpu_torch.nn import attention as tattention
from bigdl_tpu_torch.ops import attention_kernels as ak

ATOL = 1e-5
SCORE_ATOL = 1e-5
VOCAB, HIDDEN, HEADS, FILTER, LAYERS = 50, 32, 2, 64, 2
CFG = dict(vocab_size=VOCAB, hidden_size=HIDDEN, num_heads=HEADS,
           filter_size=FILTER, num_hidden_layers=LAYERS,
           with_share_weights_linear=True)
LM_CFG = dict(vocab_size=VOCAB, hidden_size=HIDDEN, num_layers=LAYERS,
              num_heads=HEADS, filter_size=FILTER, max_len=32)


def _params(ref):
    return jax.tree_util.tree_map(np.asarray, ref.parameters())


def _pair(transformer_type):
    set_seed(0)
    ref = jnn.Transformer(**CFG, transformer_type=transformer_type)
    ref = ref.eval_mode()
    port = tnn.Transformer(**CFG, transformer_type=transformer_type,
                           generator=torch.Generator().manual_seed(1),
                           device="cpu").eval()
    return ref, load_jax_parameters(port, _params(ref))


@pytest.fixture(scope="module")
def lm_pair():
    return _pair("lm")


@pytest.fixture(scope="module")
def translation_pair():
    return _pair("translation")


@pytest.fixture(scope="module")
def lm_models():
    set_seed(0)
    ref = jax_transformer_lm(**LM_CFG).eval_mode()
    port = transformer_lm(**LM_CFG, generator=torch.Generator().manual_seed(1),
                          device="cpu").eval()
    return ref, load_jax_parameters(port, _params(ref))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _sources(seed, shape=(3, 12)):
    """Token ids 1..VOCAB with two rows 0-padded at the end."""
    src = np.random.default_rng(seed).integers(1, VOCAB + 1, shape)
    src[1, 8:] = 0
    src[2, 3:] = 0
    return src.astype(np.int32)


def _targets(seed, shape=(3, 10)):
    return np.random.default_rng(seed).integers(
        1, VOCAB + 1, shape).astype(np.int32)


def test_shift_right_3d_matches():
    x = np.random.default_rng(0).standard_normal((2, 5, 3)).astype(
        np.float32)
    np.testing.assert_array_equal(
        _np(tnn.shift_right_3d(torch.from_numpy(x))),
        np.asarray(jnn.shift_right_3d(jnp.asarray(x))))


@pytest.mark.parametrize("transformer_type", ["lm", "translation"])
def test_forward_matches_with_padded_sources(transformer_type, lm_pair,
                                             translation_pair):
    ref, port = lm_pair if transformer_type == "lm" else translation_pair
    src, tgt = _sources(1), _targets(2)
    tgt[0, 7:] = 0
    inputs = (tgt,) if transformer_type == "lm" else (src, tgt)
    want = np.asarray(ref(*map(jnp.asarray, inputs)))
    with torch.no_grad():
        got = _np(port(*inputs))
    assert got.shape == (3, 10, VOCAB)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    if transformer_type == "translation":
        enc_w, bias_w = ref.encode(jnp.asarray(src))
        with torch.no_grad():
            enc_g, bias_g = port.encode(src)
        np.testing.assert_allclose(_np(enc_g), np.asarray(enc_w), atol=ATOL,
                                   rtol=0)
        np.testing.assert_array_equal(_np(bias_g), np.asarray(bias_w))


@pytest.mark.parametrize("transformer_type", ["lm", "translation"])
def test_decode_step_matches_reference_step_by_step(transformer_type,
                                                    lm_pair,
                                                    translation_pair):
    """decode_step against the reference's, step by step (the cross
    cache in translation), and against the port's own full decode()."""
    ref, port = lm_pair if transformer_type == "lm" else translation_pair
    src, tgt = _sources(3), _targets(4, (3, 7))
    enc = (None, None)
    enc_w = (None, None)
    if transformer_type == "translation":
        enc_w = ref.encode(jnp.asarray(src))
        with torch.no_grad():
            enc = port.encode(src)
    cache_w = ref.init_decode_cache(3, 8, enc_out=enc_w[0])
    cache_g = port.init_decode_cache(3, 8, enc_out=enc[0])
    if transformer_type == "translation":
        for g, w in zip(cache_g, cache_w):
            for name in ("k", "v"):
                np.testing.assert_allclose(_np(g["cross"][name]),
                                           np.asarray(w["cross"][name]),
                                           atol=ATOL, rtol=0)
    with torch.no_grad():
        full = _np(port.decode(tgt, *enc))
    shifted = np.concatenate([np.zeros((3, 1), np.int32), tgt[:, :-1]], 1)
    for i in range(7):
        want, cache_w = ref.decode_step(jnp.asarray(shifted[:, i:i + 1]), i,
                                        cache_w, *enc_w)
        got, cache_g = port.decode_step(shifted[:, i:i + 1], i, cache_g,
                                        *enc)
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL,
                                   rtol=0, err_msg=f"step {i}")
        np.testing.assert_allclose(_np(got), full[:, i], atol=ATOL, rtol=0,
                                   err_msg=f"step {i} against decode()")
    for g, w in zip(cache_g, cache_w):
        for name in ("k", "v"):
            np.testing.assert_allclose(_np(g["self"][name]),
                                       np.asarray(w["self"][name]),
                                       atol=ATOL, rtol=0)


def test_cross_cache_runs_no_kv_projection(translation_pair):
    """With the cross cache, a decode step projects the encoder output
    neither for K nor for V: k_layer runs once a layer for the step's
    own self-attention K, never on the [B, Ts, H] encoder output."""
    _, port = translation_pair
    src = _sources(5)
    with torch.no_grad():
        enc_out, enc_bias = port.encode(src)
    cache = port.init_decode_cache(3, 8, enc_out=enc_out)
    rows = []
    hooks = [layer.k_layer.register_forward_hook(
        lambda _m, args, _out: rows.append(tuple(args[0].shape)))
        for blk in port.decoder_layers
        for layer in (blk.self_attn, blk.cross_attn)]
    try:
        port.decode_step(np.zeros((3, 1), np.int32), 0, cache, enc_out,
                         enc_bias)
    finally:
        for h in hooks:
            h.remove()
    assert rows == [(3, 1, HIDDEN)] * LAYERS


def _toy_logits_jax(vocab, eos):
    def fn(ids, step, cache):
        prefs = jnp.where(step == 0, 2, jnp.where(step == 1, 3, eos))
        logits = jnp.full((ids.shape[0], vocab), -5.0)
        return logits.at[:, prefs].set(5.0), cache
    return fn


def _toy_logits_torch(vocab, eos):
    def fn(ids, step, cache):
        prefs = 2 if step == 0 else (3 if step == 1 else eos)
        logits = torch.full((ids.shape[0], vocab), -5.0)
        logits[:, prefs] = 5.0
        return logits, cache
    return fn


def test_beam_search_toy():
    """tests/test_attention.py::test_beam_search_toy restated, and held
    against the reference's search: sequences equal, scores within 1e-5."""
    vocab, beam, tmax, eos = 8, 3, 5, 1
    ref = jnn.SequenceBeamSearch(vocab, beam, alpha=0.6,
                                 max_decode_length=tmax, eos_id=eos)
    ref.set_logit_fn(_toy_logits_jax(vocab, eos))
    want_seq, want_scores = ref.search(2, {"dummy": jnp.zeros((2, 1))})
    bs = tnn.SequenceBeamSearch(vocab, beam, alpha=0.6,
                                max_decode_length=tmax, eos_id=eos,
                                device="cpu")
    bs.set_logit_fn(_toy_logits_torch(vocab, eos))
    seq, scores = bs.search(2, {"dummy": torch.zeros((2, 1))})
    assert seq.shape == (2, beam, tmax)
    np.testing.assert_array_equal(_np(seq[0, 0, :3]), [2, 3, eos])
    assert float(scores[0, 0]) > float(scores[0, 1]) - 1e-6
    np.testing.assert_array_equal(_np(seq), np.asarray(want_seq))
    np.testing.assert_allclose(_np(scores), np.asarray(want_scores),
                               atol=SCORE_ATOL, rtol=0)


def test_beam_search_tie_order_matches_reference():
    """An output that depends on the order of equal values: one beam
    finishes at step 0, so the returned pool holds it and beam - 1
    unflagged slots whose scores all tie at -1e9 (the initial pool and
    the masked candidates), and the alive set is chosen among tied
    log-probs.  A top-k without the lower index first among ties returns
    other sequences."""
    vocab, beam, tmax, eos = 6, 3, 4, 2

    def scores_of(step, ids):
        # the id fed decides the row's logits: ties everywhere but EOS
        base = np.zeros((ids.shape[0], vocab), np.float32)
        base[:, eos] = 4.0 if step == 0 else -3.0
        base[:, 0] = np.where(ids[:, 0] == 3, 1.0, 0.0)
        return base

    def jfn(ids, step, cache):
        logits = jax.pure_callback(
            lambda s, i: scores_of(int(s), np.asarray(i)),
            jax.ShapeDtypeStruct((ids.shape[0], vocab), jnp.float32),
            step, ids)
        return logits + cache["row"][:, :1] * 0.0, cache

    def tfn(ids, step, cache):
        logits = torch.from_numpy(scores_of(step, _np(ids)))
        return logits + cache["row"][:, :1] * 0.0, cache

    rows = np.arange(2, dtype=np.float32)[:, None]
    ref = jnn.SequenceBeamSearch(vocab, beam, 0.6, tmax, eos)
    ref.set_logit_fn(jfn)
    want_seq, want_scores = ref.search(2, {"row": jnp.asarray(rows)})
    bs = tnn.SequenceBeamSearch(vocab, beam, 0.6, tmax, eos, device="cpu")
    bs.set_logit_fn(tfn)
    seq, scores = bs.search(2, {"row": torch.from_numpy(rows)})
    want_scores = np.asarray(want_scores)
    assert (want_scores == -1e9).sum() >= 2 * (beam - 1)  # the tied slots
    np.testing.assert_array_equal(_np(seq), np.asarray(want_seq))
    np.testing.assert_allclose(_np(scores), want_scores, atol=SCORE_ATOL,
                               rtol=0)
    # a top-k that breaks ties the other way returns other slots
    saved = tattention._top_k
    tattention._top_k = lambda x, k: tuple(
        t.flip(-1) for t in saved(x.flip(-1), k))
    try:
        flipped, _ = bs.search(2, {"row": torch.from_numpy(rows)})
    finally:
        tattention._top_k = saved
    assert not np.array_equal(_np(flipped), np.asarray(want_seq))


def _lm_prompts(seed, shape=(2, 5)):
    return np.random.default_rng(seed).integers(
        1, VOCAB + 1, shape).astype(np.int32)


@pytest.mark.parametrize("eos", [False, True])
def test_generate_beam_matches_reference(lm_models, eos):
    """generate_beam with and without an EOS (the first token a greedy
    decode of row 0 emits, as tests/test_transformer_lm.py picks it):
    sequences equal, scores within 1e-5, positions after EOS 0."""
    ref, port = lm_models
    prompt = _lm_prompts(7)
    prompt[1, :2] = 0                      # a left-padded row
    eos_id = -1
    if eos:
        eos_id = int(_np(port.generate(prompt, 1))[0, -1])
    want_seq, want_scores = ref.generate_beam(
        jnp.asarray(prompt), beam_size=3, max_new_tokens=6, eos_id=eos_id)
    seq, scores = port.generate_beam(prompt, beam_size=3, max_new_tokens=6,
                                     eos_id=eos_id)
    assert seq.shape == (2, 3, 6) and seq.dtype == torch.int64
    np.testing.assert_array_equal(_np(seq), np.asarray(want_seq))
    np.testing.assert_allclose(_np(scores), np.asarray(want_scores),
                               atol=SCORE_ATOL, rtol=0)
    if eos:
        assert (_np(seq) == eos_id).any()


def test_beam_size_one_matches_greedy(lm_models):
    _, port = lm_models
    prompt = _lm_prompts(8, (2, 4))
    greedy = _np(port.generate(prompt, 5))[:, 4:]
    seqs, scores = port.generate_beam(prompt, beam_size=1, max_new_tokens=5)
    np.testing.assert_array_equal(_np(seqs)[:, 0, :], greedy)
    assert np.isfinite(_np(scores)).all()


def test_load_jax_parameters_carries_a_translation_model(translation_pair):
    """Every name of the reference's translation Transformer (embedding,
    encoder_layers[i], decoder_layers[i].cross_attn, the norms) loads,
    and a missing, extra or misshapen one is refused."""
    set_seed(0)
    ref = jnn.Transformer(**CFG, transformer_type="translation")
    params = _params(ref)
    _, port = translation_pair
    names = dict(port.named_parameters())
    assert "embedding" in names and "encoder_norm.weight" in names
    assert "decoder_layers.1.cross_attn.v_layer.weight" in names
    load_jax_parameters(port, params)
    missing = dict(params)
    del missing["encoder_norm"]
    with pytest.raises(KeyError, match="missing"):
        load_jax_parameters(port, missing)
    with pytest.raises(KeyError, match="extra"):
        load_jax_parameters(port, dict(params, head=np.zeros(2, np.float32)))
    with pytest.raises(ValueError, match="shape"):
        load_jax_parameters(port, dict(params, embedding=np.zeros(
            (VOCAB + 1, HIDDEN), np.float32)))


def test_the_forward_kernel_takes_only_f32_q_with_bf16_kv():
    """The route of #1 for each dtype mix: f32 q with bf16 k and v is the
    mixed entry; every other mix is refused, loudly."""
    f32, bf16 = torch.float32, torch.bfloat16
    assert ak.fwd_route(f32, True, bf16) == "mixed_kv"
    assert ak.fwd_route(f32, False, bf16) == "mixed_kv"
    assert ak.fwd_route(bf16, True, bf16) == "tensor_core"
    assert ak.fwd_route(f32, True, f32) == "scalar"
    for q, kv in ((bf16, f32), (f32, torch.float16), (torch.float16, f32)):
        with pytest.raises(TypeError):
            ak.fwd_route(q, True, kv)
    assert set(ak.flash_attention_fwd.routes) == {"tensor_core", "scalar",
                                                 "mixed_kv"}
