"""The port's TransformerLM (bigdl_tpu_torch.models) against the JAX
package's, with the JAX model's weights carried across by
``load_jax_parameters``: forward logits (padded, and with
``padded_inputs=False``), the K/V of ``prefill_kv``, the caches of
``prefill_chunk`` (per-row and pooled), ``decode_step`` logits under
teacher forcing, and the tokens of ``generate``.

Tolerance: atol 1e-4 on logits and K/V (float32 sums taken in another
order, through a few layers); token rows must be equal.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from bigdl_tpu.models import transformer_lm as jax_transformer_lm
from bigdl_tpu.utils import set_seed
from bigdl_tpu_torch.interop import load_jax_parameters
from bigdl_tpu_torch.models import TransformerLM, transformer_lm

ATOL = 1e-4
VOCAB, HIDDEN, LAYERS, HEADS, FILTER, MAX_LEN = 128, 64, 2, 4, 128, 128
CFG = dict(vocab_size=VOCAB, hidden_size=HIDDEN, num_layers=LAYERS,
           num_heads=HEADS, filter_size=FILTER, max_len=MAX_LEN)


def _pair(padded_inputs=True):
    set_seed(0)
    ref = jax_transformer_lm(**CFG, padded_inputs=padded_inputs).eval_mode()
    params = jax.tree_util.tree_map(np.asarray, ref.parameters())
    port = transformer_lm(**CFG, padded_inputs=padded_inputs,
                          generator=torch.Generator().manual_seed(1),
                          device="cpu").eval()
    return ref, load_jax_parameters(port, params), params


@pytest.fixture(scope="module")
def models():
    ref, port, _ = _pair()
    return ref, port


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _tokens(seed, shape, pad_from=None):
    toks = np.random.default_rng(seed).integers(1, VOCAB + 1, shape)
    if pad_from is not None:
        toks[-1, pad_from:] = 0
    return toks.astype(np.int32)


def test_forward_logits_padded(models):
    ref, port = models
    toks = _tokens(0, (3, 40), pad_from=29)
    want = np.asarray(ref.forward(jnp.asarray(toks)))
    with torch.no_grad():
        got = _np(port(toks))
    assert got.shape == (3, 40, VOCAB + 1)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_forward_logits_unpadded_causal_in_kernel():
    ref, port, _ = _pair(padded_inputs=False)
    toks = _tokens(1, (2, 33))
    want = np.asarray(ref.forward(jnp.asarray(toks)))
    with torch.no_grad():
        got = _np(port(toks))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    toks[0, -1] = 0
    with pytest.raises(ValueError, match="padded"):
        port(toks)


def test_prefill_kv_matches(models):
    ref, port = models
    toks = _tokens(2, (3, 19), pad_from=11)
    want_layers, want_pad = ref.prefill_kv(jnp.asarray(toks))
    got_layers, got_pad = port.prefill_kv(toks)
    np.testing.assert_array_equal(_np(got_pad), np.asarray(want_pad))
    for g, w in zip(got_layers, want_layers):
        for name in ("k", "v"):
            assert g[name].shape == (3, HEADS, 19, HIDDEN // HEADS)
            np.testing.assert_allclose(_np(g[name]), np.asarray(w[name]),
                                       atol=ATOL, rtol=0)


def _assert_caches_close(got, want):
    np.testing.assert_array_equal(_np(got["pad"]), np.asarray(want["pad"]))
    for g, w in zip(got["layers"], want["layers"]):
        for name in ("k", "v"):
            np.testing.assert_allclose(_np(g["self"][name]),
                                       np.asarray(w["self"][name]),
                                       atol=ATOL, rtol=0)


def test_prefill_chunk_per_row(models):
    ref, port = models
    toks = _tokens(3, (2, 24), pad_from=20)
    want = ref.init_cache(2)
    got = port.init_cache(2)
    for lo in (0, 8, 16):
        want = ref.prefill_chunk(jnp.asarray(toks[:, lo:lo + 8]), lo, want)
        got = port.prefill_chunk(toks[:, lo:lo + 8], lo, got)
    _assert_caches_close(got, want)


def test_prefill_chunk_pooled_writes_only_its_slot(models):
    ref, port = models
    toks = _tokens(4, (1, 20))
    want = ref.init_cache(3)
    got = port.init_cache(3)
    for lo, w in ((0, 16), (16, 4)):
        want = ref.prefill_chunk(jnp.asarray(toks[:, lo:lo + w]), lo, want,
                                 slot=jnp.int32(1))
        got = port.prefill_chunk(toks[:, lo:lo + w], lo, got, slot=1)
    _assert_caches_close(got, want)
    for layer in got["layers"]:
        assert not layer["self"]["k"][[0, 2]].any()


def test_decode_step_teacher_forced(models):
    """Prefill 6 tokens, then feed the rest one step at a time; the
    per-row position tensor (the slot pool's batched decode) gives the
    same logits as the reference's scalar index."""
    ref, port = models
    toks = _tokens(5, (2, 11))
    want_c = ref._prefill(jnp.asarray(toks[:, :7]), ref.init_cache(2))
    got_c = port._prefill(port._tokens(toks[:, :7]), port.init_cache(2))
    for t in range(6, 10):
        want, want_c = ref.decode_step(jnp.asarray(toks[:, t:t + 1]), t,
                                       want_c)
        index = torch.full((2,), t) if t % 2 else t
        got, got_c = port.decode_step(toks[:, t:t + 1], index, got_c)
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL,
                                   rtol=0, err_msg=f"step {t}")
    _assert_caches_close(got_c, want_c)


@pytest.mark.parametrize("eos", [False, True])
def test_generate_tokens_match(models, eos):
    ref, port = models
    prompt = _tokens(6, (2, 9))
    eos_id = None
    if eos:
        first = np.asarray(ref.generate(jnp.asarray(prompt), 4))
        eos_id = int(first[0, 11])          # row 0's third new token
    want = np.asarray(ref.generate(jnp.asarray(prompt), 10, eos_id=eos_id))
    got = _np(port.generate(prompt, 10, eos_id=eos_id))
    np.testing.assert_array_equal(got, want)
    if eos:
        stop = 9 + int(np.flatnonzero(got[0, 9:] == eos_id)[0])
        assert stop <= 11 and not got[0, stop + 1:].any()


def test_mask_untrained_logit_and_factory():
    logits = torch.zeros((2, 5))
    masked = TransformerLM._mask_untrained_logit(logits)
    assert masked[:, -1].eq(-1e9).all() and not logits.any()
    lm = transformer_lm(**CFG, generator=torch.Generator().manual_seed(0),
                        device="cpu")
    assert isinstance(lm, TransformerLM) and lm.max_len == MAX_LEN
    # the reference's init distributions: N(0, 1/H) embedding
    std = float(lm.embedding.weight.detach().std())
    assert abs(std - HIDDEN ** -0.5) < 0.02


def test_load_jax_parameters_refuses_missing_and_extra_keys():
    _, port, params = _pair()
    missing = dict(params)
    del missing["final_norm"]
    with pytest.raises(KeyError, match="missing"):
        load_jax_parameters(port, missing)
    extra = dict(params, head={"weight": np.zeros((2, 2), np.float32)})
    with pytest.raises(KeyError, match="extra"):
        load_jax_parameters(port, extra)
    wrong = dict(params, final_norm={"weight": np.zeros(3, np.float32),
                                     "bias": np.zeros(HIDDEN, np.float32)})
    with pytest.raises(ValueError, match="shape"):
        load_jax_parameters(port, wrong)
