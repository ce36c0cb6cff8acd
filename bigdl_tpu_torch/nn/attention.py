"""Multi-head attention, the Transformer stack and beam search
(counterpart of ``bigdl_tpu/nn/attention.py``: ``position_encoding``, the
bias helpers, ``shift_right_3d``, ``Attention`` with its self- and
cross-attention decode caches, ``FeedForwardNetwork``, the pre-norm
``TransformerEncoderLayer`` and ``TransformerDecoderLayer``, the
``Transformer`` in its "lm" and "translation" topologies, and
``SequenceBeamSearch``).

Attention goes through :func:`bigdl_tpu_torch.ops.dot_product_attention`,
which launches the CUDA flash kernel for every call on a CUDA tensor.
Decode uses a fixed-size KV cache written IN PLACE: where the reference
returns an updated copy (and donates the old one under jit), the port
writes the cache tensors it was given and returns the same dict.  The
beam search gathers a fresh copy of each leaf's rows every step, as the
reference gathers new arrays, and hands that copy to the next step.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from bigdl_tpu_torch.core.device import resolve_device
from bigdl_tpu_torch.core.module import dropout
from bigdl_tpu_torch.nn.linear import Linear
from bigdl_tpu_torch.nn.normalization import LayerNormalization
from bigdl_tpu_torch.ops.attention_kernels import NEG_INF, \
    dot_product_attention

__all__ = [
    "Attention", "FeedForwardNetwork", "TransformerEncoderLayer",
    "TransformerDecoderLayer", "Transformer", "SequenceBeamSearch",
    "position_encoding", "padding_bias", "causal_bias",
    "incremental_bias", "chunk_incremental_bias", "shift_right_3d",
]


def position_encoding(length: int, hidden_size: int,
                      min_timescale: float = 1.0,
                      max_timescale: float = 1.0e4,
                      dtype=torch.float32, device=None):
    """Sinusoidal position encoding [length, hidden_size]."""
    position = torch.arange(length, dtype=torch.float32, device=device)
    num_timescales = hidden_size // 2
    log_inc = math.log(max_timescale / min_timescale) / max(
        num_timescales - 1, 1)
    inv_timescales = min_timescale * torch.exp(
        torch.arange(num_timescales, dtype=torch.float32, device=device)
        * -log_inc)
    scaled = position[:, None] * inv_timescales[None, :]
    signal = torch.cat([torch.sin(scaled), torch.cos(scaled)], dim=1)
    if signal.shape[1] < hidden_size:  # odd hidden size
        signal = F.pad(signal, (0, hidden_size - signal.shape[1]))
    return signal.to(dtype)


def _mask_to_bias(invalid, dtype):
    return torch.where(invalid, NEG_INF, 0.0).to(dtype)


def padding_bias(tokens, padding_value: float = 0.0):
    """[B, 1, 1, T] additive bias: -1e9 at padding positions."""
    pad = (tokens == padding_value).to(torch.float32) * NEG_INF
    return pad[:, None, None, :]


def causal_bias(length: int, dtype=torch.float32, device=None):
    """[1, 1, T, T] lower-triangle attention bias."""
    mask = torch.ones((length, length), dtype=torch.bool,
                      device=device).tril()
    return _mask_to_bias(~mask, dtype)[None, None]


def incremental_bias(max_len: int, index, pad=None, dtype=torch.float32,
                     device=None):
    """Additive bias over a fixed-size KV cache for one decode step at
    position ``index``: slots beyond ``index`` are masked, and so are
    padding slots when ``pad`` ([B, max_len] bool) is given.

    ``index`` is an int, or an int tensor [B] of per-row positions (the
    slot pool's batched decode, which the reference writes as a vmap
    over rows).  Returns [1,1,1,max_len] (int index, no pad) or
    [B,1,1,max_len]."""
    if pad is not None:
        device = pad.device
    keys = torch.arange(max_len, device=device)
    if isinstance(index, torch.Tensor):
        invalid = keys[None, :] > index[:, None]
    else:
        invalid = (keys > index)[None, :]
    if pad is not None:
        invalid = invalid | pad
    return _mask_to_bias(invalid, dtype)[:, None, None, :]


def chunk_incremental_bias(max_len: int, index: int, width: int, pad,
                           dtype=torch.float32):
    """Additive bias for a ``width``-token chunk written at positions
    ``[index, index+width)`` of a fixed-size KV cache: query ``i`` may
    attend cache slots ``j <= index+i`` that are not padding (``pad``:
    [B, max_len] bool, including the chunk's own fresh flags).  Returns
    [B, 1, width, max_len]."""
    dev = pad.device
    qpos = index + torch.arange(width, device=dev)[:, None]
    invalid = torch.arange(max_len, device=dev)[None, :] > qpos
    invalid = invalid[None, :, :] | pad[:, None, :]
    return _mask_to_bias(invalid, dtype)[:, None, :, :]


def shift_right_3d(x):
    """Shift the time axis of ``x`` [B, T, H] right by one, zero-filling
    position 0 (the decoder's input shift)."""
    return F.pad(x, (0, 0, 1, 0))[:, :-1, :]


def _write_cache(buf, new, index):
    """Write ``new`` [B, h, T, d] into the cache ``buf`` [B, h, max_len, d]
    in place at ``index`` (int: positions [index, index+T); tensor [B]:
    one position per row, T == 1)."""
    if isinstance(index, torch.Tensor):
        rows = torch.arange(buf.shape[0], device=buf.device)
        buf[rows, :, index] = new[:, :, 0].to(buf.dtype)
    else:
        buf[:, :, index:index + new.shape[2]] = new.to(buf.dtype)


class Attention(nn.Module):
    """Multi-head self/cross attention.

    ``forward(x, y=None, bias=None, cache=None, cache_index=None,
    causal=False)``: x is [B, Tq, H]; y (default x) the key/value source;
    bias broadcastable to [B, h, Tq, Tk].  With a ``cache`` ({"k", "v"}:
    [B, h, Tmax, d]) ``(output, cache)`` is returned: in self-attention
    the step's K/V are written into it in place at ``cache_index``; in
    cross-attention (``y`` given) it holds the projected encoder K/V,
    which are attended as they are (``y`` is not projected again)."""

    def __init__(self, hidden_size: int, num_heads: int,
                 attention_dropout: float = 0.0, *,
                 generator: torch.Generator, device=None):
        super().__init__()
        if hidden_size % num_heads:
            raise ValueError("hidden_size must be divisible by num_heads")
        dev = resolve_device(device)
        self.hidden_size = hidden_size
        self.num_heads = num_heads
        self.attention_dropout = attention_dropout
        kw = dict(with_bias=False, generator=generator, device=dev)
        self.q_layer = Linear(hidden_size, hidden_size, **kw)
        self.k_layer = Linear(hidden_size, hidden_size, **kw)
        self.v_layer = Linear(hidden_size, hidden_size, **kw)
        self.output_layer = Linear(hidden_size, hidden_size, **kw)

    def _split_heads(self, x):
        b, t, _ = x.shape
        d = self.hidden_size // self.num_heads
        return x.reshape(b, t, self.num_heads, d).transpose(1, 2)

    def _combine_heads(self, x):
        b, h, t, d = x.shape
        return x.transpose(1, 2).reshape(b, t, h * d)

    def forward(self, x, y=None, bias=None, cache=None, cache_index=None,
                causal=False):
        self_attention = y is None
        y = x if self_attention else y
        q = self._split_heads(self.q_layer(x))
        d = self.hidden_size // self.num_heads
        if cache is not None:
            if self_attention:
                if causal:
                    # the kernel mask cannot know how much of the cache is
                    # filled: decode callers pass the position mask as bias
                    raise ValueError(
                        "causal=True is unsupported with a decode cache: "
                        "pass the decode position mask as `bias` instead")
                _write_cache(cache["k"], self._split_heads(self.k_layer(y)),
                             cache_index)
                _write_cache(cache["v"], self._split_heads(self.v_layer(y)),
                             cache_index)
            # cross-attention: the cache holds the projected encoder K/V
            k, v = cache["k"], cache["v"]
        else:
            k = self._split_heads(self.k_layer(y))
            v = self._split_heads(self.v_layer(y))

        if self.training and self.attention_dropout > 0.0:
            # dropout on the softmax weights needs the materialised path
            logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
            logits = logits / math.sqrt(d)
            if bias is not None:
                logits = logits + bias.float()
            if causal:
                tq, tk = logits.shape[-2], logits.shape[-1]
                mask = torch.ones((tq, tk), dtype=torch.bool,
                                  device=logits.device).tril(tk - tq)
                logits = logits.masked_fill(~mask, NEG_INF)
            w = dropout(torch.softmax(logits, dim=-1),
                        self.attention_dropout)
            ctxt = torch.matmul(w.to(v.dtype), v)
        else:
            ctxt = dot_product_attention(q, k, v, bias, causal=causal)
        out = self.output_layer(self._combine_heads(ctxt))
        if cache is not None:
            return out, cache
        return out

    def init_cache(self, batch: int, max_length: int, dtype=torch.float32):
        d = self.hidden_size // self.num_heads
        shape = (batch, self.num_heads, max_length, d)
        dev = self.q_layer.weight.device
        return {"k": torch.zeros(shape, dtype=dtype, device=dev),
                "v": torch.zeros(shape, dtype=dtype, device=dev)}


class FeedForwardNetwork(nn.Module):
    """Position-wise FFN: Linear -> ReLU -> Dropout -> Linear."""

    def __init__(self, hidden_size: int, filter_size: int,
                 relu_dropout: float = 0.0, *, generator: torch.Generator,
                 device=None):
        super().__init__()
        self.relu_dropout = relu_dropout
        self.filter_layer = Linear(hidden_size, filter_size, True,
                                   generator=generator, device=device)
        self.output_layer = Linear(filter_size, hidden_size, True,
                                   generator=generator, device=device)

    def forward(self, x):
        h = torch.relu(self.filter_layer(x))
        h = _residual_dropout(h, self.relu_dropout, self.training)
        return self.output_layer(h)


def _residual_dropout(x, p, training):
    """Inverted dropout in training (mask from the forward context's
    generator), identity otherwise."""
    if training and p > 0.0:
        return dropout(x, p)
    return x


class TransformerEncoderLayer(nn.Module):
    """Pre-norm encoder block: LN -> self-attention -> residual; LN -> FFN
    -> residual.  ``forward(x, bias=None)``: ``bias`` is the sources'
    padding bias."""

    def __init__(self, hidden_size, num_heads, filter_size,
                 attention_dropout=0.0, ffn_dropout=0.0, *,
                 generator: torch.Generator, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.ffn_dropout = ffn_dropout
        self.attn_norm = LayerNormalization(hidden_size, device=dev)
        self.attn = Attention(hidden_size, num_heads, attention_dropout,
                              generator=generator, device=dev)
        self.ffn_norm = LayerNormalization(hidden_size, device=dev)
        self.ffn = FeedForwardNetwork(hidden_size, filter_size, ffn_dropout,
                                      generator=generator, device=dev)

    def forward(self, x, bias=None):
        y = self.attn(self.attn_norm(x), None, bias)
        x = x + _residual_dropout(y, self.ffn_dropout, self.training)
        y = self.ffn(self.ffn_norm(x))
        return x + _residual_dropout(y, self.ffn_dropout, self.training)


class TransformerDecoderLayer(nn.Module):
    """Pre-norm decoder block: LN -> causal self-attention -> residual;
    with ``with_cross_attention`` (the default) LN -> attention over the
    encoder output -> residual; LN -> FFN -> residual.

    ``forward(x, self_bias=None, enc_out=None, enc_bias=None, cache=None,
    cache_index=None, self_causal=False)``: the cross-attention runs when
    ``enc_out`` is given, from ``cache["cross"]`` (the encoder K/V
    projected once) when the cache holds it; with a ``cache`` the block
    returns ``(x, cache)``."""

    def __init__(self, hidden_size, num_heads, filter_size,
                 attention_dropout=0.0, ffn_dropout=0.0,
                 with_cross_attention=True, *,
                 generator: torch.Generator, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.ffn_dropout = ffn_dropout
        self.with_cross_attention = with_cross_attention
        self.self_norm = LayerNormalization(hidden_size, device=dev)
        self.self_attn = Attention(hidden_size, num_heads, attention_dropout,
                                   generator=generator, device=dev)
        if with_cross_attention:
            self.cross_norm = LayerNormalization(hidden_size, device=dev)
            self.cross_attn = Attention(hidden_size, num_heads,
                                        attention_dropout,
                                        generator=generator, device=dev)
        self.ffn_norm = LayerNormalization(hidden_size, device=dev)
        self.ffn = FeedForwardNetwork(hidden_size, filter_size, ffn_dropout,
                                      generator=generator, device=dev)

    def forward(self, x, self_bias=None, enc_out=None, enc_bias=None,
                cache=None, cache_index=None, self_causal=False):
        new_cache = None
        if cache is not None:
            if self_causal and self_bias is None:
                raise ValueError(
                    "self_causal with a decode cache needs the decode "
                    "position mask passed as self_bias")
            y, self_cache = self.self_attn(
                self.self_norm(x), None, self_bias,
                cache=cache["self"], cache_index=cache_index)
            new_cache = dict(cache, self=self_cache)
        else:
            y = self.self_attn(self.self_norm(x), None, self_bias,
                               causal=self_causal)
        x = x + _residual_dropout(y, self.ffn_dropout, self.training)
        if self.with_cross_attention and enc_out is not None:
            if cache is not None and "cross" in cache:
                y, _ = self.cross_attn(self.cross_norm(x), enc_out, enc_bias,
                                       cache=cache["cross"])
            else:
                y = self.cross_attn(self.cross_norm(x), enc_out, enc_bias)
            x = x + _residual_dropout(y, self.ffn_dropout, self.training)
        y = self.ffn(self.ffn_norm(x))
        x = x + _residual_dropout(y, self.ffn_dropout, self.training)
        if cache is not None:
            return x, new_cache
        return x


class Transformer(nn.Module):
    """The full transformer, ``transformer_type`` "lm" (decoder only:
    ``forward(tokens [B, T])``) or "translation" (encoder-decoder:
    ``forward(src [B, Ts], tgt [B, Tt])``).  Returns logits [B, T, vocab]
    through the shared embedding when ``with_share_weights_linear``, else
    the decoder's hidden states [B, T, H].

    Token ids are 1-based with ``padding_value`` (default 0) as padding:
    token t reads embedding row t - 1, a padding position embeds to zeros,
    and logit index j is token j + 1.  The embedding is the bare
    parameter ``embedding`` [vocab, H], N(0, 1/H), as in the reference,
    so ``interop.load_jax_parameters`` carries a reference model's
    parameters across by name."""

    def __init__(self, vocab_size: int, hidden_size: int, num_heads: int,
                 filter_size: int, num_hidden_layers: int,
                 embedding_dropout: float = 0.0,
                 attention_dropout: float = 0.0,
                 ffn_dropout: float = 0.0,
                 padding_value: float = 0.0,
                 with_share_weights_linear: bool = False,
                 transformer_type: str = "lm", *,
                 generator: torch.Generator, device=None):
        super().__init__()
        if transformer_type not in ("lm", "translation"):
            raise ValueError(transformer_type)
        dev = resolve_device(device)
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.embedding_dropout = embedding_dropout
        self.padding_value = padding_value
        self.with_share_weights_linear = with_share_weights_linear
        self.transformer_type = transformer_type
        self.embedding = nn.Parameter(
            (torch.randn((vocab_size, hidden_size), generator=generator)
             * hidden_size ** -0.5).to(dev))
        kw = dict(generator=generator, device=dev)
        if transformer_type == "translation":
            self.encoder_layers = nn.ModuleList([
                TransformerEncoderLayer(hidden_size, num_heads, filter_size,
                                        attention_dropout, ffn_dropout, **kw)
                for _ in range(num_hidden_layers)])
            self.encoder_norm = LayerNormalization(hidden_size, device=dev)
        self.decoder_layers = nn.ModuleList([
            TransformerDecoderLayer(
                hidden_size, num_heads, filter_size, attention_dropout,
                ffn_dropout,
                with_cross_attention=(transformer_type == "translation"),
                **kw)
            for _ in range(num_hidden_layers)])
        self.decoder_norm = LayerNormalization(hidden_size, device=dev)

    @property
    def device(self) -> torch.device:
        return self.embedding.device

    # -- embedding ---------------------------------------------------------

    def embed(self, tokens):
        """Embedding rows (padding -> 0) * sqrt(H)."""
        tokens = torch.as_tensor(tokens, device=self.device)
        idx = (tokens.long() - 1).clamp(0, self.vocab_size - 1)
        emb = self.embedding[idx] * math.sqrt(self.hidden_size)
        mask = tokens != self.padding_value
        return emb * mask[..., None].to(emb.dtype)

    def logits(self, hidden):
        """Project to the vocabulary with the shared embedding matrix."""
        return torch.matmul(hidden, self.embedding.t())

    # -- topologies --------------------------------------------------------

    def _decoder_input(self, emb):
        t = emb.shape[1]
        x = shift_right_3d(emb) + position_encoding(
            t, self.hidden_size, dtype=emb.dtype, device=emb.device)
        return _residual_dropout(x, self.embedding_dropout, self.training)

    def encode(self, src):
        """``(encoder output [B, Ts, H], padding_bias(src))``."""
        src = torch.as_tensor(src, device=self.device)
        emb = self.embed(src)
        bias = padding_bias(src, self.padding_value)
        x = emb + position_encoding(emb.shape[1], self.hidden_size,
                                    dtype=emb.dtype, device=emb.device)
        x = _residual_dropout(x, self.embedding_dropout, self.training)
        for layer in self.encoder_layers:
            x = layer(x, bias)
        return self.encoder_norm(x), bias

    def decode(self, tgt, enc_out=None, enc_bias=None):
        emb = self.embed(tgt)
        x = self._decoder_input(emb)
        self_bias = causal_bias(x.shape[1], x.dtype, x.device)
        for layer in self.decoder_layers:
            x = layer(x, self_bias, enc_out, enc_bias)
        x = self.decoder_norm(x)
        if self.with_share_weights_linear:
            return self.logits(x)
        return x

    def forward(self, *inputs):
        if self.transformer_type == "lm":
            (tokens,) = inputs
            return self.decode(tokens)
        src, tgt = inputs
        enc_out, enc_bias = self.encode(src)
        return self.decode(tgt, enc_out, enc_bias)

    # -- incremental decoding (driven by SequenceBeamSearch) ---------------

    @torch.no_grad()
    def init_decode_cache(self, batch: int, max_length: int,
                          dtype=torch.float32, enc_out=None):
        """Per-layer fixed-size decode caches ``[{"self": {"k", "v"}}]``;
        with ``enc_out`` each layer's cross-attention K/V are projected
        once, into ``"cross"``."""
        cache = []
        for layer in self.decoder_layers:
            entry = {"self": layer.self_attn.init_cache(
                batch, max_length, dtype)}
            if enc_out is not None and layer.with_cross_attention:
                ca = layer.cross_attn
                entry["cross"] = {
                    "k": ca._split_heads(ca.k_layer(enc_out)).to(dtype),
                    "v": ca._split_heads(ca.v_layer(enc_out)).to(dtype),
                }
            cache.append(entry)
        return cache

    @torch.no_grad()
    def decode_step(self, token, step: int, cache, enc_out=None,
                    enc_bias=None):
        """One decode step: ``token [B, 1]`` at position ``step`` (0-based;
        token 0, the padding value, is the start), the step's self-
        attention K/V written into ``cache`` in place.  Returns (logits
        [B, vocab] when with_share_weights_linear, else hidden [B, H],
        the per-layer caches), as ``decode()`` computes column ``step``."""
        emb = self.embed(token)  # [B, 1, H]
        max_len = cache[0]["self"]["k"].shape[2]
        pos = position_encoding(max_len, self.hidden_size, dtype=emb.dtype,
                                device=emb.device)
        x = emb + pos[step][None, None]
        self_bias = incremental_bias(max_len, step, device=emb.device)
        new_cache = []
        for layer, layer_cache in zip(self.decoder_layers, cache):
            x, lc = layer(x, self_bias, enc_out, enc_bias,
                          cache=layer_cache, cache_index=step)
            new_cache.append(lc)
        x = self.decoder_norm(x)
        if self.with_share_weights_linear:
            return self.logits(x)[:, 0, :], new_cache
        return x[:, 0, :], new_cache


# ---------------------------------------------------------------------------
# Beam search
# ---------------------------------------------------------------------------

def _top_k(x, k: int):
    """``jax.lax.top_k`` over the last dim: the k largest values in
    descending order, the LOWER index first among equal values (a stable
    sort; ``torch.topk`` promises no order among ties, and ties are common
    here: -1e9 + a log-prob rounds to -1e9 in f32)."""
    values, index = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], index[..., :k]


def _tree_map(fn, tree):
    """``fn`` on every tensor of nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {key: _tree_map(fn, value) for key, value in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, value) for value in tree)
    return fn(tree)


class SequenceBeamSearch(nn.Module):
    """Length-normalized beam search over a step function set by
    :meth:`set_logit_fn` (reference ``nn/SequenceBeamSearch.scala``).

    The reference's ``lax.while_loop`` is a Python loop here: its
    condition (the best alive score can no longer beat the worst finished
    one under length normalization ``((5+len)/6)^alpha``) is read on the
    host once a step.  The body is the reference's step for step: log-
    softmax in f32, the top 2·beam of beam·vocab candidates, EOS
    candidates masked to -1e9 for the alive set, the finished pool merged
    by top-k, every top-k with the lower index first among ties.  The
    cache is replicated across beams once and gathered anew each step;
    the step function writes into the cache it is handed.  ``steps`` holds the number of steps the last search ran."""

    def __init__(self, vocab_size: int, beam_size: int, alpha: float,
                 max_decode_length: int, eos_id: int,
                 padding_value: float = 0.0, *, device=None):
        super().__init__()
        self.vocab_size = vocab_size
        self.beam_size = beam_size
        self.alpha = alpha
        self.max_decode_length = max_decode_length
        self.eos_id = eos_id
        self.padding_value = padding_value
        self.device = resolve_device(device)
        self._logits_fn = None

    def set_logit_fn(self, fn):
        """fn(flat_ids [B*beam, 1], step, cache) -> (logits [B*beam, V],
        cache); the ids are logit indices, 0 at step 0."""
        self._logits_fn = fn
        return self

    def _length_norm(self, length):
        return ((5.0 + length) / 6.0) ** self.alpha

    def search(self, batch_size: int, initial_cache):
        """Run the search; returns (seq [B, beam, T] int64, scores [B,
        beam] f32).  ``initial_cache`` (nested dicts and lists of tensors
        with batch_size rows) is replicated to batch_size·beam rows."""
        if self._logits_fn is None:
            raise RuntimeError("call set_logit_fn first")
        b, beam, vocab = batch_size, self.beam_size, self.vocab_size
        tmax = self.max_decode_length
        dev = self.device
        neg = NEG_INF
        alive_seq = torch.zeros((b, beam, tmax + 1), dtype=torch.long,
                                device=dev)
        alive_lp = torch.tensor([[0.0] + [neg] * (beam - 1)],
                                dtype=torch.float32, device=dev).repeat(b, 1)
        fin_seq = torch.zeros_like(alive_seq)
        fin_scores = torch.full((b, beam), neg, dtype=torch.float32,
                                device=dev)
        fin_flags = torch.zeros((b, beam), dtype=torch.bool, device=dev)
        cache = _tree_map(lambda t: t.repeat_interleave(beam, dim=0),
                          initial_cache)
        # row r of batch i sits at i·beam + r
        base = torch.arange(b, device=dev)[:, None] * beam
        max_norm = self._length_norm(tmax)

        def cond(i):
            if i >= tmax:
                return False
            max_alive = alive_lp[:, 0] / max_norm
            worst_fin = torch.where(fin_flags, fin_scores, neg).min(1).values
            worst_fin = torch.where(fin_flags.any(1), worst_fin, neg)
            return not bool((worst_fin >= max_alive).all())

        i = 0
        while cond(i):
            ids = alive_seq[:, :, i].reshape(b * beam, 1)
            logits, cache = self._logits_fn(ids, i, cache)
            log_probs = torch.log_softmax(logits.float(), dim=-1)
            log_probs = log_probs.reshape(b, beam, vocab) \
                + alive_lp[:, :, None]
            # 2·beam candidates so EOS-heavy rows keep enough alive beams
            top_lp, top_idx = _top_k(log_probs.reshape(b, beam * vocab),
                                     2 * beam)
            beam_idx = top_idx // vocab
            token_id = top_idx % vocab
            cand_seq = torch.gather(
                alive_seq, 1, beam_idx[:, :, None].expand(-1, -1, tmax + 1))
            cand_seq[:, :, i + 1] = token_id
            is_eos = token_id == self.eos_id
            # the new alive set: the best non-EOS candidates
            alive_lp, alive_sel = _top_k(
                torch.where(is_eos, neg, top_lp), beam)
            alive_seq = torch.gather(
                cand_seq, 1, alive_sel[:, :, None].expand(-1, -1, tmax + 1))
            # the cache follows the alive beams' source beams (sel_beam):
            # each leaf a fresh gather of its rows, never a view of itself
            rows = (torch.gather(beam_idx, 1, alive_sel) + base).reshape(-1)
            cache = _tree_map(lambda t: t.index_select(0, rows), cache)
            # the finished pool: the old one and the EOS candidates, the
            # top beam kept; the length normalization in f32, as the
            # reference's traced step evaluates it
            norm = self._length_norm(torch.tensor(i + 1,
                                                  dtype=torch.float32))
            cand_scores = torch.where(is_eos, top_lp / norm, neg)
            fin_scores, fin_sel = _top_k(
                torch.cat([fin_scores, cand_scores], 1), beam)
            fin_seq = torch.gather(
                torch.cat([fin_seq, cand_seq], 1), 1,
                fin_sel[:, :, None].expand(-1, -1, tmax + 1))
            fin_flags = torch.gather(torch.cat([fin_flags, is_eos], 1), 1,
                                     fin_sel)
            i += 1
        # rows with no finished hypothesis fall back to the alive beams
        any_fin = fin_flags.any(1, keepdim=True)
        seq = torch.where(any_fin[:, :, None], fin_seq, alive_seq)
        scores = torch.where(any_fin, fin_scores, alive_lp / max_norm)
        self.steps = i
        return seq[:, :, 1:], scores

    def forward(self, batch_size, initial_cache):
        return self.search(int(batch_size), initial_cache)
