"""Multi-head attention and the pre-norm decoder block (counterpart of
``bigdl_tpu/nn/attention.py``: ``position_encoding``, the bias helpers,
``Attention``, ``FeedForwardNetwork``, ``_residual_dropout`` and
``TransformerDecoderLayer`` without cross-attention).

Attention goes through :func:`bigdl_tpu_torch.ops.dot_product_attention`,
which launches the CUDA flash kernel for every call on a CUDA tensor.
Decode uses a fixed-size KV cache written IN PLACE: where the reference
returns an updated copy (and donates the old one under jit), the port
writes the cache tensors it was given and returns the same dict.
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
    "Attention", "FeedForwardNetwork", "TransformerDecoderLayer",
    "position_encoding", "padding_bias", "causal_bias",
    "incremental_bias", "chunk_incremental_bias",
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
    bias broadcastable to [B, h, Tq, Tk].  With a ``cache``
    ({"k", "v"}: [B, h, Tmax, d], self-attention only) the step's K/V are
    written in place at ``cache_index`` and ``(output, cache)`` is
    returned."""

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
        k = self._split_heads(self.k_layer(y))
        v = self._split_heads(self.v_layer(y))
        if cache is not None:
            if not self_attention:
                raise NotImplementedError(
                    "a cross-attention decode cache is not ported yet")
            if causal:
                # the kernel mask cannot know how much of the cache is
                # filled: decode callers pass the position mask as bias
                raise ValueError(
                    "causal=True is unsupported with a decode cache: "
                    "pass the decode position mask as `bias` instead")
            _write_cache(cache["k"], k, cache_index)
            _write_cache(cache["v"], v, cache_index)
            k, v = cache["k"], cache["v"]

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


class TransformerDecoderLayer(nn.Module):
    """Pre-norm decoder block: LN -> causal self-attention -> residual;
    LN -> FFN -> residual.  Cross-attention (the reference's default) is
    not ported yet: pass ``with_cross_attention=False``."""

    def __init__(self, hidden_size, num_heads, filter_size,
                 attention_dropout=0.0, ffn_dropout=0.0,
                 with_cross_attention=True, *,
                 generator: torch.Generator, device=None):
        super().__init__()
        if with_cross_attention:
            raise NotImplementedError(
                "TransformerDecoderLayer cross-attention is not ported "
                "yet; pass with_cross_attention=False")
        dev = resolve_device(device)
        self.ffn_dropout = ffn_dropout
        self.self_norm = LayerNormalization(hidden_size, device=dev)
        self.self_attn = Attention(hidden_size, num_heads, attention_dropout,
                                   generator=generator, device=dev)
        self.ffn_norm = LayerNormalization(hidden_size, device=dev)
        self.ffn = FeedForwardNetwork(hidden_size, filter_size, ffn_dropout,
                                      generator=generator, device=dev)

    def forward(self, x, self_bias=None, cache=None, cache_index=None,
                self_causal=False):
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
        y = self.ffn(self.ffn_norm(x))
        x = x + _residual_dropout(y, self.ffn_dropout, self.training)
        if cache is not None:
            return x, new_cache
        return x
