"""Decoder-only Transformer language model (counterpart of
``bigdl_tpu/models/transformer_lm.py``).

The incremental-decode API (``init_cache``, ``decode_step``,
``prefill_kv``, ``prefill_chunk``) is what the continuous-batching slot
pool (``serving/generation.py``) drives.  Caches are written IN PLACE:
the reference returns updated copies (donated under jit); the port
writes the tensors it is given and returns the same dict, so the
reference's ``logits, caches = decode_step(...)`` idiom still reads the
same.  ``decode_step`` also takes a per-row position tensor, the
batched form of the reference's vmap over pool slots.

Generation, beam search aside, is ported, and so is training (train
mode, dropout from the forward context, bf16 compute through the
Optimizer), with sequence parallelism (``set_sequence_parallel``: every
block's self-attention through ring attention); ``generate_beam``,
pipeline parallelism and ``remat`` belong to later slices.
"""

from __future__ import annotations

import torch
from torch import nn

from bigdl_tpu_torch.core.device import resolve_device
from bigdl_tpu_torch.nn.attention import (TransformerDecoderLayer,
                                          _residual_dropout, causal_bias,
                                          chunk_incremental_bias,
                                          incremental_bias, padding_bias,
                                          position_encoding)
from bigdl_tpu_torch.nn.linear import LookupTable
from bigdl_tpu_torch.nn.normalization import LayerNormalization
from bigdl_tpu_torch.ops.attention_kernels import NEG_INF, \
    dot_product_attention
from bigdl_tpu_torch.parallel.ring_attention import RingSelfAttention

__all__ = ["TransformerLM", "transformer_lm"]


class TransformerLM(nn.Module):
    """``forward(tokens [B,T] int, 1-based; 0 = padding) → logits
    [B, T, vocab+1]``.

    The framework's criteria are 1-based (target token t trains logit
    index t-1), so the LAST logit index is never trained: generation
    emits ``argmax + 1`` and masks that index."""

    def __init__(self, vocab_size: int, hidden_size: int = 256,
                 num_layers: int = 4, num_heads: int = 4,
                 filter_size: int = 1024, max_len: int = 512,
                 dropout: float = 0.0, padded_inputs: bool = True,
                 remat: bool = False, *, generator: torch.Generator,
                 device=None):
        super().__init__()
        if remat:
            raise NotImplementedError(
                "TransformerLM(remat=True) (recompute each block in the "
                "backward) is not ported yet (ROADMAP.md queue 1, item 4: "
                "the training loop, the rest)")
        dev = resolve_device(device)
        self.hidden_size = hidden_size
        self.max_len = max_len
        # padded_inputs=False: contiguous LM batching (no token-0
        # padding) — the causal mask moves inside the attention kernel
        # and padding fails loudly
        self.padded_inputs = padded_inputs
        self.seq_parallel = False
        self.embedding = LookupTable(vocab_size + 1, hidden_size,
                                     generator=generator, device=dev)
        with torch.no_grad():
            # N(0, 1/H): with the weight-tied head, unit-std embeddings
            # would give init logits of std sqrt(H)
            self.embedding.weight.mul_(hidden_size ** -0.5)
        self.blocks = nn.ModuleList([
            TransformerDecoderLayer(hidden_size, num_heads, filter_size,
                                    attention_dropout=dropout,
                                    ffn_dropout=dropout,
                                    with_cross_attention=False,
                                    generator=generator, device=dev)
            for _ in range(num_layers)])
        self.final_norm = LayerNormalization(hidden_size, device=dev)
        # row i depends on i alone, so one max_len table serves every
        # length the reference recomputes it for
        self.register_buffer(
            "pos_table", position_encoding(max_len, hidden_size, device=dev),
            persistent=False)

    def set_sequence_parallel(self, mesh, axis: str = "seq", kernel=None,
                              head_axis=None) -> "TransformerLM":
        """Run every block's self-attention through ring attention over
        ``mesh.shape[axis]`` shards (``parallel/ring_attention.py``).  The
        projection modules are SHARED with the existing Attention modules,
        so this changes how attention runs, not the parameters; a second
        call reconfigures the rings in place.  The ring applies the causal
        mask itself; a padded batch raises ValueError on this path.
        ``head_axis`` raises NotImplementedError (ROADMAP.md queue 1,
        item 11)."""
        for blk in self.blocks:
            if isinstance(blk.self_attn, RingSelfAttention):
                blk.self_attn._configure(mesh, axis, True, kernel, head_axis)
            else:
                blk.self_attn = RingSelfAttention.from_attention(
                    blk.self_attn, mesh, axis, causal=True, kernel=kernel,
                    head_axis=head_axis)
        self.seq_parallel = True
        return self

    @property
    def device(self) -> torch.device:
        return self.embedding.weight.device

    def _tokens(self, tokens):
        return torch.as_tensor(tokens, device=self.device).long()

    def _embed(self, tokens):
        # 0 is padding: clamp for the gather, the bias masks it
        return self.embedding(tokens.clamp(min=1)) * (self.hidden_size ** 0.5)

    def _logits(self, x):
        # weight-tied output head
        return torch.matmul(self.final_norm(x), self.embedding.weight.t())

    def forward(self, tokens):
        tokens = self._tokens(tokens)
        _, T = tokens.shape
        if T > self.max_len:
            raise ValueError(
                f"sequence length {T} exceeds max_len={self.max_len}")
        x = self._embed(tokens) + self.pos_table[:T]
        if self.padded_inputs and not self.seq_parallel:
            bias = causal_bias(T, x.dtype, x.device) \
                + padding_bias(tokens).to(x.dtype)
            causal = False
        else:
            # the ring applies the causal mask itself; the dense path
            # masks inside the attention kernel
            mode = ("sequence-parallel" if self.seq_parallel
                    else "padded_inputs=False")
            msg = (f"{mode} TransformerLM does not support padded "
                   "batches (token 0): this path has no padding mask; use "
                   "contiguous LM batching")
            if tokens.is_cuda and torch.cuda.is_current_stream_capturing():
                # a captured step reads no device value on the host: the
                # check runs on the device at every replay
                torch._assert_async(~(tokens == 0).any(), msg)
            elif bool((tokens == 0).any()):
                raise ValueError(msg)
            bias, causal = None, not self.seq_parallel
        for blk in self.blocks:
            x = blk(x, self_bias=bias, self_causal=causal)
        return self._logits(x)

    # ---- incremental decoding (KV cache) -------------------------------

    def init_cache(self, batch: int, dtype=torch.float32):
        """Per-block KV caches sized to ``max_len``, plus the per-slot
        padding flags the full forward expresses via padding_bias."""
        return {
            "layers": [{"self": blk.self_attn.init_cache(
                batch, self.max_len, dtype)} for blk in self.blocks],
            "pad": torch.zeros((batch, self.max_len), dtype=torch.bool,
                               device=self.device),
        }

    @torch.no_grad()
    def decode_step(self, tokens, index, caches, with_logits=True):
        """One token step: ``tokens [B, 1]`` at position ``index`` →
        (logits [B, vocab+1], caches).  ``index`` is an int, or an int
        tensor [B] giving each row its own position.  The step's K/V and
        pad flag are written into ``caches`` in place.
        ``with_logits=False`` skips the vocab projection."""
        tokens = self._tokens(tokens)
        pad = caches["pad"]
        if isinstance(index, torch.Tensor):
            rows = torch.arange(tokens.shape[0], device=pad.device)
            pad[rows, index] = tokens[:, 0] == 0
            pos = self.pos_table[index][:, None, :]
        else:
            pad[:, index] = tokens[:, 0] == 0
            pos = self.pos_table[index][None, None, :]
        x = self._embed(tokens) + pos
        bias = incremental_bias(self.max_len, index, pad, x.dtype)
        for blk, cache in zip(self.blocks, caches["layers"]):
            x, _ = blk(x, self_bias=bias, cache=cache, cache_index=index)
        if not with_logits:
            return None, caches
        return self._logits(x)[:, 0], caches

    @staticmethod
    def _block_prefill(blk, x, xn, k, v, bias):
        """The rest of a block once the keys it attends are known
        (attention inlined, so the K/V written to a cache are the K/V
        attended, without a second norm and projection)."""
        attn = blk.self_attn
        q = attn._split_heads(attn.q_layer(xn))
        ctxt = dot_product_attention(q, k, v, bias)
        y = attn.output_layer(attn._combine_heads(ctxt))
        x = x + _residual_dropout(y, blk.ffn_dropout, blk.training)
        y = blk.ffn(blk.ffn_norm(x))
        return x + _residual_dropout(y, blk.ffn_dropout, blk.training)

    @torch.no_grad()
    def prefill_kv(self, ptoks):
        """Per-layer K/V for every position of ``ptoks`` (a prompt minus
        its final token) as compact ``[B, heads, T, head_dim]`` tensors,
        plus the ``[B, T]`` bool padding flags — the parallel prefill
        without a max_len cache.  Both ``_prefill`` and the slot pool
        scatter these rows, so the two paths share one implementation."""
        ptoks = self._tokens(ptoks)
        _, T = ptoks.shape
        pad_cols = ptoks == 0
        x = self._embed(ptoks) + self.pos_table[:T]
        bias = causal_bias(T, x.dtype, x.device) \
            + padding_bias(ptoks).to(x.dtype)
        layers = []
        for blk in self.blocks:
            attn = blk.self_attn
            xn = blk.self_norm(x)
            k = attn._split_heads(attn.k_layer(xn))
            v = attn._split_heads(attn.v_layer(xn))
            layers.append({"k": k, "v": v})
            if blk.training and attn.attention_dropout > 0.0:
                # rare train-mode prefill: the dropout path must run
                y = attn(xn, None, bias)
                x = x + _residual_dropout(y, blk.ffn_dropout, blk.training)
                y = blk.ffn(blk.ffn_norm(x))
                x = x + _residual_dropout(y, blk.ffn_dropout, blk.training)
            else:
                x = self._block_prefill(blk, x, xn, k, v, bias)
        return layers, pad_cols

    @torch.no_grad()
    def prefill_chunk(self, toks, index: int, caches, slot=None):
        """KV-carry-in prefill: write K/V and padding flags for ``toks
        [B, W]`` at positions ``[index, index+W)`` of a cache whose
        positions ``< index`` are filled; the chunk attends to that
        prefix and, causally, to itself.  No logits.

        ``slot=None``: the caches carry B rows aligned with ``toks``.
        ``slot`` given: POOLED — the caches hold S slot rows, ``toks`` is
        [1, W], and only that slot's chunk window is written (in place);
        its keys are read back as the slot's row."""
        toks = self._tokens(toks)
        _, W = toks.shape
        if slot is None:
            caches["pad"][:, index:index + W] = toks == 0
            pad_read = caches["pad"]
        else:
            caches["pad"][slot, index:index + W] = toks[0] == 0
            pad_read = caches["pad"][slot:slot + 1]
        x = self._embed(toks) + self.pos_table[index:index + W][None]
        bias = chunk_incremental_bias(self.max_len, index, W, pad_read,
                                      x.dtype)
        for blk, cache in zip(self.blocks, caches["layers"]):
            attn = blk.self_attn
            xn = blk.self_norm(x)
            k_new = attn._split_heads(attn.k_layer(xn))
            v_new = attn._split_heads(attn.v_layer(xn))
            k, v = cache["self"]["k"], cache["self"]["v"]
            if slot is None:
                k[:, :, index:index + W] = k_new.to(k.dtype)
                v[:, :, index:index + W] = v_new.to(v.dtype)
                k_read, v_read = k, v
            else:
                k[slot, :, index:index + W] = k_new[0].to(k.dtype)
                v[slot, :, index:index + W] = v_new[0].to(v.dtype)
                k_read, v_read = k[slot:slot + 1], v[slot:slot + 1]
            x = self._block_prefill(blk, x, xn, k_read, v_read, bias)
        return caches

    @torch.no_grad()
    def _prefill(self, prompt, caches):
        """Write prompt[:, :-1]'s per-layer K/V into the front of the
        caches with one dense forward; the last prompt token is fed by
        the first decode step."""
        T = prompt.shape[1] - 1
        if T == 0:
            return caches
        layers_kv, pad = self.prefill_kv(prompt[:, :-1])
        caches["pad"][:, :T] = pad
        for kv, cache in zip(layers_kv, caches["layers"]):
            cache["self"]["k"][:, :, :T] = kv["k"]
            cache["self"]["v"][:, :, :T] = kv["v"]
        return caches

    @staticmethod
    def _mask_untrained_logit(logits):
        """Logit index ``vocab_size`` (the tied head's last row) is never
        a target; it must not win argmax.  Returns a masked copy."""
        out = logits.clone()
        out[..., -1] = NEG_INF
        return out

    @torch.no_grad()
    def generate(self, prompt, max_new_tokens: int, eos_id=None):
        """Greedy continuation: ``prompt [B, Tp]`` → ``[B, Tp +
        max_new_tokens]`` (int64, on the model's device); positions after
        ``eos_id`` (when given) are 0.  A Python loop of ``decode_step``
        in place of the reference's ``lax.scan``; nothing syncs with the
        host inside it."""
        prompt = self._tokens(prompt)
        B, Tp = prompt.shape
        if Tp + max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt {Tp} + {max_new_tokens} new tokens exceeds "
                f"max_len={self.max_len}")
        caches = self._prefill(prompt, self.init_cache(B))
        tok = prompt[:, -1:]
        done = torch.zeros((B,), dtype=torch.bool, device=prompt.device)
        out = []
        for t in range(Tp - 1, Tp - 1 + max_new_tokens):
            logits, caches = self.decode_step(tok, t, caches)
            # logit index i is token i+1's slot
            nxt = self._mask_untrained_logit(logits).argmax(-1) + 1
            nxt = torch.where(done, 0, nxt)
            if eos_id is not None:
                done = done | (nxt == eos_id)
            out.append(nxt)
            tok = nxt[:, None]
        if not out:
            return prompt
        return torch.cat([prompt, torch.stack(out, dim=1)], dim=1)


def transformer_lm(vocab_size: int, hidden_size: int = 256,
                   num_layers: int = 4, num_heads: int = 4,
                   filter_size: int = 1024, max_len: int = 512,
                   dropout: float = 0.0, padded_inputs: bool = True,
                   remat: bool = False, *, generator: torch.Generator,
                   device=None) -> TransformerLM:
    """Factory mirroring the models/* builder convention."""
    return TransformerLM(vocab_size, hidden_size, num_layers, num_heads,
                         filter_size, max_len, dropout,
                         padded_inputs=padded_inputs, remat=remat,
                         generator=generator, device=device)
