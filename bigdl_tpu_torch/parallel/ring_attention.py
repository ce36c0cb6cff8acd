"""Ring attention: sequence parallelism over a mesh axis (counterpart of
``bigdl_tpu/parallel/ring_attention.py``).

The sequence [B, H, T, D] is cut into n chunks of Tc = T/n along a mesh
axis.  Shard ``me`` holds the query chunk ``me``; at ring step s it
attends to the K/V chunk ``src = (me - s) % n`` that has travelled to it,
merging the partial result into an f32 online-softmax state (acc, m, l).
Under causality a pair whose chunk lies above the diagonal (src > me) is
skipped, and the mask inside a pair is on global positions.

The reference runs one program per device under ``shard_map`` and passes
K/V (and, in the backward, their gradient accumulators) to the next
device with ``ppermute``.  The port is single-controller, as the
reference's CPU tests are (8 fake devices driven by one process): one
Python loop drives every shard, the shards all lie on one device
(``parallel/mesh.py``), and the rotation is index arithmetic, not a copy.
The schedule is the reference's: the same pairs, the same global offsets,
the same order of every f32 sum.  On one card the ring therefore does not
cut memory; a ring across GPUs is ROADMAP.md queue 1, item 11.

Two implementations, as in the reference:

* the plain ring (the reference's ``_ring_xla``): one materialised
  [Tc, Tc] score block per step, autograd differentiates it; it serves a
  call with a bias, ``kernel="plain"``, and CPU tensors by default;
* the kernel ring (``_RingFlash``, the reference's ``_ring_flash``): an
  autograd Function whose forward merges each visible pair through
  kernel #5 and whose backward runs kernels #6 and #7 for each pair
  (``ops/attention_kernels.py``).  It
  serves CUDA tensors by default and ``kernel="flash"``; on CPU tensors
  the same Function runs the kernels' plain versions.  Unlike the
  reference it takes every chunk: its ``tc % 128`` rule was a tiling
  constraint of the Pallas kernels, and the CUDA kernels mask their
  ragged edges.
"""

from __future__ import annotations

from typing import Optional

import torch

from bigdl_tpu_torch.nn.attention import Attention, causal_bias
from bigdl_tpu_torch.ops import attention_kernels as ak
from bigdl_tpu_torch.parallel.mesh import NOT_PORTED, same_device

__all__ = ["ring_attention", "ring_self_attention", "RingSelfAttention"]


def _chunk(x, i: int, tc: int):
    """Chunk ``i`` of the sequence axis (dim 2) of x, a view."""
    return x[:, :, i * tc:(i + 1) * tc]


def _block_attend(q, k, v, bias_blk, scale, acc, m_prev, l_prev):
    """One online-softmax step: q [B,H,Tq,D] against k, v [B,H,Tc,D];
    bias_blk broadcastable to [B,H,Tq,Tc] or None; acc, m, l f32."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias_blk is not None:
        s = s + bias_blk.float()
    m_new = torch.maximum(m_prev, s.amax(-1))
    p = torch.exp(s - m_new[..., None])
    alpha = torch.exp(m_prev - m_new)
    l_new = l_prev * alpha + p.sum(-1)
    acc = acc * alpha[..., None] + torch.matmul(p.to(v.dtype).float(),
                                                v.float())
    return acc, m_new, l_new


def _fresh_state(q):
    """(acc 0, m -1e9, l 0) for the rows of q, f32."""
    b, h, tc, d = q.shape
    return (torch.zeros((b, h, tc, d), dtype=torch.float32, device=q.device),
            torch.full((b, h, tc), ak.NEG_INF, dtype=torch.float32,
                       device=q.device),
            torch.zeros((b, h, tc), dtype=torch.float32, device=q.device))


def _safe(l):
    # rows that saw no key (not in causal self-attention, whose diagonal
    # always contributes) divide by 1
    return torch.where(l == 0.0, 1.0, l)


def _ring_plain(q, k, v, n: int, causal: bool, scale: float, bias):
    """The plain ring: a materialised [Tc, Tc] block per step, with the
    causal mask and the bias folded into one additive block bias."""
    b, h, t, d = q.shape
    tc = t // n
    if bias is not None:
        bias = bias.expand(b, h, t, t)   # a view: never materialised
    outs = []
    for me in range(n):
        qc = _chunk(q, me, tc)
        acc, m, l = _fresh_state(qc)
        for s in range(n):
            src = (me - s) % n
            blk = None
            if bias is not None:
                blk = _chunk(bias, me, tc)[..., src * tc:(src + 1) * tc]
            if causal:
                pos = torch.arange(tc, device=q.device)
                visible = (me * tc + pos)[:, None] >= (src * tc + pos)[None]
                cb = torch.where(visible, 0.0, ak.NEG_INF)
                blk = cb if blk is None else blk + cb
            acc, m, l = _block_attend(qc, _chunk(k, src, tc),
                                      _chunk(v, src, tc), blk, scale, acc,
                                      m, l)
        outs.append((acc / _safe(l)[..., None]).to(q.dtype))
    return torch.cat(outs, dim=2)


def _ring_kernels(q):
    """Kernels #5-#7 for CUDA tensors, their plain versions for CPU ones
    (looked up at each call)."""
    return ak._RING_KERNELS if q.device.type == "cuda" else ak._RING_PLAIN


def _visible(me: int, src: int, causal: bool) -> bool:
    # chunks entirely above the diagonal contribute nothing
    return not causal or src <= me


class _RingFlash(torch.autograd.Function):
    """The kernel ring: forward #5 over every visible (me, src) pair,
    backward #6 and #7 over the same pairs, in the reference's order."""

    @staticmethod
    def forward(ctx, q, k, v, n, causal, scale):
        partial = _ring_kernels(q)[0]
        tc = q.shape[2] // n
        outs, lses = [], []
        for me in range(n):
            qc = _chunk(q, me, tc)
            acc, m, l = _fresh_state(qc)
            for s in range(n):
                src = (me - s) % n
                if _visible(me, src, causal):
                    acc, m, l = partial(
                        qc, _chunk(k, src, tc), _chunk(v, src, tc), acc, m,
                        l, q_offset=me * tc, k_offset=src * tc, scale=scale,
                        causal=causal)
            safe_l = _safe(l)
            outs.append((acc / safe_l[..., None]).to(q.dtype))
            lses.append(m + torch.log(safe_l))
        out = torch.cat(outs, dim=2)
        ctx.save_for_backward(q, k, v, out, *lses)
        ctx.cfg = (n, causal, scale)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, *lses = ctx.saved_tensors
        n, causal, scale = ctx.cfg
        _, dq_fn, dkv_fn = _ring_kernels(q)
        tc = q.shape[2] // n
        g32 = g.float()
        if g32.stride(-1) != 1:   # the kernels read a contiguous head dim
            g32 = g32.contiguous()
        # Δ rows (Σ_j P_ij dP_ij) of the whole sequence, like lse
        delta = (g32 * out.float()).sum(-1)
        deltas = [_chunk(delta, me, tc).contiguous() for me in range(n)]
        dq, dk, dv = [None] * n, [None] * n, [None] * n

        def add(acc, i, x):
            acc[i] = x if acc[i] is None else acc[i].add_(x)

        # step s outer: dQ of shard me sums over s ascending, and chunk
        # src's dK/dV meet shards src, src+1, ... in the order the
        # reference's rotating accumulator does
        for s in range(n):
            for me in range(n):
                src = (me - s) % n
                if not _visible(me, src, causal):
                    continue
                args = (_chunk(q, me, tc), _chunk(k, src, tc),
                        _chunk(v, src, tc), _chunk(g32, me, tc), lses[me],
                        deltas[me])
                cfg = dict(q_offset=me * tc, k_offset=src * tc, scale=scale,
                           causal=causal)
                add(dq, me, dq_fn(*args, **cfg))
                dk_c, dv_c = dkv_fn(*args, **cfg)
                add(dk, src, dk_c)
                add(dv, src, dv_c)
        return (torch.cat(dq, dim=2).to(q.dtype),
                torch.cat(dk, dim=2).to(k.dtype),
                torch.cat(dv, dim=2).to(v.dtype), None, None, None)


def ring_attention(q, k, v, n: int, *, causal: bool = False,
                   scale: Optional[float] = None, bias=None,
                   kernel: Optional[str] = None):
    """Ring attention of q, k, v [B, H, T, D] (the whole sequence) over
    ``n`` shards of T/n; returns [B, H, T, D] in q's dtype.

    The reference's ``ring_attention`` is the per-shard body under
    ``shard_map``; single-controller, the port's takes the global tensors
    and the shard count.  ``bias`` (broadcastable to [B, H, T, T]) routes
    the plain ring.  ``kernel``: ``"flash"`` (kernels #5-#7; their plain
    versions on CPU tensors), ``"plain"`` (the reference's ``"xla"``) or
    None (the kernels for CUDA tensors, the plain ring for CPU ones)."""
    if kernel not in (None, "flash", "plain"):
        raise ValueError(
            f"kernel must be None, 'flash' or 'plain', got {kernel!r}")
    t, d = q.shape[2], q.shape[3]
    if n < 1 or t % n:
        raise ValueError(f"sequence length {t} does not split into {n} "
                         f"shards")
    if scale is None:
        scale = d ** -0.5
    use_kernels = kernel == "flash" or (kernel is None
                                        and q.device.type == "cuda")
    if bias is None and use_kernels:
        return _RingFlash.apply(q, k, v, int(n), bool(causal), float(scale))
    return _ring_plain(q, k, v, n, causal, scale, bias)


def ring_self_attention(q, k, v, mesh, axis: str = "seq", *,
                        causal: bool = False, scale: Optional[float] = None,
                        bias=None, kernel: Optional[str] = None,
                        head_axis: Optional[str] = None):
    """Global entry: q, k, v [B, H, T, D] on the mesh's device, T
    divisible by ``mesh.shape[axis]``, attended with the ring schedule
    over that axis; equal to full attention.  ``head_axis`` (tensor
    parallelism through the ring) raises NotImplementedError."""
    if head_axis is not None:
        raise NotImplementedError(f"head_axis (tensor parallelism) "
                                  f"{NOT_PORTED}")
    if axis not in mesh.shape:
        raise ValueError(f"the mesh has no axis {axis!r}: {mesh.shape}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not same_device(x.device, mesh.device):
            raise ValueError(f"{name} is on {x.device}, the mesh's shards "
                             f"on {mesh.device}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"self-attention needs q, k, v of one shape: "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    return ring_attention(q, k, v, mesh.shape[axis], causal=causal,
                          scale=scale, bias=bias, kernel=kernel)


class RingSelfAttention(Attention):
    """Drop-in for :class:`bigdl_tpu_torch.nn.attention.Attention` that
    runs the training-time self-attention through the ring schedule.

    Routing, as the reference's: a decode cache and cross-attention go
    through the dense path; a bias also routes dense, with the causal
    mask folded into it; training with ``attention_dropout > 0`` raises
    (the ring never materialises the softmax weights); ``causal=True`` on
    a non-causal ring raises.  Build with :meth:`from_attention` to wrap
    an existing Attention: the four projection modules are SHARED, so
    parameter names and weights do not change."""

    def __init__(self, hidden_size, num_heads, mesh, axis="seq",
                 causal=True, attention_dropout=0.0, kernel=None,
                 head_axis=None, *, generator: torch.Generator,
                 device=None):
        super().__init__(hidden_size, num_heads, attention_dropout,
                         generator=generator, device=device)
        self._configure(mesh, axis, causal, kernel, head_axis)

    def _configure(self, mesh, axis, causal, kernel, head_axis):
        if head_axis is not None:
            raise NotImplementedError(f"head_axis (tensor parallelism) "
                                      f"{NOT_PORTED}")
        self.mesh = mesh
        self.seq_axis = axis
        self.causal = causal
        self.ring_kernel = kernel     # "flash" | "plain" | None
        self.head_axis = head_axis

    def forward(self, x, y=None, bias=None, cache=None, cache_index=None,
                causal=False):
        # a redundant causal=True is absorbed (the ring applies its own
        # causality); on a non-causal ring it would be dropped, so refuse
        if causal and not self.causal:
            raise ValueError(
                "RingSelfAttention was built with causal=False; "
                "kernel-side causal masking is not available on this "
                "ring — rebuild with causal=True")
        if cache is not None or (y is not None and y is not x):
            if causal:
                raise ValueError(
                    "causal=True is not supported on the cache/cross-"
                    "attention path; pass the decode-time incremental "
                    "bias instead")
            return Attention.forward(self, x, y, bias, cache, cache_index)
        if bias is not None:
            # dense, with the causality the ring would have applied folded
            # into the bias
            if self.causal:
                bias = bias + causal_bias(x.shape[1], dtype=bias.dtype,
                                          device=bias.device)
            return Attention.forward(self, x, None, bias)
        if self.training and self.attention_dropout > 0.0:
            raise ValueError(
                "attention dropout is not supported on the ring path "
                "(the softmax weights are never materialized); train "
                "with the dense Attention or attention_dropout=0")
        n_shards = self.mesh.shape[self.seq_axis]
        if x.shape[1] % n_shards:
            raise ValueError(
                f"sequence length {x.shape[1]} is not divisible by the "
                f"{self.seq_axis!r} mesh axis size {n_shards}")
        q = self._split_heads(self.q_layer(x))
        k = self._split_heads(self.k_layer(x))
        v = self._split_heads(self.v_layer(x))
        ctxt = ring_self_attention(q, k, v, self.mesh, self.seq_axis,
                                   causal=self.causal,
                                   kernel=self.ring_kernel)
        return self.output_layer(self._combine_heads(ctxt))

    @classmethod
    def from_attention(cls, attn, mesh, axis="seq", causal=True,
                       kernel=None, head_axis=None):
        """Wrap ``attn``: the ring shares its projection modules (no new
        parameters, no random draws) and its training flag."""
        ring = cls.__new__(cls)
        torch.nn.Module.__init__(ring)
        ring.training = attn.training
        ring.hidden_size = attn.hidden_size
        ring.num_heads = attn.num_heads
        ring.attention_dropout = attn.attention_dropout
        ring._configure(mesh, axis, causal, kernel, head_axis)
        ring.q_layer = attn.q_layer
        ring.k_layer = attn.k_layer
        ring.v_layer = attn.v_layer
        ring.output_layer = attn.output_layer
        return ring
