"""Scaled dot-product attention: the plain versions, the CUDA kernels'
wrappers, the autograd Function over them, and the dispatch.

Counterpart of ``bigdl_tpu/ops/attention_kernels.py``.  Shapes follow
[batch, heads, length, head_dim] ("BHTD").

* :func:`plain_attention` — materialised attention in plain PyTorch (the
  counterpart of ``xla_attention``): what the dispatch runs, and autograd
  differentiates, for CPU tensors.
* :func:`flash_attention_fwd` — the wrapper of the hand-written CUDA
  kernel ``csrc/flash_attention_fwd.cu`` (which replaces the Pallas
  ``_fwd_impl``/``_flash_fwd_kernel``); :func:`plain_attention_fwd` is its
  plain version, with the same ``lse``.
* :func:`flash_attention_dq`, :func:`flash_attention_dkv`,
  :func:`flash_attention_dbias` — the wrappers of the three backward
  kernels of ``csrc/flash_attention_bwd.cu`` (which replace the Pallas
  ``_flash_dq_kernel``, ``_flash_dkv_kernel`` and
  ``_flash_dbias_kernel``); ``plain_attention_dq``/``_dkv``/``_dbias`` are
  their plain versions.  Each wrapper counts its launches in
  ``<wrapper>.launches``.
* :func:`flash_attention_partial`, :func:`flash_attention_dq_partial`,
  :func:`flash_attention_dkv_partial` — the wrappers of the ring-attention
  kernels (``csrc/flash_attention_fwd.cu``'s partial merge and
  ``csrc/flash_attention_bwd.cu``'s partial dQ and dK/dV, which replace
  the Pallas ``_flash_partial_kernel``, ``_flash_dq_partial_kernel`` and
  ``_flash_dkv_partial_kernel``); ``plain_attention_partial``/
  ``_dq_partial``/``_dkv_partial`` are their plain versions.  The ring
  (``bigdl_tpu_torch.parallel.ring_attention``) chains them.  Six
  kernels route by dtype: bf16 #1, dQ (#2), dK/dV (#3), the partial
  merge (#5), the ring's dQ (#6) and dK/dV (#7) run on the tensor cores,
  f32 on scalar kernels (:func:`fwd_route`, :func:`dq_route`,
  :func:`dkv_route`, :func:`partial_route`, :func:`dq_partial_route`,
  :func:`dkv_partial_route`); their wrappers count each route in
  ``<wrapper>.routes``.
* :func:`flash_attention_with_grad` — the ``torch.autograd.Function``
  whose forward is the forward kernel and whose backward launches dQ and
  dK/dV (and dBias only when the bias needs a gradient), reading the
  ``lse`` the forward wrote: the counterpart of the reference's
  ``custom_vjp`` (``_flash3``/``_flash4``).  On CPU tensors the same
  Function runs the plain versions, because the tensors lie on the CPU.
* :func:`flash_attention` — the reference's causal contract:
  start-aligned, so a causal call needs tq == tk.
* :func:`dot_product_attention` — the public entry.  On a CUDA tensor
  EVERY call goes to the kernels (through the Function when a gradient is
  wanted): the reference's rule (Tq and Tk multiples of 128, D a multiple
  of 8) was a tiling constraint of the Pallas kernel, and these kernels
  mask their ragged edges themselves.  For a causal call it passes the
  diagonal offset tk - tq, so it equals ``plain_attention`` (whose causal
  mask is end-aligned) on every shape.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from bigdl_tpu_torch.ops.build import load_library

__all__ = ["plain_attention", "plain_attention_fwd", "attention_delta",
           "plain_attention_dq", "plain_attention_dkv",
           "plain_attention_dbias", "fold_bias_grad", "flash_attention_fwd",
           "flash_attention_dq", "flash_attention_dkv",
           "flash_attention_dbias", "flash_attention_with_grad",
           "flash_attention", "dot_product_attention", "NEG_INF",
           "plain_attention_partial", "plain_attention_dq_partial",
           "plain_attention_dkv_partial", "flash_attention_partial",
           "flash_attention_dq_partial", "flash_attention_dkv_partial",
           "dq_route", "dkv_route", "partial_route", "fwd_route",
           "dkv_partial_route", "dq_partial_route", "rows_aligned"]

NEG_INF = -1e9  # the reference's attention mask fill (_NEG_INF)
MAX_HEAD_DIM = 128

_SUPPORTED = (torch.float32, torch.bfloat16)


def _default_scale(d: int) -> float:
    return 1.0 / (d ** 0.5)


def plain_attention(q, k, v, bias=None, *, causal: bool = False,
                    scale: Optional[float] = None):
    """Materialised attention: softmax(q k^T * scale + bias) v.

    q: [B, H, Tq, D]; k, v: [B, H, Tk, D]; bias broadcastable to
    [B, H, Tq, Tk].  The product is taken in f32 and scaled after the
    dot; masked scores are REPLACED by -1e9 (causal mask end-aligned,
    ``tril(k=tk-tq)``); the softmax weights are cast to v's dtype before
    P.V, which accumulates in f32.  Output in q's dtype."""
    tq, d = q.shape[-2], q.shape[-1]
    tk = k.shape[-2]
    if scale is None:
        scale = _default_scale(d)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        logits = logits + bias.float()
    if causal:
        mask = torch.ones((tq, tk), dtype=torch.bool,
                          device=q.device).tril(tk - tq)
        logits = logits.masked_fill(~mask, NEG_INF)
    weights = torch.softmax(logits, dim=-1)
    return torch.matmul(weights.to(v.dtype).float(),
                        v.float()).to(q.dtype)


# ---- plain versions of the kernels ----------------------------------------
#
# Each repeats its kernel's arithmetic at the reference's rounding points
# (``_recompute_p`` :284, ``_dq_accum`` :299, ``_dkv_accum`` :321,
# ``_flash_dbias_kernel`` :410), with the kernels' causal diagonal offset.
# On a card the main path never calls them: chip_smoke.py and the cuda
# tests hold the kernels against them, and the autograd Function runs
# them for CPU tensors.

def _scores(q, k, bias, scale, causal, causal_offset):
    """(s [B,H,Tq,Tk] f32 with replaced scores at -1e9, visible mask or
    None, rows-with-no-key [Tq] or None)."""
    tq, tk = q.shape[-2], k.shape[-2]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias.float()
    if not causal:
        return s, None, None
    visible = torch.ones((tq, tk), dtype=torch.bool,
                         device=q.device).tril(causal_offset)
    blind = torch.arange(tq, device=q.device) + causal_offset < 0
    return s.masked_fill(~visible, NEG_INF), visible, blind


def _rows(x, b, h, tq):
    """[B*H, Tq] → [B, H, Tq, 1]."""
    return x.reshape(b, h, tq, 1)


def plain_attention_fwd(q, k, v, bias=None, *, scale: float,
                        causal: bool = False, causal_offset: int = 0):
    """Plain version of :func:`flash_attention_fwd`: ``(out, lse f32
    [B*H, Tq])``, with the causal mask ``j <= i + causal_offset``."""
    b, h, tq, _ = q.shape
    s, _, _ = _scores(q, k, bias, scale, causal, causal_offset)
    out = torch.matmul(torch.softmax(s, dim=-1).to(v.dtype).float(),
                       v.float()).to(q.dtype)
    return out, torch.logsumexp(s, dim=-1).reshape(b * h, tq)


def attention_delta(out, do):
    """Δ = rowsum(dO ∘ O) in f32 as [B*H, Tq]: the backward prologue the
    reference computes in XLA (``_bwd_prep`` :434), a PyTorch op here."""
    b, h, tq, _ = out.shape
    return (do.float() * out.float()).sum(-1).reshape(b * h, tq)


def _p_and_ds(q, k, v, bias, do, lse, delta, scale, causal, causal_offset):
    """The kernels' recomputed P and dS, both f32 [B, H, Tq, Tk]: P =
    exp(s - lse) (1/Tk on a row that sees no key), dS = P ∘ (dO·Vᵀ − Δ),
    0 where the causal mask replaced the score."""
    b, h, tq, _ = q.shape
    s, visible, blind = _scores(q, k, bias, scale, causal, causal_offset)
    p = torch.exp(s - _rows(lse, b, h, tq))
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    ds = p * (dp - _rows(delta, b, h, tq))
    if causal:
        ds = ds.masked_fill(~visible, 0.0)
        p = torch.where(blind[:, None], 1.0 / k.shape[-2], p)
    return p, ds


def plain_attention_dq(q, k, v, bias, do, lse, delta, *, scale: float,
                       causal: bool = False, causal_offset: int = 0):
    """Plain version of :func:`flash_attention_dq`: dQ = scale · dS·K,
    dS cast to K's dtype first; dq in q's dtype."""
    _, ds = _p_and_ds(q, k, v, bias, do, lse, delta, scale, causal,
                      causal_offset)
    return (torch.matmul(ds.to(k.dtype).float(), k.float())
            * scale).to(q.dtype)


def plain_attention_dkv(q, k, v, bias, do, lse, delta, *, scale: float,
                        causal: bool = False, causal_offset: int = 0):
    """Plain version of :func:`flash_attention_dkv`: ``(dK, dV)`` with
    dV = Pᵀ·dO (P cast to dO's dtype) and dK = scale · dSᵀ·Q (dS cast to
    Q's dtype), in k's and v's dtypes."""
    p, ds = _p_and_ds(q, k, v, bias, do, lse, delta, scale, causal,
                      causal_offset)
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), do.float())
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2),
                      q.float()) * scale
    return dk.to(k.dtype), dv.to(v.dtype)


def plain_attention_dbias(q, k, v, bias, do, lse, delta, *, scale: float,
                          causal: bool = False, causal_offset: int = 0):
    """Plain version of :func:`flash_attention_dbias`: dS in f32 as
    [B*H, Tq, Tk]."""
    b, h, tq, _ = q.shape
    _, ds = _p_and_ds(q, k, v, bias, do, lse, delta, scale, causal,
                      causal_offset)
    return ds.reshape(b * h, tq, k.shape[-2])


def fold_bias_grad(ds, bias, b: int, h: int):
    """dS [B*H, Tq, Tk] folded to ``bias``'s own (broadcast) shape and
    dtype: right-align the bias shape against [B, H, Tq, Tk], sum over
    every dim the bias has as 1 or lacks (``_dbias_impl`` :560-570)."""
    ds = ds.reshape(b, h, ds.shape[-2], ds.shape[-1])
    aligned = (1,) * (4 - bias.dim()) + tuple(bias.shape)
    dims = [i for i, (full, orig) in enumerate(zip(ds.shape, aligned))
            if orig == 1 and full != 1]
    if dims:
        ds = ds.sum(dim=dims, keepdim=True)
    return ds.reshape(bias.shape).to(bias.dtype)


# ---- the CUDA kernels' wrappers ---------------------------------------------

def _check_inputs(q, k, v, bias):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor) or t.dim() != 4:
            raise ValueError(f"{name} must be a 4-D [B, H, T, D] tensor")
        if t.device.type != "cuda":
            raise ValueError(
                f"the flash-attention kernel runs on CUDA tensors; {name} "
                f"is on {t.device} (dot_product_attention runs the plain "
                "version for CPU tensors)")
        if t.dtype not in _SUPPORTED:
            raise TypeError(f"{name} has dtype {t.dtype}; the kernel takes "
                            "float32 or bfloat16")
        if t.stride(-1) != 1:
            raise ValueError(f"{name} needs a contiguous head dim "
                             f"(stride {t.stride(-1)})")
    if q.device != k.device or q.device != v.device:
        raise ValueError("q, k and v must be on one device")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    b, h, tq, d = q.shape
    if k.shape != v.shape or k.shape[:2] != (b, h) or k.shape[3] != d:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    tk = k.shape[2]
    if min(b, h, tq, tk, d) < 1:
        raise ValueError("empty attention input")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} > {MAX_HEAD_DIM} is not supported")
    if b * h >= 2 ** 31 or (tq + 15) // 16 > 65535 \
            or (tk + 31) // 32 > 65535:
        raise ValueError("attention grid too large for one launch")
    if bias is not None and bias.device != q.device:
        raise ValueError("bias must be on q's device")


def _bias_args(bias, shape):
    """The f32 bias broadcast (by strides, never materialised) to
    ``shape``, as (pointer, strides); (None, zeros) without one."""
    if bias is None:
        return None, (0, 0, 0, 0)
    if bias.dtype != torch.float32:
        bias = bias.float()     # the small, un-broadcast bias
    bias = bias.expand(*shape)
    return bias, bias.stride()


def _bind(library: str, name: str, argtypes):
    """A C entry point, built and bound at first use (never at import:
    the CPU tests import this module without a CUDA toolkit)."""
    key = (library, name)
    fn = _bound.get(key)
    if fn is None:
        fn = getattr(load_library(library), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _bound[key] = fn
    return fn


_bound: dict = {}
_FWD_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                 + [ctypes.c_longlong] * 13
                 + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                    ctypes.c_void_p])
_BWD_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
                 + [ctypes.c_longlong] * 16
                 + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                    ctypes.c_void_p])


def _raise_on(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {rc}")


def rows_aligned(*tensors) -> bool:
    """Whether every row of each tensor starts on 16 bytes, as the
    tensor-core routes' copies need: the head dim a whole number of 16
    bytes (8 bf16 or 4 f32 values), the batch, head and time strides too,
    the data 16-byte aligned."""
    def aligned(t):
        size = t.element_size()
        return (t.shape[-1] * size % 16 == 0 and t.data_ptr() % 16 == 0
                and all(st * size % 16 == 0 for st in t.stride()[:3]))
    return all(aligned(t) for t in tensors)


def fwd_route(dtype, aligned: bool = True) -> str:
    """Which forward kernel (#1) runs for q, k, v of ``dtype``:
    ``"tensor_core"`` (``flash_fwd_tc_kernel``: bf16 operands, f32 sums on
    mma.sync) for bfloat16 rows that start on 16 bytes
    (:func:`rows_aligned`), the pooled decode (Tq 1) included, where it
    beats the scalar template too (PERF.md); ``"scalar"`` (the f32-FMA
    template) for float32, whose operands the tensor cores would round,
    and for bf16 rows that do not."""
    if dtype == torch.bfloat16:
        return "tensor_core" if aligned else "scalar"
    if dtype == torch.float32:
        return "scalar"
    raise TypeError(f"the forward kernel takes float32 or bfloat16, not "
                    f"{dtype}")


def _launch_fwd(q, k, v, bias, scale, causal, causal_offset, route):
    """Launch the forward kernel by ``route`` on inputs that
    :func:`_check_inputs` passed; ``(out, lse)``.  Counts nothing: the
    wrapper counts its launches."""
    b, h, tq, d = q.shape
    tk = k.shape[2]
    bias, b_strides = _bias_args(bias, (b, h, tq, tk))
    out = torch.empty((b, h, tq, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, tq), dtype=torch.float32, device=q.device)
    fn = _bind("flash_attention_fwd", "flash_attention_fwd", _FWD_ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                None if bias is None else bias.data_ptr(),
                out.data_ptr(), lse.data_ptr(),
                int(q.dtype == torch.bfloat16), int(route == "tensor_core"),
                b, h, tq, tk, d,
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                *b_strides, float(scale), int(bool(causal)),
                int(causal_offset), stream)
    _raise_on(rc, "flash_attention_fwd")
    return out, lse


def flash_attention_fwd(q, k, v, bias=None, *, scale: float,
                        causal: bool = False, causal_offset: int = 0):
    """Launch the CUDA forward kernel on CUDA tensors.  Returns
    ``(out [B, H, Tq, D] in q's dtype, lse f32 [B*H, Tq])``.

    q, k, v may have any strides on the batch, head and time dims (the
    head dim must be contiguous); bias is broadcast by strides, never
    materialised per head.  The causal mask admits key j for row i when
    ``j <= i + causal_offset``.  bf16 takes the tensor-core route where
    its rows start on 16 bytes, else the scalar one (:func:`fwd_route`);
    ``flash_attention_fwd.routes`` counts each.  Raises on anything the
    kernel does not take; never falls back to the plain version."""
    _check_inputs(q, k, v, bias)
    route = fwd_route(q.dtype, rows_aligned(q, k, v))
    out = _launch_fwd(q, k, v, bias, scale, causal, causal_offset, route)
    flash_attention_fwd.launches += 1
    flash_attention_fwd.routes[route] += 1
    return out


flash_attention_fwd.launches = 0
flash_attention_fwd.routes = {"tensor_core": 0, "scalar": 0}


def _launch_bwd(name, q, k, v, bias, do, lse, delta, out0, out1, scale,
                causal, causal_offset):
    """Check the backward's extra inputs and launch kernel ``name``."""
    _check_inputs(q, k, v, bias)
    b, h, tq, d = q.shape
    tk = k.shape[2]
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(f"dO must match q: {tuple(do.shape)} {do.dtype} "
                         f"{do.device}")
    if do.stride(-1) != 1:
        raise ValueError(f"dO needs a contiguous head dim "
                         f"(stride {do.stride(-1)})")
    for label, t in (("lse", lse), ("delta", delta)):
        if (t.shape != (b * h, tq) or t.dtype != torch.float32
                or t.device != q.device or not t.is_contiguous()):
            raise ValueError(f"{label} must be a contiguous f32 [B*H, Tq] "
                             f"tensor on q's device")
    bias, b_strides = _bias_args(bias, (b, h, tq, tk))
    fn = _bind("flash_attention_bwd", name, _BWD_ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                None if bias is None else bias.data_ptr(), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), out0.data_ptr(),
                None if out1 is None else out1.data_ptr(),
                int(q.dtype == torch.bfloat16), b, h, tq, tk, d,
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                *do.stride()[:3], *b_strides, float(scale),
                int(bool(causal)), int(causal_offset), stream)
    _raise_on(rc, name)


def dq_route(dtype) -> str:
    """Which dQ kernel (#2) runs for q, k, v and dO of ``dtype``:
    ``"tensor_core"`` (``flash_dq_tc_kernel``: bf16 operands, f32 sums on
    mma.sync) for bfloat16, ``"scalar"`` (``flash_dq_kernel``: f32 FMAs)
    for float32, whose operands the tensor cores would round.  The C entry
    picks the same kernel by dtype; this names it for the route
    counter."""
    if dtype == torch.bfloat16:
        return "tensor_core"
    if dtype == torch.float32:
        return "scalar"
    raise TypeError(f"the dQ kernel takes float32 or bfloat16, not {dtype}")


def flash_attention_dq(q, k, v, bias, do, lse, delta, *, scale: float,
                       causal: bool = False, causal_offset: int = 0):
    """Launch the dQ kernel (#2) on CUDA tensors: dq [B, H, Tq, D] in q's
    dtype.  ``lse`` is the forward kernel's, ``delta`` is
    :func:`attention_delta`; q, k, v, dO are read through their strides.
    bf16 takes the tensor-core route, f32 the scalar one
    (:func:`dq_route`); ``flash_attention_dq.routes`` counts each."""
    route = dq_route(q.dtype)
    b, h, tq, d = q.shape
    dq = torch.empty((b, h, tq, d), dtype=q.dtype, device=q.device)
    _launch_bwd("flash_attention_dq", q, k, v, bias, do, lse, delta, dq,
                None, scale, causal, causal_offset)
    flash_attention_dq.launches += 1
    flash_attention_dq.routes[route] += 1
    return dq


flash_attention_dq.launches = 0
flash_attention_dq.routes = {"tensor_core": 0, "scalar": 0}


def dkv_route(dtype) -> str:
    """Which dK/dV kernel (#3) runs for q, k, v and dO of ``dtype``:
    ``"tensor_core"`` (``flash_dkv_tc_kernel``: bf16 operands, f32 sums
    on mma.sync) for bfloat16, ``"scalar"`` (``flash_dkv_kernel``: f32
    FMAs) for float32, whose operands the tensor cores would round.  The
    C entry picks the same kernel by dtype; this names it for the route
    counter."""
    if dtype == torch.bfloat16:
        return "tensor_core"
    if dtype == torch.float32:
        return "scalar"
    raise TypeError(f"the dK/dV kernel takes float32 or bfloat16, not "
                    f"{dtype}")


def flash_attention_dkv(q, k, v, bias, do, lse, delta, *, scale: float,
                        causal: bool = False, causal_offset: int = 0):
    """Launch the dK/dV kernel (#3) on CUDA tensors: ``(dk, dv)``
    [B, H, Tk, D] in k's and v's dtype.  bf16 takes the tensor-core
    route, f32 the scalar one (:func:`dkv_route`);
    ``flash_attention_dkv.routes`` counts each."""
    route = dkv_route(q.dtype)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _launch_bwd("flash_attention_dkv", q, k, v, bias, do, lse, delta, dk,
                dv, scale, causal, causal_offset)
    flash_attention_dkv.launches += 1
    flash_attention_dkv.routes[route] += 1
    return dk, dv


flash_attention_dkv.launches = 0
flash_attention_dkv.routes = {"tensor_core": 0, "scalar": 0}


def flash_attention_dbias(q, k, v, bias, do, lse, delta, *, scale: float,
                          causal: bool = False, causal_offset: int = 0):
    """Launch the dBias kernel (#4) on CUDA tensors: dS f32
    [B*H, Tq, Tk] (fold it with :func:`fold_bias_grad`)."""
    b, h, tq, _ = q.shape
    ds = torch.empty((b * h, tq, k.shape[2]), dtype=torch.float32,
                     device=q.device)
    _launch_bwd("flash_attention_dbias", q, k, v, bias, do, lse, delta, ds,
                None, scale, causal, causal_offset)
    flash_attention_dbias.launches += 1
    return ds


flash_attention_dbias.launches = 0

_KERNELS = (flash_attention_fwd, flash_attention_dq, flash_attention_dkv,
            flash_attention_dbias)
_PLAIN = (plain_attention_fwd, plain_attention_dq, plain_attention_dkv,
          plain_attention_dbias)


# ---- the ring-attention partial kernels (#5-#7) ------------------------------
#
# One visiting K/V chunk of ring attention at a time.  q_offset and
# k_offset are the chunks' GLOBAL positions: the causal mask admits key j
# for row i when q_offset + i >= k_offset + j.  The carried state (acc
# [B,H,Tq,D], m and l [B,H,Tq]), lse, Δ and dO are f32; q, k and v keep
# their dtype.  The plain versions keep the rounding points of the
# reference's ``_flash_partial_kernel`` (:577) and of ``_dq_accum`` and
# ``_dkv_accum`` (:299, :321) as the partial kernels call them.

def _partial_scores(q, k, scale, causal, q_offset, k_offset):
    """s = q·kᵀ·scale in f32 [B,H,Tq,Tk], -1e9 where a global row may not
    see a global key."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if not causal:
        return s
    rows = q_offset + torch.arange(q.shape[-2], device=q.device)
    keys = k_offset + torch.arange(k.shape[-2], device=q.device)
    return s.masked_fill(rows[:, None] < keys[None, :], NEG_INF)


def plain_attention_partial(q, k, v, acc, m, l, *, q_offset: int,
                            k_offset: int, scale: float,
                            causal: bool = False):
    """Plain version of :func:`flash_attention_partial`: the state
    (acc, m, l) with this chunk merged in by the online softmax (P cast to
    v's dtype before P·V).  A causal chunk that no row sees leaves the
    state as it was."""
    if causal and q_offset + q.shape[-2] - 1 < k_offset:
        return acc, m, l
    s = _partial_scores(q, k, scale, causal, q_offset, k_offset)
    m_new = torch.maximum(m, s.amax(-1))
    p = torch.exp(s - m_new[..., None])
    alpha = torch.exp(m - m_new)
    l_new = l * alpha + p.sum(-1)
    acc_new = acc * alpha[..., None] + torch.matmul(
        p.to(v.dtype).float(), v.float())
    return acc_new, m_new, l_new


def _partial_p_and_ds(q, k, v, do, lse, delta, scale, causal, q_offset,
                      k_offset):
    """P = exp(s − lse) and dS = P ∘ (dO·Vᵀ − Δ), f32 [B,H,Tq,Tk], with the
    whole sequence's lse and Δ [B,H,Tq]."""
    s = _partial_scores(q, k, scale, causal, q_offset, k_offset)
    p = torch.exp(s - lse[..., None])
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    return p, p * (dp - delta[..., None])


def plain_attention_dq_partial(q, k, v, do, lse, delta, *, q_offset: int,
                               k_offset: int, scale: float,
                               causal: bool = False):
    """Plain version of :func:`flash_attention_dq_partial`: this chunk's
    dQ in f32, scale · dS·K with dS cast to K's dtype first."""
    _, ds = _partial_p_and_ds(q, k, v, do, lse, delta, scale, causal,
                              q_offset, k_offset)
    return torch.matmul(ds.to(k.dtype).float(), k.float()) * scale


def plain_attention_dkv_partial(q, k, v, do, lse, delta, *, q_offset: int,
                                k_offset: int, scale: float,
                                causal: bool = False):
    """Plain version of :func:`flash_attention_dkv_partial`: this chunk's
    ``(dK, dV)`` in f32, dV = Pᵀ·dO with P cast to dO's dtype (f32) and
    dK = scale · dSᵀ·Q with dS cast to Q's dtype."""
    p, ds = _partial_p_and_ds(q, k, v, do, lse, delta, scale, causal,
                              q_offset, k_offset)
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), do.float())
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2),
                      q.float()) * scale
    return dk, dv


_PARTIAL_FWD_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
                         + [ctypes.c_longlong] * 9
                         + [ctypes.c_float] + [ctypes.c_int] * 3
                         + [ctypes.c_void_p])
_PARTIAL_BWD_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                         + [ctypes.c_longlong] * 12
                         + [ctypes.c_float] + [ctypes.c_int] * 3
                         + [ctypes.c_void_p])


def _check_f32(label, t, shape, device):
    if (tuple(t.shape) != tuple(shape) or t.dtype != torch.float32
            or t.device != device or not t.is_contiguous()):
        raise ValueError(f"{label} must be a contiguous f32 tensor of shape "
                         f"{tuple(shape)} on {device}; got "
                         f"{tuple(t.shape)} {t.dtype} {t.device}")


def _check_offsets(q_offset, k_offset):
    for label, x in (("q_offset", q_offset), ("k_offset", k_offset)):
        if not 0 <= int(x) < 2 ** 30:
            raise ValueError(f"{label} {x} is not a position in [0, 2^30)")


def partial_route(dtype, aligned: bool = True) -> str:
    """Which merge kernel (#5) runs for q, k, v of ``dtype``:
    ``"tensor_core"`` (``flash_fwd_tc_kernel<true>``: bf16 operands, f32
    sums on mma.sync) for bfloat16 rows that start on 16 bytes
    (:func:`rows_aligned`), ``"scalar"`` (the f32-FMA template) for
    float32, whose operands the tensor cores would round, and for bf16
    rows that do not."""
    if dtype == torch.bfloat16:
        return "tensor_core" if aligned else "scalar"
    if dtype == torch.float32:
        return "scalar"
    raise TypeError(f"the partial merge takes float32 or bfloat16, not "
                    f"{dtype}")


def flash_attention_partial(q, k, v, acc, m, l, *, q_offset: int,
                            k_offset: int, scale: float,
                            causal: bool = False):
    """Launch kernel #5 on CUDA tensors: merge the visiting chunk k, v
    [B,H,Tk,D] into the state (acc [B,H,Tq,D], m, l [B,H,Tq], contiguous
    f32) of the rows q [B,H,Tq,D]; returns the new state in new tensors.
    q, k, v are read through their strides (head dim contiguous).  bf16
    takes the tensor-core route where its rows start on 16 bytes, else the
    scalar one (:func:`partial_route`); ``flash_attention_partial.routes``
    counts each.  Raises on anything the kernel does not take; never falls
    back to the plain version."""
    _check_inputs(q, k, v, None)
    _check_offsets(q_offset, k_offset)
    b, h, tq, d = q.shape
    tk = k.shape[2]
    for label, t, shape in (("acc", acc, (b, h, tq, d)), ("m", m, (b, h, tq)),
                            ("l", l, (b, h, tq))):
        _check_f32(label, t, shape, q.device)
    route = partial_route(q.dtype, rows_aligned(q, k, v))
    out = tuple(torch.empty_like(t) for t in (acc, m, l))
    fn = _bind("flash_attention_fwd", "flash_attention_partial",
               _PARTIAL_FWD_ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), acc.data_ptr(),
                m.data_ptr(), l.data_ptr(), *(t.data_ptr() for t in out),
                int(q.dtype == torch.bfloat16),
                int(route == "tensor_core"), b, h, tq, tk, d,
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                float(scale), int(bool(causal)), int(q_offset),
                int(k_offset), stream)
    _raise_on(rc, "flash_attention_partial")
    flash_attention_partial.launches += 1
    flash_attention_partial.routes[route] += 1
    return out


flash_attention_partial.launches = 0
flash_attention_partial.routes = {"tensor_core": 0, "scalar": 0}


def _launch_partial_bwd(name, q, k, v, do, lse, delta, out0, out1, scale,
                        causal, q_offset, k_offset, route="scalar"):
    """Check the partial backward's inputs and launch kernel ``name`` by
    ``route``."""
    _check_inputs(q, k, v, None)
    _check_offsets(q_offset, k_offset)
    b, h, tq, d = q.shape
    if (do.shape != q.shape or do.dtype != torch.float32
            or do.device != q.device or do.stride(-1) != 1):
        raise ValueError(f"dO must be f32 with q's shape and a contiguous "
                         f"head dim: {tuple(do.shape)} {do.dtype} "
                         f"{do.device} stride {do.stride()}")
    for label, t in (("lse", lse), ("delta", delta)):
        _check_f32(label, t, (b, h, tq), q.device)
    fn = _bind("flash_attention_bwd", name, _PARTIAL_BWD_ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), out0.data_ptr(),
                None if out1 is None else out1.data_ptr(),
                int(q.dtype == torch.bfloat16), int(route == "tensor_core"),
                b, h, tq, k.shape[2], d,
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                *do.stride()[:3], float(scale), int(bool(causal)),
                int(q_offset), int(k_offset), stream)
    _raise_on(rc, name)


def dq_partial_route(dtype, aligned: bool = True) -> str:
    """Which ring dQ kernel (#6) runs for q, k, v of ``dtype`` (dO is
    f32): ``"tensor_core"`` (``flash_dq_tc_kernel<D, true>``: #2's loop
    with dO in three bf16 pieces, so dP keeps f32's precision) for
    bfloat16 where every row of q, k, v and dO starts on 16 bytes
    (:func:`rows_aligned`), ``"scalar"`` (the f32-FMA template) for
    float32 and for bf16 rows that do not."""
    if dtype == torch.bfloat16:
        return "tensor_core" if aligned else "scalar"
    if dtype == torch.float32:
        return "scalar"
    raise TypeError(f"the ring dQ kernel takes float32 or bfloat16, not "
                    f"{dtype}")


def flash_attention_dq_partial(q, k, v, do, lse, delta, *, q_offset: int,
                               k_offset: int, scale: float,
                               causal: bool = False):
    """Launch kernel #6 on CUDA tensors: the visiting chunk's dQ
    contribution, f32 [B,H,Tq,D].  dO is f32 [B,H,Tq,D]; lse and Δ are the
    whole sequence's rows of q, contiguous f32 [B,H,Tq].  bf16 takes the
    tensor-core route where every row starts on 16 bytes, else the scalar
    one (:func:`dq_partial_route`); ``flash_attention_dq_partial.routes``
    counts each."""
    route = dq_partial_route(q.dtype, rows_aligned(q, k, v, do))
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    _launch_partial_bwd("flash_attention_dq_partial", q, k, v, do, lse,
                        delta, dq, None, scale, causal, q_offset, k_offset,
                        route)
    flash_attention_dq_partial.launches += 1
    flash_attention_dq_partial.routes[route] += 1
    return dq


flash_attention_dq_partial.launches = 0
flash_attention_dq_partial.routes = {"tensor_core": 0, "scalar": 0}


def dkv_partial_route(dtype, aligned: bool = True) -> str:
    """Which ring dK/dV kernel (#7) runs for q, k, v of ``dtype`` (dO is
    f32): ``"tensor_core"`` (``flash_dkv_partial_tc_kernel``: dO and P in
    three bf16 pieces each, so the f32 products keep f32's precision) for
    bfloat16 where every row of q, k, v and dO starts on 16 bytes
    (:func:`rows_aligned`), ``"scalar"`` (the f32-FMA template) for
    float32 and for bf16 rows that do not."""
    if dtype == torch.bfloat16:
        return "tensor_core" if aligned else "scalar"
    if dtype == torch.float32:
        return "scalar"
    raise TypeError(f"the ring dK/dV kernel takes float32 or bfloat16, not "
                    f"{dtype}")


def flash_attention_dkv_partial(q, k, v, do, lse, delta, *, q_offset: int,
                                k_offset: int, scale: float,
                                causal: bool = False):
    """Launch kernel #7 on CUDA tensors: ``(dK, dV)`` of the visiting
    chunk against these rows' q and dO, f32 [B,H,Tk,D].  bf16 takes the
    tensor-core route where every row starts on 16 bytes, else the scalar
    one (:func:`dkv_partial_route`); ``flash_attention_dkv_partial.routes``
    counts each."""
    route = dkv_partial_route(q.dtype, rows_aligned(q, k, v, do))
    dk = torch.empty(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.empty(v.shape, dtype=torch.float32, device=v.device)
    _launch_partial_bwd("flash_attention_dkv_partial", q, k, v, do, lse,
                        delta, dk, dv, scale, causal, q_offset, k_offset,
                        route)
    flash_attention_dkv_partial.launches += 1
    flash_attention_dkv_partial.routes[route] += 1
    return dk, dv


flash_attention_dkv_partial.launches = 0
flash_attention_dkv_partial.routes = {"tensor_core": 0, "scalar": 0}

# the ring's kernels and their plain versions, looked up at each call
_RING_KERNELS = (flash_attention_partial, flash_attention_dq_partial,
                 flash_attention_dkv_partial)
_RING_PLAIN = (plain_attention_partial, plain_attention_dq_partial,
               plain_attention_dkv_partial)


class _FlashAttention(torch.autograd.Function):
    """Forward kernel #1, backward kernels #2 and #3, and #4 only when
    the bias needs a gradient (the reference runs it as a separate
    ``pallas_call`` that jit drops for a constant mask).  On CPU tensors
    the plain versions stand in, only because the tensors are there."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale, causal, causal_offset):
        fwd = (_KERNELS if q.device.type == "cuda" else _PLAIN)[0]
        out, lse = fwd(q, k, v, bias, scale=scale, causal=causal,
                       causal_offset=causal_offset)
        ctx.save_for_backward(q, k, v, bias, out, lse)
        ctx.cfg = dict(scale=scale, causal=causal,
                       causal_offset=causal_offset)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias, out, lse = ctx.saved_tensors
        _, dq_fn, dkv_fn, dbias_fn = (_KERNELS if q.device.type == "cuda"
                                      else _PLAIN)
        if do.stride(-1) != 1:   # the kernels read only a contiguous head dim
            do = do.contiguous()
        do = do.to(q.dtype)
        delta = attention_delta(out, do)
        args = (q, k, v, bias, do, lse, delta)
        need_q, need_k, need_v, need_bias = ctx.needs_input_grad[:4]
        dq = dq_fn(*args, **ctx.cfg) if need_q else None
        dk = dv = None
        if need_k or need_v:
            dk, dv = dkv_fn(*args, **ctx.cfg)
        dbias = None
        if bias is not None and need_bias:
            dbias = fold_bias_grad(dbias_fn(*args, **ctx.cfg), bias,
                                   q.shape[0], q.shape[1])
        return dq, dk, dv, dbias, None, None, None


def flash_attention_with_grad(q, k, v, bias=None, *, scale: float,
                              causal: bool = False, causal_offset: int = 0):
    """Attention through the autograd Function: the kernels on CUDA
    tensors (forward #1; backward #2, #3 and, when the bias needs a
    gradient, #4), their plain versions on CPU tensors."""
    return _FlashAttention.apply(q, k, v, bias, float(scale), bool(causal),
                                 int(causal_offset))


def _kernel_attention(q, k, v, bias, scale, causal, causal_offset):
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (q, k, v, bias)):
        return flash_attention_with_grad(q, k, v, bias, scale=scale,
                                         causal=causal,
                                         causal_offset=causal_offset)
    return flash_attention_fwd(q, k, v, bias, scale=scale, causal=causal,
                               causal_offset=causal_offset)[0]


def flash_attention(q, k, v, bias=None, *, causal: bool = False,
                    scale: Optional[float] = None):
    """The kernels with the reference's contract: the causal mask is
    start-aligned, so a causal call with tq != tk is refused rather than
    silently diverging from the end-aligned plain version.  CUDA tensors
    only: there is no interpret mode for a CUDA kernel."""
    tq, tk = q.shape[-2], k.shape[-2]
    if causal and tq != tk:
        raise ValueError("flash_attention causal requires tq == tk")
    if scale is None:
        scale = _default_scale(q.shape[-1])
    _check_inputs(q, k, v, bias)   # a CPU tensor raises here, before the
    return _kernel_attention(q, k, v, bias, scale, causal, 0)  # Function


def dot_product_attention(q, k, v, bias=None, *, causal: bool = False,
                          scale: Optional[float] = None,
                          force: Optional[str] = None):
    """Public attention entry (used by nn.Attention and TransformerLM).
    A CUDA tensor goes to the kernels on every call, with the causal
    offset ``tk - tq`` so the result equals :func:`plain_attention`; when
    a gradient is wanted, through :func:`flash_attention_with_grad`.  A
    CPU tensor goes to :func:`plain_attention` (autograd differentiates
    it).  ``force="flash"`` calls :func:`flash_attention` whatever the
    device (a CPU tensor then raises); ``force="plain"`` (the reference's
    ``"xla"``) calls :func:`plain_attention`."""
    if force not in (None, "flash", "plain"):
        raise ValueError(
            f"force must be None, 'flash' or 'plain', got {force!r}")
    if force == "flash":
        return flash_attention(q, k, v, bias, causal=causal, scale=scale)
    if force == "plain" or q.device.type == "cpu":
        return plain_attention(q, k, v, bias, causal=causal, scale=scale)
    if scale is None:
        scale = _default_scale(q.shape[-1])
    return _kernel_attention(q, k, v, bias, scale, causal,
                             k.shape[-2] - q.shape[-2])
