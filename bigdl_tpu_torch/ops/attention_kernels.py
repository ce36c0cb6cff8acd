"""Scaled dot-product attention: the plain version, the CUDA kernel's
wrapper, and the dispatch between them.

Counterpart of ``bigdl_tpu/ops/attention_kernels.py``.  Shapes follow
[batch, heads, length, head_dim] ("BHTD").

* :func:`plain_attention` — materialised attention in plain PyTorch (the
  counterpart of ``xla_attention``): the reference the kernel is held to,
  and what the dispatch runs for CPU tensors.
* :func:`flash_attention_fwd` — the wrapper of the hand-written CUDA
  kernel ``csrc/flash_attention_fwd.cu`` (which replaces the Pallas
  ``_fwd_impl``/``_flash_fwd_kernel``).  It counts its launches in
  ``flash_attention_fwd.launches``.
* :func:`flash_attention` — the kernel with the reference's causal
  contract: start-aligned, so a causal call needs tq == tk.
* :func:`dot_product_attention` — the public entry.  On a CUDA tensor
  EVERY call goes to the kernel: the reference's rule (Tq and Tk
  multiples of 128, D a multiple of 8) was a tiling constraint of the
  Pallas kernel, and this kernel masks its ragged edges itself.  For a
  causal call it passes the diagonal offset tk - tq, so it equals
  ``plain_attention`` (whose causal mask is end-aligned) on every shape.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from bigdl_tpu_torch.ops.build import load_library

__all__ = ["plain_attention", "flash_attention_fwd", "flash_attention",
           "dot_product_attention", "NEG_INF"]

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
    if b * h >= 2 ** 31 or (tq + 15) // 16 > 65535:
        raise ValueError("attention grid too large for one launch")
    if bias is not None and bias.device != q.device:
        raise ValueError("bias must be on q's device")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (q, k, v, bias)):
        raise NotImplementedError(
            "the flash-attention backward kernels are not ported yet; run "
            "the CUDA forward under torch.no_grad()")


_kernel = None


def _kernel_fn():
    """The C entry point, built and bound at first use (never at
    import: the CPU tests import this module without a CUDA toolkit)."""
    global _kernel
    if _kernel is None:
        fn = load_library("flash_attention_fwd").flash_attention_fwd
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                       + [ctypes.c_longlong] * 13
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _kernel = fn
    return _kernel


def flash_attention_fwd(q, k, v, bias=None, *, scale: float,
                        causal: bool = False, causal_offset: int = 0):
    """Launch the CUDA forward kernel on CUDA tensors.  Returns
    ``(out [B, H, Tq, D] in q's dtype, lse f32 [B*H, Tq])``.

    q, k, v may have any strides on the batch, head and time dims (the
    head dim must be contiguous); bias is broadcast by strides, never
    materialised per head.  The causal mask admits key j for row i when
    ``j <= i + causal_offset``.  Raises on anything the kernel does not
    take; never falls back to the plain version."""
    _check_inputs(q, k, v, bias)
    b, h, tq, d = q.shape
    tk = k.shape[2]
    if bias is not None:
        if bias.dtype != torch.float32:
            bias = bias.float()     # the small, un-broadcast bias
        bias = bias.expand(b, h, tq, tk)
        b_ptr, b_strides = bias.data_ptr(), bias.stride()
    else:
        b_ptr, b_strides = None, (0, 0, 0, 0)
    out = torch.empty((b, h, tq, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, tq), dtype=torch.float32, device=q.device)
    fn = _kernel_fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), b_ptr,
                out.data_ptr(), lse.data_ptr(),
                int(q.dtype == torch.bfloat16), b, h, tq, tk, d,
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                *b_strides, float(scale), int(bool(causal)),
                int(causal_offset), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed with CUDA "
                           f"error {rc}")
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0


def flash_attention(q, k, v, bias=None, *, causal: bool = False,
                    scale: Optional[float] = None):
    """The kernel with the reference's contract: its causal mask is
    start-aligned, so a causal call with tq != tk is refused rather than
    silently diverging from the end-aligned plain version.  CUDA tensors
    only: there is no interpret mode for a CUDA kernel."""
    tq, tk = q.shape[-2], k.shape[-2]
    if causal and tq != tk:
        raise ValueError("flash_attention causal requires tq == tk")
    if scale is None:
        scale = _default_scale(q.shape[-1])
    return flash_attention_fwd(q, k, v, bias, scale=scale, causal=causal,
                               causal_offset=0)[0]


def dot_product_attention(q, k, v, bias=None, *, causal: bool = False,
                          scale: Optional[float] = None,
                          force: Optional[str] = None):
    """Public attention entry (used by nn.Attention and TransformerLM).
    A CUDA tensor goes to the kernel on every call, with the causal
    offset ``tk - tq`` so the result equals :func:`plain_attention`; a
    CPU tensor goes to :func:`plain_attention`.  ``force="flash"`` calls
    :func:`flash_attention` whatever the device (a CPU tensor then
    raises); ``force="plain"`` (the reference's ``"xla"``) calls
    :func:`plain_attention`."""
    if force not in (None, "flash", "plain"):
        raise ValueError(
            f"force must be None, 'flash' or 'plain', got {force!r}")
    if force == "flash":
        return flash_attention(q, k, v, bias, causal=causal, scale=scale)
    if force == "plain" or q.device.type == "cpu":
        return plain_attention(q, k, v, bias, causal=causal, scale=scale)
    if scale is None:
        scale = _default_scale(q.shape[-1])
    return flash_attention_fwd(q, k, v, bias, scale=scale, causal=causal,
                               causal_offset=k.shape[-2] - q.shape[-2])[0]
