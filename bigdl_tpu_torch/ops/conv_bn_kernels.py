"""Fused conv+BN+ReLU for bottleneck convnets: the plain versions, the
CUDA kernels' wrappers and the autograd Functions over them.

Counterpart of ``bigdl_tpu/ops/conv_bn_kernels.py``, whose layouts it
keeps: NHWC activations, HWIO weights (a 1x1 weight sliced to [K, N]).

* :func:`fused_matmul_bn` — (normalize → relu → 1x1 conv → batch stats),
  a ``torch.autograd.Function`` whose forward is kernel #8
  (:func:`matmul_bn_fwd`, ``csrc/conv_bn_fwd.cu``, replacing the Pallas
  ``_fused_fwd``/``_fwd_kernel``) and whose backward is kernel #9
  (:func:`matmul_bn_bwd`, ``csrc/conv_bn_bwd.cu``, replacing
  ``_fused_bwd``/``_bwd_kernel``), folding the forward's saved y.
* Four kernels route by dtype: bf16 #8-#11 run on the tensor cores
  (``csrc/conv_bn_tc.cuh``), f32 on scalar kernels
  (:func:`matmul_fwd_route`, :func:`matmul_bwd_route`,
  :func:`conv3x3_fwd_route`, :func:`conv3x3_bwd_route`); their wrappers
  count each route in ``<wrapper>.routes``.
* :func:`fused_conv3x3_bn` — the same around a 3x3 stride-1 SAME conv:
  kernels #10 (:func:`conv3x3_bn_fwd`, replacing ``_conv3_fwd``) and #11
  (:func:`conv3x3_bn_bwd`, replacing ``_conv3_bwd``).
* ``plain_matmul_bn_fwd``/``_bwd`` and ``plain_conv3x3_bn_fwd``/``_bwd``
  — the kernels' plain versions, at the reference's rounding points.  On
  CPU tensors the Functions run them, only because the tensors are
  there; on a card the main path never calls them.  Each wrapper counts
  its launches in ``<wrapper>.launches``.
* :func:`fused_matmul_bn_reference`, :func:`fused_conv3x3_bn_reference`
  and :func:`shifted_batch_stats` — the reference's oracles.

The contract is the reference's ``custom_vjp``: ``kshift`` has a zero
cotangent (the caller detaches it); the statistics outputs are
differentiable and their cotangents (gm, gs) flow into the backward
kernel; dW comes back in W's dtype; with ``norm=None`` dx = dz and the
norm vectors get no gradient.  The C-sized algebra stays outside the
kernels, as in the reference: the factor 2 on gs, and dmean, dscale and
dbeta from the kernels' channel sums.

:func:`fused_block_supported` and :func:`fused_conv3x3_supported`
describe the CUDA kernels' own limits (the TPU's VMEM block pickers are
not ported): the kernels tile any shape and mask their ragged edges, so
only the size of the dW partials and the grid bound them.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.ops.build import load_library

__all__ = ["shifted_batch_stats", "fused_matmul_bn_reference",
           "fused_conv3x3_bn_reference", "fused_block_supported",
           "fused_conv3x3_supported", "fused_matmul_bn", "fused_conv3x3_bn",
           "matmul_bn_fwd", "matmul_bn_bwd", "conv3x3_bn_fwd",
           "conv3x3_bn_bwd", "plain_matmul_bn_fwd", "plain_matmul_bn_bwd",
           "plain_conv3x3_bn_fwd", "plain_conv3x3_bn_bwd", "dw_splits",
           "tc_channels", "conv3x3_fwd_route", "conv3x3_bwd_route",
           "matmul_fwd_route", "matmul_bwd_route", "matmul_fwd_scratch",
           "matmul_bwd_scratch", "tc_split_chunk", "tc_split_plan"]

_SUPPORTED = (torch.float32, torch.bfloat16)
_TILE = 64                        # the kernels' fixed output tile
_MAX_PART_BYTES = 256 * 2 ** 20   # the dW partials' scratch, at most
_TARGET_BLOCKS = 4 * 132          # four blocks per SM of an H100
_MIN_SPLIT_ROWS = 256             # rows a dW split sums, at least
_MAX_GRID_Y = 65535
# the tensor-core routes of #9, #10 and #11 (csrc/conv_bn_tc.cuh)
# the tensor-core routes of #8 and #9 too
_TC_PAD = 64                      # channels of its scratch, rounded up to
_TC_ROWS = 128                    # rows of its product tiles
_TC_MIN_SPLIT_ROWS = 512          # positions a dW split sums, at least
_TC_DEPTH = 32                    # positions in one stage of its dW sum


def _tiles(n: int) -> int:
    return -(-n // _TILE)


# ---- the reference's oracles ------------------------------------------------

def shifted_batch_stats(y, kshift):
    """(sum(y-K), sum((y-K)^2)) in f32 over every axis but the last."""
    yf = y.float() - kshift.float()
    dims = tuple(range(y.dim() - 1))
    return yf.sum(dims), (yf * yf).sum(dims)


def _z(x, norm):
    """relu((x - mean) * scale + beta) in f32, cast to x's dtype."""
    if norm is None:
        return x
    mean, scale, beta = (v.float() for v in norm)
    return torch.relu((x.float() - mean) * scale + beta).to(x.dtype)


@contextlib.contextmanager
def _full_f32():
    """f32 products and convolutions in full f32 (no TF32) on the card,
    whatever the caller's settings; the plain versions do not depend on
    torch's flags."""
    matmul, cudnn = (torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn


def _nchw(t):
    return t.permute(0, 3, 1, 2)


def _oihw(w):
    return w.permute(3, 2, 0, 1)


def _conv3x3_f32(z, w):
    """The 3x3 stride-1 SAME conv of NHWC z with HWIO w, in f32."""
    with _full_f32():
        y = F.conv2d(_nchw(z.float()), _oihw(w.float()), padding=1)
    return y.permute(0, 2, 3, 1)


def fused_matmul_bn_reference(x2d, w2d, norm=None, kshift=None):
    """The unfused op: the normalized input cast to x's dtype before the
    product, y summed in f32 and cast to x's dtype before the
    statistics."""
    with _full_f32():
        y = torch.matmul(_z(x2d, norm).float(), w2d.float()).to(x2d.dtype)
    if kshift is None:
        return y
    return (y, *shifted_batch_stats(y, kshift))


def fused_conv3x3_bn_reference(x4d, w, norm=None, kshift=None):
    """The unfused 3x3 op, at the same rounding points."""
    y = _conv3x3_f32(_z(x4d, norm), w).to(x4d.dtype).contiguous()
    if kshift is None:
        return y
    return (y, *shifted_batch_stats(y, kshift))


# ---- what the kernels take --------------------------------------------------

def dw_splits(rows: int, out_rows: int, cols: int, tile_rows: int = _TILE,
              min_rows: int = _MIN_SPLIT_ROWS) -> int:
    """How many parts the backward kernels split dW's sum over ``rows``
    into: enough ``tile_rows`` x 64 tiles of the [out_rows, cols] dW to
    fill the card, each part summing at least ``min_rows`` rows, the f32
    partials within their budget (one part may pass it at widths near
    fused_conv3x3_supported's limit).  A pure function of the shape, so a
    shape is always summed alike."""
    tiles = -(-out_rows // tile_rows) * _tiles(cols)
    splits = -(-_TARGET_BLOCKS // tiles)
    splits = min(splits, max(1, rows // min_rows),
                 _MAX_PART_BYTES // (out_rows * cols * 4))
    return max(1, splits)


def conv3x3_fwd_route(dtype) -> str:
    """Which kernel #10 runs for inputs of ``dtype``: ``"tensor_core"``
    (a prepass of z, then bf16 operands and f32 sums on mma.sync) for
    bfloat16, ``"scalar"`` (f32 FMAs) for float32, whose operands the
    tensor cores would round.  The C entry picks the same kernel by dtype;
    this names it for the route counter."""
    if dtype == torch.bfloat16:
        return "tensor_core"
    if dtype == torch.float32:
        return "scalar"
    raise TypeError(f"kernel #10 takes float32 or bfloat16, not {dtype}")


def conv3x3_bwd_route(dtype) -> str:
    """Which kernel #11 runs for inputs of ``dtype``: ``"tensor_core"``
    (bf16 operands, f32 sums on mma.sync) for bfloat16, ``"scalar"`` (f32
    FMAs) for float32, whose operands the tensor cores would round."""
    if dtype == torch.bfloat16:
        return "tensor_core"
    if dtype == torch.float32:
        return "scalar"
    raise TypeError(f"kernel #11 takes float32 or bfloat16, not {dtype}")


def matmul_fwd_route(dtype) -> str:
    """Which kernel #8 runs for inputs of ``dtype``: ``"tensor_core"``
    (#10's route with one tap: bf16 operands, f32 sums on mma.sync) for
    bfloat16, ``"scalar"`` (f32 FMAs) for float32, whose operands the
    tensor cores would round.  The C entry picks the same kernel by dtype;
    this names it for the route counter."""
    if dtype == torch.bfloat16:
        return "tensor_core"
    if dtype == torch.float32:
        return "scalar"
    raise TypeError(f"kernel #8 takes float32 or bfloat16, not {dtype}")


def matmul_bwd_route(dtype) -> str:
    """Which kernel #9 runs for inputs of ``dtype``: ``"tensor_core"``
    (the one-tap route of csrc/conv_bn_tc.cuh: bf16 operands, f32 sums on
    mma.sync) for bfloat16, ``"scalar"`` (f32 FMAs) for float32, whose
    operands the tensor cores would round."""
    if dtype == torch.bfloat16:
        return "tensor_core"
    if dtype == torch.float32:
        return "scalar"
    raise TypeError(f"kernel #9 takes float32 or bfloat16, not {dtype}")


def tc_channels(n: int) -> int:
    """A channel count rounded up to the tensor-core route's padding."""
    return -(-n // _TC_PAD) * _TC_PAD


def tc_split_chunk(rows: int, splits: int) -> int:
    """Positions in each part of the tensor-core dW sum: part s adds
    positions [s * chunk, (s + 1) * chunk) of ``rows``, equal parts in
    whole stages of the kernel's 32 positions, the last one short."""
    chunk = -(-rows // splits)
    return -(-chunk // _TC_DEPTH) * _TC_DEPTH


def tc_split_plan(rows: int, out_rows: int, cols: int) -> tuple:
    """``(splits, chunk)`` of a tensor-core dW sum over ``rows`` positions
    into an [out_rows, cols] dW (padded channels): :func:`dw_splits` with
    the route's 128-row tiles, the parts of :func:`tc_split_chunk`, and no
    part past the last position (rounding the parts up to whole stages can
    leave the last few empty; they are dropped)."""
    splits = dw_splits(rows, out_rows, cols, _TC_ROWS, _TC_MIN_SPLIT_ROWS)
    chunk = tc_split_chunk(rows, splits)
    return -(-rows // chunk), chunk


def _grid_ok(rows: int, cols: int) -> bool:
    return rows >= 1 and 1 <= cols and _tiles(cols) <= _MAX_GRID_Y \
        and _tiles(rows) < 2 ** 31


def fused_block_supported(m: int, k: int, n: int,
                          itemsize: int = 2) -> bool:
    """Whether kernels #8/#9 take this (M, K, N) problem in this dtype
    size: any shape whose grid fits one launch and whose [K, N] f32 dW
    partial fits the scratch budget."""
    return (itemsize in (2, 4) and k >= 1 and _grid_ok(m, n)
            and _grid_ok(m, k) and _grid_ok(k, n)
            and k * n * 4 <= _MAX_PART_BYTES)


def fused_conv3x3_supported(h: int, w: int, c: int, co: int,
                            itemsize: int = 2) -> bool:
    """Whether kernels #10/#11 take this 3x3 (per image; any batch whose
    grid fits one launch)."""
    return (itemsize in (2, 4) and min(h, w, c, co) >= 1
            and _tiles(co) <= _MAX_GRID_Y and _tiles(c) <= _MAX_GRID_Y
            and 9 * c * co * 4 <= _MAX_PART_BYTES)


# ---- plain versions of the kernels ------------------------------------------
#
# Each repeats its kernel's arithmetic at the reference's rounding points
# (_fwd_kernel :158, _bwd_kernel :186, _conv3_fwd_kernel :460,
# _conv3_bwd_kernel :510): products upcast to f32 first and summed in
# full f32 whatever torch's TF32 flags, z and the folded dy cast to the
# input's dtype before the products, y cast before the statistics, dW in
# f32 cast to W's dtype, the channel sums on x in f32.

def _vectors(mean, scale, beta, fuse_input):
    return (mean, scale, beta) if fuse_input else None


def plain_matmul_bn_fwd(x, w, mean, scale, beta, kshift, *,
                        fuse_input: bool, emit_stats: bool):
    """Plain version of :func:`matmul_bn_fwd`: ``(y, s1, s2)``, the sums
    None without stats."""
    out = fused_matmul_bn_reference(
        x, w, _vectors(mean, scale, beta, fuse_input),
        kshift if emit_stats else None)
    return out if emit_stats else (out, None, None)


def plain_conv3x3_bn_fwd(x, w, mean, scale, beta, kshift, *,
                         fuse_input: bool, emit_stats: bool):
    """Plain version of :func:`conv3x3_bn_fwd`: ``(y, s1, s2)``."""
    out = fused_conv3x3_bn_reference(
        x, w, _vectors(mean, scale, beta, fuse_input),
        kshift if emit_stats else None)
    return out if emit_stats else (out, None, None)


def _fold(dy, y, kshift, gm, gs, emit_stats):
    """dy + gm + gs * (y - K) in f32 (gs already doubled), cast to dy's
    dtype; dy itself without stats."""
    if not emit_stats:
        return dy
    return (dy.float() + gm + gs * (y.float() - kshift)).to(dy.dtype)


def _input_side(x, dz, mean, scale, beta, fuse_input, dims):
    """(dx, sum du*x, sum du) from dz: du = dz where u > 0."""
    if not fuse_input:
        zeros = torch.zeros(x.shape[-1], device=x.device)
        return dz.to(x.dtype), zeros, zeros.clone()
    xf = x.float()
    u = (xf - mean) * scale + beta
    du = torch.where(u > 0, dz, torch.zeros((), device=dz.device))
    return ((du * scale).to(x.dtype), (du * xf).sum(dims), du.sum(dims))


def plain_matmul_bn_bwd(x, w, mean, scale, beta, kshift, y, dy, gm, gs, *,
                        fuse_input: bool, emit_stats: bool):
    """Plain version of :func:`matmul_bn_bwd`: ``(dx, dw, dsx, dsu)``,
    folding the statistics cotangents with the forward's saved ``y`` (the
    reference recomputes it, :203-205: the same values); ``gs`` is the
    doubled cotangent of s2."""
    z = _z(x, _vectors(mean, scale, beta, fuse_input))
    dyl = _fold(dy, y, kshift, gm, gs, emit_stats).float()
    with _full_f32():
        dw = torch.matmul(z.float().t(), dyl).to(w.dtype)
        dz = torch.matmul(dyl, w.float().t())
    dx, dsx, dsu = _input_side(x, dz, mean, scale, beta, fuse_input, (0,))
    return dx, dw, dsx, dsu


def plain_conv3x3_bn_bwd(x, w, mean, scale, beta, kshift, y, dy, gm, gs, *,
                         fuse_input: bool, emit_stats: bool):
    """Plain version of :func:`conv3x3_bn_bwd`: ``(dx, dw, dsx, dsu)``,
    folding the statistics cotangents with the forward's saved ``y``."""
    z = _z(x, _vectors(mean, scale, beta, fuse_input))
    dyl = _nchw(_fold(dy, y, kshift, gm, gs, emit_stats).float())
    wf = _oihw(w.float())
    with _full_f32():
        dz = torch.nn.grad.conv2d_input(_nchw(x).shape, wf, dyl, padding=1)
        dw = torch.nn.grad.conv2d_weight(_nchw(z.float()), wf.shape, dyl,
                                         padding=1)
    dz = dz.permute(0, 2, 3, 1)
    dx, dsx, dsu = _input_side(x, dz, mean, scale, beta, fuse_input,
                               (0, 1, 2))
    return (dx.contiguous(), dw.permute(2, 3, 1, 0).to(w.dtype).contiguous(),
            dsx, dsu)


# ---- the CUDA kernels' wrappers ---------------------------------------------

def _check(name, tensors, dtype, device):
    for label, t in tensors:
        if not isinstance(t, torch.Tensor):
            raise ValueError(f"{name}: {label} must be a tensor")
        if t.device.type != "cuda":
            raise ValueError(
                f"{name} runs on CUDA tensors; {label} is on {t.device} "
                "(the autograd Functions run the plain versions for CPU "
                "tensors)")
        if t.device != device:
            raise ValueError(f"{name}: {label} is on {t.device}, not "
                             f"{device}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {label} has dtype {t.dtype}, "
                            f"expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")


def _check_main(name, x, w):
    if not isinstance(x, torch.Tensor) or x.dtype not in _SUPPORTED:
        raise TypeError(f"{name}: x has dtype "
                        f"{getattr(x, 'dtype', None)}; the kernel takes "
                        "float32 or bfloat16 tensors")
    _check(name, (("x", x), ("w", w)), x.dtype, x.device)


def _check_vectors(name, device, sizes):
    _check(name, [(label, v) for label, (v, _) in sizes.items()],
           torch.float32, device)
    for label, (v, n) in sizes.items():
        if v.shape != (n,):
            raise ValueError(f"{name}: {label} must have shape ({n},), not "
                             f"{tuple(v.shape)}")


_bound: dict = {}
_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_ARGTYPES = {
    ("conv_bn_fwd", "conv_bn_matmul_fwd"):
        [_P] * 13 + [_I, _L] + [_I] * 6 + [_P],
    ("conv_bn_fwd", "conv_bn_conv3x3_fwd"):
        [_P] * 13 + [_I] * 10 + [_P],
    ("conv_bn_bwd", "conv_bn_matmul_bwd"):
        [_P] * 17 + [_L, _I, _I, _I, _I, _I, _P],
    ("conv_bn_bwd", "conv_bn_matmul_bwd_tc"):
        [_P] * 20 + [_L] + [_I] * 7 + [_L, _P],
    ("conv_bn_bwd", "conv_bn_conv3x3_bwd"):
        [_P] * 17 + [_I] * 8 + [_P],
    ("conv_bn_bwd", "conv_bn_conv3x3_bwd_tc"):
        [_P] * 20 + [_I] * 10 + [_L, _P],
}


def _bind(library: str, name: str):
    """A C entry point, built and bound at first use (never at import:
    the CPU tests import this module without a CUDA toolkit)."""
    key = (library, name)
    fn = _bound.get(key)
    if fn is None:
        fn = getattr(load_library(library), name)
        fn.argtypes = _ARGTYPES[key]
        fn.restype = ctypes.c_int
        _bound[key] = fn
    return fn


def _launch(library, name, device, *args):
    fn = _bind(library, name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {rc}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stats_scratch(rows, n, device, tile_rows=_TILE):
    return (torch.empty((-(-rows // tile_rows), n), dtype=torch.float32,
                        device=device) for _ in range(2))


def matmul_bn_fwd(x, w, mean, scale, beta, kshift, *, fuse_input: bool,
                  emit_stats: bool):
    """Launch kernel #8 on CUDA tensors: x [M, K], w [K, N] (one dtype),
    f32 mean, scale, beta [K] and kshift [N] (zeros where unused).
    Returns ``(y [M, N] in x's dtype, s1, s2)``, the sums f32 [N] or
    None without stats.  bf16 takes the tensor-core route, f32 the scalar
    one (:func:`matmul_fwd_route`); ``matmul_bn_fwd.routes`` counts each.
    Raises on what the kernel does not take."""
    name = "conv_bn_matmul_fwd"
    _check_main(name, x, w)
    m, k = x.shape
    if w.dim() != 2 or w.shape[0] != k:
        raise ValueError(f"{name}: w {tuple(w.shape)} does not match x "
                         f"{tuple(x.shape)}")
    n = w.shape[1]
    _check_vectors(name, x.device, {"mean": (mean, k), "scale": (scale, k),
                                    "beta": (beta, k), "kshift": (kshift, n)})
    if not fused_block_supported(m, k, n, x.element_size()):
        raise ValueError(f"{name} cannot take M={m} K={k} N={n}")
    dev = x.device
    route = matmul_fwd_route(x.dtype)
    kp, np_, z, wp, tile_rows = 0, 0, None, None, _TILE
    if route == "tensor_core":   # z and W padded to 64 channels, or read
        kp, np_, tile_rows = tc_channels(k), tc_channels(n), _TC_ROWS
        own_z, own_w = matmul_fwd_scratch(k, n, fuse_input,
                                          x.data_ptr() % 16 == 0,
                                          w.data_ptr() % 16 == 0)
        z = torch.empty((m, kp), dtype=x.dtype, device=dev) if own_z \
            else None
        wp = torch.empty((kp, np_), dtype=x.dtype, device=dev) if own_w \
            else None
    y = torch.empty((m, n), dtype=x.dtype, device=dev)
    p1, p2 = (_stats_scratch(m, n, dev, tile_rows) if emit_stats
              else (None, None))
    s1, s2 = ((torch.empty(n, device=dev) for _ in range(2))
              if emit_stats else (None, None))
    _launch("conv_bn_fwd", name, dev, x.data_ptr(), w.data_ptr(),
            mean.data_ptr(), scale.data_ptr(), beta.data_ptr(),
            kshift.data_ptr(), y.data_ptr(), _ptr(p1), _ptr(p2), _ptr(s1),
            _ptr(s2), _ptr(z), _ptr(wp), int(x.dtype == torch.bfloat16), m,
            k, n, kp, np_, int(fuse_input), int(emit_stats))
    matmul_bn_fwd.launches += 1
    matmul_bn_fwd.routes[route] += 1
    return y, s1, s2


def matmul_fwd_scratch(k: int, n: int, fuse_input: bool,
                       x_aligned: bool = True,
                       w_aligned: bool = True) -> tuple:
    """Whether #8's tensor-core route needs its own z and padded W: z is
    x itself without a norm where K is a whole number of 64-channel tiles
    and x starts on 16 bytes; W is read in place where K and N are and w
    does.  Else the prepass stores them."""
    own_z = fuse_input or k != tc_channels(k) or not x_aligned
    own_w = k != tc_channels(k) or n != tc_channels(n) or not w_aligned
    return own_z, own_w


matmul_bn_fwd.launches = 0
matmul_bn_fwd.routes = {"tensor_core": 0, "scalar": 0}


def _check_image(name, x, w):
    _check_main(name, x, w)
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[:3]) != (3, 3,
                                                               x.shape[3]):
        raise ValueError(f"{name}: needs x [B, H, W, C] and w [3, 3, C, Co]; "
                         f"got {tuple(x.shape)} and {tuple(w.shape)}")
    b, h, wd, c = x.shape
    co = w.shape[3]
    if b < 1 or not fused_conv3x3_supported(h, wd, c, co, x.element_size()) \
            or not _grid_ok(b * h * wd, max(c, co)):
        raise ValueError(f"{name} cannot take B={b} H={h} W={wd} C={c} "
                         f"Co={co}")
    return b, h, wd, c, co


def conv3x3_bn_fwd(x, w, mean, scale, beta, kshift, *, fuse_input: bool,
                   emit_stats: bool):
    """Launch kernel #10 on CUDA tensors: x [B, H, W, C], w [3, 3, C, Co]
    (one dtype), f32 mean, scale, beta [C] and kshift [Co].  Returns
    ``(y [B, H, W, Co] in x's dtype, s1, s2)``.  bf16 takes the
    tensor-core route, f32 the scalar one (:func:`conv3x3_fwd_route`);
    ``conv3x3_bn_fwd.routes`` counts each."""
    name = "conv_bn_conv3x3_fwd"
    b, h, wd, c, co = _check_image(name, x, w)
    _check_vectors(name, x.device, {"mean": (mean, c), "scale": (scale, c),
                                    "beta": (beta, c),
                                    "kshift": (kshift, co)})
    m, dev = b * h * wd, x.device
    route = conv3x3_fwd_route(x.dtype)
    if route == "tensor_core":  # z and W padded to 64 channels
        cp, cop, tile_rows = tc_channels(c), tc_channels(co), _TC_ROWS
        z = torch.empty((m, cp), dtype=x.dtype, device=dev)
        wp = torch.empty((9, cp, cop), dtype=x.dtype, device=dev)
    else:
        cp, cop, tile_rows, z, wp = 0, 0, _TILE, None, None
    y = torch.empty((b, h, wd, co), dtype=x.dtype, device=dev)
    p1, p2 = (_stats_scratch(m, co, dev, tile_rows) if emit_stats
              else (None, None))
    s1, s2 = ((torch.empty(co, device=dev) for _ in range(2))
              if emit_stats else (None, None))
    _launch("conv_bn_fwd", name, dev, x.data_ptr(), w.data_ptr(),
            mean.data_ptr(), scale.data_ptr(), beta.data_ptr(),
            kshift.data_ptr(), y.data_ptr(), _ptr(p1), _ptr(p2), _ptr(s1),
            _ptr(s2), _ptr(z), _ptr(wp), int(x.dtype == torch.bfloat16), b,
            h, wd, c, co, cp, cop, int(fuse_input), int(emit_stats))
    conv3x3_bn_fwd.launches += 1
    conv3x3_bn_fwd.routes[route] += 1
    return y, s1, s2


conv3x3_bn_fwd.launches = 0
conv3x3_bn_fwd.routes = {"tensor_core": 0, "scalar": 0}


def _grad_outputs(x, w, c, fuse_input, splits, rows_w, cols_w, rows,
                  tile_rows=_TILE):
    """dx, dw, dsx, dsu and the f32 scratch of a backward launch: the dW
    partials [splits, rows_w, cols_w] and, with a norm, the channel
    partials of ``tile_rows``-row tiles."""
    dev = x.device
    part = torch.empty((splits, rows_w, cols_w), dtype=torch.float32,
                       device=dev)
    psx, psu = (_stats_scratch(rows, c, dev, tile_rows) if fuse_input
                else (None, None))
    dsx, dsu = torch.zeros(c, device=dev), torch.zeros(c, device=dev)
    return (torch.empty_like(x), torch.empty_like(w), dsx, dsu, part, psx,
            psu)


def matmul_bn_bwd(x, w, mean, scale, beta, kshift, y, dy, gm, gs, *,
                  fuse_input: bool, emit_stats: bool):
    """Launch kernel #9 on CUDA tensors: the inputs of #8, the forward's
    saved y and dy [M, N] in x's dtype (y is read with stats only) and the
    f32 cotangents gm, gs [N] of s1 and s2 (gs already doubled; zeros
    without stats).  Returns ``(dx [M, K], dw [K, N],
    dsx [K], dsu [K])``: dx and dw in the inputs' dtype, the channel sums
    sum du*x and sum du in f32 (zeros without a norm).  bf16 takes the
    tensor-core route, f32 the scalar one (:func:`matmul_bwd_route`);
    ``matmul_bn_bwd.routes`` counts each."""
    name = "conv_bn_matmul_bwd"
    _check_main(name, x, w)
    m, k = x.shape
    if w.dim() != 2 or w.shape[0] != k:
        raise ValueError(f"{name}: w {tuple(w.shape)} does not match x "
                         f"{tuple(x.shape)}")
    n = w.shape[1]
    _check(name, (("y", y), ("dy", dy)), x.dtype, x.device)
    if y.shape != (m, n) or dy.shape != (m, n):
        raise ValueError(f"{name}: y and dy must be [{m}, {n}]")
    _check_vectors(name, x.device, {
        "mean": (mean, k), "scale": (scale, k), "beta": (beta, k),
        "kshift": (kshift, n), "gm": (gm, n), "gs": (gs, n)})
    if not fused_block_supported(m, k, n, x.element_size()):
        raise ValueError(f"{name} cannot take M={m} K={k} N={n}")
    route = matmul_bwd_route(x.dtype)
    if route == "tensor_core":
        grads = _matmul_bwd_tc(x, w, mean, scale, beta, kshift, y, dy, gm,
                               gs, fuse_input, emit_stats)
    else:
        splits = dw_splits(m, k, n)
        dx, dw, dsx, dsu, part, psx, psu = _grad_outputs(
            x, w, k, fuse_input, splits, k, n, m)
        _launch("conv_bn_bwd", name, x.device, x.data_ptr(), w.data_ptr(),
                mean.data_ptr(), scale.data_ptr(), beta.data_ptr(),
                kshift.data_ptr(), y.data_ptr(), dy.data_ptr(),
                gm.data_ptr(), gs.data_ptr(), dx.data_ptr(), part.data_ptr(),
                dw.data_ptr(), _ptr(psx), _ptr(psu), dsx.data_ptr(),
                dsu.data_ptr(), m, k, n, int(fuse_input), int(emit_stats),
                splits)
        grads = dx, dw, dsx, dsu
    matmul_bn_bwd.launches += 1
    matmul_bn_bwd.routes[route] += 1
    return grads


def _matmul_bwd_tc(x, w, mean, scale, beta, kshift, y, dy, gm, gs,
                   fuse_input, emit_stats):
    """The tensor-core launch of #9 (bf16), its scratch allocated here.  z
    is x itself, and dyl dy itself, where nothing is folded into them and
    their rows are already whole 64-channel tiles on 16 bytes: then the
    kernels read them in place (:func:`matmul_bwd_scratch`)."""
    m, k = x.shape
    n, dev = w.shape[1], x.device
    kp, np_ = tc_channels(k), tc_channels(n)
    splits, chunk = tc_split_plan(m, kp, np_)
    own_z, own_dyl = matmul_bwd_scratch(k, n, fuse_input, emit_stats,
                                        x.data_ptr() % 16 == 0,
                                        dy.data_ptr() % 16 == 0)
    z = torch.empty((m, kp), dtype=x.dtype, device=dev) if own_z else None
    dyl = (torch.empty((m, np_), dtype=x.dtype, device=dev) if own_dyl
           else None)
    wp = torch.empty((kp, np_), dtype=x.dtype, device=dev)
    dx, dw, dsx, dsu, part, psx, psu = _grad_outputs(
        x, w, k, fuse_input, splits, kp, np_, m, _TC_ROWS)
    _launch("conv_bn_bwd", "conv_bn_matmul_bwd_tc", dev, x.data_ptr(),
            w.data_ptr(), mean.data_ptr(), scale.data_ptr(), beta.data_ptr(),
            kshift.data_ptr(), y.data_ptr(), dy.data_ptr(), gm.data_ptr(),
            gs.data_ptr(), dx.data_ptr(), _ptr(z), _ptr(dyl), wp.data_ptr(),
            part.data_ptr(),
            dw.data_ptr(), _ptr(psx), _ptr(psu), dsx.data_ptr(),
            dsu.data_ptr(), m, k, n, int(fuse_input), int(emit_stats),
            splits, kp, np_, chunk)
    return dx, dw, dsx, dsu


def matmul_bwd_scratch(k: int, n: int, fuse_input: bool, emit_stats: bool,
                       x_aligned: bool = True,
                       dy_aligned: bool = True) -> tuple:
    """Whether #9's tensor-core route needs its own z and dyl: z is x
    itself without a norm where K is a whole number of 64-channel tiles
    and x starts on 16 bytes; dyl is dy itself without statistics where N
    is and dy does.  Else the prepass stores them (dyl folded with the
    forward's saved y)."""
    own_z = fuse_input or k != tc_channels(k) or not x_aligned
    own_dyl = emit_stats or n != tc_channels(n) or not dy_aligned
    return own_z, own_dyl


matmul_bn_bwd.launches = 0
matmul_bn_bwd.routes = {"tensor_core": 0, "scalar": 0}


def conv3x3_bn_bwd(x, w, mean, scale, beta, kshift, y, dy, gm, gs, *,
                   fuse_input: bool, emit_stats: bool):
    """Launch kernel #11 on CUDA tensors: the inputs of #10, the forward's
    saved y and dy [B, H, W, Co] in x's dtype, and the f32 cotangents gm,
    gs [Co] (gs doubled).  Returns ``(dx, dw [3, 3, C, Co], dsx [C],
    dsu [C])``.  bf16 takes the tensor-core route, f32 the scalar one
    (:func:`conv3x3_bwd_route`); ``conv3x3_bn_bwd.routes`` counts each."""
    name = "conv_bn_conv3x3_bwd"
    b, h, wd, c, co = _check_image(name, x, w)
    _check(name, (("y", y), ("dy", dy)), x.dtype, x.device)
    if y.shape != (b, h, wd, co) or dy.shape != y.shape:
        raise ValueError(f"{name}: y and dy must be [{b}, {h}, {wd}, {co}]")
    _check_vectors(name, x.device, {
        "mean": (mean, c), "scale": (scale, c), "beta": (beta, c),
        "kshift": (kshift, co), "gm": (gm, co), "gs": (gs, co)})
    m = b * h * wd
    route = conv3x3_bwd_route(x.dtype)
    if route == "tensor_core":
        grads = _conv3x3_bwd_tc(x, w, mean, scale, beta, kshift, y, dy, gm,
                                gs, fuse_input, emit_stats)
    else:
        splits = dw_splits(m, 9 * c, co)
        dx, dw, dsx, dsu, part, psx, psu = _grad_outputs(
            x, w, c, fuse_input, splits, 9 * c, co, m)
        _launch("conv_bn_bwd", name, x.device, x.data_ptr(), w.data_ptr(),
                mean.data_ptr(), scale.data_ptr(), beta.data_ptr(),
                kshift.data_ptr(), y.data_ptr(), dy.data_ptr(),
                gm.data_ptr(), gs.data_ptr(), dx.data_ptr(), part.data_ptr(),
                dw.data_ptr(), _ptr(psx), _ptr(psu), dsx.data_ptr(),
                dsu.data_ptr(), b, h, wd, c, co, int(fuse_input),
                int(emit_stats), splits)
        grads = dx, dw, dsx, dsu
    conv3x3_bn_bwd.launches += 1
    conv3x3_bn_bwd.routes[route] += 1
    return grads


def _conv3x3_bwd_tc(x, w, mean, scale, beta, kshift, y, dy, gm, gs,
                    fuse_input, emit_stats):
    """The tensor-core launch of #11 (bf16), its scratch allocated here."""
    b, h, wd, c = x.shape
    co, m, dev = w.shape[3], b * h * wd, x.device
    cp, cop = tc_channels(c), tc_channels(co)
    splits, chunk = tc_split_plan(m, 9 * cp, cop)
    z = torch.empty((m, cp), dtype=x.dtype, device=dev)
    dyl = torch.empty((m, cop), dtype=x.dtype, device=dev)
    wp = torch.empty((9, cp, cop), dtype=x.dtype, device=dev)
    dx, dw, dsx, dsu, part, psx, psu = _grad_outputs(
        x, w, c, fuse_input, splits, 9 * cp, cop, m, _TC_ROWS)
    _launch("conv_bn_bwd", "conv_bn_conv3x3_bwd_tc", dev, x.data_ptr(),
            w.data_ptr(), mean.data_ptr(), scale.data_ptr(), beta.data_ptr(),
            kshift.data_ptr(), y.data_ptr(), dy.data_ptr(), gm.data_ptr(),
            gs.data_ptr(), dx.data_ptr(), z.data_ptr(), dyl.data_ptr(),
            wp.data_ptr(), part.data_ptr(), dw.data_ptr(), _ptr(psx),
            _ptr(psu), dsx.data_ptr(), dsu.data_ptr(), b, h, wd, c, co,
            int(fuse_input), int(emit_stats), splits, cp, cop, chunk)
    return dx, dw, dsx, dsu


conv3x3_bn_bwd.launches = 0
conv3x3_bn_bwd.routes = {"tensor_core": 0, "scalar": 0}

_KERNELS = (matmul_bn_fwd, matmul_bn_bwd, conv3x3_bn_fwd, conv3x3_bn_bwd)
_PLAIN = (plain_matmul_bn_fwd, plain_matmul_bn_bwd, plain_conv3x3_bn_fwd,
          plain_conv3x3_bn_bwd)


# ---- the autograd Functions -------------------------------------------------

def _ops(x):
    """The kernels for a CUDA tensor, the plain versions for a CPU one."""
    return _KERNELS if x.device.type == "cuda" else _PLAIN


def _cotangents(gm, gs, n, device, emit_stats):
    """gm and the doubled gs in f32 (s1 and s2 are sums, so
    d/dy sum (y-K)^2 = 2 (y-K): the factor 2 is folded in here, as
    _fused_bwd :303-307 does)."""
    if not emit_stats:
        zeros = torch.zeros(n, device=device)
        return zeros, zeros
    return gm.float().contiguous(), (2.0 * gs.float()).contiguous()


def _norm_grads(mean, scale, dsx, dsu, fuse_input):
    """dmean, dscale, dbeta of u = (x - mean) * scale + beta from the
    kernels' channel sums (_fused_bwd :334-343)."""
    if not fuse_input:
        return None, None, None
    return -scale * dsu, dsx - mean * dsu, dsu


class _MatmulBN(torch.autograd.Function):
    """Forward kernel #8, backward kernel #9 (their plain versions on CPU
    tensors); the forward's y is saved for the backward's statistics fold,
    as _Conv3x3BN saves its y.  The reference's 1x1 saves (x, w, mean,
    scale, beta, kshift) and recomputes y (:296, :203-204): the same
    values, since the statistics were taken on the rounded y the forward
    stored, and #8's tensor-core sum is that y only where it is saved."""

    @staticmethod
    def forward(ctx, x, w, mean, scale, beta, kshift, fuse_input,
                emit_stats):
        y, s1, s2 = _ops(x)[0](x, w, mean, scale, beta, kshift,
                               fuse_input=fuse_input, emit_stats=emit_stats)
        ctx.save_for_backward(x, w, mean, scale, beta, kshift, y)
        ctx.flags = dict(fuse_input=fuse_input, emit_stats=emit_stats)
        return (y, s1, s2) if emit_stats else y

    @staticmethod
    def backward(ctx, dy, gm=None, gs=None):
        x, w, mean, scale, beta, kshift, y = ctx.saved_tensors
        fuse, stats = ctx.flags["fuse_input"], ctx.flags["emit_stats"]
        gm, gs = _cotangents(gm, gs, w.shape[1], x.device, stats)
        dx, dw, dsx, dsu = _ops(x)[1](
            x, w, mean, scale, beta, kshift, y, dy.to(x.dtype).contiguous(),
            gm, gs, **ctx.flags)
        return (dx, dw, *_norm_grads(mean, scale, dsx, dsu, fuse), None,
                None, None)


class _Conv3x3BN(torch.autograd.Function):
    """Forward kernel #10, backward kernel #11; the forward's y is saved
    for the backward's statistics fold, as the reference saves it
    (:678)."""

    @staticmethod
    def forward(ctx, x, w, mean, scale, beta, kshift, fuse_input,
                emit_stats):
        y, s1, s2 = _ops(x)[2](x, w, mean, scale, beta, kshift,
                               fuse_input=fuse_input, emit_stats=emit_stats)
        ctx.save_for_backward(x, w, mean, scale, beta, kshift, y)
        ctx.flags = dict(fuse_input=fuse_input, emit_stats=emit_stats)
        return (y, s1, s2) if emit_stats else y

    @staticmethod
    def backward(ctx, dy, gm=None, gs=None):
        x, w, mean, scale, beta, kshift, y = ctx.saved_tensors
        fuse, stats = ctx.flags["fuse_input"], ctx.flags["emit_stats"]
        gm, gs = _cotangents(gm, gs, w.shape[3], x.device, stats)
        dx, dw, dsx, dsu = _ops(x)[3](
            x, w, mean, scale, beta, kshift, y, dy.to(x.dtype).contiguous(),
            gm, gs, **ctx.flags)
        return (dx, dw, *_norm_grads(mean, scale, dsx, dsu, fuse), None,
                None, None)


def _vector(v, n, device):
    if v is None:
        return torch.zeros(n, device=device)
    return v.float().reshape(n).contiguous()


def _apply(fn, x, w, norm, kshift, c, co):
    dev = x.device
    mean, scale, beta = ((_vector(v, c, dev) for v in norm)
                         if norm is not None else
                         (_vector(None, c, dev) for _ in range(3)))
    ks = _vector(None if kshift is None else kshift.detach(), co, dev)
    return fn.apply(x.contiguous(), w.contiguous(), mean, scale, beta, ks,
                    norm is not None, kshift is not None)


def fused_matmul_bn(x2d, w2d, *, norm=None, kshift=None):
    """Fused (normalize → relu → matmul → batch stats) for 1x1 convs.

    x2d: [M, K] pre-normalization activation (NHWC collapsed to rows);
    w2d: [K, N] (the HWIO 1x1 kernel sliced to [Cin, Cout]), x's dtype;
    norm: optional (mean, scale, beta) f32 [K] — the previous BN folded to
      subtract-first form; None feeds x through unchanged;
    kshift: optional [N] shift (the next BN's running_mean); None = no
      statistics.  A constant under autograd (detached here).

    Returns y [M, N] in x's dtype, and with a kshift also (sum(y-K),
    sum((y-K)^2)) f32 [N].  Differentiable in x, w, the norm vectors and
    the statistics.  Kernels #8/#9 on CUDA tensors, their plain versions
    on CPU tensors."""
    m, k = x2d.shape
    if w2d.dim() != 2 or w2d.shape[0] != k:
        raise ValueError(f"w {tuple(w2d.shape)} does not match x "
                         f"{tuple(x2d.shape)}")
    n = w2d.shape[1]
    if not fused_block_supported(m, k, n, x2d.element_size()):
        raise ValueError(f"fused_matmul_bn cannot take M={m} K={k} N={n}; "
                         "use fused_block_supported() to pre-check")
    return _apply(_MatmulBN, x2d, w2d, norm, kshift, k, n)


def fused_conv3x3_bn(x4d, w, *, norm=None, kshift=None):
    """Fused (normalize → relu → 3x3 stride-1 SAME conv → batch stats)
    for NHWC inputs — the bottleneck's conv2.

    x4d: [B, H, W, C]; w: [3, 3, C, Co] (HWIO); norm: optional (mean,
    scale, beta) f32 [C]; kshift: optional [Co] (detached).  Returns y
    [B, H, W, Co] (and the shifted sums with a kshift).  Kernels #10/#11
    on CUDA tensors, their plain versions on CPU tensors."""
    b, h, wd, c = x4d.shape
    if tuple(w.shape[:3]) != (3, 3, c):
        raise ValueError(f"w {tuple(w.shape)} does not match x "
                         f"{tuple(x4d.shape)}")
    co = w.shape[3]
    if not fused_conv3x3_supported(h, wd, c, co, x4d.element_size()):
        raise ValueError(f"fused_conv3x3_bn cannot take H={h} W={wd} C={c} "
                         f"Co={co}; use fused_conv3x3_supported() to "
                         "pre-check")
    return _apply(_Conv3x3BN, x4d, w, norm, kshift, c, co)
