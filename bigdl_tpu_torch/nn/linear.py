"""Dense and parameterized elementwise layers (counterpart of
``bigdl_tpu/nn/linear.py``, every class).

Weight layout stays Torch-style (out, in).  Initial values are drawn
from the caller's ``torch.Generator`` on its device (a CPU generator, so
one seed gives the same weights whatever the device; a CUDA generator
draws on the card) and then moved to ``device``; they
follow the reference's distributions, not its bits.  ``init_weight`` /
``init_bias`` give them as they are.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from bigdl_tpu_torch.core.device import resolve_device
from bigdl_tpu_torch.core.module import Module

__all__ = [
    "Linear", "Bilinear", "Add", "Mul", "CMul", "CAdd", "Cosine",
    "Euclidean", "LookupTable", "Maxout", "Highway", "Identity", "Echo",
]


def _uniform(shape, bound: float, generator: Optional[torch.Generator]):
    if generator is None:
        raise ValueError("a random initial value needs generator= (or "
                         "init_weight= / init_bias=)")
    # drawn where the generator lives: a CUDA generator draws on the card
    return (torch.rand(shape, generator=generator, device=generator.device)
            * 2.0 - 1.0) * bound


def _given(value, shape, what: str) -> torch.Tensor:
    t = torch.as_tensor(value, dtype=torch.float32).detach().clone().cpu()
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what} has shape {tuple(t.shape)}, not "
                         f"{tuple(shape)}")
    return t


class Linear(Module):
    """y = x W^T + b.  W ~ U(-1/sqrt(in), 1/sqrt(in)) (the reference's
    default ``RandomUniform``) unless an ``init_method`` of
    :mod:`bigdl_tpu_torch.core.init` or an ``init_weight`` is given; b ~
    U(-1/sqrt(in), 1/sqrt(in)) unless ``init_bias`` is.
    ``w_regularizer``/``b_regularizer`` (``optim/regularizer.py``) are
    applied to the gradients by the ``Optimizer``'s step."""

    def __init__(self, input_size: int, output_size: int,
                 with_bias: bool = True, w_regularizer=None,
                 b_regularizer=None, *,
                 generator: Optional[torch.Generator] = None,
                 device=None, init_method=None, init_weight=None,
                 init_bias=None):
        super().__init__()
        dev = resolve_device(device)
        self.w_regularizer = w_regularizer
        self.b_regularizer = b_regularizer
        self.input_size = input_size
        self.output_size = output_size
        self.with_bias = with_bias
        bound = 1.0 / math.sqrt(max(input_size, 1))
        if init_weight is not None:
            weight = _given(init_weight, (output_size, input_size),
                            "init_weight")
        elif init_method is None:
            weight = _uniform((output_size, input_size), bound, generator)
        else:
            weight = init_method((output_size, input_size),
                                 generator=generator, fan_in=input_size,
                                 fan_out=output_size)
        self.weight = nn.Parameter(weight.to(dev))
        if with_bias:
            bias = (_given(init_bias, (output_size,), "init_bias")
                    if init_bias is not None
                    else _uniform((output_size,), bound, generator))
            self.bias = nn.Parameter(bias.to(dev))
        else:
            self.register_parameter("bias", None)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class Identity(Module):
    """Pass-through (reference nn/Identity.scala): one input as it is,
    several as a tuple."""

    def forward(self, *xs):
        return xs[0] if len(xs) == 1 else xs


class Echo(Module):
    """Identity that prints the activation's shape and dtype (reference
    nn/Echo.scala)."""

    def forward(self, x):
        shape = tuple(x.shape) if hasattr(x, "shape") else None
        print(f"[Echo {self.name}] shape={shape} "
              f"dtype={getattr(x, 'dtype', None)}")
        return x


class Bilinear(Module):
    """y_k = x1^T W_k x2 + b_k over a two-tensor table (reference
    nn/Bilinear.scala); W (out, in1, in2) and b ~ U(-1/sqrt(in1),
    1/sqrt(in1)).  The regularizer arguments are accepted and unused, as
    in the reference."""

    def __init__(self, input_size1: int, input_size2: int, output_size: int,
                 bias_res: bool = True, w_regularizer=None,
                 b_regularizer=None, *, generator: torch.Generator,
                 device=None):
        super().__init__()
        dev = resolve_device(device)
        self.bias_res = bias_res
        stdv = 1.0 / math.sqrt(input_size1)
        self.weight = nn.Parameter(_uniform(
            (output_size, input_size1, input_size2), stdv, generator).to(dev))
        if bias_res:
            self.bias = nn.Parameter(
                _uniform((output_size,), stdv, generator).to(dev))
        else:
            self.register_parameter("bias", None)

    def forward(self, inputs):
        x1, x2 = inputs[0], inputs[1]
        y = torch.einsum("bi,oij,bj->bo", x1, self.weight, x2)
        return y + self.bias if self.bias_res else y


class Add(Module):
    """A learnable per-element bias (reference nn/Add.scala); ~
    U(-1/sqrt(n), 1/sqrt(n))."""

    def __init__(self, input_size: int, *, generator: torch.Generator,
                 device=None):
        super().__init__()
        self.bias = nn.Parameter(_uniform(
            (input_size,), 1.0 / math.sqrt(input_size), generator).to(
                resolve_device(device)))

    def forward(self, x):
        return x + self.bias


class Mul(Module):
    """A single learnable scalar gain (reference nn/Mul.scala); ~ U(-1,
    1)."""

    def __init__(self, *, generator: torch.Generator, device=None):
        super().__init__()
        self.weight = nn.Parameter(_uniform((1,), 1.0, generator).to(
            resolve_device(device)))

    def forward(self, x):
        return x * self.weight[0]


class CMul(Module):
    """A learnable componentwise gain broadcast over the batch (reference
    nn/CMul.scala); weight ~ U(-1/sqrt(n), 1/sqrt(n)), n its size."""

    def __init__(self, size, *, generator: torch.Generator, device=None):
        super().__init__()
        size = tuple(size)
        self.weight = nn.Parameter(_uniform(
            size, 1.0 / math.sqrt(math.prod(size)), generator).to(
                resolve_device(device)))

    def forward(self, x):
        return x * self.weight


class CAdd(Module):
    """A learnable componentwise bias (reference nn/CAdd.scala); bias ~
    U(-1/sqrt(n), 1/sqrt(n)).  ``b_regularizer`` is accepted and unused,
    as in the reference."""

    def __init__(self, size, b_regularizer=None, *,
                 generator: torch.Generator, device=None):
        super().__init__()
        size = tuple(size)
        self.bias = nn.Parameter(_uniform(
            size, 1.0 / math.sqrt(math.prod(size)), generator).to(
                resolve_device(device)))

    def forward(self, x):
        return x + self.bias


class Cosine(Module):
    """The cosine similarity of the input to each weight row (reference
    nn/Cosine.scala); W (out, in) ~ U(-1/sqrt(in), 1/sqrt(in))."""

    def __init__(self, input_size: int, output_size: int, *,
                 generator: torch.Generator, device=None):
        super().__init__()
        self.weight = nn.Parameter(_uniform(
            (output_size, input_size), 1.0 / math.sqrt(input_size),
            generator).to(resolve_device(device)))

    def forward(self, x):
        xn = x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-12)
        wn = self.weight / (torch.linalg.vector_norm(
            self.weight, dim=-1, keepdim=True) + 1e-12)
        return xn @ wn.T


class Euclidean(Module):
    """The L2 distance of the input to each weight row (reference
    nn/Euclidean.scala); W (out, in) ~ U(-1/sqrt(in), 1/sqrt(in)).
    ``fast_backward`` is accepted and changes nothing, as in the
    reference."""

    def __init__(self, input_size: int, output_size: int,
                 fast_backward: bool = True, *, generator: torch.Generator,
                 device=None):
        super().__init__()
        self.weight = nn.Parameter(_uniform(
            (output_size, input_size), 1.0 / math.sqrt(input_size),
            generator).to(resolve_device(device)))

    def forward(self, x):
        diff = x[:, None, :] - self.weight[None, :, :]
        return torch.linalg.vector_norm(diff, dim=-1)


class LookupTable(Module):
    """Embedding lookup (reference nn/LookupTable.scala); indices are
    1-based (the reference/Torch convention) and clipped into range.
    Weight ~ N(0, 1).  With a finite ``max_norm`` every row is scaled by
    min(1, max_norm / (its ``norm_type``-norm + 1e-7)) inside the forward,
    differentiated through; with ``mask_zero`` and a ``padding_value``
    other than 0 the rows of indices equal to it are zeroed.
    ``should_scale_grad_by_freq`` and ``w_regularizer`` are accepted and
    unused, as in the reference."""

    def __init__(self, n_index: int, n_output: int,
                 padding_value: float = 0.0,
                 max_norm: float = float("inf"), norm_type: float = 2.0,
                 should_scale_grad_by_freq: bool = False,
                 w_regularizer=None, mask_zero: bool = False, *,
                 generator: torch.Generator, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.n_index, self.n_output = n_index, n_output
        self.padding_value = padding_value
        self.max_norm = max_norm
        self.norm_type = norm_type
        self.mask_zero = mask_zero
        self.weight = nn.Parameter(
            torch.randn((n_index, n_output), generator=generator).to(dev))

    def forward(self, indices):
        indices = torch.as_tensor(indices, device=self.weight.device)
        idx = (indices.long() - 1).clamp(0, self.n_index - 1)
        w = self.weight
        if self.max_norm != float("inf"):
            norms = torch.linalg.vector_norm(w, ord=self.norm_type, dim=1,
                                             keepdim=True)
            w = w * torch.clamp(self.max_norm / (norms + 1e-7), max=1.0)
        out = w[idx]
        if self.mask_zero and self.padding_value != 0:
            mask = indices != self.padding_value
            out = out * mask[..., None].to(out.dtype)
        return out


class Maxout(Module):
    """A Linear to ``maxout_number`` pieces of ``output_size``, the max
    over the pieces (reference nn/Maxout.scala)."""

    def __init__(self, input_size: int, output_size: int, maxout_number: int,
                 with_bias: bool = True, w_regularizer=None,
                 b_regularizer=None, init_weight=None, init_bias=None, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.output_size = output_size
        self.maxout_number = maxout_number
        self.layer = Linear(input_size, output_size * maxout_number,
                            with_bias=with_bias, init_weight=init_weight,
                            init_bias=init_bias, generator=generator,
                            device=device)

    def forward(self, x):
        y = self.layer(x)
        y = y.reshape(y.shape[:-1] + (self.maxout_number, self.output_size))
        return y.amax(dim=-2)


class Highway(Module):
    """A highway layer, t * g(W_h x) + (1 - t) * x with t = sigmoid(W_t x)
    (reference nn/Highway.scala): ``gate`` and ``transform`` Linears, an
    optional ``activation`` g."""

    def __init__(self, size: int, with_bias: bool = True,
                 activation: Optional[nn.Module] = None, w_regularizer=None,
                 b_regularizer=None, *, generator: torch.Generator,
                 device=None):
        super().__init__()
        self.gate = Linear(size, size, with_bias=with_bias,
                           generator=generator, device=device)
        self.transform = Linear(size, size, with_bias=with_bias,
                                generator=generator, device=device)
        self.activation = activation

    def forward(self, x):
        t = torch.sigmoid(self.gate(x))
        h = self.transform(x)
        if self.activation is not None:
            h = self.activation(h)
        return t * h + (1.0 - t) * x
