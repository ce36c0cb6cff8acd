"""Recurrent layers: the cells and the time-iteration containers
(counterpart of ``bigdl_tpu/nn/rnn.py``, whole).

Layout [batch, time, feature], the reference's.  A cell's weights keep
the reference's names, shapes and gate order, so its parameters load by
name: ``w_input`` [in, G x H], ``w_hidden`` [H, G x H] (GRU: [H, 2H] and
``w_candidate`` [H, H]), one ``bias`` [G x H], LSTM gates i, f, g, o.
The rounding points are the reference's: a single cell's input
projection ``x @ w_input + bias`` is hoisted over the whole sequence
(``precompute_inputs``, with the cell's input dropout drawn on the whole
sequence first), then ``h @ w_hidden`` is added at each step; GRU
applies its reset gate before the candidate product, ``(r * h) @
w_candidate``.  ``MultiRNNCell`` hoists nothing: each layer projects its
own timestep inside ``step`` through ``step_single``, its input dropout
drawn on that one step.  Time is a Python loop over T (the reference's
``lax.scan``); ``torch.nn.LSTM``/``GRU`` are not used, their two biases
and their order of sums not being the reference's.  Random inits draw
from the caller's ``torch.Generator``; dropout from the forward
context's generator (``core.module.next_generator``).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from bigdl_tpu_torch.core.device import resolve_device
from bigdl_tpu_torch.core.module import Module, dropout
from bigdl_tpu_torch.nn.conv import SpatialConvolution, VolumetricConvolution

__all__ = [
    "Cell", "RnnCell", "RNN", "LSTM", "LSTMPeephole", "GRU",
    "ConvLSTMPeephole", "ConvLSTMPeephole3D",
    "Recurrent", "BiRecurrent", "RecurrentDecoder", "MultiRNNCell",
    "TimeDistributed",
]


def _uniform(shape, bound: float, generator: torch.Generator, dev):
    return nn.Parameter(((torch.rand(shape, generator=generator) * 2.0 - 1.0)
                         * bound).to(dev))


def _zeros(n: int, dev):
    return nn.Parameter(torch.zeros(n, device=dev))


def _act(module, default):
    return default if module is None else module


class Cell(Module):
    """The recurrent-cell protocol (reference nn/Cell.scala): ``step(x_t,
    state) -> (output_t, new_state)`` and ``init_state(batch)``."""

    def init_state(self, batch_size: int, dtype=torch.float32, device=None):
        raise NotImplementedError

    def init_state_for(self, xproj, dtype=torch.float32):
        """The state for a hoisted projection ``xproj`` [B, T, ...]:
        cells whose state has spatial dims take them from it."""
        return self.init_state(xproj.shape[0], dtype, xproj.device)

    def step(self, x_t, state):
        raise NotImplementedError

    def precompute_inputs(self, x):
        """The whole-sequence input projection hoisted out of the time
        loop ([B, T, F] -> [B, T, proj]); by default the identity."""
        return x

    def step_single(self, x_t, state):
        """``step`` on one raw (unprojected) timestep."""
        proj = self.precompute_inputs(x_t[:, None])[:, 0]
        return self.step(proj, state)

    def _input_dropout(self, x, p: float):
        """The input-connection dropout (the reference cells' ``p``),
        drawn from the forward context's generator."""
        if p <= 0.0 or not self.training:
            return x
        return dropout(x, p)

    def forward(self, x, state=None):
        if state is None:
            state = self.init_state(x.shape[0], x.dtype, x.device)
        return self.step_single(x, state)


class RnnCell(Cell):
    """Vanilla RNN: h' = act(x W + h U + b), tanh by default (reference
    nn/RNN.scala RnnCell).  The regularizer arguments and
    ``isInputWithBias`` are accepted and unused, as in the reference."""

    def __init__(self, input_size: int, hidden_size: int,
                 activation: Optional[nn.Module] = None,
                 isInputWithBias: bool = True,
                 w_regularizer=None, u_regularizer=None, b_regularizer=None,
                 *, generator: torch.Generator, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.hidden_size = hidden_size
        stdv = 1.0 / math.sqrt(hidden_size)
        self.w_input = _uniform((input_size, hidden_size), stdv, generator,
                                dev)
        self.w_hidden = _uniform((hidden_size, hidden_size), stdv, generator,
                                 dev)
        self.bias = _zeros(hidden_size, dev)
        self.activation = activation

    def init_state(self, batch_size, dtype=torch.float32, device=None):
        return torch.zeros((batch_size, self.hidden_size), dtype=dtype,
                           device=device)

    def precompute_inputs(self, x):
        return x @ self.w_input + self.bias

    def step(self, xproj_t, h):
        h_new = _act(self.activation, torch.tanh)(xproj_t + h @ self.w_hidden)
        return h_new, h_new


class LSTM(Cell):
    """The standard LSTM (reference nn/LSTM.scala), gates i, f, g, o:
    c' = inner(f) c + inner(i) act(g), h' = inner(o) act(c'); act tanh
    and inner sigmoid by default; ``p`` the input dropout."""

    def __init__(self, input_size: int, hidden_size: int, p: float = 0.0,
                 activation: Optional[nn.Module] = None,
                 inner_activation: Optional[nn.Module] = None,
                 w_regularizer=None, u_regularizer=None, b_regularizer=None,
                 *, generator: torch.Generator, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.hidden_size = hidden_size
        self.p = float(p)
        stdv = 1.0 / math.sqrt(hidden_size)
        self.w_input = _uniform((input_size, 4 * hidden_size), stdv,
                                generator, dev)
        self.w_hidden = _uniform((hidden_size, 4 * hidden_size), stdv,
                                 generator, dev)
        self.bias = _zeros(4 * hidden_size, dev)
        self.activation = activation
        self.inner_activation = inner_activation

    def init_state(self, batch_size, dtype=torch.float32, device=None):
        return (torch.zeros((batch_size, self.hidden_size), dtype=dtype,
                            device=device),
                torch.zeros((batch_size, self.hidden_size), dtype=dtype,
                            device=device))

    def precompute_inputs(self, x):
        x = self._input_dropout(x, self.p)
        return x @ self.w_input + self.bias

    def step(self, xproj_t, state):
        h, c = state
        gates = xproj_t + h @ self.w_hidden
        i, f, g, o = torch.chunk(gates, 4, dim=-1)
        act = _act(self.activation, torch.tanh)
        inner = _act(self.inner_activation, torch.sigmoid)
        c_new = inner(f) * c + inner(i) * act(g)
        h_new = inner(o) * act(c_new)
        return h_new, (h_new, c_new)


class LSTMPeephole(Cell):
    """LSTM with peephole connections from the cell state to the gates
    (reference nn/LSTMPeephole.scala): ``peep_i``, ``peep_f`` on c,
    ``peep_o`` on c'."""

    def __init__(self, input_size: int, hidden_size: int, p: float = 0.0,
                 w_regularizer=None, u_regularizer=None, b_regularizer=None,
                 *, generator: torch.Generator, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.hidden_size = hidden_size
        self.p = float(p)
        stdv = 1.0 / math.sqrt(hidden_size)
        self.w_input = _uniform((input_size, 4 * hidden_size), stdv,
                                generator, dev)
        self.w_hidden = _uniform((hidden_size, 4 * hidden_size), stdv,
                                 generator, dev)
        self.bias = _zeros(4 * hidden_size, dev)
        self.peep_i = _zeros(hidden_size, dev)
        self.peep_f = _zeros(hidden_size, dev)
        self.peep_o = _zeros(hidden_size, dev)

    init_state = LSTM.init_state
    precompute_inputs = LSTM.precompute_inputs

    def step(self, xproj_t, state):
        h, c = state
        gates = xproj_t + h @ self.w_hidden
        i, f, g, o = torch.chunk(gates, 4, dim=-1)
        i = torch.sigmoid(i + self.peep_i * c)
        f = torch.sigmoid(f + self.peep_f * c)
        c_new = f * c + i * torch.tanh(g)
        o = torch.sigmoid(o + self.peep_o * c_new)
        h_new = o * torch.tanh(c_new)
        return h_new, (h_new, c_new)


class GRU(Cell):
    """GRU (reference nn/GRU.scala): r, z = inner(x_rz + h U), g =
    act(x_g + (r h) W_c), h' = (1 - z) g + z h."""

    def __init__(self, input_size: int, output_size: int, p: float = 0.0,
                 activation: Optional[nn.Module] = None,
                 inner_activation: Optional[nn.Module] = None,
                 w_regularizer=None, u_regularizer=None, b_regularizer=None,
                 *, generator: torch.Generator, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.hidden_size = output_size
        self.p = float(p)
        self.activation = activation
        self.inner_activation = inner_activation
        stdv = 1.0 / math.sqrt(output_size)
        self.w_input = _uniform((input_size, 3 * output_size), stdv,
                                generator, dev)
        self.w_hidden = _uniform((output_size, 2 * output_size), stdv,
                                 generator, dev)
        self.w_candidate = _uniform((output_size, output_size), stdv,
                                    generator, dev)
        self.bias = _zeros(3 * output_size, dev)

    init_state = RnnCell.init_state
    precompute_inputs = LSTM.precompute_inputs

    def step(self, xproj_t, h):
        H = self.hidden_size
        inner = _act(self.inner_activation, torch.sigmoid)
        act = _act(self.activation, torch.tanh)
        x_rz, x_g = xproj_t[..., :2 * H], xproj_t[..., 2 * H:]
        r, z = torch.chunk(inner(x_rz + h @ self.w_hidden), 2, dim=-1)
        g = act(x_g + (r * h) @ self.w_candidate)
        h_new = (1 - z) * g + z * h
        return h_new, h_new


class _ConvLSTM(Cell):
    """The gates of the convolutional LSTMs: conv_input hoisted over the
    sequence (time folded into the batch), conv_hidden each step."""

    def _peepholes(self, output_size, with_peephole, dev):
        self.output_size = output_size
        self.with_peephole = with_peephole
        if with_peephole:
            self.peep_i = _zeros(output_size, dev)
            self.peep_f = _zeros(output_size, dev)
            self.peep_o = _zeros(output_size, dev)

    def init_state_for(self, xproj, dtype=torch.float32):
        # the hidden spatial dims follow the (perhaps strided) projection
        return self.init_state(xproj.shape[0], dtype, xproj.device,
                               spatial=tuple(xproj.shape[2:-1]))

    def precompute_inputs(self, x):
        b, t = x.shape[0], x.shape[1]
        proj = self.conv_input(x.reshape((b * t,) + tuple(x.shape[2:])))
        return proj.reshape((b, t) + tuple(proj.shape[1:]))

    def step(self, xproj_t, state):
        h, c = state
        gates = xproj_t + self.conv_hidden(h)
        i, f, g, o = torch.chunk(gates, 4, dim=-1)
        if self.with_peephole:
            i = torch.sigmoid(i + self.peep_i * c)
            f = torch.sigmoid(f + self.peep_f * c)
        else:
            i, f = torch.sigmoid(i), torch.sigmoid(f)
        c_new = f * c + i * torch.tanh(g)
        if self.with_peephole:
            o = torch.sigmoid(o + self.peep_o * c_new)
        else:
            o = torch.sigmoid(o)
        h_new = o * torch.tanh(c_new)
        return h_new, (h_new, c_new)


class ConvLSTMPeephole(_ConvLSTM):
    """Convolutional LSTM over NHWC maps (reference
    nn/ConvLSTMPeephole.scala).  ``padding=-1`` (SAME) or an explicit pad
    on the input conv; the hidden conv is always SAME and has no bias."""

    def __init__(self, input_size: int, output_size: int,
                 kernel_i: int = 3, kernel_c: int = 3, stride: int = 1,
                 padding: int = -1, with_peephole: bool = True,
                 w_regularizer=None, u_regularizer=None, b_regularizer=None,
                 *, generator: torch.Generator, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.conv_input = SpatialConvolution(
            input_size, 4 * output_size, kernel_i, kernel_i,
            stride, stride, padding, padding, **kw)
        self.conv_hidden = SpatialConvolution(
            output_size, 4 * output_size, kernel_c, kernel_c,
            1, 1, -1, -1, with_bias=False, **kw)
        self._peepholes(output_size, with_peephole, resolve_device(device))

    def init_state(self, batch_size, dtype=torch.float32, device=None,
                   spatial: Optional[Tuple[int, int]] = None):
        if spatial is None:
            raise ValueError("ConvLSTMPeephole needs spatial dims; pass "
                             "state explicitly or use Recurrent")
        h, w = spatial
        z = torch.zeros((batch_size, h, w, self.output_size), dtype=dtype,
                        device=device)
        return (z, z)


class ConvLSTMPeephole3D(_ConvLSTM):
    """Volumetric convolutional LSTM over NDHWC maps (reference
    nn/ConvLSTMPeephole3D.scala), the 2-D cell's gates on 3-D convs."""

    def __init__(self, input_size: int, output_size: int,
                 kernel_i: int = 3, kernel_c: int = 3, stride: int = 1,
                 padding: int = -1, with_peephole: bool = True,
                 w_regularizer=None, u_regularizer=None, b_regularizer=None,
                 *, generator: torch.Generator, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.conv_input = VolumetricConvolution(
            input_size, 4 * output_size, kernel_i, kernel_i, kernel_i,
            stride, stride, stride, padding, padding, padding, **kw)
        self.conv_hidden = VolumetricConvolution(
            output_size, 4 * output_size, kernel_c, kernel_c, kernel_c,
            1, 1, 1, -1, -1, -1, with_bias=False, **kw)
        self._peepholes(output_size, with_peephole, resolve_device(device))

    def init_state(self, batch_size, dtype=torch.float32, device=None,
                   spatial=None):
        if spatial is None:
            raise ValueError("ConvLSTMPeephole3D needs (D, H, W) dims")
        d, h, w = spatial
        z = torch.zeros((batch_size, d, h, w, self.output_size), dtype=dtype,
                        device=device)
        return (z, z)


class MultiRNNCell(Cell):
    """A stack of cells applied at each timestep (reference
    nn/MultiRNNCell.scala): no hoisting, each layer projects its own
    timestep through ``step_single``."""

    def __init__(self, cells):
        super().__init__()
        self.cells = nn.ModuleList(list(cells))

    def init_state(self, batch_size, dtype=torch.float32, device=None):
        return tuple(c.init_state(batch_size, dtype, device)
                     for c in self.cells)

    def step(self, x_t, states):
        new_states = []
        out = x_t
        for cell, state in zip(self.cells, states):
            out, s = cell.step_single(out, state)
            new_states.append(s)
        return out, tuple(new_states)


class Recurrent(Module):
    """Iterate a cell over the time axis of [batch, time, ...]
    (reference nn/Recurrent.scala:47): the full output sequence [batch,
    time, hidden]."""

    def __init__(self, cell: Cell):
        super().__init__()
        self.cell = cell

    def forward(self, x, init_state=None):
        cell = self.cell
        xproj = cell.precompute_inputs(x)
        state = cell.init_state_for(xproj, x.dtype) \
            if init_state is None else init_state
        outs = []
        for t in range(xproj.shape[1]):
            out, state = cell.step(xproj[:, t], state)
            outs.append(out)
        return torch.stack(outs, dim=1)


class BiRecurrent(Module):
    """Forward and time-reversed passes merged, by concatenation on the
    last axis unless a ``merge`` module is given (reference
    nn/BiRecurrent.scala).  ``BiRecurrent(cell)`` and
    ``BiRecurrent(cell_a, cell_b)`` also work; the reverse pass runs a
    clone of ``cell`` unless ``cell_reverse`` is given."""

    def __init__(self, merge: Optional[nn.Module] = None,
                 cell: Optional[Cell] = None,
                 cell_reverse: Optional[Cell] = None):
        super().__init__()
        if isinstance(merge, Cell):
            if cell is not None and cell_reverse is None:
                cell_reverse = cell
            merge, cell = None, merge
        if cell is None:
            raise ValueError("BiRecurrent needs a cell: "
                             "BiRecurrent(merge, cell=...) or "
                             "BiRecurrent(cell)")
        self.fwd = Recurrent(cell)
        self.bwd = Recurrent(cell_reverse if cell_reverse is not None
                             else cell.clone())
        if merge is not None:
            self.merge = merge
        self.use_concat = merge is None

    def forward(self, x):
        f = self.fwd(x)
        b = torch.flip(self.bwd(torch.flip(x, dims=(1,))), dims=(1,))
        if self.use_concat:
            return torch.cat([f, b], dim=-1)
        return self.merge((f, b))


class RecurrentDecoder(Module):
    """Feed each output back as the next input for ``output_length``
    steps (reference nn/RecurrentDecoder.scala); the input is the first
    step's [batch, ...]."""

    def __init__(self, output_length: int, cell: Cell = None):
        super().__init__()
        self.output_length = output_length
        self.cell = cell

    def forward(self, x, init_state=None):
        cell = self.cell
        state = cell.init_state(x.shape[0], x.dtype, x.device) \
            if init_state is None else init_state
        inp, outs = x, []
        for _ in range(self.output_length):
            inp, state = cell.step_single(inp, state)
            outs.append(inp)
        return torch.stack(outs, dim=1)


class TimeDistributed(Module):
    """Apply a module at every timestep by folding time into the batch
    (reference nn/TimeDistributed.scala)."""

    def __init__(self, layer: nn.Module):
        super().__init__()
        self.layer = layer

    def forward(self, x):
        b, t = x.shape[0], x.shape[1]
        y = self.layer(x.reshape((b * t,) + tuple(x.shape[2:])))
        return y.reshape((b, t) + tuple(y.shape[1:]))


# the reference's vanilla cell file is nn/RNN.scala (class RnnCell): both
# names resolve
RNN = RnnCell
