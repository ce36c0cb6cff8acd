"""Tree-structured LSTMs (counterpart of ``bigdl_tpu/nn/tree.py``).

A batch of B trees is encoded as node arrays in children-first order,
as the reference's:

* ``children (B, N, 2)``: the left and right children's slots, or -1
  (none, a leaf);
* ``leaf_ids (B, N)``: a leaf's position in the token sequence, -1 for an
  internal node.

Every child's slot is below its parent's (post-order satisfies this).
Padding slots (children and leaf id all -1, after the real nodes) carry
the previous slot's state forward, so ``output[:, -1]`` is every tree's
root in a ragged batch.  Where the reference runs one ``fori_loop`` over
the slots, vmapped over the trees, the port runs one Python loop over the
slots, each step batched over the B trees: a gather reads the children's
states from a (B, N + 1, H) tensor whose slot N is the zero state of
"none", and an out-of-place ``index_copy`` writes the new state, so no
tensor autograd saved is changed.  The loop reads nothing back to the
host, so a dispatch window captures it as a CUDA graph.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from bigdl_tpu_torch.core.device import resolve_device
from bigdl_tpu_torch.core.module import Module

__all__ = ["TreeLSTM", "BinaryTreeLSTM"]


class TreeLSTM(Module):
    """The tree-LSTM protocol (reference nn/TreeLSTM.scala): a subclass
    implements ``compose(child_h, child_c, leaf_x, is_leaf)`` over a
    batch of nodes (child states (B, 2, H), leaf inputs (B, in), is_leaf
    (B, 1)) -> (h, c), each (B, H)."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size

    def compose(self, child_h, child_c, leaf_x, is_leaf):
        raise NotImplementedError

    def forward(self, inputs):
        """``(x (B, T, in), children (B, N, 2), leaf_ids (B, N))`` -> the
        hidden states (B, N, hidden)."""
        x, children, leaf_ids = inputs
        children = torch.as_tensor(children, device=x.device).long()
        leaf_ids = torch.as_tensor(leaf_ids, device=x.device).long()
        b, n = children.shape[:2]
        hidden = self.hidden_size
        rows = torch.arange(b, device=x.device)
        slots = torch.arange(n, device=x.device)
        kids = torch.where(children < 0, n, children)      # -1 -> "none"
        is_leaf = (leaf_ids >= 0)[..., None]
        is_pad = ((leaf_ids < 0) & (children[..., 0] < 0)
                  & (children[..., 1] < 0))[..., None]
        leaf_pos = leaf_ids.clamp(0, x.shape[1] - 1)
        h = x.new_zeros((b, n + 1, hidden))
        c = x.new_zeros((b, n + 1, hidden))
        for i in range(n):
            kid = kids[:, i, :, None].expand(b, 2, hidden)
            nh, nc = self.compose(h.gather(1, kid), c.gather(1, kid),
                                  x[rows, leaf_pos[:, i]], is_leaf[:, i])
            prev = max(i - 1, 0)
            nh = torch.where(is_pad[:, i], h[:, prev], nh)
            nc = torch.where(is_pad[:, i], c[:, prev], nc)
            h = h.index_copy(1, slots[i:i + 1], nh[:, None])
            c = c.index_copy(1, slots[i:i + 1], nc[:, None])
        return h[:, :n]


class BinaryTreeLSTM(TreeLSTM):
    """The constituency binary tree-LSTM (reference
    nn/BinaryTreeLSTM.scala): a leaf runs an input transform (``leaf_w``
    (2H, in), ``leaf_b``: c and the output gate), an internal node
    composes its children (``comp_w`` (5H, 2H), ``comp_b``: the input
    gate, the left and right forget gates, the update and the output
    gate), all ~ U(-1/sqrt(H), 1/sqrt(H)).  ``with_graph`` is accepted
    and changes nothing, as in the reference."""

    def __init__(self, input_size: int, hidden_size: int,
                 gate_output: bool = True, with_graph: bool = True, *,
                 generator: torch.Generator, device=None):
        super().__init__(input_size, hidden_size)
        dev = resolve_device(device)
        self.gate_output = gate_output
        hid, d = hidden_size, input_size
        s = 1.0 / math.sqrt(hid)

        def rnd(*shape):
            return nn.Parameter(((torch.rand(shape, generator=generator)
                                  * 2.0 - 1.0) * s).to(dev))

        self.leaf_w = rnd(2 * hid, d)
        self.leaf_b = rnd(2 * hid)
        self.comp_w = rnd(5 * hid, 2 * hid)
        self.comp_b = rnd(5 * hid)

    def compose(self, child_h, child_c, leaf_x, is_leaf):
        hid = self.hidden_size
        proj = leaf_x @ self.leaf_w.T + self.leaf_b
        c_leaf = proj[:, :hid]
        o_leaf = torch.sigmoid(proj[:, hid:])
        h_leaf = o_leaf * torch.tanh(c_leaf) if self.gate_output \
            else torch.tanh(c_leaf)
        g = torch.cat([child_h[:, 0], child_h[:, 1]], dim=-1) \
            @ self.comp_w.T + self.comp_b
        i = torch.sigmoid(g[:, :hid])
        lf = torch.sigmoid(g[:, hid:2 * hid])
        rf = torch.sigmoid(g[:, 2 * hid:3 * hid])
        u = torch.tanh(g[:, 3 * hid:4 * hid])
        o = torch.sigmoid(g[:, 4 * hid:])
        c_int = i * u + lf * child_c[:, 0] + rf * child_c[:, 1]
        h_int = o * torch.tanh(c_int) if self.gate_output \
            else torch.tanh(c_int)
        return (torch.where(is_leaf, h_leaf, h_int),
                torch.where(is_leaf, c_leaf, c_int))
