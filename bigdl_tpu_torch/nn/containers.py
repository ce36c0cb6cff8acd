"""Structural containers (counterpart of ``bigdl_tpu/nn/containers.py``).

A "Table" activity of the reference is a Python tuple here.  A
container keeps its children in ``layers`` (an ``nn.ModuleList``), and a
``Graph`` its modules in ``graph_modules``, in the reference's
topological order, so the reference's ``layers[i]`` and
``graph_modules[i]`` parameters load by name
(``interop/jax_params.py``).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Union

import torch
from torch import nn

from bigdl_tpu_torch.core.module import Input, Module, Node, node_of

__all__ = [
    "Container", "Sequential", "Concat", "ConcatTable", "ParallelTable",
    "MapTable", "Bottle", "Node", "Input", "node_of", "Graph",
]


class Container(Module):
    """Base composite module."""

    def __init__(self, *modules: nn.Module):
        super().__init__()
        self.layers = nn.ModuleList(list(modules))

    def add(self, module: nn.Module) -> "Container":
        self.layers.append(module)
        return self

    def __len__(self):
        return len(self.layers)

    def __getitem__(self, i) -> nn.Module:
        return self.layers[i]


class Sequential(Container):
    """Chain the modules."""

    def forward(self, x):
        for m in self.layers:
            x = m(x)
        return x


class Concat(Container):
    """Each branch on the same input, the outputs concatenated along
    ``dimension`` (1-based, counting the batch dim)."""

    def __init__(self, dimension: int, *modules: nn.Module):
        super().__init__(*modules)
        self.dimension = dimension

    def forward(self, x):
        return torch.cat([m(x) for m in self.layers],
                         dim=self.dimension - 1)


class ConcatTable(Container):
    """Each branch on the same input; the tuple of outputs."""

    def forward(self, x):
        return tuple(m(x) for m in self.layers)


class ParallelTable(Container):
    """The i-th module on the i-th element of the input table."""

    def forward(self, xs):
        return tuple(m(x) for m, x in zip(self.layers, xs))


class MapTable(Container):
    """One shared module on every element of the input table."""

    def __init__(self, module: nn.Module):
        super().__init__(module)

    def forward(self, xs):
        m = self.layers[0]
        return tuple(m(x) for x in xs)


class Bottle(Container):
    """Collapse the leading dims, apply the module, restore them."""

    def __init__(self, module: nn.Module, n_input_dim: int = 2,
                 n_output_dim: int = 2):
        super().__init__(module)
        self.n_input_dim = n_input_dim
        self.n_output_dim = n_output_dim

    def forward(self, x):
        cut = x.dim() - self.n_input_dim + 1
        y = self.layers[0](x.reshape((-1,) + tuple(x.shape[cut:])))
        return y.reshape(tuple(x.shape[:cut]) + tuple(y.shape[1:]))


# ---------------------------------------------------------------------------
# Graph: a DAG of modules run in topological order
# ---------------------------------------------------------------------------

class Graph(Module):
    """A DAG container run in the reference's topological order (a
    depth-first visit from the outputs).  A node with several inputs
    receives them as a tuple; several outputs come back as a tuple."""

    def __init__(self, inputs: Union[Node, Sequence[Node]],
                 outputs: Union[Node, Sequence[Node]]):
        super().__init__()
        input_nodes = [inputs] if isinstance(inputs, Node) else list(inputs)
        output_nodes = ([outputs] if isinstance(outputs, Node)
                        else list(outputs))
        order = self._topo_sort(input_nodes, output_nodes)
        self.exec_order = tuple(n.id for n in order)
        self.node_prevs = tuple(tuple(p.id for p in n.prev) for n in order)
        self.input_ids = tuple(n.id for n in input_nodes)
        self.output_ids = tuple(n.id for n in output_nodes)
        self.graph_modules = nn.ModuleList(
            [n.module for n in order if n.module is not None])
        self.module_node_ids = tuple(
            n.id for n in order if n.module is not None)

    @staticmethod
    def _topo_sort(input_nodes, output_nodes) -> List[Node]:
        visited: Dict[int, Node] = {}
        order: List[Node] = []
        temp = set()

        def visit(n: Node):
            if n.id in visited:
                return
            if n.id in temp:
                raise ValueError("Graph has a cycle")
            temp.add(n.id)
            for p in n.prev:
                visit(p)
            temp.discard(n.id)
            visited[n.id] = n
            order.append(n)

        for out in output_nodes:
            visit(out)
        for inp in input_nodes:
            if inp.id not in visited:
                raise ValueError(
                    f"Input node {inp} is not connected to any output")
        return order

    def forward(self, *xs):
        if len(xs) == 1 and isinstance(xs[0], (tuple, list)) \
                and len(self.input_ids) > 1:
            xs = tuple(xs[0])
        if len(xs) != len(self.input_ids):
            raise ValueError(f"Graph expects {len(self.input_ids)} "
                             f"input(s), got {len(xs)}")
        values: Dict[int, object] = dict(zip(self.input_ids, xs))
        mod_for_node = dict(zip(self.module_node_ids, self.graph_modules))
        for nid, prevs in zip(self.exec_order, self.node_prevs):
            if nid in values and not prevs:
                continue  # an input node
            args = [values[p] for p in prevs]
            m = mod_for_node[nid]
            values[nid] = m(args[0]) if len(args) == 1 else m(tuple(args))
        outs = tuple(values[o] for o in self.output_ids)
        return outs[0] if len(outs) == 1 else outs


# ---------------------------------------------------------------------------
# structural aliases (reference nn/containers.py:225-235): BaseModule (a
# module defined by an inner graph) is any Module holding a Graph;
# DynamicContainer (the add()-accepting base) is Container; DynamicGraph
# (the scheduler-driven executor for control-flow nodes) is Graph, whose
# nodes may hold ops/control.py's modules
# ---------------------------------------------------------------------------

BaseModule = Module
DynamicContainer = Container
DynamicGraph = Graph

__all__ += ["BaseModule", "DynamicContainer", "DynamicGraph"]
