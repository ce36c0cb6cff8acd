"""Torch-style Table, the ``T()`` DSL (counterpart of
``bigdl_tpu/utils/table.py``; the reference's utils/Table.scala).

A 1-based int-keyed (plus named-key) container, used as multi-tensor
layer IO and as a state or config dict.  The reference registers it as
a JAX pytree so that it flows through jitted forwards; the port has no
trace to flow through, so it is a plain container.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator

__all__ = ["Table", "T"]


class Table:
    """1-based int-keyed (plus named-key) container."""

    def __init__(self, *items, **named):
        self._state: Dict[Any, Any] = {}
        for i, v in enumerate(items):
            self._state[i + 1] = v
        self._state.update(named)

    def __getitem__(self, key):
        return self._state[key]

    def __setitem__(self, key, value):
        self._state[key] = value

    def __contains__(self, key):
        return key in self._state

    def get(self, key, default=None):
        return self._state.get(key, default)

    def length(self) -> int:
        """Count of consecutive int keys from 1 (Table.length)."""
        n = 0
        while (n + 1) in self._state:
            n += 1
        return n

    def insert(self, value) -> "Table":
        self._state[self.length() + 1] = value
        return self

    def remove(self, key=None):
        if key is None:
            key = self.length()
        return self._state.pop(key, None)

    def keys(self):
        return self._state.keys()

    def values(self):
        return self._state.values()

    def items(self):
        return self._state.items()

    def __iter__(self) -> Iterator:
        """Iterate the 1..n array part."""
        for i in range(1, self.length() + 1):
            yield self._state[i]

    def __len__(self):
        return self.length()

    def __eq__(self, other):
        return isinstance(other, Table) and self._state == other._state

    def __repr__(self):
        inner = ", ".join(f"{k}: {v!r}" for k, v in self._state.items())
        return f"T({{{inner}}})"

    def to_tuple(self):
        return tuple(self)


def T(*items, **named) -> Table:
    """The reference's ``T()`` constructor sugar."""
    return Table(*items, **named)
