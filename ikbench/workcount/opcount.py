"""Count the FP32 operations a scalar computation needs, by tracing it.

A verbatim copy of ``optik_tpu_torch/ops/opcount.py`` at commit d444d89,
for ``ops.py``.

The structure-of-arrays math of ``soa.py`` (beside this file) is written
over scalars that may be lane tensors or static Python floats.  A
:class:`Sym` is a third kind of scalar: it carries one concrete value and a
node in an expression graph, so running ``soa.residual_and_jtask`` on
``Sym`` inputs records every operation the function performs on them, with
the chain's static 0 / +-1 terms already folded by ``smul`` / ``sadd``.

What the count leaves out, so that it is what the *function* needs and not
what one implementation of it executes:

* the side of a ``torch.where`` that the traced values do not select (the
  node depends on its condition and on the live side only);
* a repeated subexpression (nodes are hash-consed, commutative operands in
  one order);
* everything no output depends on.

Every add, subtract, multiply, divide, floor, sqrt and rsqrt counts 1 (so a
fused multiply-add is 2); negation, abs, max, compares, logic and selects
count 0.
"""

from __future__ import annotations

import math

import torch

_COMMUTATIVE = ("add", "mul", "and", "or")


class Trace:
    """An expression graph: ``nodes[i] = (cost, ids of operand nodes)``."""

    def __init__(self):
        self.nodes = []
        self._index = {}

    def leaf(self, name: str, val: float) -> "Sym":
        return self._node(("leaf", name), 0, (), val)

    def _node(self, key, cost, deps, val) -> "Sym":
        i = self._index.get(key)
        if i is None:
            i = len(self.nodes)
            self._index[key] = i
            self.nodes.append((cost, deps))
        return Sym(self, i, val)

    def op(self, name, cost, args, val) -> "Sym":
        """The node of ``name(*args)``; args are Syms or Python constants."""
        keys = [("n", a.id) if isinstance(a, Sym) else ("c", float(a))
                for a in args]
        if name in _COMMUTATIVE:
            keys.sort()
        deps = tuple(a.id for a in args if isinstance(a, Sym))
        return self._node((name, *keys), cost, deps, val)

    def cost(self, outputs) -> int:
        """Operations the ``outputs`` (Syms; constants are skipped) need."""
        seen, todo, total = set(), [o.id for o in outputs
                                    if isinstance(o, Sym)], 0
        while todo:
            i = todo.pop()
            if i in seen:
                continue
            seen.add(i)
            c, deps = self.nodes[i]
            total += c
            todo.extend(deps)
        return total


def _val(x):
    return x.val if isinstance(x, Sym) else x


class Sym:
    """A traced scalar: a concrete value (float or bool) and its node."""

    __slots__ = ("trace", "id", "val")

    def __init__(self, trace: Trace, node_id: int, val):
        self.trace, self.id, self.val = trace, node_id, val

    __hash__ = object.__hash__

    def _bin(self, name, a, b, val, cost=1):
        return self.trace.op(name, cost, (a, b), val)

    def __add__(self, o):
        if not isinstance(o, Sym) and o == 0:
            return self
        return self._bin("add", self, o, self.val + _val(o))

    __radd__ = __add__

    def __sub__(self, o):
        if not isinstance(o, Sym) and o == 0:
            return self
        return self._bin("sub", self, o, self.val - _val(o))

    def __rsub__(self, o):
        if o == 0:
            return -self
        return self._bin("sub", o, self, o - self.val)

    def __mul__(self, o):
        if not isinstance(o, Sym):
            if o == 1:
                return self
            if o == -1:
                return -self
            if o == 0:
                return 0.0
        return self._bin("mul", self, o, self.val * _val(o))

    __rmul__ = __mul__

    def __truediv__(self, o):
        if not isinstance(o, Sym) and o == 1:
            return self
        return self._bin("div", self, o, self.val / _val(o))

    def __rtruediv__(self, o):
        return self._bin("div", o, self, o / self.val)

    def __neg__(self):
        return self.trace.op("neg", 0, (self,), -self.val)

    def abs(self):
        return self.trace.op("abs", 0, (self,), abs(self.val))

    def clamp_min(self, lo):
        return self._bin("max", self, lo, max(self.val, lo), cost=0)

    def __gt__(self, o):
        return self._bin("gt", self, o, self.val > _val(o), cost=0)

    def __ge__(self, o):
        return self._bin("ge", self, o, self.val >= _val(o), cost=0)

    def __lt__(self, o):
        return self._bin("lt", self, o, self.val < _val(o), cost=0)

    def __le__(self, o):
        return self._bin("le", self, o, self.val <= _val(o), cost=0)

    def __eq__(self, o):
        return self._bin("eq", self, o, self.val == _val(o), cost=0)

    def __and__(self, o):
        return self._bin("and", self, o, bool(self.val and _val(o)), cost=0)

    def __or__(self, o):
        return self._bin("or", self, o, bool(self.val or _val(o)), cost=0)

    def __invert__(self):
        return self.trace.op("not", 0, (self,), not self.val)

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        if func is torch.where:
            cond, a, b = args
            live = a if cond.val else b
            return cond.trace.op("select", 0, (cond, live), _val(live))
        if func is torch.zeros_like:
            return 0.0
        x = args[0]
        if func is torch.floor:
            return x.trace.op("floor", 1, (x,), float(math.floor(x.val)))
        if func is torch.sqrt:
            return x.trace.op("sqrt", 1, (x,), math.sqrt(x.val))
        if func is torch.rsqrt:
            return x.trace.op("rsqrt", 1, (x,), 1.0 / math.sqrt(x.val))
        raise TypeError(f"{func} is not traced")
