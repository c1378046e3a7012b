"""Linear and basic operators: apply, inspect, plus / minus / neg, the
n-ary sum and the generator source. Counterpart of
``dbsp_tpu/operators/basic.py`` for one worker."""

from __future__ import annotations

from typing import Any, Callable, List, Sequence

from dbsp_tpu_torch.circuit.builder import Stream
from dbsp_tpu_torch.circuit.operator import (
    BinaryOperator, NaryOperator, SinkOperator, SourceOperator, UnaryOperator)
from dbsp_tpu_torch.operators.registry import stream_method
from dbsp_tpu_torch.zset.batch import Batch, concat_batches


def group_add(a: Any, b: Any) -> Any:
    """Group addition on stream values: Z-set addition for batches, ``+``
    otherwise."""
    if isinstance(a, Batch):
        return a.add(b)
    return a + b


def group_neg(a: Any) -> Any:
    if isinstance(a, Batch):
        return a.neg()
    return -a


class Apply(UnaryOperator):
    def __init__(self, fn: Callable[[Any], Any], name: str = "apply"):
        self.fn = fn
        self.name = name

    def eval(self, v):
        return self.fn(v)


class Apply2(BinaryOperator):
    def __init__(self, fn: Callable[[Any, Any], Any], name: str = "apply2"):
        self.fn = fn
        self.name = name

    def eval(self, a, b):
        return self.fn(a, b)


class Inspect(SinkOperator):
    name = "inspect"

    def __init__(self, cb: Callable[[Any], None]):
        self.cb = cb

    def eval(self, v):
        self.cb(v)


class Plus(BinaryOperator):
    name = "plus"

    def eval(self, a, b):
        return group_add(a, b)


class Minus(BinaryOperator):
    name = "minus"

    def eval(self, a, b):
        return group_add(a, group_neg(b))


class Neg(UnaryOperator):
    name = "neg"

    def eval(self, a):
        return group_neg(a)


class SumN(NaryOperator):
    """N-ary Z-set sum: one concatenation and one consolidation, not a
    chain of pairwise additions."""

    name = "sum"

    def eval(self, *vals):
        batches = [v for v in vals if isinstance(v, Batch)]
        if len(batches) == len(vals):
            return concat_batches(batches).consolidate()
        out = vals[0]
        for v in vals[1:]:
            out = group_add(out, v)
        return out


class Generator(SourceOperator):
    """Test source: yields the values of a host list one per tick, then
    ``default`` forever (it raises when exhausted without one)."""

    name = "generator"

    def __init__(self, values: Sequence[Any], default: Any = None):
        self.values: List[Any] = list(values)
        self.pos = 0
        self.default = default

    def eval(self):
        if self.pos < len(self.values):
            v = self.values[self.pos]
            self.pos += 1
            return v
        if self.default is not None:
            return self.default
        raise StopIteration("Generator exhausted and no default value set")


# -- Stream sugar -----------------------------------------------------------


@stream_method
def apply(self: Stream, fn, name: str = "apply") -> Stream:
    return self.circuit.add_unary_operator(Apply(fn, name), self)


@stream_method
def apply2(self: Stream, other: Stream, fn, name: str = "apply2") -> Stream:
    return self.circuit.add_binary_operator(Apply2(fn, name), self, other)


@stream_method
def inspect(self: Stream, cb) -> Stream:
    self.circuit.add_sink(Inspect(cb), self)
    return self


def _with_schema(out: Stream, like: Stream) -> Stream:
    out.schema = like.schema
    return out


@stream_method
def plus(self: Stream, other: Stream) -> Stream:
    return _with_schema(
        self.circuit.add_binary_operator(Plus(), self, other), self)


@stream_method
def minus(self: Stream, other: Stream) -> Stream:
    return _with_schema(
        self.circuit.add_binary_operator(Minus(), self, other), self)


@stream_method
def neg(self: Stream) -> Stream:
    return _with_schema(self.circuit.add_unary_operator(Neg(), self), self)


@stream_method
def sum_with(self: Stream, others: Sequence[Stream]) -> Stream:
    return _with_schema(
        self.circuit.add_nary_operator(SumN(), [self, *others]), self)
