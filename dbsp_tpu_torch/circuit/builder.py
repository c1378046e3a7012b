"""Circuit construction: streams, nodes, edges and the per-circuit cache.
Counterpart of ``dbsp_tpu/circuit/builder.py`` for a root circuit without
nested clocks or feedback. The graph lives on the host;
the values on its streams are batches of device tensors, and each operator
launches its own device work."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from dbsp_tpu_torch.circuit.operator import (
    BinaryOperator, NaryOperator, Operator, SinkOperator, SourceOperator,
    UnaryOperator)


class CircuitError(RuntimeError):
    """A malformed circuit construction or use."""


class Stream:
    """An edge of the circuit carrying one value per clock tick. Operator
    sugar (``map_rows``/``join_index``/``aggregate``/...) is attached by
    the ``dbsp_tpu_torch.operators`` package. ``schema`` — the (key
    dtypes, val dtypes) of the batches on this edge — lives on the node."""

    def __init__(self, circuit: "Circuit", node_index: int):
        self.circuit = circuit
        self.node_index = node_index

    @property
    def node(self) -> "Node":
        return self.circuit.nodes[self.node_index]

    @property
    def schema(self):
        return self.node.schema

    @schema.setter
    def schema(self, value) -> None:
        self.node.schema = value

    def __repr__(self):
        return f"Stream({self.node_index}:{self.node.operator.name})"


@dataclasses.dataclass
class Node:
    """One scheduled unit: an operator plus its input streams."""

    index: int
    operator: Operator
    kind: str  # "source" | "unary" | "binary" | "nary" | "sink"
    inputs: List[int] = dataclasses.field(default_factory=list)
    schema: Optional[Tuple] = None


class Circuit:
    """A dataflow circuit under one logical clock whose state lives on
    ``device``."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.nodes: List[Node] = []
        self._values: Dict[int, Any] = {}
        # shared sub-streams (e.g. one trace per source stream)
        self.cache: Dict[Any, Any] = {}
        self._executor = None

    def _add_node(self, op: Operator, kind: str, inputs: List[int]) -> Node:
        node = Node(index=len(self.nodes), operator=op, kind=kind,
                    inputs=list(inputs))
        self.nodes.append(node)
        self._executor = None  # invalidate the schedule
        return node

    def _check_stream(self, s: Stream) -> None:
        if s.circuit is not self:
            raise CircuitError(f"stream {s} belongs to a different circuit")

    def add_source(self, op: SourceOperator) -> Stream:
        return Stream(self, self._add_node(op, "source", []).index)

    def add_unary_operator(self, op: UnaryOperator, s: Stream) -> Stream:
        self._check_stream(s)
        return Stream(self, self._add_node(op, "unary", [s.node_index]).index)

    def add_binary_operator(self, op: BinaryOperator, a: Stream, b: Stream
                            ) -> Stream:
        self._check_stream(a)
        self._check_stream(b)
        return Stream(self, self._add_node(
            op, "binary", [a.node_index, b.node_index]).index)

    def add_nary_operator(self, op: NaryOperator, streams: Sequence[Stream]
                          ) -> Stream:
        for s in streams:
            self._check_stream(s)
        return Stream(self, self._add_node(
            op, "nary", [s.node_index for s in streams]).index)

    def add_sink(self, op: SinkOperator, s: Stream) -> None:
        self._check_stream(s)
        self._add_node(op, "sink", [s.node_index])

    def step(self) -> None:
        """Evaluate every node exactly once (one tick)."""
        from dbsp_tpu_torch.circuit.scheduler import OnceExecutor

        if self._executor is None:
            self._executor = OnceExecutor(self)
        self._executor.run(self)


class RootCircuit(Circuit):
    """Top-level circuit under the root clock (one tick == one input
    delta)."""

    @staticmethod
    def build(constructor: Callable[["RootCircuit"], Any], *, device
              ) -> Tuple["RootCircuit", Any]:
        """Construct the dataflow from ``constructor``; returns the circuit
        and the constructor's result (typically input/output handles)."""
        circuit = RootCircuit(device)
        return circuit, constructor(circuit)
