"""The static scheduler: a topological node order, evaluated once per
tick. Counterpart of ``dbsp_tpu/circuit/scheduler.py`` (root circuits
only: no nested clocks, no feedback)."""

from __future__ import annotations

from typing import List

from dbsp_tpu_torch.circuit.builder import Circuit, CircuitError, Node


def static_schedule(circuit: Circuit) -> List[Node]:
    """Topological order; FIFO keeps sources first and sinks last."""
    nodes = circuit.nodes
    indeg = [len(n.inputs) for n in nodes]
    consumers: List[List[int]] = [[] for _ in nodes]
    for n in nodes:
        for i in n.inputs:
            consumers[i].append(n.index)
    ready = [n.index for n in nodes if indeg[n.index] == 0]
    order: List[Node] = []
    while ready:
        idx = ready.pop(0)
        order.append(nodes[idx])
        for c in consumers[idx]:
            indeg[c] -= 1
            if indeg[c] == 0:
                ready.append(c)
    if len(order) != len(nodes):
        raise CircuitError("circuit has a cycle")
    return order


class OnceExecutor:
    """Evaluate each node exactly once per tick."""

    def __init__(self, circuit: Circuit):
        self.order = static_schedule(circuit)

    def run(self, circuit: Circuit) -> None:
        values = circuit._values
        for node in self.order:
            args = [values[i] for i in node.inputs]
            out = node.operator.eval(*args)
            if node.kind != "sink":
                values[node.index] = out
        values.clear()
