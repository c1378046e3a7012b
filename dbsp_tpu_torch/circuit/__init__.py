from dbsp_tpu_torch.circuit.builder import (
    Circuit, CircuitError, RootCircuit, Stream)
from dbsp_tpu_torch.circuit.operator import (
    BinaryOperator, NaryOperator, Operator, SinkOperator, SourceOperator,
    UnaryOperator)
from dbsp_tpu_torch.circuit.runtime import (CircuitHandle, Runtime,
                                            resolve_device)

__all__ = [
    "Circuit", "CircuitError", "RootCircuit", "Stream", "Operator",
    "SourceOperator", "SinkOperator", "UnaryOperator", "BinaryOperator",
    "NaryOperator",
    "CircuitHandle", "Runtime", "resolve_device",
]
