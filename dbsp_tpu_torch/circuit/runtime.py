"""Runtime + handle: the entry points for building and stepping a
circuit. Counterpart of ``dbsp_tpu/circuit/runtime.py`` with ONE worker:
the circuit's state lives on one device, the card unless the caller asks
for the CPU."""

from __future__ import annotations

import time
from typing import Any, Callable, Tuple

import torch

from dbsp_tpu_torch.circuit.builder import Circuit, RootCircuit


def resolve_device(device=None) -> torch.device:
    """``None`` means the card: ``cuda``, which must be available. Any
    other value is taken as given (``"cpu"`` runs the plain versions). A
    CUDA device gets its index, so it compares equal to its tensors'."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' "
                               "to run on the CPU")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


class Runtime:
    """Execution context of a circuit: one worker on one device."""

    def __init__(self, device: torch.device):
        self.device = device

    @staticmethod
    def worker_count() -> int:
        return 1

    @staticmethod
    def init_circuit(workers: int, constructor: Callable[[RootCircuit], Any],
                     device=None) -> Tuple["CircuitHandle", Any]:
        """Build a circuit and return a stepping handle plus the
        constructor's result (the I/O handles). ``device=None`` runs on the
        card and raises if CUDA is absent."""
        if workers != 1:
            raise ValueError(f"the port runs one worker, got {workers}")
        runtime = Runtime(resolve_device(device))
        circuit, result = RootCircuit.build(constructor,
                                            device=runtime.device)
        return CircuitHandle(circuit, runtime), result


class CircuitHandle:
    """Steps a built circuit and records each step's latency."""

    def __init__(self, circuit: Circuit, runtime: Runtime):
        self.circuit = circuit
        self.runtime = runtime
        self.step_times_ns: list[int] = []

    def step(self) -> None:
        """One tick. On a CUDA device the step ends with a synchronize, so
        ``step_times_ns`` holds the time until the device finished."""
        t0 = time.perf_counter_ns()
        self.circuit.step()
        if self.runtime.device.type == "cuda":
            torch.cuda.synchronize(self.runtime.device)
        self.step_times_ns.append(time.perf_counter_ns() - t0)

