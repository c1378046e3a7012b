"""The compiled engine: static-capacity tick programs validated every N
ticks. Counterpart of ``dbsp_tpu/compiled/``."""

from dbsp_tpu_torch.compiled.compiler import (CompiledHandle,
                                              CompiledOverflow,
                                              compile_circuit)

__all__ = ["CompiledHandle", "CompiledOverflow", "compile_circuit"]
