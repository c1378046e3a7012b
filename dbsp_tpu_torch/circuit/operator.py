"""Operator traits — the interface every circuit node implements.
Counterpart of ``dbsp_tpu/circuit/operator.py`` for the root clock only
(no lifecycle hooks): arity-specific ``eval`` signatures. ``eval`` takes
and returns host Python values (usually
:class:`~dbsp_tpu_torch.zset.Batch` objects holding device tensors);
operators may keep device-side state such as spines."""

from __future__ import annotations

from typing import Any


class Operator:
    """Base: naming."""

    name: str = "operator"


class SourceOperator(Operator):
    """Produces one value per tick."""

    def eval(self) -> Any:
        raise NotImplementedError


class SinkOperator(Operator):
    def eval(self, value: Any) -> None:
        raise NotImplementedError


class UnaryOperator(Operator):
    def eval(self, value: Any) -> Any:
        raise NotImplementedError


class BinaryOperator(Operator):
    def eval(self, a: Any, b: Any) -> Any:
        raise NotImplementedError


class NaryOperator(Operator):
    def eval(self, *values: Any) -> Any:
        raise NotImplementedError
