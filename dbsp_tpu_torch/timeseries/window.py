"""The window operator: the rows of a stream whose first key column lies
inside moving bounds. Counterpart of ``dbsp_tpu/timeseries/window.py``
(one worker).

Per tick, with the previous bounds [a0, b0) and the new ones [a1, b1)
(monotone: a1 >= a0, b1 >= b0), the output delta is

    out = delta ∩ [a1, b1)                     (new rows inside the window)
        - trace_pre ∩ [a0, min(a1, b0))        (rows that slid out)
        + trace_pre ∩ [max(b0, a1), b1)        (rows that slid in)

A range of a consolidated level is one ``searchsorted`` pair on its first
key column and a masked slice at a capacity that grows on demand, so a
tick costs O(log n + |range delta|).

With ``gc=True`` the operator also truncates the trace below the new
lower bound, which keeps the state proportional to the window's span.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from dbsp_tpu_torch.circuit.builder import Stream
from dbsp_tpu_torch.circuit.operator import BinaryOperator
from dbsp_tpu_torch.operators.registry import require_schema, stream_method
from dbsp_tpu_torch.operators.trace_op import TraceView
from dbsp_tpu_torch.zset import kernels
from dbsp_tpu_torch.zset.batch import Batch, bucket_cap, concat_batches


def _as_key(x, col: torch.Tensor) -> torch.Tensor:
    """Bound ``x`` (a host int or a device scalar) as a 0-d tensor of the
    key column's dtype, as ``jnp.asarray(x, dtype)`` casts it. A host int
    is filled on the device (no host-to-device copy)."""
    if not isinstance(x, torch.Tensor):
        x = torch.full((), x, dtype=torch.int64, device=col.device)
    return x.to(col.dtype)


def _slice_range(level: Batch, a, b, out_cap: int
                 ) -> Tuple[Batch, torch.Tensor]:
    """The rows of a consolidated level whose first key is in [a, b),
    packed at the front of an ``out_cap`` batch, and their count
    (unclamped, a device scalar): a contiguous slice of a consolidated
    level, re-packed with a sentinel tail, is itself one consolidated
    run."""
    k0 = level.keys[0].contiguous()
    lo = torch.searchsorted(k0, _as_key(a, k0), side="left")
    hi = torch.searchsorted(k0, _as_key(b, k0), side="left")
    total = hi - lo
    j = torch.arange(out_cap, device=level.device)
    idx = torch.clamp(lo + j, 0, level.cap - 1)
    dead = j >= total
    cols = tuple(c[idx].masked_fill(dead, kernels.sentinel_scalar(c.dtype))
                 for c in level.cols)
    w = level.weights[idx].masked_fill(dead, 0)
    nk = len(level.keys)
    return Batch(cols[:nk], cols[nk:], w, runs=(out_cap,)), total


def _filter_window(batch: Batch, a, b) -> Batch:
    """The live rows of ``batch`` whose first key is in [a, b), order
    kept."""
    k0 = batch.keys[0]
    keep = (batch.weights != 0) & (k0 >= _as_key(a, k0)) & \
        (k0 < _as_key(b, k0))
    return batch.compacted(keep)


class RangeExtract:
    """Host driver for [a, b) slices across spine levels: a slice capacity
    per level capacity, grown (and the slice taken again) when a range
    holds more rows."""

    def __init__(self):
        self.caps: Dict[int, int] = {}

    def __call__(self, levels, a, b) -> List[Batch]:
        outs = []
        for level in levels:
            cap = self.caps.get(level.cap, 64)
            out, total = _slice_range(level, a, b, cap)
            t = int(total)
            if t > cap:
                cap = bucket_cap(t)
                self.caps[level.cap] = cap
                out, _ = _slice_range(level, a, b, cap)
            outs.append(out)
        return outs


class WindowOp(BinaryOperator):
    name = "window"

    def __init__(self, schema, gc: bool = False):
        self.schema = schema
        self.gc = gc
        self.prev: Optional[Tuple[int, int]] = None
        self._extract = RangeExtract()

    def eval(self, view: TraceView, bounds) -> Batch:
        if bounds is None:
            return Batch.empty(*self.schema, device=view.delta.device)
        a1, b1 = bounds
        a0, b0 = self.prev if self.prev is not None else (a1, a1)
        assert a1 >= a0 and b1 >= b0, (
            f"window bounds must be monotone: {(a0, b0)} -> {(a1, b1)}")
        self.prev = (a1, b1)

        parts = [_filter_window(view.delta, a1, b1)]
        parts += [b.neg() for b in
                  self._extract(view.pre_levels, a0, min(a1, b0))]
        parts += self._extract(view.pre_levels, max(b0, a1), b1)
        out = parts[0] if len(parts) == 1 else \
            concat_batches(parts).consolidate().shrink_to_fit()
        if self.gc:
            view.spine.truncate_keys_below((a1,))
        return out


@stream_method
def window(self: Stream, bounds: Stream, gc: bool = False) -> Stream:
    """Windowed view of this stream: the rows whose first key column is
    inside the (monotone) bounds that ``bounds`` emits this tick.

    ``gc=True`` reclaims the trace's state below the lower bound; enable
    it only where this window is the sole consumer of the stream's
    trace."""
    schema = require_schema(self, "window")
    out = self.circuit.add_binary_operator(WindowOp(schema, gc),
                                           self.trace(), bounds)
    out.schema = schema
    return out
