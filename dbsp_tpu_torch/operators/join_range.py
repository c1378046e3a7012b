"""Range joins: each left key matches a contiguous interval of right keys.
Counterpart of ``dbsp_tpu/operators/join_range.py`` (one worker).

:func:`stream_join_range` is the non-incremental per-tick contract: for
every ``(k1, v1, w1)`` in the left batch and ``(k2, v2, w2)`` in the right
batch with ``k2`` in ``[lower(k1), upper(k1))``, emit ``join_func(k1, v1,
k2, v2)`` with weight ``w1 * w2``, joining only the two current tick
batches.

:func:`join_range` is the incremental variant for relative ranges
(``k2`` in ``[k1 + lo_off, k1 + hi_off]``). The inverse of a relative
range is itself one (``k1`` in ``[k2 - hi_off, k2 - lo_off]``), so the
bilinear delta form applies with range probes in both directions::

    Δ(A ⋈r B) = ΔA ⋈r trace(B)  +  trace(A)⁻ ⋈r ΔB

The SQL layer lowers BETWEEN joins onto it.

Probes and expansions are the plain :func:`kernels.lex_probe` and
:func:`kernels.expand_ranges`, as they are XLA operations (not Pallas
kernels) in the reference.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import torch

from dbsp_tpu_torch.circuit.builder import Stream
from dbsp_tpu_torch.circuit.operator import BinaryOperator
from dbsp_tpu_torch.operators.registry import require_schema, stream_method
from dbsp_tpu_torch.operators.trace_op import TraceView
from dbsp_tpu_torch.zset import kernels
from dbsp_tpu_torch.zset.batch import Batch, bucket_cap, concat_batches

# fn(l_key_cols, l_val_cols, r_key_cols, r_val_cols) -> (out_keys, out_vals)
RangeJoinFn = Callable


def _expand_pairs(a: Batch, b: Batch, lo, hi, fn: RangeJoinFn,
                  out_cap: int):
    """Expand the per-row ranges [lo, hi) of ``b`` rows into ``out_cap``
    slots of ``fn``'s output, with weight ``w_a * w_b`` and sentinel
    columns in dead slots; and the unclamped total."""
    row, src, valid, total = kernels.expand_ranges(lo, hi, out_cap)
    # a dead slot's source index may lie past the level: clamp the read
    # (the reference's gather clamps it), the slot stays dead
    row = row.to(torch.int64)
    src = torch.clamp(src.to(torch.int64), 0, b.cap - 1)
    w = torch.where(valid, a.weights[row] * b.weights[src], 0)
    out_keys, out_vals = fn(tuple(c[row] for c in a.keys),
                            tuple(c[row] for c in a.vals),
                            tuple(c[src] for c in b.keys),
                            tuple(c[src] for c in b.vals))
    dead = ~valid
    out_keys = tuple(c.masked_fill(dead, kernels.sentinel_scalar(c.dtype))
                     for c in out_keys)
    out_vals = tuple(c.masked_fill(dead, kernels.sentinel_scalar(c.dtype))
                     for c in out_vals)
    return Batch(out_keys, out_vals, w), total


def _range_join_level_impl(delta: Batch, level: Batch, lo_off: int,
                           hi_off: int, fn: RangeJoinFn, out_cap: int):
    """Expand the matches of the delta rows against one level, where the
    level's (single) key lies in [delta.key + lo_off, delta.key +
    hi_off]."""
    dk = delta.keys[0]
    lk = level.keys[0]
    lo = kernels.lex_probe((lk,), (dk + lo_off,), side="left")
    hi = kernels.lex_probe((lk,), (dk + hi_off,), side="right")
    live = delta.weights != 0
    lo = torch.where(live, lo, 0)
    hi = torch.where(live, hi, lo)
    return _expand_pairs(delta, level, lo, hi, fn, out_cap)


class RangeJoinCore:
    """Grow-on-demand driver, one expansion a level with a capacity per
    level capacity, and one read of the match totals per eval."""

    def __init__(self, lo_off: int, hi_off: int, fn: RangeJoinFn):
        self.lo_off = lo_off
        self.hi_off = hi_off
        self.fn = fn
        self.caps: Dict[int, int] = {}

    def join_levels(self, delta: Batch, levels: Sequence[Batch]
                    ) -> List[Batch]:
        outs, totals, caps = [], [], []
        for level in levels:
            cap = self.caps.get(level.cap, max(64, delta.cap))
            out, total = _range_join_level_impl(delta, level, self.lo_off,
                                                self.hi_off, self.fn, cap)
            outs.append(out)
            totals.append(total)
            caps.append(cap)
        if not outs:
            return []
        for i, t in enumerate(torch.stack(totals).tolist()):
            if t > caps[i]:
                cap = bucket_cap(t)
                self.caps[levels[i].cap] = cap
                outs[i], _ = _range_join_level_impl(
                    delta, levels[i], self.lo_off, self.hi_off, self.fn, cap)
        return outs


class RangeJoinOp(BinaryOperator):
    """Incremental relative-range join over the two trace streams."""

    def __init__(self, lo_off: int, hi_off: int, fn: RangeJoinFn, out_schema,
                 device, name="join_range"):
        self.name = name
        self.out_schema = out_schema
        self.device = device
        self._left = RangeJoinCore(lo_off, hi_off, fn)
        # the inverse direction, k1 in [k2 - hi_off, k2 - lo_off], with
        # the pair function flipped back so fn always sees (left, right)
        self._right = RangeJoinCore(
            -hi_off, -lo_off, lambda rk, rv, lk, lv: fn(lk, lv, rk, rv))

    def eval(self, left: TraceView, right: TraceView) -> Batch:
        outs = self._left.join_levels(left.delta, right.spine.batches)
        outs += self._right.join_levels(right.delta, left.pre_levels)
        if not outs:
            return Batch.empty(*self.out_schema, device=self.device)
        out = outs[0] if len(outs) == 1 else concat_batches(outs)
        return out.consolidate().shrink_to_fit()


@stream_method
def join_range(self: Stream, other: Stream, lo_off: int, hi_off: int,
               fn: RangeJoinFn, out_key_dtypes, out_val_dtypes,
               name: str = "join_range") -> Stream:
    """Incremental relative-range join: pairs every left row with the
    right rows whose (single, numeric) key lies in ``[k + lo_off, k +
    hi_off]`` (inclusive). ``fn(l_keys, l_vals, r_keys, r_vals) -> (keys,
    vals)``."""
    ls = require_schema(self, "join_range (left input)")
    rs = require_schema(other, "join_range (right input)")
    assert len(ls[0]) == 1 and len(rs[0]) == 1, (
        "join_range operands must be keyed by one numeric column")
    out_schema = (tuple(out_key_dtypes), tuple(out_val_dtypes))
    out = self.circuit.add_binary_operator(
        RangeJoinOp(lo_off, hi_off, fn, out_schema, self.circuit.device,
                    name), self.trace(), other.trace())
    out.schema = out_schema
    return out


def _stream_range_join(a: Batch, b: Batch, range_fn, fn, out_cap: int):
    lower, upper = range_fn(a.keys)
    lo = kernels.lex_probe(b.keys, tuple(lower), side="left")
    hi = kernels.lex_probe(b.keys, tuple(upper), side="left")  # half-open
    live = a.weights != 0
    lo = torch.where(live, lo, 0)
    hi = torch.where(live, torch.maximum(hi, lo), lo)
    return _expand_pairs(a, b, lo, hi, fn, out_cap)


@stream_method
def stream_join_range(self: Stream, other: Stream,
                      range_fn: Callable, fn: RangeJoinFn,
                      out_key_dtypes, out_val_dtypes,
                      name: str = "stream_join_range") -> Stream:
    """Per-tick range join (the reference's exact contract):
    ``range_fn(l_key_cols) -> (lower_cols, upper_cols)`` gives each left
    row's half-open right-key interval ``[lower, upper)``. Non-incremental:
    joins only the two current tick batches."""
    from dbsp_tpu_torch.operators.basic import Apply2

    require_schema(self, "stream_join_range (left input)")
    require_schema(other, "stream_join_range (right input)")
    out_schema = (tuple(out_key_dtypes), tuple(out_val_dtypes))
    caps: Dict[int, int] = {}

    def eval_fn(a: Batch, b: Batch) -> Batch:
        cap = caps.get(b.cap, max(64, a.cap))
        out, total = _stream_range_join(a, b, range_fn, fn, cap)
        t = int(total)
        if t > cap:
            cap = bucket_cap(t)
            caps[b.cap] = cap
            out, _ = _stream_range_join(a, b, range_fn, fn, cap)
        return out.consolidate().shrink_to_fit()

    out = self.circuit.add_binary_operator(Apply2(eval_fn, name), self,
                                           other)
    out.schema = out_schema
    return out
