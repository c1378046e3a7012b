"""Linear aggregation: per-key accumulators maintained from delta segment
sums alone, with no group re-gather from an input trace. Counterpart of
``dbsp_tpu/operators/aggregate_linear.py``:

    out(key) = finalize(sum_rows weight * weigh(vals), sum_rows weight)

Per tick: a segment sum of the (sorted) delta by key, one ladder gather of
the operator's own accumulator spine (one net row per key, not the input
history), and an elementwise combine + diff. The segment sums here are
plain torch (``index_add_``), as they are XLA in the reference. The
``*_impl`` steps read no device value on the host; the compiled engine's
linear node calls them inside a tick.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from dbsp_tpu_torch.circuit.operator import UnaryOperator
from dbsp_tpu_torch.operators.aggregate import GroupGather, _unique_keys
from dbsp_tpu_torch.trace.spine import Spine
from dbsp_tpu_torch.zset import kernels
from dbsp_tpu_torch.zset.batch import Batch


class LinearAggregator:
    """``weigh`` maps each row's val columns to per-row contributions
    (times the row's weight, summed per key); ``finalize`` maps the summed
    accumulators and the summed weight ``count`` to the output columns."""

    acc_dtypes: Tuple = ()
    out_dtypes: Tuple = ()
    name = "linear"

    def weigh(self, val_cols):
        return ()

    def finalize(self, acc_cols, count):
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class LinearCount(LinearAggregator):
    """Net weight per key; no accumulator columns."""

    acc_dtypes = ()
    out_dtypes = (torch.int64,)
    name = "count"

    def finalize(self, acc_cols, count):
        return (count,)


@dataclasses.dataclass(frozen=True)
class LinearAverage(LinearAggregator):
    """Integer average sum/count, truncating toward zero (SQL semantics)."""

    col: int = 0
    acc_dtypes = (torch.int64,)
    out_dtypes = (torch.int64,)
    name = "avg"

    def weigh(self, val_cols):
        return (val_cols[self.col].to(torch.int64),)

    def finalize(self, acc_cols, count):
        s = acc_cols[0]
        c = torch.clamp(count, min=1)
        return (torch.where(s >= 0, s // c, -((-s) // c)),)


def _weigh_deltas_impl(delta: Batch, agg: LinearAggregator, nk: int):
    """Per-distinct-key accumulator deltas, aligned with the key order of
    :func:`~dbsp_tpu_torch.operators.aggregate._unique_keys`."""
    cap = delta.cap
    live = delta.weights != 0
    first = ~kernels.rows_equal_prev(delta.keys[:nk], cap, delta.device) & live
    seg = torch.cumsum(first.to(torch.int64), 0) - 1
    seg = torch.where(live, seg, cap)
    w = delta.weights
    accs = tuple(kernels.segment_sum(a.to(d) * w, seg, cap + 1)[:cap]
                 for a, d in zip(agg.weigh(delta.vals), agg.acc_dtypes))
    cnt = kernels.segment_sum(w, seg, cap + 1)[:cap]
    return accs, cnt


def _net_state_impl(part, q_cap: int):
    """Per-key state from the accumulator-state gather: net accumulator
    columns, net count and net row count (plain segment sums; linearity
    means no netting pass is needed)."""
    qrow, vals, w = part
    seg = torch.clamp(qrow, max=q_cap)
    # vals = (*acc_cols, count_col); dead slots have w == 0
    sums = tuple(kernels.segment_sum(v * w, seg, q_cap + 1)[:q_cap]
                 for v in vals)
    rows = kernels.segment_sum(w, seg, q_cap + 1)[:q_cap]
    return sums[:-1], sums[-1], rows


def _combine_diff_impl(qkeys, qlive, acc_delta, cnt_delta, old_accs,
                       old_cnt, old_rows, agg: LinearAggregator, nk: int):
    """Combine old state and deltas into the output diff and the state
    diff. A group is VISIBLE iff its net count > 0; a STATE row exists iff
    any accumulator component is nonzero (a group retracted below zero
    still owes its negative sums)."""
    old_has_row = qlive & (old_rows > 0)
    old_present = qlive & (old_cnt > 0)
    new_accs = tuple(o + d for o, d in zip(old_accs, acc_delta))
    new_cnt = old_cnt + cnt_delta
    new_present = qlive & (new_cnt > 0)

    fin_old = tuple(c.to(d) for c, d in
                    zip(agg.finalize(old_accs, old_cnt), agg.out_dtypes))
    fin_new = tuple(c.to(d) for c, d in
                    zip(agg.finalize(new_accs, new_cnt), agg.out_dtypes))
    changed = new_present != old_present
    for a, b in zip(fin_new, fin_old):
        changed = changed | ~kernels._col_eq(a, b)

    def two_sided(vals_new, vals_old, ins_mask, ret_mask):
        keys = tuple(torch.cat([c, c]) for c in qkeys)
        vals = tuple(torch.cat([n, o]) for n, o in zip(vals_new, vals_old))
        w = torch.cat([torch.where(ins_mask, 1, 0),
                       torch.where(ret_mask, -1, 0)]).to(torch.int64)
        cols, w = kernels.consolidate_cols((*keys, *vals), w)
        return Batch(cols[:nk], cols[nk:], w, runs=(int(w.shape[-1]),))

    out = two_sided(fin_new, fin_old,
                    new_present & changed, old_present & changed)
    state_changed = cnt_delta != 0
    for d in acc_delta:
        state_changed = state_changed | (d != 0)
    new_has_row = new_cnt != 0
    for a in new_accs:
        new_has_row = new_has_row | (a != 0)
    state = two_sided((*new_accs, new_cnt), (*old_accs, old_cnt),
                      qlive & new_has_row & state_changed,
                      old_has_row & state_changed)
    return out, state


class LinearAggregateOp(UnaryOperator):
    """Incremental linear aggregate: consumes the raw delta stream and
    keeps only its own (key -> accumulators, count) state spine."""

    def __init__(self, agg: LinearAggregator, key_dtypes, device, name=None):
        self.agg = agg
        self.name = name or f"aggregate_linear<{agg.name}>"
        self.key_dtypes = tuple(key_dtypes)
        self.device = device
        self.out_schema = (self.key_dtypes, tuple(agg.out_dtypes))
        self._state_schema = (self.key_dtypes,
                              (*agg.acc_dtypes, torch.int64))  # + count
        self.acc_spine = Spine(*self._state_schema, device=device)
        self._gather = GroupGather()

    def eval(self, delta: Batch) -> Batch:
        nk = len(self.key_dtypes)
        if int(delta.live_count()) == 0:
            return Batch.empty(*self.out_schema, device=self.device)
        qkeys, qlive = _unique_keys(delta, nk)
        q_cap = qlive.shape[-1]
        acc_delta, cnt_delta = _weigh_deltas_impl(delta, self.agg, nk)
        acc_delta = tuple(a[:q_cap] for a in acc_delta)
        cnt_delta = cnt_delta[:q_cap]

        part = self._gather(qkeys, qlive, self.acc_spine.batches, q_cap)
        if part is None:
            zero = torch.zeros(qlive.shape, dtype=torch.int64,
                               device=self.device)
            old = (tuple(zero.to(d) for d in self.agg.acc_dtypes), zero,
                   zero)
        else:
            old = _net_state_impl(part, q_cap)

        out, state = _combine_diff_impl(qkeys, qlive, acc_delta, cnt_delta,
                                        *old, self.agg, nk)
        self.acc_spine.insert(state.shrink_to_fit())
        return out.shrink_to_fit()
