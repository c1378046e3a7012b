"""Incremental per-key top-K: the K extreme rows of each group.
Counterpart of ``dbsp_tpu/operators/topk.py``.

The delta pattern is the aggregate's: for the keys a delta touches,
recompute the group's top-K from the input trace and diff it against
the previous output. Per tick:

  1. the distinct live keys Q of the delta;
  2. their groups from every input-spine level, in one ladder gather
     launch (``cuda_kernels.gather_ladder``);
  3. one consolidation of (q, vals), which nets cross-level rows, then a
     segmented rank from cumulative sums: a present row's rank within
     its group follows from prefix sums, with no sort past the
     consolidation's; rows of rank < K are the new top-K (+1);
  4. the previous top-K of Q from the operator's own output spine, the
     same way (-1); both parts consolidated.

Ordering: rows rank by their value columns, lexicographically as signed
integers; ``largest`` takes the tail of each group. Index the stream so
the priority columns come first. Set semantics: a row of weight w > 1
takes one slot; a row of net weight <= 0 is absent.

The segment min and sum stay plain PyTorch, as they are XLA ops (not
Pallas kernels) in the reference.
"""

from __future__ import annotations

import torch

from dbsp_tpu_torch.circuit.builder import Stream
from dbsp_tpu_torch.circuit.operator import UnaryOperator
from dbsp_tpu_torch.operators.aggregate import GroupGather, _unique_keys
from dbsp_tpu_torch.operators.registry import require_schema, stream_method
from dbsp_tpu_torch.operators.trace_op import TraceView
from dbsp_tpu_torch.trace.spine import Spine
from dbsp_tpu_torch.zset import kernels
from dbsp_tpu_torch.zset.batch import Batch, concat_batches


def _topk_rows_impl(qrow, qkeys, val_cols, w, k: int, largest: bool,
                    weight_sign: int, q_cap: int) -> Batch:
    """The top-K present rows of each query segment, with weight
    ``weight_sign``. Segment ids are query slots in [0, q_cap), sized by
    q_cap and not by the gathered rows (whose capacity may be smaller);
    dead rows go to the trash segment q_cap."""
    cols, w = kernels.consolidate_cols((qrow, *val_cols), w)
    qrow, val_cols = cols[0], cols[1:]
    present = w > 0
    one = present.to(torch.int64)
    cum = torch.cumsum(one, 0)
    base_src = cum - one
    num_seg = q_cap + 1
    seg_ids = torch.where((qrow >= 0) & (qrow < q_cap), qrow,
                          q_cap).to(torch.int64)
    # a segment no row maps to keeps the identity, and no row reads it
    base = kernels.segment_extreme(base_src, seg_ids, num_seg,
                                   largest=False)
    total = kernels.segment_sum(one, seg_ids, num_seg)
    within = cum - base[seg_ids]  # 1-based rank among present rows
    if largest:
        rank = total[seg_ids] - within  # 0 == the last (largest) row
    else:
        rank = within - 1  # 0 == the first (smallest) row
    keep = present & (rank < k) & (qrow >= 0)
    src = torch.clamp(qrow.to(torch.int64), 0, qkeys[0].shape[0] - 1)
    keys = tuple(kc[src].masked_fill(~keep, kernels.sentinel_scalar(kc.dtype))
                 for kc in qkeys)
    out_w = torch.where(keep, weight_sign, 0).to(w.dtype)
    out_cols, out_w = kernels.compact((*keys, *val_cols), out_w, keep)
    nk = len(qkeys)
    return Batch(out_cols[:nk], out_cols[nk:], out_w)


class TopKOp(UnaryOperator):
    def __init__(self, k: int, schema, device, largest: bool = True,
                 name=None):
        self.k = k
        self.largest = largest
        self.schema = schema
        self.device = device
        self.name = name or f"topk<{k}>"
        self.out_spine = Spine(*schema, device=device)
        self._group_gather = GroupGather()
        self._old_gather = GroupGather()

    def eval(self, view: TraceView) -> Batch:
        delta = view.delta
        nk = len(self.schema[0])
        if int(delta.live_count()) == 0:
            return Batch.empty(*self.schema, device=self.device)
        qkeys, qlive = _unique_keys(delta, nk)
        q_cap = qlive.shape[-1]
        parts = []
        g = self._group_gather(qkeys, qlive, view.spine.batches, q_cap)
        if g is not None:
            parts.append(_topk_rows_impl(g[0], qkeys, g[1], g[2], self.k,
                                         self.largest, 1, q_cap))
        o = self._old_gather(qkeys, qlive, self.out_spine.batches, q_cap)
        if o is not None:
            # the previous top-K rows of the touched keys, retracted: no
            # group holds more than K of them, so every present one stays
            parts.append(_topk_rows_impl(o[0], qkeys, o[1], o[2], self.k,
                                         self.largest, -1, q_cap))
        if not parts:
            return Batch.empty(*self.schema, device=self.device)
        out = parts[0] if len(parts) == 1 else \
            concat_batches(parts).consolidate().shrink_to_fit()
        self.out_spine.insert(out)
        return out


@stream_method
def topk(self: Stream, k: int, largest: bool = True, name=None) -> Stream:
    """Top-K rows per key, ordered by the value columns (see the module
    docstring)."""
    schema = require_schema(self, "topk")
    schema = (tuple(schema[0]), tuple(schema[1]))
    out = self.circuit.add_unary_operator(
        TopKOp(k, schema, self.circuit.device, largest, name), self.trace())
    out.schema = schema
    return out
