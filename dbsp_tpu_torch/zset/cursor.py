"""Fused trace cursor: probe every level of a trace ladder at once —
counterpart of ``dbsp_tpu/zset/cursor.py``, for the consumers that do
more than launch one kernel.

A trace is a small set of consolidated batches in geometric capacity
classes. :func:`join_ladder` (the incremental join) runs ONE launch of the
CUDA ladder-consumer kernel on a CUDA tensor (``cuda_kernels.join_ladder``;
its plain version, the stitched probe-ladder / expand / gather chain, sits
beside it there), then applies the pair function.
:func:`old_weights_ladder` (incremental distinct) runs ONE launch of the
CUDA ladder probe for both sides and sums the found weights in plain
torch. :func:`agg_ladder`, the compiled aggregate's whole chain, sends an
aggregator with a reduce spec to the fused CUDA kernel
(``cuda_kernels.agg_ladder``) and a spec-less one (``Fold``) to the
stitched chain (:func:`agg_ladder_stitched`), whose gather is the
ladder-consumer kernel on a CUDA tensor.

Overflow contract (as in the reference): the match total comes back
UNCLAMPED; when it exceeds ``out_cap`` the tail matches drop off and the
caller grows ``out_cap`` and relaunches.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from dbsp_tpu_torch.zset import cuda_kernels, kernels
from dbsp_tpu_torch.zset.batch import Batch

Cols = Tuple[torch.Tensor, ...]


def _finish_join(fn, key_cols, lvals, rvals, w, valid, total
                 ) -> Tuple[Batch, torch.Tensor]:
    """Apply the pair function, then mark dead slots with sentinels so they
    sort to the tail later."""
    out_keys, out_vals = fn(key_cols, lvals, rvals)
    dead = ~valid
    out_keys = tuple(c.masked_fill(dead, kernels.sentinel_scalar(c.dtype))
                     for c in out_keys)
    out_vals = tuple(c.masked_fill(dead, kernels.sentinel_scalar(c.dtype))
                     for c in out_vals)
    return Batch(out_keys, out_vals, w), total


def join_ladder(delta: Batch, levels: Sequence[Batch], nk: int, fn,
                out_cap: int) -> Tuple[Batch, torch.Tensor]:
    """Join a delta against ALL trace levels into one RAW output batch
    (callers consolidate once) plus the UNCLAMPED match total."""
    assert levels, "join_ladder: trace has no levels"
    dk = delta.keys[:nk]
    qrow, rvals, w, valid, total = cuda_kernels.join_ladder(
        dk, delta.weights, levels, nk, out_cap)
    qrow = qrow.to(torch.int64)
    key_cols = tuple(c[qrow] for c in dk)
    lvals = tuple(c[qrow] for c in delta.vals)
    return _finish_join(fn, key_cols, lvals, rvals, w, valid, total)


def old_weights_ladder(delta: Batch, levels: Sequence[Batch]
                       ) -> torch.Tensor:
    """Accumulated weight of each delta ROW (keys+vals) across ALL levels:
    the left and the right ladder probe of the full rows (one launch of
    the CUDA probe kernel on a CUDA tensor), then the found weights summed
    across levels. Rows are unique within a consolidated level, so each
    (level, row) range is 0 or 1 wide."""
    assert levels, "old_weights_ladder: trace has no levels"
    lo, hi = cuda_kernels.lex_probe_ladder_both(
        [lvl.cols for lvl in levels], delta.cols)
    found = (hi > lo) & (delta.weights != 0)[None, :]
    old = torch.zeros_like(delta.weights)
    for k, lvl in enumerate(levels):
        w = lvl.weights[torch.clamp(lo[k].to(torch.int64), max=lvl.cap - 1)]
        old = old + torch.where(found[k], w, 0)
    return old


def agg_ladder(delta: Batch, nk: int, out_trace: Batch,
               levels: Sequence[Batch], agg, q_cap: int, gather_cap: int,
               fast: bool, flag: torch.Tensor):
    """The compiled general aggregate's whole chain: unique touched keys,
    their previous outputs from the out trace, their groups' ladder
    histories netted and reduced (while the device bool ``flag`` is on),
    and on the fast path the delta's own reduction. Returns the 10-tuple
    of ``cuda_kernels.agg_ladder``. The route is chosen by the
    aggregator's type, before any launch: one with a reduce spec takes
    the fused kernel, a spec-less one (``Fold``) the stitched chain."""
    assert levels, "agg_ladder: trace has no levels"
    if agg.reduce_spec() is not None:
        return cuda_kernels.agg_ladder(delta, nk, out_trace, levels, agg,
                                       q_cap, gather_cap, fast, flag)
    return agg_ladder_stitched(delta, nk, out_trace, levels, agg, q_cap,
                               gather_cap, fast, flag)


def agg_ladder_stitched(delta: Batch, nk: int, out_trace: Batch, levels,
                        agg, q_cap: int, gather_cap: int, fast: bool, flag,
                        gather=None, seg_reduce=None):
    """The aggregate chain as separate steps (reference
    ``cursor._agg_ladder_stitched``): the run-boundary scan once (it feeds
    the unique-key compaction and the fast path's segment ids), the
    previous outputs by an exact q_cap gather of the out trace (one live
    row per present key), the ladder gather, cross-level netting, the
    aggregator's reduction. ``gather`` and ``seg_reduce`` name the gather
    and the segment reduction (default the wrappers, which launch the
    kernels on a CUDA tensor); the plain versions make it
    ``cuda_kernels.agg_ladder_plain``."""
    from dbsp_tpu_torch.operators import aggregate as A

    gather = gather or cuda_kernels.gather_ladder
    qkeys_full, qlive_full, anylive, seg_full = A._delta_groups_impl(
        delta, nk)
    nq = qlive_full.sum()
    qkeys = tuple(c[:q_cap] for c in qkeys_full)
    qlive = qlive_full[:q_cap]

    oqrow, ovals, ow, _ = A._gather_level_impl(qkeys, qlive, out_trace,
                                               q_cap, gather)
    old_vals, old_present = A._reduce_groups_impl(
        (oqrow, ovals, ow), A._TupleMax(len(agg.out_dtypes)), q_cap,
        net=False, seg_reduce=seg_reduce)

    d_vals = d_present = None  # the general path never reads them
    if fast:
        seg = torch.where(anylive, seg_full, q_cap).to(torch.int32)
        d_vals, d_present = A.reduce_with_present(
            agg, delta.vals, delta.weights, seg, q_cap + 1, seg_reduce)
        d_vals = tuple(o[:q_cap] for o in d_vals)
        d_present = d_present[:q_cap] > 0
    part, gtot = gather(qkeys, qlive & flag, levels, gather_cap)
    lad_vals, lad_present = A._reduce_groups_impl(
        part, agg, q_cap, net=len(levels) > 1, seg_reduce=seg_reduce)
    return (qkeys, qlive, nq, old_vals, old_present, lad_vals, lad_present,
            d_vals, d_present, gtot.to(torch.int64))
