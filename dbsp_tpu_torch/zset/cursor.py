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
torch. The host aggregate's group gather calls
``cuda_kernels.gather_ladder`` directly, and the compiled aggregate calls
``cuda_kernels.agg_ladder``.

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
