"""Columnar Z-set batches on a torch device — counterpart of
``dbsp_tpu/zset/batch.py``.

A :class:`Batch` holds flat ``[cap]`` tensors with a *static capacity*:

    keys:    tuple of [cap] tensors — the indexing columns (lexicographic order)
    vals:    tuple of [cap] tensors — the value columns
    weights: [cap] int64 — Z-set multiplicities (0 == dead row)

Invariants of a *consolidated* batch: rows sorted lexicographically by
(keys, vals), no two live rows equal, live rows packed at the front, dead
rows carrying the per-dtype sentinel (max value; 1 for bool).

Capacities are power-of-two buckets (:func:`bucket_cap`). PyTorch needs no
static shapes, but the overflow contract and the grow-and-relaunch logic of
the join and gather drivers are stated in these buckets, so they stay.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from dbsp_tpu_torch.zset import kernels

WEIGHT_DTYPE = torch.int64

Row = Tuple

# consolidate() folds rank merges over a batch's sorted runs instead of
# sorting when it carries at most this many runs (beyond that the fold's
# N-1 sequential merges lose to one sort)
RANK_FOLD_MAX_RUNS = 12


def bucket_cap(n: int, minimum: int = 8) -> int:
    """Round ``n`` up to a power-of-two capacity bucket."""
    cap = minimum
    while cap < n:
        cap *= 2
    return cap


@dataclasses.dataclass(frozen=True)
class Batch:
    """An immutable columnar Z-set batch (possibly un-consolidated).

    ``runs`` is sorted-run metadata: segment lengths (summing to ``cap``)
    such that each segment is itself a consolidated slice. ``None`` means
    unknown order. It decides :meth:`consolidate`'s regime: one run is
    already canonical, a few runs fold with rank merges, anything else
    sorts."""

    keys: Tuple[torch.Tensor, ...]
    vals: Tuple[torch.Tensor, ...]
    weights: torch.Tensor
    runs: Optional[Tuple[int, ...]] = None

    # -- basic properties ---------------------------------------------------
    @property
    def cap(self) -> int:
        return int(self.weights.shape[-1])

    @property
    def device(self) -> torch.device:
        return self.weights.device

    @property
    def sorted_runs(self) -> int:
        """Number of known sorted-consolidated runs (0 = unknown)."""
        return len(self.runs) if self.runs is not None else 0

    @property
    def cols(self) -> Tuple[torch.Tensor, ...]:
        return (*self.keys, *self.vals)

    def live_count(self) -> torch.Tensor:
        """Number of live rows (device scalar)."""
        return torch.count_nonzero(self.weights)

    def nbytes(self) -> int:
        """Device bytes held by the columns and weights."""
        return sum(c.element_size() * c.numel()
                   for c in (*self.cols, self.weights))

    # -- constructors -------------------------------------------------------
    @staticmethod
    def empty(key_dtypes: Sequence[torch.dtype],
              val_dtypes: Sequence[torch.dtype] = (), cap: int = 8, *,
              device) -> "Batch":
        keys = tuple(kernels.sentinel_fill((cap,), d, device)
                     for d in key_dtypes)
        vals = tuple(kernels.sentinel_fill((cap,), d, device)
                     for d in val_dtypes)
        return Batch(keys, vals,
                     torch.zeros((cap,), dtype=WEIGHT_DTYPE, device=device),
                     runs=(cap,))

    @staticmethod
    def from_numpy(keys: Sequence[np.ndarray], vals: Sequence[np.ndarray],
                   weights: np.ndarray, runs: Optional[Tuple[int, ...]] = None,
                   *, device) -> "Batch":
        """The batch holding exactly these columns (capacity = their
        length), moved to ``device`` — the loader for state made elsewhere,
        e.g. a reference batch's columns. The caller vouches for ``runs``;
        nothing is padded, sorted or consolidated."""
        def put(a):
            return torch.from_numpy(np.array(a)).to(device)

        n = len(weights)
        for c in (*keys, *vals):
            if len(c) != n:
                raise ValueError(f"column length {len(c)} != weights "
                                 f"length {n}")
        if runs is not None and sum(runs) != n:
            raise ValueError(f"runs {runs} do not cover {n} rows")
        return Batch(tuple(put(k) for k in keys), tuple(put(v) for v in vals),
                     put(np.asarray(weights, np.int64)),
                     tuple(runs) if runs is not None else None)

    @staticmethod
    def from_columns(keys: Sequence, vals: Sequence, weights, *, device,
                     cap: Optional[int] = None,
                     consolidated: bool = False) -> "Batch":
        """Build (and by default consolidate) a batch from raw columns
        (numpy arrays or tensors), padded with sentinels to ``cap``
        (default: the bucket of the row count)."""
        def put(a):
            if isinstance(a, np.ndarray):
                a = torch.from_numpy(np.array(a))
            return a.to(device)

        weights = put(weights).to(WEIGHT_DTYPE)
        n = int(weights.shape[0])
        for c in (*keys, *vals):
            if c.shape[0] != n:
                raise ValueError(f"column length {c.shape[0]} != weights "
                                 f"length {n}")
        cap = cap or bucket_cap(n)
        keys = tuple(_pad_sentinel(put(k), cap) for k in keys)
        vals = tuple(_pad_sentinel(put(v), cap) for v in vals)
        w = torch.zeros((cap,), dtype=WEIGHT_DTYPE, device=device)
        w[:n] = weights
        b = Batch(keys, vals, w, runs=(cap,) if consolidated else None)
        return b if consolidated else b.consolidate()

    @staticmethod
    def from_tuples(rows: Sequence[Tuple[Row, int]], key_dtypes: Sequence,
                    val_dtypes: Sequence = (), cap: Optional[int] = None, *,
                    device) -> "Batch":
        """Host-side constructor from ``((key..., val...), weight)`` pairs,
        consolidated on ``device``. A live value equal to its integer
        column's sentinel (the dtype's max) is refused: it would be taken
        for a dead row."""
        nk, nv = len(key_dtypes), len(val_dtypes)
        n = len(rows)
        cap = cap or bucket_cap(max(n, 1))
        for row, _ in rows:
            if len(row) != nk + nv:
                raise ValueError(f"row arity {len(row)} != {nk}+{nv}")
        cols = [torch.tensor([row[j] for row, _ in rows], dtype=d)
                for j, d in enumerate((*key_dtypes, *val_dtypes))]
        for col in cols:
            if n and not col.dtype.is_floating_point and \
                    col.dtype != torch.bool and \
                    bool((col == torch.iinfo(col.dtype).max).any()):
                raise ValueError(
                    f"value {torch.iinfo(col.dtype).max} ({col.dtype}) is "
                    "reserved as the dead-row sentinel; remap the input "
                    "domain (e.g. use a wider dtype)")
        ws = torch.tensor([w for _, w in rows], dtype=WEIGHT_DTYPE)
        return Batch.from_columns(cols[:nk], cols[nk:], ws, device=device,
                                  cap=cap)

    # -- canonicalization ---------------------------------------------------
    def consolidate(self) -> "Batch":
        """Canonicalize by sorted-run regime: one known run is free, a few
        runs fold with rank merges, unknown order sorts. Every regime
        gives the identical canonical batch."""
        if self.sorted_runs == 1:
            return self
        return consolidate_regime(self)

    def tagged(self, runs: Optional[Tuple[int, ...]]) -> "Batch":
        """The same columns with other sorted-run metadata; the caller
        vouches for it."""
        return Batch(self.keys, self.vals, self.weights, runs)

    def masked(self, cond) -> "Batch":
        """The batch where ``cond`` holds, dead (sentinel columns, weight
        0) where it does not, at the same capacity. A Python bool or a 0-d
        ``cond`` treats every row alike, so the run metadata survives; a
        per-row ``cond`` leaves the order unknown."""
        nk = len(self.keys)
        if isinstance(cond, bool):
            if cond:
                return self
            cols = tuple(kernels.sentinel_fill(c.shape, c.dtype, self.device)
                         for c in self.cols)
            return Batch(cols[:nk], cols[nk:],
                         torch.zeros_like(self.weights), self.runs)
        cols = tuple(c.masked_fill(~cond, kernels.sentinel_scalar(c.dtype))
                     for c in self.cols)
        runs = self.runs if cond.dim() == 0 else None
        return Batch(cols[:nk], cols[nk:],
                     self.weights.masked_fill(~cond, 0), runs)

    def compacted(self, keep: torch.Tensor) -> "Batch":
        """Rows where ``keep`` holds, packed to the front, same capacity;
        sort order is preserved, so a consolidated input stays one run."""
        cols, w = kernels.compact(self.cols, self.weights, keep)
        nk = len(self.keys)
        runs = (self.cap,) if self.sorted_runs == 1 else None
        return Batch(cols[:nk], cols[nk:], w, runs)

    def with_cap(self, cap: int) -> "Batch":
        """Grow or shrink row capacity. Shrinking assumes live rows fit
        (the caller checked the live count)."""
        if cap == self.cap:
            return self
        if cap > self.cap:
            # the sentinel pad extends the LAST run
            runs = (*self.runs[:-1], self.runs[-1] + cap - self.cap) \
                if self.runs else None
            w = torch.zeros((cap,), dtype=self.weights.dtype,
                            device=self.device)
            w[:self.cap] = self.weights
            return Batch(tuple(_pad_sentinel(k, cap) for k in self.keys),
                         tuple(_pad_sentinel(v, cap) for v in self.vals),
                         w, runs)
        runs = (cap,) if self.sorted_runs == 1 else None
        return Batch(tuple(k[:cap] for k in self.keys),
                     tuple(v[:cap] for v in self.vals),
                     self.weights[:cap], runs)

    # -- algebra ------------------------------------------------------------
    def neg(self) -> "Batch":
        return Batch(self.keys, self.vals, -self.weights, self.runs)

    def add(self, other: "Batch") -> "Batch":
        """Z-set addition of two consolidated batches (rank merge), shrunk
        to the bucket of its live rows."""
        return self.merge_with(other).shrink_to_fit()

    def merge_with(self, other: "Batch") -> "Batch":
        """Sorted merge of two consolidated batches; capacity is the sum."""
        assert len(self.keys) == len(other.keys) and \
            len(self.vals) == len(other.vals), "schema mismatch in merge"
        cols, w = kernels.merge_sorted_cols(self.cols, self.weights,
                                            other.cols, other.weights)
        nk = len(self.keys)
        return Batch(cols[:nk], cols[nk:], w, runs=(int(w.shape[-1]),))

    def shrink_to_fit(self, minimum: int = 8) -> "Batch":
        """Re-bucket a consolidated batch to bucket_cap(live rows) — one
        scalar device-to-host read."""
        return self.with_cap(bucket_cap(int(self.live_count()), minimum))

    # -- host view ----------------------------------------------------------
    def to_dict(self) -> Dict[Row, int]:
        """Materialize as {(key..., val...): weight} (the test oracle
        format)."""
        ws = self.weights.cpu().numpy()
        live = ws != 0
        if not live.any():
            return {}
        ws = ws[live]
        if not self.cols:
            total = int(ws.sum())
            return {(): total} if total else {}
        cols = [c.cpu().numpy()[live].tolist() for c in self.cols]
        out: Dict[Row, int] = {}
        for row, w in zip(zip(*cols), ws.tolist()):
            nw = out.get(row, 0) + w
            if nw:
                out[row] = nw
            else:
                out.pop(row, None)
        return out


def consolidate_regime(batch: Batch) -> Batch:
    """The regime dispatch behind :meth:`Batch.consolidate` for a batch
    that is not one known run: fold rank merges over 2..RANK_FOLD_MAX_RUNS
    known runs, else sort."""
    nk = len(batch.keys)
    runs = batch.runs
    if runs is not None and 2 <= len(runs) <= RANK_FOLD_MAX_RUNS:
        # fold sorted merges over the run slices, smallest first so each
        # merge probes the smaller side into the accumulator
        bounds = []
        off = 0
        for r in runs:
            bounds.append((off, off + r))
            off += r
        parts = sorted(bounds, key=lambda se: se[1] - se[0])
        s0, e0 = parts[0]
        acc = tuple(c[s0:e0] for c in batch.cols)
        acc_w = batch.weights[s0:e0]
        for s, e in parts[1:]:
            acc, acc_w = kernels.merge_sorted_cols(
                acc, acc_w, tuple(c[s:e] for c in batch.cols),
                batch.weights[s:e])
        return Batch(acc[:nk], acc[nk:], acc_w, runs=(batch.cap,))
    cols, w = kernels.consolidate_cols(batch.cols, batch.weights)
    return Batch(cols[:nk], cols[nk:], w, runs=(batch.cap,))


def _pad_sentinel(col: torch.Tensor, cap: int) -> torch.Tensor:
    n = col.shape[-1]
    if n == cap:
        return col
    assert n < cap, f"column of {n} rows exceeds capacity {cap}"
    fill = kernels.sentinel_fill((cap - n,), col.dtype, col.device)
    return torch.cat([col, fill])


def concat_batches(batches: Sequence[Batch]) -> Batch:
    """Stack batches into one (un-consolidated) batch of summed capacity.
    Sorted-run metadata concatenates; an unknown input makes the result
    unknown."""
    assert batches
    first = batches[0]
    keys = tuple(torch.cat([b.keys[i] for b in batches])
                 for i in range(len(first.keys)))
    vals = tuple(torch.cat([b.vals[i] for b in batches])
                 for i in range(len(first.vals)))
    w = torch.cat([b.weights for b in batches])
    runs: Optional[Tuple[int, ...]] = ()
    for b in batches:
        if b.runs is None:
            runs = None
            break
        runs = (*runs, *b.runs)
    return Batch(keys, vals, w, runs)
