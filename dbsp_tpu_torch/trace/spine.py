"""Spine: the LSM-style trace of a stream — its integral as a small set of
consolidated batches in geometric capacity classes. Counterpart of
``dbsp_tpu/trace/spine.py``, with every level on the device.

Two levels in the same power-of-two capacity bucket merge (one rank merge
— on a CUDA device the CUDA rank-merge scatter), which keeps O(log n)
levels and O(1) amortized merges per insert. A maintenance budget bounds
the rows one insert may merge; deferred merges leave correct but
uncompacted state, since every consumer fans out over all levels.
:meth:`Spine.truncate_keys_below` drops the state below a consumer's
monotone lower bound (a window's garbage collection).

The reference's residency tiers (levels spilled to host memory and disk)
are not part of the port.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from dbsp_tpu_torch.zset.batch import Batch, Row, bucket_cap

# rows one maintenance call may merge (the reference's default budget)
MAINTAIN_BUDGET_ROWS = 1 << 17


class Spine:
    """An append-only Z-set trace with amortized device merges."""

    def __init__(self, key_dtypes: Sequence[torch.dtype],
                 val_dtypes: Sequence[torch.dtype] = (), *, device):
        self.key_dtypes = tuple(key_dtypes)
        self.val_dtypes = tuple(val_dtypes)
        self.device = torch.device(device)
        self.batches: List[Batch] = []
        self._consolidated: Optional[Batch] = None

    @staticmethod
    def from_levels(levels: Sequence[Batch]) -> "Spine":
        """A spine holding exactly these consolidated levels (state made
        elsewhere, e.g. loaded with :meth:`Batch.from_numpy`), largest
        first, without merging them."""
        first = levels[0]
        sp = Spine(tuple(c.dtype for c in first.keys),
                   tuple(c.dtype for c in first.vals), device=first.device)
        sp.batches = sorted(levels, key=lambda b: b.cap, reverse=True)
        return sp

    def insert(self, batch: Batch) -> None:
        """Insert a consolidated delta batch; merge equal-sized levels."""
        batch = _shrink(batch)
        if batch is None:
            return
        self._consolidated = None
        self.batches.append(batch)
        self.batches.sort(key=lambda b: b.cap, reverse=True)
        self.maintain()

    def maintain(self) -> None:
        """One bounded compaction slice: merge levels sharing a capacity
        bucket until the per-call budget is spent. A bucket holding more
        than two batches merges regardless, so a small budget delays
        compaction but never lets the level count grow without bound."""
        sliced = 0
        merged = True
        while merged:
            merged = False
            buckets: Dict[int, int] = {}
            for b in self.batches:
                buckets[b.cap] = buckets.get(b.cap, 0) + 1
            for i in range(len(self.batches) - 1):
                if self.batches[i].cap != self.batches[i + 1].cap:
                    continue
                cost = self.batches[i].cap + self.batches[i + 1].cap
                over = cost > MAINTAIN_BUDGET_ROWS - sliced
                if over and buckets[self.batches[i].cap] <= 2:
                    continue  # deferred to a later insert
                a = self.batches.pop(i + 1)
                b = self.batches.pop(i)
                m = _shrink(a.merge_with(b))
                if m is not None:
                    self.batches.insert(i, m)
                    self.batches.sort(key=lambda x: x.cap, reverse=True)
                sliced += cost
                merged = True
                break

    def nbytes(self) -> int:
        """Device bytes held by the levels."""
        return sum(b.nbytes() for b in self.batches)

    def consolidated(self) -> Batch:
        """All levels merged into one canonical batch (cached until the
        next insert)."""
        if self._consolidated is None:
            if not self.batches:
                self._consolidated = Batch.empty(
                    self.key_dtypes, self.val_dtypes, device=self.device)
            elif len(self.batches) == 1:
                self._consolidated = self.batches[0]
            else:
                # fold small->large so each rank merge probes the smaller side
                acc = None
                for b in sorted(self.batches, key=lambda b: b.cap):
                    acc = b if acc is None else acc.merge_with(b)
                c = _shrink(acc)
                self._consolidated = c if c is not None else Batch.empty(
                    self.key_dtypes, self.val_dtypes, device=self.device)
        return self._consolidated

    def truncate_keys_below(self, bound_key: Tuple) -> None:
        """Drop every row whose key tuple is lexicographically below
        ``bound_key``: consumers that declare monotone lower bounds (a
        window with ``gc=True``) can never read that state again. Every
        level is rewritten and shrunk to the bucket of its live rows; an
        emptied level goes."""
        new: List[Batch] = []
        for b in self.batches:
            kept = _shrink(_truncate_batch(b, bound_key))
            if kept is not None:
                new.append(kept)
        self.batches = sorted(new, key=lambda b: b.cap, reverse=True)
        self._consolidated = None

    def to_dict(self) -> Dict[Row, int]:
        out: Dict[Row, int] = {}
        for b in self.batches:
            for r, w in b.to_dict().items():
                out[r] = out.get(r, 0) + w
                if out[r] == 0:
                    del out[r]
        return out


def _at_or_above(keys: Sequence[torch.Tensor], bound: Tuple
                 ) -> torch.Tensor:
    """Whether each row's key tuple is >= ``bound`` lexicographically,
    each column compared in its own dtype."""
    ge = torch.zeros_like(keys[0], dtype=torch.bool)
    all_eq = torch.ones_like(keys[0], dtype=torch.bool)
    for k, bv in zip(keys, bound):
        kv = torch.full((), bv, dtype=k.dtype, device=k.device)
        ge = ge | (all_eq & (k > kv))
        all_eq = all_eq & (k == kv)
    return ge | all_eq


def _truncate_batch(b: Batch, bound_key: Tuple) -> Batch:
    """A consolidated level without its rows below ``bound_key``: dropping
    rows of a sorted, netted run and packing the rest to the front leaves
    it consolidated."""
    keep = _at_or_above(b.keys[:len(bound_key)], tuple(bound_key))
    return b.compacted(keep & (b.weights != 0))


def _shrink(batch: Batch) -> Optional[Batch]:
    """Shrink a consolidated batch to its tight capacity bucket; None if
    empty. The one scalar device-to-host read per insert."""
    live = int(batch.live_count())
    if live == 0:
        return None
    return batch.with_cap(bucket_cap(live))

