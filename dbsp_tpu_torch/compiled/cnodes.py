"""Compiled operator evals: static-capacity counterparts of the host
operators, for the compiled engine (``compiler.py``). Counterpart of
``dbsp_tpu/compiled/cnodes.py``.

Each compiled node (``C*`` class) mirrors one host operator and expresses
its per-tick eval as ``eval(ctx, state, inputs) -> (state', output)`` over
static-capacity device batches. The algorithms are the host operators'
(the ``*_impl`` steps are shared); what changes is the driver: the host
path's grow-on-demand loops and per-eval scalar reads become static
capacities plus device-side "required capacity" scalars
(``ctx.require``), which the handle reads only at its validation points
and answers with grow + replay. A tick therefore never waits on the card.

The reference traces the eval sequence into one XLA program and donates
its states. Here the evals run eagerly, and every state update makes new
tensors: no state tensor is written in place after it is made, so the
level views a tick hands its consumers stay valid, and a snapshot is a
copy that nothing later overwrites.

INPUT traces (:class:`CTrace`) are LEVELED: a static tuple of K level
batches in geometric capacity classes. A tick's delta lands in a SLOT of
level 0 (an O(|delta|) indexed copy, no merge, see
:meth:`_Leveled._levels_append`); deeper compaction happens between
validated intervals in the handle's ``maintain``. Consumers probe every
level at once with the fused ladder cursors and consolidate once.

A trace that a window, a range join or a rolling aggregate reads is not
slotted: a window and a range join work level by level, so each slot would
cost them launches (the rolling aggregate keeps the reference's rule). A
window with ``gc=True`` truncates every level of its trace each tick
(``ctx.gc_bounds``, applied by the handle after the tick's evals).

OUTPUT traces (an aggregate's previous outputs, a linear aggregate's
accumulators, a top-K's previous rows) are NOT leveled: consolidated,
they hold one live row per key (k for a top-K), so the old-value gather
is an exact q_cap (k * q_cap) expansion.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import torch

from dbsp_tpu_torch.zset import cuda_kernels, kernels
from dbsp_tpu_torch.zset.batch import Batch, bucket_cap, concat_batches

# ---------------------------------------------------------------------------
# Static leveled trace (the in-tick spine)
# ---------------------------------------------------------------------------

# Default level count K (including the tail), level 0's first capacity and
# the capacity ratio between adjacent levels. Level capacities then follow
# the observed requirements through grow; these only seed the ladder. A
# harness that knows its run length passes ``compile_circuit`` a level
# count from levels_for_run() instead of the default.
TRACE_LEVELS = 4
LEVEL0_CAP = 1024
LEVEL_GROWTH = 4


def levels_for_run(ticks: int) -> int:
    """Level count that amortizes tail merges for a planned run length:
    state grows by one delta a tick and level 0 holds about two, so with
    growth g the tail absorbs a spill every ~2 g^(K-2) ticks;
    K ~ 1 + log_g(ticks / 8) levels keeps that to a few per run (the
    reference's tuning, one level fewer than before level 0 was
    slotted)."""
    if ticks <= 1:
        return 1
    extra = max(0.0, math.log(ticks / 8, LEVEL_GROWTH))
    return max(1, min(4, 1 + math.ceil(extra)))


class _Leveled:
    """Mixin managing a leveled static trace state ``(levels, base_live)``:
    ``levels`` is a tuple of K consolidated batches (level 0 smallest, the
    last one the tail) and ``base_live`` a device scalar with the frozen
    live-row count of levels 1..K-1. Capacity keys are "l0".."l{K-2}" plus
    the subclass's ``TAIL_KEY``.

    The tick only writes level 0 (a slot append) and hands levels 1..K-1
    through unchanged; draining level k into k+1 happens between
    validated intervals in ``CompiledHandle.maintain()``, so ``base_live``
    stays exact between maintenance points. A window's GC truncates every
    level in the tick, and recounts ``base_live`` there."""

    TAIL_KEY = "trace"
    _slot_cap: Optional[int] = None
    _append_slotted = False
    # set by the handle: a trace a window reads takes no slots; a
    # window-GC'd trace (every level of which a tick truncates) also has
    # its live counts refetched by maintain, and snapshot reuses none of
    # its deep levels
    _no_slots = False
    _gc_refresh = False

    def _init_level_caps(self, levels: int) -> None:
        n = max(1, levels)
        self.level_keys: Tuple[str, ...] = tuple(
            f"l{k}" for k in range(n - 1)) + (self.TAIL_KEY,)
        cap = LEVEL0_CAP
        for key in self.level_keys[:-1]:
            self.caps.setdefault(key, bucket_cap(cap))
            cap *= LEVEL_GROWTH

    def _levels_init(self, schema, migrated: Optional[Batch]):
        dev = self.device
        lv = [Batch.empty(*schema, cap=self.caps[k], device=dev)
              for k in self.level_keys]
        # level 0's run tag is always None: a slotted level 0 holds its
        # runs at slot offsets
        lv[0] = lv[0].tagged(None)
        base = 0
        if migrated is not None:
            # warm start: the host spine's consolidated state becomes the
            # tail
            lv[-1] = migrated.with_cap(self.caps[self.TAIL_KEY])
            base = int(migrated.live_count())
        return (tuple(lv), torch.full((), base, dtype=torch.int64,
                                      device=dev))

    def _levels_append(self, ctx, state, delta: Batch):
        """Append a delta to level 0, the only state a tick writes.

        SLOTTED append (the steady state): level 0 is a ladder of
        ``cap(l0) / cap(delta)`` slots of one delta capacity each. The
        (consolidated, padded) delta goes into the next free slot by one
        indexed copy over ``start + arange(dcap)``, where ``start`` is a
        device scalar: no merge, no sync. Occupancy is derived (the count
        of non-empty slots), so an empty delta re-uses its slot. The write
        happens only when the delta has rows and a slot is free; a full
        ladder with a non-empty delta loses the rows, but its requirement
        then exceeds the capacity and the handle replays from its
        snapshot (the overflow contract).

        Requirements: level 0's consumed capacity (slots in use x slot
        size) and the whole trace's live rows (``base_live`` + level 0's
        rows) under ``TAIL_KEY``.

        The slot size is pinned per instance at the first slotted append:
        a delta of another capacity takes the consolidate-then-merge path
        below, whose output (one consolidated run) is a valid slot ladder
        at any size."""
        levels, base = state
        new = list(levels)
        l0 = new[0]
        dcap = delta.cap
        can_slot = (not self._no_slots and len(self.level_keys) > 1
                    and dcap > 0 and l0.cap % dcap == 0)
        if can_slot and self._slot_cap is None:
            self._slot_cap = dcap
        slotted = can_slot and self._slot_cap == dcap
        self._append_slotted = slotted
        if slotted:
            nslots = l0.cap // dcap
            occ = (l0.weights.reshape(nslots, dcap) != 0).any(-1).sum()
            has = (delta.weights != 0).any()
            start = torch.clamp(occ, max=nslots - 1) * dcap
            write = has & (occ < nslots)
            idx = start + torch.arange(dcap, device=l0.device)

            def put(dst, src):
                # out of place: the pre-tick level 0 stays what the
                # consumers' pre views read
                keep = dst.index_select(0, idx)
                return dst.index_copy(
                    0, idx, torch.where(write, src.to(dst.dtype), keep))

            l0_live = (l0.weights != 0).sum() + (delta.weights != 0).sum()
            new[0] = Batch(
                tuple(put(k, dk) for k, dk in zip(l0.keys, delta.keys)),
                tuple(put(v, dv) for v, dv in zip(l0.vals, delta.vals)),
                put(l0.weights, delta.weights))
            ctx.require(self, self.level_keys[0],
                        (occ + has.to(torch.int64)) * dcap)
            if self.TAIL_KEY != self.level_keys[0]:
                ctx.require(self, self.TAIL_KEY, base + l0_live)
            return (tuple(new), base)
        if self._slot_cap is not None:
            # level 0 may hold slot runs: canonicalize before the merge,
            # whose contract needs sorted inputs
            nk0 = len(l0.keys)
            cols0, w0 = kernels.consolidate_cols(l0.cols, l0.weights)
            l0 = Batch(cols0[:nk0], cols0[nk0:], w0)
        m0 = l0.merge_with(delta)
        live0 = m0.live_count()
        ctx.require(self, self.level_keys[0], live0)
        if self.TAIL_KEY != self.level_keys[0]:
            ctx.require(self, self.TAIL_KEY, base + live0)
        new[0] = m0.with_cap(self.caps[self.level_keys[0]]).tagged(None)
        return (tuple(new), base)

    def _view_levels(self, levels) -> Tuple[Batch, ...]:
        """The level tuple consumers probe: a slotted level 0 expands into
        its per-slot runs (static slices, each a consolidated batch); the
        deeper levels pass through. The fused cursors fan over the whole
        expansion in one launch, so extra slots cost probe lanes, not
        launches."""
        slot = self._slot_cap
        l0 = levels[0]
        if not slot or l0.cap == slot or l0.cap % slot != 0:
            return tuple(levels)
        slices = tuple(
            Batch(tuple(k[i * slot:(i + 1) * slot] for k in l0.keys),
                  tuple(v[i * slot:(i + 1) * slot] for v in l0.vals),
                  l0.weights[i * slot:(i + 1) * slot], runs=(slot,))
            for i in range(l0.cap // slot))
        return (*slices, *levels[1:])

    def _levels_repad(self, state):
        """Re-fit the levels to the current capacities (after a grow). A
        slotted level 0 is consolidated first: the grow may have changed
        its producer's delta capacity, and one consolidated run is a valid
        slot ladder at every slot size. So the slot size is pinned anew
        by the next append, at the delta capacity the producer now has: a
        pin kept from a smaller producer would send every later delta
        down the merge path and still slice level 0 into ``cap(l0) /
        slot`` views for every consumer to probe (q5's counts, whose
        delta capacity grows with their query capacity)."""
        levels, base = state
        out = []
        for i, (b, k) in enumerate(zip(levels, self.level_keys)):
            if i == 0 and self._slot_cap is not None:
                b = b.consolidate().with_cap(self.caps[k]).tagged(None)
                self._slot_cap = None
            elif i == 0:
                b = b.with_cap(self.caps[k]).tagged(None)
            else:
                b = b.with_cap(self.caps[k]).tagged((self.caps[k],))
            out.append(b)
        return (tuple(out), base)


def static_append(trace: Batch, delta: Batch) -> Tuple[Batch, torch.Tensor]:
    """Merge ``delta`` into a fixed-capacity SINGLE-batch trace: (the new
    trace at the same capacity, its required live rows). Live rows pack
    to the front after a merge, so cutting back to the capacity drops only
    dead tail, unless the requirement exceeds it, which the handle
    detects. The state layout of operator OUTPUT traces."""
    merged = trace.merge_with(delta)
    required = merged.live_count()
    return merged.with_cap(trace.cap), required


def join_levels(delta: Batch, levels: Sequence[Batch], nk: int, fn,
                out_cap: int) -> Tuple[Batch, torch.Tensor]:
    """Join a delta against ALL trace levels into ONE out_cap buffer with
    the fused cursor (one ladder-join launch). The returned requirement is
    the UNCLAMPED total across levels: past ``out_cap`` the tail matches
    drop off and the handle grows the cap and replays."""
    from dbsp_tpu_torch.zset import cursor

    assert levels, "join_levels: trace has no levels"
    out, total = cursor.join_ladder(delta, levels, nk, fn, out_cap)
    return out, total.to(torch.int64)


def gather_levels(qkeys, qlive, levels: Sequence[Batch], out_cap: int):
    """Gather the query keys' rows from ALL trace levels into ONE
    ``(qrow, vals, w)`` part of capacity ``out_cap`` in one launch of the
    ladder consumer (on a CUDA tensor). Returns the part and the
    UNCLAMPED total. With several levels the part may hold cross-level
    insert/retract rows of one (qrow, vals): reducers net them."""
    assert levels, "gather_levels: trace has no levels"
    part, total = cuda_kernels.gather_ladder(qkeys, qlive, levels, out_cap)
    return part, total.to(torch.int64)


def ensure_side_cap(cn: "CNode", key: str, floor: int) -> int:
    """Size a fused join side's shared output buffer on its FIRST eval, on
    ``bucket_cap``'s power-of-two ladder (the one grow climbs)."""
    if not cn.caps.get(key):
        cn.caps[key] = bucket_cap(max(64, floor))
    return cn.caps[key]


def trim_queries(ctx, cn: "CNode", qkeys, qlive):
    """Cut the front-packed unique-key buffer to the "queries" capacity,
    requirement-checked: every gather, reduce and diff after it is sized
    by this buffer, not by the delta's capacity."""
    if not cn.caps.get("queries"):
        cn.caps["queries"] = 64
    q_cap = cn.caps["queries"]
    ctx.require(cn, "queries", qlive.sum())
    return tuple(c[:q_cap] for c in qkeys), qlive[:q_cap]


@dataclasses.dataclass
class CView:
    """What a trace hands its consumers each tick: the delta, and the
    LEVEL TUPLES of the trace before (z^-1) and after this tick's
    append."""

    delta: Batch
    pre: Tuple[Batch, ...]
    post: Tuple[Batch, ...]


class CNode:
    """Base: the compiled counterpart of one circuit node.

    ``caps`` holds named static capacities; ``init_state`` builds the
    state (None for stateless nodes); ``eval`` runs one tick with no read
    of a device value on the host. ``MONOTONE_CAPS`` names the capacities
    that integrate the stream (trace sizes): ``presize`` projects them
    linearly for a planned run length."""

    MONOTONE_CAPS: frozenset = frozenset()

    def __init__(self, node, op):
        self.node = node
        self.op = op
        self.caps: Dict[str, int] = {}
        self.device: Optional[torch.device] = None  # set by the handle

    def init_state(self):
        return None

    def repad_state(self, st):
        """Re-fit a snapshotted state to the CURRENT capacities (after a
        grow); the default handles single-batch trace states."""
        cap_key = next((k for k in ("trace", "out_trace", "acc_trace")
                        if k in self.caps), None)
        if cap_key and isinstance(st, Batch) and st.cap != self.caps[cap_key]:
            return st.with_cap(self.caps[cap_key])
        return st

    def note_requirement(self, key: str, required: int) -> None:
        """Called with each VALIDATED requirement: lets a node reclassify
        a capacity once its behavior contradicts a static assumption."""

    def eval(self, ctx, state, inputs):  # -> (state', output)
        raise NotImplementedError


# ---------------------------------------------------------------------------
# Stateless nodes
# ---------------------------------------------------------------------------


class CInput(CNode):
    """Source: the tick's feed batch (from the generator function or the
    feeds argument), injected through ``ctx.feeds``; it must be
    consolidated, as the generator's are."""

    def eval(self, ctx, state, inputs):
        batch = ctx.feeds.get(self.node.index)
        if batch is None:
            batch = Batch.empty(self.op.key_dtypes, self.op.val_dtypes,
                                device=self.device)
        return None, batch


class CPure(CNode):
    """Map / filter / flat_map / stream distinct: the host operator's eval
    is already a pure Batch -> Batch function. With ``defer_consolidate`` (the handle's
    placement pass) a map or flat_map skips its trailing consolidation:
    every consumer canonicalizes anyway."""

    defer_consolidate = False

    def eval(self, ctx, state, inputs):
        if self.defer_consolidate:
            return None, self.op.eval_raw(inputs[0])
        return None, self.op.eval(inputs[0])


class CPlus(CNode):
    """Z-set addition of two consolidated batches: one rank merge at the
    summed capacity (no shrink, which would read the live count)."""

    def eval(self, ctx, state, inputs):
        a, b = inputs
        return None, a.merge_with(b)


class CMinus(CNode):
    def eval(self, ctx, state, inputs):
        return None, inputs[0].merge_with(inputs[1].neg())


class CNeg(CNode):
    """Negation keeps the row order: it passes its consumers' need for
    consolidated rows on to its producer."""

    def eval(self, ctx, state, inputs):
        return None, inputs[0].neg()


class CSumN(CNode):
    """N-ary sum: one concatenation and one consolidation, which the
    placement pass defers when no consumer needs consolidated rows."""

    defer_consolidate = False

    def eval(self, ctx, state, inputs):
        cat = concat_batches(list(inputs))
        if self.defer_consolidate:
            return None, cat
        return None, cat.consolidate()


class CApply(CNode):
    """Host ``apply``: the Python fn on the tick's value, which must read
    no device value on the host. A :class:`CMaybe` input keeps its
    validity: the fn runs on the device value, so its host-side ``None``
    branch is never taken."""

    def eval(self, ctx, state, inputs):
        v = inputs[0]
        if isinstance(v, CMaybe):
            return None, CMaybe(v.valid, self.op.fn(v.value))
        return None, self.op.fn(v)


class COutput(CNode):
    """Sink: expose the batch as the tick's output."""

    def eval(self, ctx, state, inputs):
        ctx.outputs[self.node.index] = inputs[0]
        return None, None


# ---------------------------------------------------------------------------
# Stateful nodes
# ---------------------------------------------------------------------------


def _migrate_spine(spine) -> Optional[Batch]:
    """One consolidated batch of a host-engine spine (None if empty): the
    state bridge of a warm start."""
    if not spine.batches:
        return None
    return spine.consolidated()


class CTrace(CNode, _Leveled):
    """integrate_trace as a leveled static trace (see module doc)."""

    MONOTONE_CAPS = frozenset({"trace"})
    TAIL_KEY = "trace"
    DEFAULT_CAP = 1024

    def __init__(self, node, op, levels: int = TRACE_LEVELS):
        super().__init__(node, op)
        self._migrated = _migrate_spine(op.spine)
        live = 0 if self._migrated is None \
            else int(self._migrated.live_count())
        self.caps["trace"] = bucket_cap(max(live * 2, self.DEFAULT_CAP))
        self._init_level_caps(levels)

    def init_state(self):
        sp = self.op.spine
        return self._levels_init((sp.key_dtypes, sp.val_dtypes),
                                 self._migrated)

    def repad_state(self, st):
        return self._levels_repad(st)

    def eval(self, ctx, state, inputs):
        delta = inputs[0]
        post = self._levels_append(ctx, state, delta)
        pre = self._view_levels(state[0])
        # lazy post view: after a slotted append the post-tick trace IS
        # pre + delta, so consumers probe the delta as one more level
        # instead of the slot just written (the same Z-set)
        if self._append_slotted and delta.sorted_runs == 1:
            post_view: Tuple[Batch, ...] = (*pre, delta)
        else:
            post_view = self._view_levels(post[0])
        return post, CView(delta=delta, pre=pre, post=post_view)


class CJoin(CNode):
    """Bilinear incremental join over CViews (the host JoinOp's
    semantics: dL joins trace(R) after the tick, dR joins trace(L) before
    it), each side into one shared buffer, one consolidation."""

    defer_consolidate = False

    def __init__(self, node, op):
        super().__init__(node, op)
        self.caps["left"] = 0    # sized on the first eval from delta caps
        self.caps["right"] = 0

    def eval(self, ctx, state, inputs):
        left, right = inputs
        lcore = self.op._left_core
        rcore = self.op._right_core
        nk = lcore.nk
        cap_l = ensure_side_cap(self, "left", left.delta.cap)
        cap_r = ensure_side_cap(self, "right", right.delta.cap)
        lout, ltot = join_levels(left.delta, right.post, nk, lcore.fn, cap_l)
        ctx.require(self, "left", ltot)
        rout, rtot = join_levels(right.delta, left.pre, nk, rcore.fn, cap_r)
        ctx.require(self, "right", rtot)
        out = concat_batches([lout, rout])
        if not self.defer_consolidate:
            out = out.consolidate()
        return None, out


def range_gather_levels(qp, qlo, qhi, qlive, levels: Sequence[Batch],
                        out_cap: int):
    """Per-row [lo, hi] time-range gather over K trace levels in one
    launch of the ladder consumer (on a CUDA tensor): the range twin of
    :func:`gather_levels`, with distinct lo/hi probe columns and the time
    key column gathered back (the host rolling aggregate's
    ``RangeGather`` makes the same call). Returns ``((qrow, t, vals, w),
    unclamped total)``; dead slots carry qrow == q_cap (the trash
    segment) and sentinel columns."""
    assert levels, "range_gather_levels: trace has no levels"
    (qrow, cols, w), total = cuda_kernels.gather_ladder(
        (qp, qlo), qlive, list(levels), out_cap, qhi_keys=(qp, qhi),
        gather_keys=1)
    return (qrow, cols[0], cols[1:], w), total.to(torch.int64)


class CRangeJoin(CNode):
    """Incremental relative-range join over CViews (the host RangeJoinOp's
    semantics: dL joins trace(R) after the tick, dR joins trace(L) before
    it), each side's per-level expansions written into one shared static
    buffer at running offsets. The buffers are one trash slot longer than
    the capacity: a slot past the capacity (an overflow, which the
    requirement reports) is written there, then cut off."""

    defer_consolidate = False

    def __init__(self, node, op):
        super().__init__(node, op)
        self.caps["left"] = 0
        self.caps["right"] = 0

    def _fan(self, ctx, cap_key, delta, levels, core) -> Batch:
        from dbsp_tpu_torch.operators.join_range import _range_join_level_impl

        out_cap = self.caps[cap_key]
        dev = delta.device
        j = torch.arange(out_cap, device=dev)
        offset = torch.zeros((), dtype=torch.int64, device=dev)
        req = torch.zeros((), dtype=torch.int64, device=dev)
        bufs = wbuf = None
        for lvl in levels:
            out, total = _range_join_level_impl(
                delta, lvl, core.lo_off, core.hi_off, core.fn, out_cap)
            req = req + total
            n = torch.clamp(total, max=out_cap)
            at = j + offset
            idx = torch.where((j < n) & (at < out_cap), at, out_cap)
            if bufs is None:
                bufs = [kernels.sentinel_fill((out_cap + 1,), c.dtype, dev)
                        for c in out.cols]
                wbuf = torch.zeros((out_cap + 1,), dtype=out.weights.dtype,
                                   device=dev)
            bufs = [b.index_copy(0, idx, c) for b, c in zip(bufs, out.cols)]
            wbuf = wbuf.index_copy(0, idx,
                                   torch.where(j < n, out.weights, 0))
            offset = torch.clamp(offset + n, max=out_cap)
        ctx.require(self, cap_key, req)
        if bufs is None:
            return Batch.empty(*self.op.out_schema, cap=out_cap, device=dev)
        nko = len(self.op.out_schema[0])
        cols = [b[:out_cap] for b in bufs]
        return Batch(tuple(cols[:nko]), tuple(cols[nko:]), wbuf[:out_cap])

    def eval(self, ctx, state, inputs):
        left, right = inputs
        ensure_side_cap(self, "left", left.delta.cap)
        ensure_side_cap(self, "right", right.delta.cap)
        lout = self._fan(ctx, "left", left.delta, right.post,
                         self.op._left)
        rout = self._fan(ctx, "right", right.delta, left.pre,
                         self.op._right)
        out = concat_batches([lout, rout])
        if not self.defer_consolidate:
            out = out.consolidate()
        return None, out


class CDistinct(CNode):
    """Incremental distinct over its trace's CView, stateless given the
    view: one launch of the two-sided ladder probe finds every delta row's
    weight across the pre-tick levels (a slotted level 0 fans out into its
    slots), then the output delta is elementwise."""

    def eval(self, ctx, state, inputs):
        from dbsp_tpu_torch.operators.distinct import _distinct_delta
        from dbsp_tpu_torch.zset import cursor

        view: CView = inputs[0]
        old_w = cursor.old_weights_ladder(view.delta, view.pre)
        return None, _distinct_delta(view.delta, old_w)


class CAggregate(CNode):
    """General incremental aggregate (Count, Sum, Min, Max, Average,
    Fold): gather the touched groups from the input trace view, reduce,
    diff against the node's own output trace, all in one
    ``cursor.agg_ladder`` call (the fused kernel for a spec'd aggregator,
    the stitched chain for ``Fold``).

    Insert-combinable aggregates (Min, Max) take a fast path: a group
    whose delta only inserts combines the delta's own reduction with the
    previous output (new max = max(old max, delta max)), so no history
    comes back from the input trace. That is sound only while every net
    weight in the trace is non-negative, so the state carries an
    ``ever_negative`` flag: once any retraction has entered the stream,
    touched groups re-gather (the slow path). The flag is a device bool and gates the gather at run
    time; it never needs a host read."""

    MONOTONE_CAPS = frozenset({"out_trace", "gather"})

    def __init__(self, node, op):
        super().__init__(node, op)
        self.caps["gather"] = 0
        self.caps["out_trace"] = 0
        if getattr(op.agg, "insert_combinable", False):
            # the gather only serves retracted groups: not monotone...
            self.MONOTONE_CAPS = frozenset({"out_trace"})

    def note_requirement(self, key, required):
        # ...until a retraction engages the slow path: from then on every
        # touched group re-gathers its whole history, which grows with the
        # run
        if key == "gather" and required > 0 \
                and "gather" not in self.MONOTONE_CAPS:
            self.MONOTONE_CAPS = self.MONOTONE_CAPS | {"gather"}

    def init_state(self):
        dev = self.device
        migrated = _migrate_spine(self.op.out_spine)
        if not self.caps["out_trace"]:
            live = 0 if migrated is None else int(migrated.live_count())
            self.caps["out_trace"] = bucket_cap(max(live * 2, 1024))
        if migrated is not None:
            # a host-warmed spine has an unknown retraction history: the
            # fast path must assume the worst
            return (migrated.with_cap(self.caps["out_trace"]),
                    torch.ones((), dtype=torch.bool, device=dev))
        return (Batch.empty(*self.op.out_schema, cap=self.caps["out_trace"],
                            device=dev),
                torch.zeros((), dtype=torch.bool, device=dev))

    def repad_state(self, st):
        batch, ever_neg = st
        if batch.cap != self.caps["out_trace"]:
            batch = batch.with_cap(self.caps["out_trace"])
        return (batch, ever_neg)

    def eval(self, ctx, state, inputs):
        from dbsp_tpu_torch.operators.aggregate import _diff_outputs_impl
        from dbsp_tpu_torch.zset import cursor

        view: CView = inputs[0]
        out_trace, ever_neg = state
        agg = self.op.agg
        nk = len(self.op.key_dtypes)
        delta = view.delta
        if not self.caps.get("queries"):
            self.caps["queries"] = 64  # trim_queries' seed, same contract
        # the unique-key buffer never holds more rows than the delta has
        q_cap = min(self.caps["queries"], delta.cap)
        fast = getattr(agg, "insert_combinable", False)
        if not self.caps["gather"]:
            self.caps["gather"] = 64 if fast else max(64, 2 * q_cap)

        ever_neg = ever_neg | (delta.weights < 0).any()
        flag = ever_neg if fast else torch.ones(
            (), dtype=torch.bool, device=self.device)
        (qkeys, qlive, nq, old_vals, old_present, lad_vals, lad_present,
         d_vals, d_present, gtot) = cursor.agg_ladder(
            delta, nk, out_trace, view.post, agg, q_cap,
            self.caps["gather"], fast, flag)
        ctx.require(self, "queries", nq)
        ctx.require(self, "gather", gtot)
        if fast:
            fast_vals = agg.combine(old_vals, old_present, d_vals, d_present)
            fast_present = old_present | d_present
            slow = qlive & ever_neg
            new_vals = tuple(torch.where(slow, sv.to(fv.dtype), fv)
                             for sv, fv in zip(lad_vals, fast_vals))
            new_present = torch.where(slow, lad_present, fast_present)
        else:
            new_vals, new_present = lad_vals, lad_present

        cols, w = _diff_outputs_impl(qkeys, qlive, new_vals, new_present,
                                     old_vals, old_present)
        out = Batch(cols[:nk], cols[nk:], w, runs=(int(w.shape[-1]),))
        state2, required = static_append(out_trace, out)
        ctx.require(self, "out_trace", required)
        return (state2, ever_neg), out


class CTopK(CNode):
    """Incremental per-key top-K (``operators/topk.py``): recompute the
    touched groups' top-K from the input trace view and diff it against
    the previous output, kept in a static out trace that holds at most k
    live rows a key, consolidated (not leveled, see the module doc), so
    the old-output gather is exact at ``k * q_cap``."""

    MONOTONE_CAPS = frozenset({"out_trace", "gather"})

    def __init__(self, node, op):
        super().__init__(node, op)
        self.caps["gather"] = 0
        self.caps["out_trace"] = 0

    def init_state(self):
        migrated = _migrate_spine(self.op.out_spine)
        if not self.caps["out_trace"]:
            live = 0 if migrated is None else int(migrated.live_count())
            self.caps["out_trace"] = bucket_cap(max(live * 2, 1024))
        if migrated is not None:
            return migrated.with_cap(self.caps["out_trace"])
        return Batch.empty(*self.op.schema, cap=self.caps["out_trace"],
                           device=self.device)

    def eval(self, ctx, state, inputs):
        from dbsp_tpu_torch.operators.aggregate import (_gather_level_impl,
                                                        _unique_keys_impl)
        from dbsp_tpu_torch.operators.topk import _topk_rows_impl

        view: CView = inputs[0]
        k, largest = self.op.k, self.op.largest
        qkeys, qlive = _unique_keys_impl(view.delta, len(self.op.schema[0]))
        qkeys, qlive = trim_queries(ctx, self, qkeys, qlive)
        q_cap = qlive.shape[-1]
        if not self.caps["gather"]:
            self.caps["gather"] = max(64, 2 * q_cap)

        g, gtot = gather_levels(qkeys, qlive, view.post, self.caps["gather"])
        ctx.require(self, "gather", gtot)
        new_part = _topk_rows_impl(g[0], qkeys, g[1], g[2], k, largest, 1,
                                   q_cap)
        o = _gather_level_impl(qkeys, qlive, state, k * q_cap)
        old_part = _topk_rows_impl(o[0], qkeys, o[1], o[2], k, largest, -1,
                                   q_cap)
        out = concat_batches([new_part, old_part]).consolidate()
        state2, required = static_append(state, out)
        ctx.require(self, "out_trace", required)
        return state2, out


class CLinearAggregate(CNode):
    """Linear aggregate: per-key accumulator state in a static trace batch
    (one live row per key; not leveled, see module doc)."""

    MONOTONE_CAPS = frozenset({"acc_trace"})

    def __init__(self, node, op):
        super().__init__(node, op)
        self.caps["acc_trace"] = 0

    def init_state(self):
        migrated = _migrate_spine(self.op.acc_spine)
        if not self.caps["acc_trace"]:
            live = 0 if migrated is None else int(migrated.live_count())
            self.caps["acc_trace"] = bucket_cap(max(live * 2, 1024))
        if migrated is not None:
            return migrated.with_cap(self.caps["acc_trace"])
        return Batch.empty(*self.op._state_schema,
                           cap=self.caps["acc_trace"], device=self.device)

    def eval(self, ctx, state, inputs):
        from dbsp_tpu_torch.operators.aggregate import (_gather_level_impl,
                                                        _unique_keys_impl)
        from dbsp_tpu_torch.operators.aggregate_linear import (
            _combine_diff_impl, _net_state_impl, _weigh_deltas_impl)

        agg = self.op.agg
        nk = len(self.op.key_dtypes)
        delta = inputs[0]
        qkeys, qlive = _unique_keys_impl(delta, nk)
        qkeys, qlive = trim_queries(ctx, self, qkeys, qlive)
        q_cap = qlive.shape[-1]
        acc_delta, cnt_delta = _weigh_deltas_impl(delta, agg, nk)
        # per-unique-key segment sums, packed like qkeys: trim to match
        # (ids past q_cap are caught by the "queries" requirement)
        acc_delta = tuple(a[:q_cap] for a in acc_delta)
        cnt_delta = cnt_delta[:q_cap]

        # the consolidated accumulator trace holds one live row per key, so
        # a q_cap expansion is exact: no requirement needed
        qrow, vals, w, _ = _gather_level_impl(qkeys, qlive, state, q_cap)
        old = _net_state_impl((qrow, vals, w), q_cap)
        out, sdiff = _combine_diff_impl(qkeys, qlive, acc_delta, cnt_delta,
                                        *old, agg, nk)
        state2, required = static_append(state, sdiff)
        ctx.require(self, "acc_trace", required)
        return state2, out


class CRolling(CNode):
    """Partitioned rolling aggregate (``timeseries/rolling.py``) over a
    CView: find the dirty (p, t') slots, recompute each window [t' -
    range, t'] from the input trace's levels, and diff against the
    previous outputs, kept in a static out trace (one live row per key,
    so the old-output gather is exact at the dirty capacity). Window
    recompute only: the radix tree keeps host-driven level state, so a
    compiled ``use_tree=True`` operator ignores its tree. Three gathers a
    tick, each one launch of the ladder consumer: the affected rows (over
    key-only levels, range mode with the time column gathered back), the
    windows, and the old outputs."""

    MONOTONE_CAPS = frozenset({"out_trace", "affected", "window"})

    def __init__(self, node, op):
        super().__init__(node, op)
        self.caps["affected"] = 0
        self.caps["dirty"] = 0
        self.caps["window"] = 0
        self.caps["out_trace"] = 0

    def init_state(self):
        migrated = _migrate_spine(self.op.out_spine)
        if not self.caps["out_trace"]:
            live = 0 if migrated is None else int(migrated.live_count())
            self.caps["out_trace"] = bucket_cap(max(live * 2, 1024))
        if migrated is not None:
            return migrated.with_cap(self.caps["out_trace"])
        return Batch.empty(*self.op.out_schema, cap=self.caps["out_trace"],
                           device=self.device)

    def eval(self, ctx, state, inputs):
        from dbsp_tpu_torch.operators.aggregate import (_diff_outputs_impl,
                                                        _gather_level_impl,
                                                        _reduce_groups_impl,
                                                        _TupleMax)
        from dbsp_tpu_torch.timeseries.rolling import (_dirty_rows_impl,
                                                       _rolling_reduce_impl)

        view: CView = inputs[0]
        delta = view.delta
        rng = self.op.range_ms
        dp, dt = delta.keys[0], delta.keys[1]
        dlive = delta.weights != 0
        if not self.caps["affected"]:
            self.caps["affected"] = max(64, 2 * delta.cap)
            self.caps["dirty"] = max(64, 2 * delta.cap)
            self.caps["window"] = max(64, 4 * delta.cap)

        # 1. dirty slots: the trace rows in [ts, ts + range] of each delta
        #    row (keys only), and the delta's own rows
        key_only = [Batch(b.keys, (), b.weights) for b in view.post]
        (qrow, t, _, w), aff_req = range_gather_levels(
            dp, dt, dt + rng, dlive, key_only, self.caps["affected"])
        ctx.require(self, "affected", aff_req)
        ap, at, alive = _dirty_rows_impl(dp, dt, dlive, qrow, t, w)
        ctx.require(self, "dirty", alive.sum())
        a_cap = self.caps["dirty"]

        def fit(arr, fill):
            # the consolidated slots are packed at the front: cut or pad
            # to the dirty capacity (the requirement reports a cut of
            # live slots)
            n = arr.shape[-1]
            if n >= a_cap:
                return arr[:a_cap]
            pad = torch.full((a_cap - n,), fill, dtype=arr.dtype,
                             device=arr.device)
            return torch.cat([arr, pad])

        ap = fit(ap, kernels.sentinel_scalar(ap.dtype))
        at = fit(at, kernels.sentinel_scalar(at.dtype))
        alive = fit(alive, False)

        # 2. recompute each dirty window from the input trace
        (wrow, wt, wvals, ww), win_req = range_gather_levels(
            ap, at - rng, at, alive, view.post, self.caps["window"])
        ctx.require(self, "window", win_req)
        new_vals, new_present = _rolling_reduce_impl(
            wrow, wt, wvals, ww, at, self.op.agg, a_cap)

        # 3. diff against the previous outputs
        oqrow, ovals, ow, _ = _gather_level_impl((ap, at), alive, state,
                                                 a_cap)
        old_vals, old_present = _reduce_groups_impl(
            (oqrow, ovals, ow), _TupleMax(len(self.op.agg.out_dtypes)),
            a_cap, net=False)
        cols, w = _diff_outputs_impl((ap, at), alive, new_vals, new_present,
                                     old_vals, old_present)
        out = Batch(cols[:2], cols[2:], w, runs=(int(w.shape[-1]),))
        state2, required = static_append(state, out)
        ctx.require(self, "out_trace", required)
        return state2, out


# ---------------------------------------------------------------------------
# Time-series nodes (watermark, window)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CMaybe:
    """A device scalar stream value that may not exist yet (the host
    engine's ``None`` before the first event, e.g. a watermark's):
    ``valid`` masks every consumer, so the value computed before the
    first event is never observed."""

    valid: torch.Tensor
    value: object


# the watermark before the first event; headroom below it for the bounds'
# arithmetic
_WM_FLOOR = torch.iinfo(torch.int64).min // 4


def truncate_below(batch: Batch, bound: torch.Tensor) -> Batch:
    """Drop the rows whose first key is below ``bound`` (the compiled
    ``Spine.truncate_keys_below``): capacity unchanged, live rows packed
    and sorted. The comparison runs in int64: cast down to an int32 key
    column, the bound before the first bounds (``_WM_FLOOR``) would wrap
    and truncate live negative keys."""
    k0 = batch.keys[0]
    return batch.compacted((batch.weights != 0)
                           & (k0.to(torch.int64) >= bound))


def _device_int(x, device) -> torch.Tensor:
    """``x`` as a 0-d int64 device tensor: a device value is cast, a host
    int is filled on the device (a fill kernel, which a CUDA graph
    captures; a host-to-device copy it could not)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64)
    return torch.full((), x, dtype=torch.int64, device=device)


class CWatermark(CNode):
    """``watermark_monotonic``: the running max of a live timestamp column
    minus lateness, as device scalars. The state is (wm, valid) where the
    host engine holds a Python int or ``None``; a tick with no live row
    keeps it, with no host read."""

    def init_state(self):
        return (torch.full((), _WM_FLOOR, dtype=torch.int64,
                           device=self.device),
                torch.zeros((), dtype=torch.bool, device=self.device))

    def eval(self, ctx, state, inputs):
        batch = inputs[0]
        wm0, valid0 = state
        if batch.cap == 0:
            return state, CMaybe(valid0, wm0)
        ts = self.op.ts_fn(batch.keys, batch.vals).to(torch.int64)
        live = batch.weights != 0
        m = torch.where(live, ts, _WM_FLOOR).amax()
        any_live = live.any()
        wm1 = torch.where(any_live,
                          torch.maximum(wm0, m - self.op.lateness), wm0)
        valid1 = valid0 | any_live
        return (wm1, valid1), CMaybe(valid1, wm1)


class CWindow(CNode):
    """Moving-bounds window over a compiled trace view: the host
    operator's three-part delta (new rows in [a1, b1), minus the rows that
    slid out of [a0, min(a1, b0)), plus those that slid in from
    [max(b0, a1), b1)), with a slice of each pre-tick level per part at
    the shared ``slide_out`` / ``slide_in`` capacities. Before the first
    bounds the output is masked dead instead of returned early. With
    ``gc=True`` the lower bound goes to ``ctx.gc_bounds``, and the handle
    truncates the trace below it in the same tick."""

    def __init__(self, node, op):
        super().__init__(node, op)
        self.caps["slide_out"] = 0
        self.caps["slide_in"] = 0

    def init_state(self):
        # (a0, b0, had_bounds)
        zero = torch.zeros((), dtype=torch.int64, device=self.device)
        return (zero, zero.clone(),
                torch.zeros((), dtype=torch.bool, device=self.device))

    def eval(self, ctx, state, inputs):
        from dbsp_tpu_torch.timeseries.window import (_filter_window,
                                                      _slice_range)

        view, bounds = inputs
        if not isinstance(bounds, CMaybe):
            bounds = CMaybe(torch.ones((), dtype=torch.bool,
                                       device=self.device), bounds)
        a1, b1 = (_device_int(x, self.device) for x in bounds.value)
        valid1 = bounds.valid
        a0, b0, had = state
        # first bounds ever: the previous window is the empty [a1, a1)
        a0e = torch.where(had, a0, a1)
        b0e = torch.where(had, b0, a1)

        if not self.caps["slide_out"]:
            cap = max(64, view.delta.cap)
            self.caps["slide_out"] = cap
            self.caps["slide_in"] = cap
        parts = [_filter_window(view.delta, a1, b1)]
        for lvl in view.pre:
            out_b, n_out = _slice_range(lvl, a0e, torch.minimum(a1, b0e),
                                        self.caps["slide_out"])
            ctx.require(self, "slide_out", n_out)
            parts.append(out_b.neg())
            in_b, n_in = _slice_range(lvl, torch.maximum(b0e, a1), b1,
                                      self.caps["slide_in"])
            ctx.require(self, "slide_in", n_in)
            parts.append(in_b)
        # everything is dead until bounds exist
        out = concat_batches(parts).consolidate().masked(valid1)

        if self.op.gc:
            ctx.gc_bounds[self.node.inputs[0]] = torch.where(valid1, a1,
                                                             _WM_FLOOR)
        state2 = (torch.where(valid1, a1, a0), torch.where(valid1, b1, b0),
                  had | valid1)
        return state2, out
