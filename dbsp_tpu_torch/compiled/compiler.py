"""Compile a built circuit into a static-capacity tick program driven by
the host between validation points. Counterpart of
``dbsp_tpu/compiled/compiler.py`` (one worker, every level on the card).

The host-driven scheduler evaluates operators one at a time and makes
host-side decisions (grow-on-demand capacities, spine merges, overflow
checks), each a device-to-host read that makes the host wait on the card.
The compiled engine takes the host out of the tick:

  * the scheduler's eval order runs as one tick program over the compiled
    nodes (``cnodes.py``), eagerly, with no read of a device value;
  * every state (traces, accumulators) is a fixed-capacity device batch;
  * every data-dependent capacity decision becomes a device-side
    "required capacity" scalar, folded into a running max; the handle
    reads them at validation points (every N ticks, ONE device-to-host
    read), and on overflow grows the capacity and REPLAYS from the last
    validated snapshot. Deterministic inputs (tick-indexed generators)
    make the replay exact.

The input side can be closed over too: pass ``gen_fn(tick) -> feeds``
(e.g. :func:`dbsp_tpu_torch.nexmark.device_gen.generate_tick`); the tick
index it gets is a device scalar that the handle advances in place on the
card, so a tick uploads nothing.

Scanned mode (:meth:`CompiledHandle.step_scanned`, ``run_ticks(scan=True)``)
runs a validation interval of n ticks as one dispatch: on CUDA one replay
of a ``torch.cuda.CUDAGraph`` captured per (n, capacity signature), whose
input buffers, tick cursor and requirement running max sit at fixed
addresses; on the CPU the same n ticks eagerly, under the same contract.

Between ticks: ticks run pipelined at depth 1 (:meth:`_run_pipelined`:
dispatch t, wait for t-1), snapshots copy only the levels that changed
since the last one, and LSM maintenance is budgeted (rows moved per
:meth:`CompiledHandle.maintain` call, resumable), so no single interval
absorbs a drain cascade.

Where the reference re-traces its jitted program after a capacity
change, the eager tick simply reads the new ``cn.caps`` on its next run,
and the scanned mode captures a new graph. Not ported (see ROADMAP):
trace residency tiers, the SPMD mesh, the maintenance JIT warm-up and the
per-node profilers.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from dbsp_tpu_torch.circuit.scheduler import static_schedule
from dbsp_tpu_torch.compiled import cnodes
from dbsp_tpu_torch.compiled.cnodes import CNode
from dbsp_tpu_torch.trace.spine import MAINTAIN_BUDGET_ROWS
from dbsp_tpu_torch.zset.batch import Batch, bucket_cap


class CompiledOverflow(RuntimeError):
    """A static capacity was exceeded since the last validation point.

    ``items`` is a list of (cnode, cap_key, required); :meth:`grow`
    consumes it. State since the last snapshot is invalid and must be
    replayed after growing."""

    def __init__(self, items):
        self.items = items
        msg = ", ".join(f"{c.op.name}.{k}: need {r} > cap {c.caps[k]}"
                        for c, k, r in items)
        super().__init__(f"compiled capacities exceeded: {msg}")


class _Ctx:
    """Per-tick context: feeds in, outputs and capacity requirements
    out."""

    def __init__(self, feeds):
        self.feeds = feeds
        self.outputs: Dict[int, Batch] = {}
        self.reqs: List[torch.Tensor] = []
        self.req_index: List[Tuple[CNode, str]] = []
        # trace node index -> lower bound: a window's GC, applied to the
        # trace's state at the end of the same tick
        self.gc_bounds: Dict[int, torch.Tensor] = {}

    def require(self, cnode: CNode, key: str, scalar: torch.Tensor) -> None:
        self.req_index.append((cnode, key))
        self.reqs.append(scalar.to(torch.int64).reshape(()))


def _cnode_for(node, trace_levels: int) -> CNode:
    from dbsp_tpu_torch.operators.aggregate import AggregateOp
    from dbsp_tpu_torch.operators.aggregate_linear import LinearAggregateOp
    from dbsp_tpu_torch.operators.basic import Apply, Minus, Neg, Plus, SumN
    from dbsp_tpu_torch.operators.distinct import DistinctOp, StreamDistinct
    from dbsp_tpu_torch.operators.filter_map import (FilterOp, FlatMapOp,
                                                     MapOp)
    from dbsp_tpu_torch.operators.io_handles import OutputOperator, ZSetInput
    from dbsp_tpu_torch.operators.join import JoinOp
    from dbsp_tpu_torch.operators.join_range import RangeJoinOp
    from dbsp_tpu_torch.operators.topk import TopKOp
    from dbsp_tpu_torch.operators.trace_op import TraceOp
    from dbsp_tpu_torch.timeseries import (RollingAggregateOp,
                                           WatermarkMonotonic, WindowOp)

    op = node.operator
    if isinstance(op, ZSetInput):
        return cnodes.CInput(node, op)
    if isinstance(op, (MapOp, FilterOp, FlatMapOp, StreamDistinct)):
        return cnodes.CPure(node, op)
    if isinstance(op, TraceOp):
        return cnodes.CTrace(node, op, levels=trace_levels)
    if isinstance(op, JoinOp):
        return cnodes.CJoin(node, op)
    if isinstance(op, AggregateOp):
        return cnodes.CAggregate(node, op)
    if isinstance(op, LinearAggregateOp):
        return cnodes.CLinearAggregate(node, op)
    if isinstance(op, DistinctOp):
        return cnodes.CDistinct(node, op)
    if isinstance(op, TopKOp):
        return cnodes.CTopK(node, op)
    if isinstance(op, Plus):
        return cnodes.CPlus(node, op)
    if isinstance(op, Minus):
        return cnodes.CMinus(node, op)
    if isinstance(op, Neg):
        return cnodes.CNeg(node, op)
    if isinstance(op, SumN):
        return cnodes.CSumN(node, op)
    if isinstance(op, Apply):
        return cnodes.CApply(node, op)
    if isinstance(op, WatermarkMonotonic):
        return cnodes.CWatermark(node, op)
    if isinstance(op, WindowOp):
        return cnodes.CWindow(node, op)
    if isinstance(op, RangeJoinOp):
        return cnodes.CRangeJoin(node, op)
    if isinstance(op, RollingAggregateOp):
        return cnodes.CRolling(node, op)
    if isinstance(op, OutputOperator):
        return cnodes.COutput(node, op)
    raise NotImplementedError(
        f"operator {op.name!r} ({type(op).__name__}) has no compiled "
        "equivalent yet — run this circuit on the host-driven path")


def _copy_tree(tree):
    """A deep copy of a state tree of batches, tuples and tensors."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, Batch):
        return Batch(tuple(c.clone() for c in tree.keys),
                     tuple(c.clone() for c in tree.vals),
                     tree.weights.clone(), tree.runs)
    if isinstance(tree, tuple):
        return tuple(_copy_tree(t) for t in tree)
    if isinstance(tree, dict):
        return {k: _copy_tree(v) for k, v in tree.items()}
    return tree


def _leaves(tree, out: Optional[List[torch.Tensor]] = None
            ) -> List[torch.Tensor]:
    """The tensors of a state tree, in a fixed order (dict keys sorted)."""
    if out is None:
        out = []
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, Batch):
        out.extend((*tree.keys, *tree.vals, tree.weights))
    elif isinstance(tree, tuple):
        for t in tree:
            _leaves(t, out)
    elif isinstance(tree, dict):
        for k in sorted(tree):
            _leaves(tree[k], out)
    return out


def _layout(tree):
    """A hashable description of a state tree: its structure, every
    tensor's shape and dtype, and every batch's run metadata, which picks
    code paths (whether a consolidation is skipped)."""
    if isinstance(tree, torch.Tensor):
        return (tuple(tree.shape), tree.dtype)
    if isinstance(tree, Batch):
        return ("batch", tuple(_layout(t) for t in tree.keys),
                tuple(_layout(t) for t in tree.vals), _layout(tree.weights),
                tree.runs)
    if isinstance(tree, tuple):
        return tuple(_layout(t) for t in tree)
    if isinstance(tree, dict):
        return tuple((k, _layout(tree[k])) for k in sorted(tree))
    return type(tree).__name__


def _same_buffer(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a is b or (a.data_ptr() == b.data_ptr() and a.shape == b.shape
                      and a.stride() == b.stride())


class _ScanGraph:
    """One captured n-tick chunk: the CUDA graph, the state buffers it
    reads and writes (the graph owns them), and the last tick's outputs
    (graph-pool tensors, overwritten by the next replay).

    The captured ticks end by copying every state leaf they wrote back
    into its input buffer, so after a replay the state IS the buffers. A
    leaf the ticks pass through (a deep trace level, which only
    ``maintain`` replaces) is copied in before a replay when the handle's
    state no longer holds the buffer itself. A batch of such leaves is
    represented by a wrapper object that is renewed whenever a copy
    changes its buffers: ``snapshot`` reuses the copy of a level whose
    batch is the same object, so the same object must mean the same
    content."""

    def __init__(self, sig, graph, bufs, post, outputs, req,
                 writeback_bytes: int = 0):
        self.sig, self.graph = sig, graph
        self.bufs = bufs        # the input state tree (the buffers)
        self.post = post        # the state tree the captured ticks made
        self.outputs = outputs  # the last tick's outputs
        self.req = req          # the requirement buffer it folds into
        # the bytes a replay copies back into the buffers: every leaf the
        # ticks wrote (level 0s, out traces, every level of a GC'd trace)
        self.writeback_bytes = writeback_bytes
        self.wrappers: Dict[int, Batch] = {}  # id(buffer batch) -> batch

    def copy_in(self, cur, buf) -> int:
        """Copy the leaves of state ``cur`` that are not the buffers of
        ``buf`` into them; the bytes copied."""
        if isinstance(buf, torch.Tensor):
            if _same_buffer(cur, buf):
                return 0
            buf.copy_(cur)
            return buf.element_size() * buf.numel()
        if isinstance(buf, Batch):
            n = sum(self.copy_in(c, b) for c, b in
                    zip((*cur.cols, cur.weights), (*buf.cols, buf.weights)))
            if n:
                self.wrappers[id(buf)] = dataclasses.replace(buf)
            return n
        if isinstance(buf, tuple):
            return sum(self.copy_in(c, b) for c, b in zip(cur, buf))
        if isinstance(buf, dict):
            return sum(self.copy_in(cur[k], buf[k]) for k in buf)
        return 0

    def state(self, post=None, buf=None):
        """The state tree after a replay: the buffers, under the post-tick
        metadata; a passed-through batch is its current wrapper."""
        if post is None:
            post, buf = self.post, self.bufs
        if isinstance(post, torch.Tensor):
            return buf
        if isinstance(post, Batch):
            if post is buf:
                return self.wrappers.setdefault(id(buf), buf)
            return Batch(buf.keys, buf.vals, buf.weights, post.runs)
        if isinstance(post, tuple):
            return tuple(self.state(p, b) for p, b in zip(post, buf))
        if isinstance(post, dict):
            return {k: self.state(post[k], buf[k]) for k in post}
        return post


def _drain_pair(receiver: Batch, source: Batch, cap: int):
    """One maintenance drain: ``source`` merged into ``receiver`` (cut to
    ``cap``), and ``source`` emptied."""
    return receiver.merge_with(source).with_cap(cap), source.masked(False)


def _drain_slice(receiver: Batch, source: Batch, n: int, cap: int):
    """Drain only the FIRST ``n`` live rows of ``source`` into
    ``receiver``: the resumable cursor of budgeted maintenance. Live rows
    are packed at the front of a consolidated level, so the taken prefix
    is itself consolidated, and the remainder re-packs by a roll and stays
    one consolidated run. A key split across the cut lands in two levels,
    which consumers already net."""
    idx = torch.arange(source.cap, device=source.device)
    take = source.masked(idx < n)
    rolled = Batch(tuple(torch.roll(k, -n) for k in source.keys),
                   tuple(torch.roll(v, -n) for v in source.vals),
                   torch.roll(source.weights, -n))
    rest = rolled.masked(idx < source.cap - n).tagged((source.cap,))
    return receiver.merge_with(take).with_cap(cap), rest


class CompiledHandle:
    """Drives a compiled circuit: step / validate / grow / snapshot-replay.
    """

    def __init__(self, circuit, gen_fn: Optional[Callable] = None,
                 trace_levels: int = cnodes.TRACE_LEVELS):
        self.circuit = circuit
        self.device = circuit.device
        self.order = static_schedule(circuit)
        self.trace_levels = trace_levels
        self.cnodes: List[CNode] = [_cnode_for(n, trace_levels)
                                    for n in self.order]
        self.by_index = {cn.node.index: cn for cn in self.cnodes}
        for cn in self.cnodes:
            if not isinstance(cn, (cnodes.CWindow, cnodes.CRangeJoin,
                                   cnodes.CRolling)):
                continue
            # a window slices each viewed level and a range join expands
            # each one: their traces take no slots (nor, as in the
            # reference, does a rolling aggregate's)
            for i in cn.node.inputs:
                tgt = self.by_index.get(i)
                if isinstance(tgt, cnodes.CTrace):
                    tgt._no_slots = True
            tgt = self.by_index.get(cn.node.inputs[0])
            if isinstance(cn, cnodes.CWindow) and cn.op.gc and \
                    isinstance(tgt, cnodes.CTrace):
                # a GC'd trace is bounded by the window's span, not the
                # run's length: presize does not project it linearly. A
                # tick truncates (shrinks) every level, so maintain
                # refetches its live counts (its cache assumes only level
                # 0 changes in a tick) and snapshot copies every level
                tgt.MONOTONE_CAPS = frozenset()
                tgt._gc_refresh = True
        # host InputHandle ops -> node indices (for feeds dicts)
        self._op_to_index = {id(n.operator): n.index for n in self.order}
        self._gen_fn = gen_fn
        self.deferred_consolidations = self._place_consolidations()
        self.states: Dict[str, Any] = {}
        for cn in self.cnodes:
            cn.device = self.device
            st = cn.init_state()
            if st is not None:
                self.states[str(cn.node.index)] = st
        # device-resident tick cursor, one buffer for the handle's life: a
        # tick advances it in place on the card, so the steady state never
        # uploads the tick index; a jump (first tick, restore, replay)
        # fills it from the host int
        self._tick_dev = torch.zeros((), dtype=torch.int64,
                                     device=self.device)
        self._tick_host: Optional[int] = None
        self._checks: List[Tuple[CNode, str]] = []
        # device running max of the requirements: a fixed buffer (made at
        # the first tick, anew only if the requirement layout changes),
        # updated in place and zeroed in place; dirty once a tick wrote it
        self._req: Optional[torch.Tensor] = None
        self._req_dirty = False
        self.last_req: Optional[List[int]] = None
        self.last_outputs: Dict[int, Batch] = {}
        self.step_times_ns: List[int] = []
        # (sample index, cause) annotations: a spike in step_times_ns[i]
        # is explained by the causes noted against i (maintain, snapshot,
        # retrace: a graph capture)
        self.tick_causes: List[Tuple[int, str]] = []
        self._pending_causes: set = set()
        # scanned mode: captured chunks by length n (only those of the
        # current capacity signature), captures by cause, and the bytes
        # copied into a graph's buffers before each replay
        self._graphs: Dict[int, _ScanGraph] = {}
        self._captured_n: set = set()
        self._cap_cause: Optional[str] = None
        self.captures: Dict[str, int] = {}
        self.scan_copy_bytes: List[int] = []
        self.graph_replays = 0
        # grow-and-replay cycles since construction
        self.overflow_replays = 0
        # wall time of each between-tick host phase
        self.host_overhead_ns: Dict[str, List[int]] = {
            "validate": [], "maintain": [], "snapshot": []}
        self.maintain_stats: Dict[str, int] = {
            "calls": 0, "drains": 0, "partial_drains": 0, "rows_moved": 0,
            "max_slice_rows": 0, "max_budgeted_slice_rows": 0,
            "exempt_drains": 0}
        self.maintain_pending = False
        # (state key, level) -> (level batch, its copy) of the last
        # snapshot: batches are immutable and never written in place, so
        # the same object means the same content
        self._snap_levels: Dict[Tuple[str, int], Tuple[Batch, Batch]] = {}

    # -- consolidate placement ----------------------------------------------
    def _place_consolidations(self) -> int:
        """Defer consolidations toward the sinks. A consolidation only
        canonicalizes: it never changes a batch's Z-set value. When every
        consumer of a node re-canonicalizes anyway (a general map or
        flat_map, which consolidate after transforming; an n-ary sum,
        which concatenates and consolidates; an output sink, which
        canonicalizes when read), the node's own trailing consolidation is
        dead work and is dropped (``defer_consolidate``): a join's, a
        range join's, an n-ary sum's, or a map's or flat_map's that does
        not preserve order. Order-preserving pass-throughs (filter, neg)
        pass their consumers' need on. Everything stateful (traces, aggregates,
        distinct, the plus / minus merges) and an order-preserving map,
        whose sort-free consolidation scans one sorted run, need
        consolidated inputs and fence the deferral. Returns the number of
        deferred consolidations."""
        from dbsp_tpu_torch.operators.filter_map import (FilterOp, FlatMapOp,
                                                         MapOp)

        consumers: Dict[int, List[CNode]] = {}
        for cn in self.cnodes:
            for i in cn.node.inputs:
                consumers.setdefault(i, []).append(cn)

        def input_need(cn: CNode) -> bool:
            """Does ``cn`` need consolidated INPUT batches? (Consumers are
            resolved before producers, so a pass-through node reads its
            own ``_out_need``.)"""
            if isinstance(cn, cnodes.COutput):
                return False  # reads canonicalize at the sink
            if isinstance(cn, cnodes.CSumN):
                # it consolidates itself unless deferred, and it is
                # deferred only when its own consumers need no
                # consolidated rows
                return False
            if isinstance(cn, cnodes.CPure):
                op = cn.op
                if isinstance(op, FilterOp):
                    return getattr(cn, "_out_need", True)
                if isinstance(op, MapOp):
                    return op.preserves_order
                if isinstance(op, FlatMapOp):
                    return False
                return True  # stream distinct
            if isinstance(cn, cnodes.CNeg):
                return getattr(cn, "_out_need", True)
            return True

        deferred = 0
        for cn in reversed(self.cnodes):
            cons = consumers.get(cn.node.index, [])
            cn._out_need = (not cons) or any(input_need(c) for c in cons)
            if cn._out_need:
                continue
            can_defer = isinstance(cn, (cnodes.CJoin, cnodes.CRangeJoin,
                                        cnodes.CSumN)) or (
                isinstance(cn, cnodes.CPure)
                and isinstance(cn.op, (MapOp, FlatMapOp))
                and not getattr(cn.op, "preserves_order", False))
            if can_defer:
                cn.defer_consolidate = True
                deferred += 1
        return deferred

    # -- feeds ---------------------------------------------------------------
    def _feed_indices(self, feeds: Dict) -> Dict[int, Batch]:
        out = {}
        for h, b in feeds.items():
            op = getattr(h, "_op", h)  # InputHandle or raw operator
            out[self._op_to_index[id(op)]] = b
        return out

    # -- the tick -------------------------------------------------------------
    def _run_nodes(self, states, tick, feeds):
        """One tick of the scheduler's eval sequence: (new states, outputs,
        stacked requirements). Reads no device value on the host."""
        if self._gen_fn is not None:
            raw = self._gen_fn(tick)
            feeds = {self._op_to_index[id(getattr(h, "_op", h))]: b
                     for h, b in raw.items()}
        ctx = _Ctx(feeds)
        values: Dict[int, Any] = {}
        new_states = {}
        for cn in self.cnodes:
            ins = [values[i] for i in cn.node.inputs]
            st = states.get(str(cn.node.index))
            st2, out = cn.eval(ctx, st, ins)
            if st2 is not None:
                new_states[str(cn.node.index)] = st2
            values[cn.node.index] = out
        for idx, bound in ctx.gc_bounds.items():
            # a window's GC: truncate every level of its trace, and recount
            # base_live (the deep levels' live rows), which it shrank: the
            # trace's requirement stays exact, not high by what an
            # interval truncated
            levels, base = new_states[str(idx)]
            levels = tuple(cnodes.truncate_below(lvl, bound)
                           for lvl in levels)
            new_states[str(idx)] = (levels, sum(
                (lvl.live_count() for lvl in levels[1:]),
                torch.zeros_like(base)))
        req = (torch.stack(ctx.reqs) if ctx.reqs
               else torch.zeros((0,), dtype=torch.int64, device=self.device))
        self._checks = ctx.req_index  # the same order every tick
        return new_states, ctx.outputs, req

    def _tick_operand(self, tick: int) -> torch.Tensor:
        """The device tick scalar, holding ``tick``: in the steady state the
        previous tick already advanced it; after a jump it is filled in
        place from the host int (a fill, not a copy)."""
        if self._tick_host != tick:
            self._tick_dev.fill_(tick)
            self._tick_host = tick
        return self._tick_dev

    def _note_cause(self, cause: str) -> None:
        """Annotate the NEXT latency sample with a spike cause (maintain,
        snapshot, retrace); :meth:`_append_sample` consumes it."""
        self._pending_causes.add(cause)

    def _append_sample(self, ns: int) -> None:
        idx = len(self.step_times_ns)
        self.step_times_ns.append(ns)
        if self._pending_causes:
            for c in sorted(self._pending_causes):
                self.tick_causes.append((idx, c))
            self._pending_causes.clear()

    def reset_timing(self) -> None:
        """Clear latency samples, cause annotations, host-overhead records
        and maintain stats (between warm-up and a measured run)."""
        self.step_times_ns.clear()
        self.tick_causes.clear()
        self._pending_causes.clear()
        self.scan_copy_bytes.clear()
        for v in self.host_overhead_ns.values():
            v.clear()
        for k in self.maintain_stats:
            self.maintain_stats[k] = 0

    def _fold_req(self, req: torch.Tensor) -> None:
        """Fold one tick's requirements into the running max, in place."""
        if self._req is None or self._req.shape != req.shape:
            if self._req_dirty:
                raise RuntimeError("the requirement layout changed inside a "
                                   "validation interval")
            self._req = torch.zeros_like(req)
        torch.maximum(self._req, req, out=self._req)
        self._req_dirty = True

    def _clear_req(self) -> None:
        """Forget the requirements recorded since the last validation."""
        if self._req is not None:
            self._req.zero_()
        self._req_dirty = False

    def _dispatch(self, tick: int, feeds: Optional[Dict] = None) -> None:
        """Queue one tick's work on the card (no timing, no sync)."""
        f = self._feed_indices(feeds) if feeds else {}
        tick_dev = self._tick_operand(tick)
        states, outputs, req = self._run_nodes(self.states, tick_dev, f)
        tick_dev.add_(1)
        self._tick_host = tick + 1
        self.states = {**self.states, **states}
        self.last_outputs = outputs
        self._fold_req(req)

    def step(self, tick: int = 0, feeds: Optional[Dict] = None,
             block: bool = False) -> None:
        """Run one tick. No host sync unless ``block``; call
        :meth:`validate` (one sync) before trusting outputs or state."""
        t0 = time.perf_counter_ns()
        self._dispatch(tick, feeds)
        if block:
            self.block()
        self._append_sample(time.perf_counter_ns() - t0)

    # -- scanned mode ---------------------------------------------------------
    def step_scanned(self, t0: int, n: int, block: bool = False) -> None:
        """Run ticks [t0, t0+n) as one dispatch (``gen_fn`` mode only): the
        outputs are the last tick's, the requirements a running max over
        the n ticks, the tick cursor ends at t0+n, and the chunk gives one
        latency sample.

        On CUDA the chunk is one replay of a CUDA graph, captured on first
        use for (n, the capacity signature) after a warm-up tick on a side
        stream; a grow, presize, tail growth in maintain or restore's repad
        changes the signature, so the next chunk captures anew and the
        superseded graphs go with their memory pools. A capture that fails
        raises: no eager ticks run in its place. After a replay the
        outputs and the states are the graph's buffers, which the next
        chunk overwrites: read them before it. On the CPU the n ticks run
        eagerly under the same contract."""
        assert self._gen_fn is not None, "scan mode needs a gen_fn"
        t_start = time.perf_counter_ns()
        if self.device.type == "cuda":
            g = self._scan_graph(t0, n)
            self.scan_copy_bytes.append(g.copy_in(self.states, g.bufs))
            self._tick_operand(t0)
            g.graph.replay()
            self.graph_replays += 1
            self._tick_host = t0 + n
            self.states = g.state()
            self.last_outputs = dict(g.outputs)
            self._req_dirty = True
        else:
            for tt in range(t0, t0 + n):
                self._dispatch(tt)
        if block:
            self.block()
        self._append_sample(time.perf_counter_ns() - t_start)

    def _scan_signature(self, n: int):
        """What a captured chunk depends on besides its buffers' content:
        its length, every node's capacities and slot size, and the state
        layout."""
        caps = tuple((cn.node.index, tuple(sorted(cn.caps.items())),
                      getattr(cn, "_slot_cap", None)) for cn in self.cnodes)
        return (n, caps, _layout(self.states))

    def _scan_graph(self, t0: int, n: int) -> _ScanGraph:
        """The captured chunk of length n for the current signature,
        capturing it (and dropping every graph of another signature) if
        there is none."""
        sig = self._scan_signature(n)
        g = self._graphs.get(n)
        if g is not None and g.sig == sig and g.req is self._req:
            return g
        cause = ((self._cap_cause or "layout") if n in self._captured_n
                 else "first")
        # the superseded graphs go, with their pools, before the capture
        self._graphs = {k: v for k, v in self._graphs.items()
                        if k != n and v.sig[1:] == sig[1:]}
        del g
        g = self._graphs[n] = self._capture(t0, n, sig)
        self._captured_n.add(n)
        self.captures[cause] = self.captures.get(cause, 0) + 1
        self._cap_cause = None
        self._note_cause("retrace")
        return g

    def _capture(self, t0: int, n: int, sig) -> _ScanGraph:
        """Capture n ticks over buffers of the graph's own (copies of the
        current states), ending with the copy of every state leaf the
        ticks wrote back into its buffer."""
        # the graph's own buffers, a copy of the current states, which
        # they now are
        bufs = self.states = _copy_tree(self.states)
        # a warm-up tick on a side stream, its results discarded: what a
        # first call does outside stream order (a library's set-up) must
        # not happen inside the capture
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            _, _, req = self._run_nodes(bufs, torch.full_like(
                self._tick_dev, t0), {})
        main.wait_stream(side)
        if self._req is None or self._req.shape != req.shape:
            self._fold_req(torch.zeros_like(req))
        del req
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            st = bufs
            for i in range(n):
                ns, outs, req = self._run_nodes(st, self._tick_dev + i, {})
                st = {**st, **ns}
                torch.maximum(self._req, req, out=self._req)
            self._tick_dev.add_(n)
            written, held = _leaves(st), _leaves(bufs)
            if [(t.shape, t.dtype) for t in written] != \
                    [(t.shape, t.dtype) for t in held]:
                raise RuntimeError("a tick changed the state layout: the "
                                   "chunk cannot be captured")
            # what the ticks wrote goes back into the buffers (a written
            # leaf is a new tensor: a tick writes no state in place)
            back = 0
            for o, b in zip(written, held):
                if not _same_buffer(o, b):
                    b.copy_(o)
                    back += b.element_size() * b.numel()
        return _ScanGraph(sig, graph, bufs, st, outs, self._req, back)

    def _run_pipelined(self, t0: int, upto: int) -> None:
        """Run ticks [t0, upto) at pipeline depth 1: queue tick t, then
        wait for tick t-1, so the host's work on one tick overlaps the
        card's work on the previous. One latency sample per tick (the
        time between consecutive completions). The interval's last tick
        completes inside the caller's :meth:`validate`, the designated
        sync point."""
        cuda = self.device.type == "cuda"
        prev = None
        t_prev = time.perf_counter_ns()
        for tt in range(t0, upto):
            self._dispatch(tt)
            marker = None
            if cuda:
                marker = torch.cuda.Event()
                marker.record()
            if prev is not None:
                prev.synchronize()  # the pipeline barrier on tick t-1
            now = time.perf_counter_ns()
            self._append_sample(now - t_prev)
            t_prev = now
            prev = marker

    def block(self) -> None:
        """Wait for queued work (a sync, no data transfer)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- validation / growth -------------------------------------------------
    def validate(self) -> None:
        """ONE device-to-host read: check every capacity requirement
        recorded since the last validation. Raises
        :class:`CompiledOverflow`."""
        if not self._req_dirty or not self._checks:
            return
        req = self._req.tolist()
        items = []
        for (cn, key), r in zip(self._checks, req):
            cn.note_requirement(key, r)
            if r > cn.caps[key]:
                items.append((cn, key, r))
        self.last_req = req  # validated requirement levels (for presize)
        self._clear_req()
        if items:
            raise CompiledOverflow(items)

    def _req_value(self, cn: CNode, key: str) -> Optional[int]:
        """The last validated requirement for (cn, key), if any."""
        if self.last_req is None:
            return None
        for (c, k), r in zip(self._checks, self.last_req):
            if c is cn and k == key:
                return r
        return None

    def maintain(self) -> bool:
        """Host-side spine maintenance between validated intervals: drain
        half-full trace levels into the next level (the compiled analog of
        the spine's background merges). State stays valid throughout (rows
        only move between levels whose union is the trace), so no replay
        is needed; a receiving level's capacity may grow. Returns True
        when a capacity changed.

        Drain policy: a level is due when half full, and levels drain
        shallow first. :data:`~dbsp_tpu_torch.trace.spine.MAINTAIN_BUDGET_ROWS`
        bounds the rows moved per call: a level whose rows exceed the
        remaining budget drains a prefix slice and stays due. Level 0's
        drain is exempt (deferring it would overflow level 0 and replay).
        A drain whose receiver lacks room fills the receiver to its
        capacity (the sweep drains it onward) instead of growing it; only
        the tail grows."""
        left = MAINTAIN_BUDGET_ROWS
        stats = self.maintain_stats
        stats["calls"] += 1
        rows_before = stats["rows_moved"]
        self.maintain_pending = False
        changed = False
        for cn in self.cnodes:
            if not isinstance(cn, cnodes._Leveled):
                continue
            key = str(cn.node.index)
            st = self.states.get(key)
            if st is None:
                continue
            levels, base = st
            K = len(levels)
            if K == 1:
                continue
            levels = list(levels)
            # host-cached live counts: level 0 is the only level a tick
            # writes, and its validated requirement already says how full
            # it is; deeper levels change only here (drain sums are upper
            # bounds: netting may shrink the real count, and an
            # over-estimate only drains early). A window-GC'd trace
            # shrinks every level each tick: its counts are refetched
            cache = getattr(cn, "_live_cache", None)
            if cache is None or len(cache) != K or cn._gc_refresh:
                cache = [int(b.live_count()) for b in levels]
            lives = cache
            req = self._req_value(cn, cn.level_keys[0])
            due0 = lives[0]
            if req is not None:
                due0 = req
                if cn._slot_cap:
                    # a slotted level 0's requirement is slot CAPACITY in
                    # use, not rows: its rows come from the tail
                    # requirement less the deep levels' rows
                    tail_req = self._req_value(cn, cn.TAIL_KEY)
                    lives[0] = req if tail_req is None \
                        else max(0, tail_req - sum(lives[1:]))
                else:
                    lives[0] = req
            dues = [due0] + lives[1:]
            if not any(dues[k] and dues[k] * 2 >= levels[k].cap
                       for k in range(K - 1)):
                cn._live_cache = lives
                continue

            def drain(k, exempt=False):
                nonlocal changed, left
                budgeted = not exempt and k > 0
                n = min(lives[k], left) if budgeted else lives[k]
                if n <= 0:
                    self.maintain_pending = True  # fuel ran out
                    return
                rk1 = cn.level_keys[k + 1]
                need = lives[k + 1] + n
                if need > cn.caps[rk1]:
                    if k + 1 == K - 1:
                        # the tail holds the whole trace: it grows
                        cn.caps[rk1] = bucket_cap(need)
                        changed = True
                    else:
                        # fill the receiver to its capacity; the sweep
                        # drains it onward
                        n = cn.caps[rk1] - lives[k + 1]
                        if k == 0 and n < lives[k]:
                            # level 0 MUST drain fully: force room below
                            stats["exempt_drains"] += 1
                            drain(k + 1, exempt=True)
                            n = cn.caps[rk1] - lives[k + 1]
                        if n <= 0:
                            self.maintain_pending = True
                            return
                        n = min(n, lives[k])
                if k == 0 and cn._slot_cap:
                    # fold the slot runs into one consolidated batch, the
                    # drain merge's sorted-input contract
                    slot = cn._slot_cap
                    levels[0] = levels[0].tagged(
                        (slot,) * (levels[0].cap // slot)).consolidate()
                if n >= lives[k]:
                    levels[k + 1], levels[k] = _drain_pair(
                        levels[k + 1], levels[k], cn.caps[rk1])
                    stats["drains"] += 1
                else:
                    levels[k + 1], levels[k] = _drain_slice(
                        levels[k + 1], levels[k], n, cn.caps[rk1])
                    stats["partial_drains"] += 1
                    self.maintain_pending = True  # the remainder stays due
                if k == 0:
                    levels[0] = levels[0].tagged(None)
                lives[k + 1] += n  # upper bound (netting may shrink)
                lives[k] -= n
                stats["rows_moved"] += n
                stats["max_slice_rows"] = max(stats["max_slice_rows"], n)
                if budgeted:
                    stats["max_budgeted_slice_rows"] = max(
                        stats["max_budgeted_slice_rows"], n)
                    left -= n

            # shallow first, so the inflow path (l0 -> l1) never starves
            # behind a tail compaction
            for k in range(K - 1):
                due = dues[0] if k == 0 else lives[k]
                if due and due * 2 >= levels[k].cap:
                    if k > 0 and left <= 0:
                        self.maintain_pending = True
                        continue  # deep compaction defers; l0 may not
                    drain(k)
            cn._live_cache = lives
            self.states[key] = (tuple(levels),
                                torch.full_like(base, sum(lives[1:])))
        if stats["rows_moved"] > rows_before:
            self._note_cause("maintain")
        if changed:
            self._cap_cause = self._cap_cause or "maintain"
        return changed

    def _enforce_ladders(self) -> bool:
        """Re-establish geometric level capacities between level 0 and the
        tail (requirement-driven growth sizes those two; without this the
        middle levels collapse toward level 0's size and every drain
        cascades into the tail)."""
        changed = False
        for cn in self.cnodes:
            if not isinstance(cn, cnodes._Leveled):
                continue
            keys = cn.level_keys
            if len(keys) < 3:
                continue
            lo, hi = cn.caps[keys[0]], cn.caps[keys[-1]]
            if hi <= lo:
                continue
            g = (hi / lo) ** (1.0 / (len(keys) - 1))
            for k in range(1, len(keys) - 1):
                target = bucket_cap(int(lo * g ** k))
                if target > cn.caps[keys[k]]:
                    cn.caps[keys[k]] = target
                    changed = True
        return changed

    def presize(self, ratio: float, safety: float = 1.3,
                interval: int = 1) -> None:
        """Scale capacities for a run ~``ratio`` times longer than what
        produced the last validated requirements: monotone capacities
        (traces) are projected linearly, the others (join fan-outs) get
        double headroom. ``interval`` is the validation cadence of the run
        presized for: level 0 drains only at validation points, so it must
        hold ``interval`` ticks of inflow."""
        if self.last_req is None:
            return
        changed = False
        for (cn, key), r in zip(self._checks, self.last_req):
            if r <= 0:
                continue
            is_l0 = isinstance(cn, cnodes._Leveled) and \
                len(cn.level_keys) > 1 and key == cn.level_keys[0]
            if is_l0:
                target = int(r * max(1, interval) * safety)
            elif key in cn.MONOTONE_CAPS:
                target = int(r * ratio * safety)
            else:
                target = 2 * r
            if bucket_cap(target) > cn.caps[key]:
                cn.caps[key] = bucket_cap(target)
                changed = True
        changed |= self._enforce_ladders()
        if changed:
            self._cap_cause = self._cap_cause or "presize"
            snap = self.snapshot()
            self._clear_req()
            self.restore(snap)  # re-pad states to the new capacities

    def grow(self, overflow: CompiledOverflow, headroom: int = 2,
             project_ratio: float = 1.0) -> None:
        """Grow the overflowed capacities (with headroom, so a growing
        state does not overflow again next interval). ``project_ratio`` > 1
        sends monotone capacities straight to their projected end-of-run
        size. State since the last validated snapshot is invalid: callers
        MUST follow with :meth:`restore` of a validated snapshot."""
        for cn, key, required in overflow.items:
            factor = max(headroom, project_ratio * 1.3) \
                if key in cn.MONOTONE_CAPS else headroom
            # max: a key can overflow at several sites in one interval
            cn.caps[key] = max(cn.caps[key],
                               bucket_cap(int(required * factor)))
        self._enforce_ladders()
        self._clear_req()
        self._cap_cause = self._cap_cause or "grow"

    def snapshot(self) -> Dict[str, Any]:
        """A restorable DEEP copy of the current (validated) states.

        Incremental: a deep trace level changes only in :meth:`maintain`,
        which replaces the level's batch, so a level whose batch is the
        very object copied by an earlier snapshot reuses that copy. A
        window-GC'd trace, whose every level a tick truncates, is copied
        whole."""
        snap: Dict[str, Any] = {}
        for key, st in self.states.items():
            cn = self.by_index.get(int(key))
            if not isinstance(cn, cnodes._Leveled) or cn._gc_refresh:
                snap[key] = _copy_tree(st)
                continue
            levels, base = st
            out = []
            for i, lvl in enumerate(levels):
                ent = self._snap_levels.get((key, i))
                if i > 0 and ent is not None and ent[0] is lvl:
                    out.append(ent[1])
                    continue
                c = _copy_tree(lvl)
                if i > 0:
                    self._snap_levels[(key, i)] = (lvl, c)
                out.append(c)
            snap[key] = (tuple(out), base.clone())
        return snap

    def restore(self, snap: Dict[str, Any]) -> None:
        """Restore a snapshot (copying again, so the snapshot survives for
        a further replay), re-padding states to the current capacities."""
        states = _copy_tree(snap)
        self._snap_levels.clear()
        self._cap_cause = self._cap_cause or "restore"
        for cn in self.cnodes:
            key = str(cn.node.index)
            if key in states:
                states[key] = cn.repad_state(states[key])
            # cached live counts may under-estimate the rewound state
            cn._live_cache = None
        self.states = states

    # -- checkpointed run -----------------------------------------------------
    def run_ticks(self, t0: int, n: int, validate_every: int = 16,
                  on_validated: Optional[Callable] = None,
                  block_each: bool = False, scan: bool = False,
                  project_ratio: float = 1.0,
                  snapshot_every: int = 1) -> None:
        """Run ticks [t0, t0+n) under a ``gen_fn`` with a validation every
        ``validate_every`` ticks and snapshot/replay on overflow (exact:
        inputs are functions of the tick index). ``on_validated(next_tick)``
        fires after each validated interval, once per tick reported: a
        high-water mark suppresses repeats while a replay re-runs
        intervals. ``block_each`` runs each interval pipelined
        (:meth:`_run_pipelined`) with per-tick latency samples; without
        it, ticks queue fully asynchronously and the only syncs are the
        validations. ``scan`` runs each interval, the replay after an
        overflow included, as one chunk (:meth:`step_scanned`): one latency
        sample per chunk."""
        assert self._gen_fn is not None, "run_ticks needs a gen_fn"
        overhead = self.host_overhead_ns
        h0 = time.perf_counter_ns()
        snap, snap_t = self.snapshot(), t0
        overhead["snapshot"].append(time.perf_counter_ns() - h0)
        t = t0
        iv = 0
        reported = t0  # high-water tick already delivered to on_validated
        while t < t0 + n:
            upto = min(t + validate_every, t0 + n)
            if scan:
                self.step_scanned(t, upto - t, block=block_each)
            elif block_each:
                self._run_pipelined(t, upto)
            else:
                for tt in range(t, upto):
                    self.step(tick=tt)
            h0 = time.perf_counter_ns()
            try:
                self.validate()
            except CompiledOverflow as e:
                overhead["validate"].append(time.perf_counter_ns() - h0)
                self.overflow_replays += 1
                self.grow(e, project_ratio=project_ratio)
                self.restore(snap)
                t = snap_t
                continue  # replay from the snapshot at the new capacities
            overhead["validate"].append(time.perf_counter_ns() - h0)
            h0 = time.perf_counter_ns()
            self.maintain()
            overhead["maintain"].append(time.perf_counter_ns() - h0)
            iv += 1
            t = upto
            if iv % max(1, snapshot_every) == 0:
                h0 = time.perf_counter_ns()
                snap, snap_t = self.snapshot(), t
                overhead["snapshot"].append(time.perf_counter_ns() - h0)
                self._note_cause("snapshot")
            if on_validated is not None and t > reported:
                on_validated(t)
                reported = t

    # -- host views -----------------------------------------------------------
    def canonicalize_sink(self, b):
        """Canonical form of a (possibly deferred) sink batch; no-op for a
        batch known to be one sorted run."""
        if not isinstance(b, Batch) or b.sorted_runs == 1:
            return b
        return b.consolidate()

    def output(self, handle_or_op) -> Optional[Batch]:
        """The latest output batch of an output handle (on the device).
        A deferred consolidation happens here, on read, and is cached."""
        op = getattr(handle_or_op, "_op", handle_or_op)
        idx = self._op_to_index[id(op)]
        b = self.last_outputs.get(idx)
        canon = self.canonicalize_sink(b)
        if canon is not b:
            self.last_outputs[idx] = canon
        return canon


def compile_circuit(handle, gen_fn: Optional[Callable] = None,
                    trace_levels: int = cnodes.TRACE_LEVELS
                    ) -> CompiledHandle:
    """Compile a host :class:`~dbsp_tpu_torch.circuit.runtime.CircuitHandle`'s
    circuit onto the handle's device. Operator state already in its spines
    (host-engine steps) migrates into the compiled states: warm up on the
    host, then compile. ``gen_fn(tick)`` returns {input handle: batch} for
    a device tick scalar. ``trace_levels`` is the level count K of every
    input trace (``cnodes.levels_for_run`` picks one for a run length)."""
    return CompiledHandle(handle.circuit, gen_fn=gen_fn,
                          trace_levels=trace_levels)
