"""The port's watermarks and moving windows (dbsp_tpu_torch/timeseries/)
and Nexmark q5 and q7 against dbsp_tpu's, on the CPU: the watermark
sequence with a late row, a window that slides and retracts, a window
whose GC truncates its trace (the spine's rows after the GC equal the
reference's), the compiled watermark and window nodes on seeded numpy
rows (negative keys, int32 and int64 key columns, GC on and off, seed
capacities that overflow), q5 and q7 on the host engine at a slow event
rate (the windows move every tick), q5 in the compiled engine's scanned
mode, and the compiled nodes' edges: the GC bound before the first
bounds on negative int32 keys, and q7's floor division of a negative
watermark. Compiled q5 and q7 tick for tick, the GC'd trace's bounds and
a replay across truncating ticks are in test_torch_compiled.py. Everything runs on the kernels' plain
versions; the columns are integers and every comparison is exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dbsp_tpu.circuit import RootCircuit, Runtime
from dbsp_tpu.circuit.operator import SourceOperator
from dbsp_tpu.compiled import cnodes as rcnodes
from dbsp_tpu.nexmark import (GeneratorConfig, NexmarkGenerator, build_inputs,
                              queries)
from dbsp_tpu.operators import add_input_zset
from dbsp_tpu.zset.batch import Batch
from dbsp_tpu_torch.circuit import RootCircuit as TRootCircuit
from dbsp_tpu_torch.circuit import Runtime as TRuntime
from dbsp_tpu_torch.circuit.operator import SourceOperator as TSourceOperator
from dbsp_tpu_torch.compiled import CompiledOverflow, cnodes, compile_circuit
from dbsp_tpu_torch.nexmark import GeneratorConfig as TGeneratorConfig
from dbsp_tpu_torch.nexmark import NexmarkGenerator as TNexmarkGenerator
from dbsp_tpu_torch.nexmark import build_inputs as tbuild_inputs
from dbsp_tpu_torch.nexmark import queries as tqueries
from dbsp_tpu_torch.operators import add_input_zset as tadd_input_zset
from dbsp_tpu_torch.zset.batch import Batch as TBatch
from test_torch_compiled import one_torch_thread  # noqa: F401  (autouse)


def dict_add(acc: dict, delta: dict) -> dict:
    for r, w in delta.items():
        acc[r] = acc.get(r, 0) + w
        if acc[r] == 0:
            del acc[r]
    return acc


def _push(rh, th, rows, key_dtypes, val_dtypes=()):
    """The same ``((key..., val...), weight)`` rows to the reference's
    input ``rh`` (jnp dtypes) and the port's ``th`` (torch dtypes, the
    same names)."""
    if not rows:
        return
    rk = [getattr(jnp, d) for d in key_dtypes]
    rv = [getattr(jnp, d) for d in val_dtypes]
    tk = [getattr(torch, d) for d in key_dtypes]
    tv = [getattr(torch, d) for d in val_dtypes]
    rh.push_batch(Batch.from_tuples(rows, rk, rv))
    th.push_batch(TBatch.from_tuples(rows, tk, tv, device="cpu"))


def _bounds_source(base):
    """A source emitting the bounds the test sets (``None`` until then),
    on the reference's or the port's operator base class."""
    class BoundsSource(base):
        name = "bounds"
        value = None

        def eval(self):
            return self.value

    return BoundsSource()


# ---------------------------------------------------------------------------
# Watermark
# ---------------------------------------------------------------------------


def _watermark_circuit(add_input, i64):
    def build(c):
        s, h = add_input(c, [i64], [])
        got = []
        s.watermark_monotonic(lambda k, v: k[0], lateness=5).inspect(
            got.append)
        return h, got
    return build


WATERMARK_TICKS = [[], [((100,), 1)], [((90,), 1)],
                   [((300,), 1), ((300,), -1)], [((200,), 2)]]


def test_watermark_sequence_equals_reference():
    """The running max of live timestamps less lateness 5: ``None``
    before the first row, held at a late row and at a tick whose only row
    nets to nothing. The compiled node's (valid, wm) pairs, one tick at a
    time on the same batches, give the same sequence."""
    rc, (rh, rgot) = RootCircuit.build(
        _watermark_circuit(add_input_zset, jnp.int64))
    tc, (th, tgot) = TRootCircuit.build(
        _watermark_circuit(tadd_input_zset, torch.int64), device="cpu")
    for rows in WATERMARK_TICKS:
        _push(rh, th, rows, ["int64"])
        rc.step()
        tc.step()
    assert tgot == rgot == [None, 95, 95, 95, 195]

    node = next(n for n in tc.nodes if n.operator.name == "watermark")
    cn = cnodes.CWatermark(node, node.operator)
    cn.device = torch.device("cpu")
    st = cn.init_state()
    got = []
    for rows in WATERMARK_TICKS:
        b = TBatch.from_tuples(rows, [torch.int64], device="cpu") if rows \
            else TBatch.empty([torch.int64], device="cpu")
        st, out = cn.eval(None, st, [b])
        got.append(int(out.value) if bool(out.valid) else None)
    assert got == rgot


# ---------------------------------------------------------------------------
# Window on the host engine
# ---------------------------------------------------------------------------


def _window_circuit(add_input, base, i64, i32, gc):
    def build(c):
        s, h = add_input(c, [i64], [i32] if not gc else [])
        src = _bounds_source(base)
        w = s.window(c.add_source(src), gc=gc)
        return h, src, w.output(), s.trace()
    return build


def _both_windows(gc):
    rc, (rh, rsrc, rout, rtrace) = RootCircuit.build(_window_circuit(
        add_input_zset, SourceOperator, jnp.int64, jnp.int32, gc))
    tc, (th, tsrc, tout, ttrace) = TRootCircuit.build(_window_circuit(
        tadd_input_zset, TSourceOperator, torch.int64, torch.int32, gc),
        device="cpu")
    return (rc, rh, rsrc, rout, rtrace), (tc, th, tsrc, tout, ttrace)


def test_window_slides_and_retracts():
    """The window's deltas, integrated, hold exactly the rows inside the
    bounds as they slide (a late row inside the window arrives with the
    slide) and jump past everything; equal to the reference each tick."""
    ref, port = _both_windows(gc=False)
    acc_r, acc_t = {}, {}
    steps = [([((t, t * 10), 1) for t in range(20)], (5, 10)),
             ([((8, 81), 1)], (7, 15)),
             ([], (100, 200))]
    wants = [{(t, t * 10): 1 for t in range(5, 10)},
             {**{(t, t * 10): 1 for t in range(7, 15)}, (8, 81): 1},
             {}]
    for (rows, bounds), want in zip(steps, wants):
        _push(ref[1], port[1], rows, ["int64"], ["int32"])
        ref[2].value = port[2].value = bounds
        ref[0].step()
        port[0].step()
        dict_add(acc_r, ref[3].to_dict())
        dict_add(acc_t, port[3].to_dict())
        assert acc_t == acc_r == want


def test_window_gc_truncates_trace():
    """``gc=True``: after the bounds move to [90, 95) the spine holds only
    the rows at or above 90, in both engines' spines alike."""
    ref, port = _both_windows(gc=True)
    _push(ref[1], port[1], [((t,), 1) for t in range(100)], ["int64"])
    acc_r, acc_t = {}, {}
    for bounds in ((0, 10), (90, 95)):
        ref[2].value = port[2].value = bounds
        ref[0].step()
        port[0].step()
        dict_add(acc_r, ref[3].to_dict())
        dict_add(acc_t, port[3].to_dict())
    assert acc_t == acc_r == {(t,): 1 for t in range(90, 95)}
    rspine = ref[4].node.operator.spine
    tspine = port[4].node.operator.spine
    assert tspine.to_dict() == rspine.to_dict() == \
        {(t,): 1 for t in range(90, 100)}
    # every level was shrunk to the bucket of its live rows
    assert sum(b.cap for b in tspine.batches) <= 16


@pytest.mark.parametrize("bound", [(3,), (3, -2), (-9, 0), (40, 0)])
def test_spine_truncate_keys_below_equals_reference(bound):
    """``Spine.truncate_keys_below`` on a multi-level spine of rows with
    two key columns (one int32), negative keys and retractions: the
    lexicographic cut of the reference's spine, each column compared in
    its own dtype."""
    from dbsp_tpu.trace.spine import Spine as RSpine
    from dbsp_tpu_torch.trace.spine import Spine as TSpine

    rng = np.random.default_rng(5)
    rsp = RSpine([jnp.int64, jnp.int32], [jnp.int64])
    tsp = TSpine([torch.int64, torch.int32], [torch.int64], device="cpu")
    for n in (40, 9, 17, 3):
        rows = [((int(rng.integers(-10, 10)), int(rng.integers(-4, 4)),
                  int(rng.integers(0, 3))), int(rng.choice([1, 2, -1])))
                for _ in range(n)]
        rsp.insert(Batch.from_tuples(rows, [jnp.int64, jnp.int32],
                                     [jnp.int64]))
        tsp.insert(TBatch.from_tuples(rows, [torch.int64, torch.int32],
                                      [torch.int64], device="cpu"))
    assert len(tsp.batches) > 1
    rsp.truncate_keys_below(bound)
    tsp.truncate_keys_below(bound)
    assert tsp.to_dict() == rsp.to_dict()
    assert all(r[:len(bound)] >= bound for r in tsp.to_dict())


# ---------------------------------------------------------------------------
# Window and watermark compiled, in feeds mode
# ---------------------------------------------------------------------------


def _wm_window_circuit(add_input, key_dtype, i64, gc):
    """Rows keyed by a (possibly int32, possibly negative) time, windowed
    by bounds [wm - 10, wm + 4) from a watermark (lateness 3) over a
    second input of times."""
    def build(c):
        s, h = add_input(c, [key_dtype], [i64])
        t, ht = add_input(c, [i64], [])
        wm = t.watermark_monotonic(lambda k, v: k[0], lateness=3)
        bounds = wm.apply(lambda w: None if w is None else (w - 10, w + 4),
                          name="bounds")
        return (h, ht), s.window(bounds, gc=gc).output()
    return build


def _wm_window_rows(rng, tick, pool):
    """One tick: rows of keys around the moving time (negative at first),
    some retracting earlier rows, and the tick's times."""
    centre = -30 + 6 * tick
    rows = [((int(rng.integers(centre - 12, centre + 12)),
              int(rng.integers(0, 3))), int(rng.choice([1, 1, 2])))
            for _ in range(int(rng.integers(4, 14)))]
    if pool and tick % 2:
        idx = rng.integers(0, len(pool), 3)
        rows += [(pool[i], -1) for i in idx]
    pool += [r for r, w in rows if w > 0]
    times = [((centre + int(d),), 1) for d in rng.integers(-2, 3, 2)] \
        if tick else []
    return rows, times


def _compiled_feeds_step(ch, tick, feeds) -> int:
    """One feeds-mode tick with the replay contract: on an overflow grow,
    restore the snapshot and step again. Returns the overflows."""
    overflows = 0
    while True:
        snap = ch.snapshot()
        ch.step(tick, feeds=feeds)
        try:
            ch.validate()
            break
        except CompiledOverflow as e:
            overflows += 1
            ch.grow(e)
            ch.restore(snap)
    ch.maintain()
    return overflows


@pytest.mark.parametrize("key_dtype,gc", [("int64", True), ("int32", True),
                                          ("int64", False)])
def test_compiled_window_equals_reference(monkeypatch, key_dtype, gc):
    """A watermark-driven window over seeded rows with retractions: the
    port's host and compiled engines equal the reference's host engine
    every tick, from slide capacities small enough to overflow and
    replay. With GC the trace's rows (the union of the compiled levels)
    equal the reference spine's after every tick, and the trace takes no
    slots."""
    monkeypatch.setattr(cnodes, "LEVEL0_CAP", 16)
    rb = _wm_window_circuit(add_input_zset, getattr(jnp, key_dtype),
                            jnp.int64, gc)
    tb = _wm_window_circuit(tadd_input_zset, getattr(torch, key_dtype),
                            torch.int64, gc)
    rh, ((rs, rt), rout) = Runtime.init_circuit(1, rb)
    th, ((ts, tt), tout) = TRuntime.init_circuit(1, tb, device="cpu")
    chh, ((cs, ct), cout) = TRuntime.init_circuit(1, tb, device="cpu")
    ch = compile_circuit(chh)
    win = next(cn for cn in ch.cnodes if isinstance(cn, cnodes.CWindow))
    win.caps["slide_out"] = win.caps["slide_in"] = 2  # force replays
    trace_cn = ch.by_index[win.node.inputs[0]]
    rtrace = next(n.operator for n in rh.circuit.nodes
                  if n.operator.name == "trace")
    rng = np.random.default_rng(3)
    pool: list = []
    overflows = seen = 0
    for tick in range(8):
        rows, times = _wm_window_rows(rng, tick, pool)
        _push(rs, ts, rows, [key_dtype], ["int64"])
        _push(rt, tt, times, ["int64"])
        rh.step()
        th.step()
        feeds = {}
        if rows:
            feeds[cs] = TBatch.from_tuples(rows, [getattr(torch, key_dtype)],
                                           [torch.int64], device="cpu")
        if times:
            feeds[ct] = TBatch.from_tuples(times, [torch.int64],
                                           device="cpu")
        overflows += _compiled_feeds_step(ch, tick, feeds)
        want = rout.to_dict()
        got = ch.output(cout)
        assert tout.to_dict() == want, tick
        assert (got.to_dict() if got is not None else {}) == want, tick
        seen += len(want)
        if gc:
            levels, _ = ch.states[str(trace_cn.node.index)]
            held: dict = {}
            for lvl in levels:
                dict_add(held, lvl.to_dict())
            assert held == rtrace.spine.to_dict(), tick
    assert seen > 20 and overflows > 0
    assert trace_cn._slot_cap is None and trace_cn._no_slots
    assert (trace_cn.MONOTONE_CAPS == frozenset()) == gc


def test_truncate_below_keeps_negative_int32_keys_before_bounds():
    """Before the first bounds the GC bound is ``_WM_FLOOR``; compared in
    int64 it keeps every row of an int32 key column, negative keys
    included (cast to int32 it would wrap to 0 and drop them), as the
    reference's truncate_below does."""
    keys = np.array([-50, -7, -1, 0, 3, 12], np.int32)
    w = np.ones(len(keys), np.int64)
    b = TBatch.from_columns([keys], [], w, device="cpu", cap=8)
    floor = torch.full((), cnodes._WM_FLOOR, dtype=torch.int64)
    assert cnodes._WM_FLOOR == rcnodes._WM_FLOOR
    kept = cnodes.truncate_below(b, floor)
    rb = Batch.from_columns([jnp.asarray(keys)], [], jnp.asarray(w), cap=8)
    rkept = rcnodes.truncate_below(rb, jnp.asarray(rcnodes._WM_FLOOR,
                                                   jnp.int64))
    assert kept.to_dict() == rkept.to_dict() == b.to_dict()
    assert len(kept.to_dict()) == 6
    # a real bound drops the rows below it and keeps the rest packed
    cut = cnodes.truncate_below(b, torch.tensor(-1))
    assert cut.to_dict() == {(-1,): 1, (0,): 1, (3,): 1, (12,): 1}
    assert cut.keys[0][:4].tolist() == [-1, 0, 3, 12]
    assert cut.weights[4:].tolist() == [0] * 4


def test_q7_bounds_floor_negative_watermarks():
    """q7's bounds on a device watermark (the compiled ``apply``) floor
    as the reference's do on a host int, below zero and at the
    pre-first-event floor too."""
    tc, _ = TRuntime.init_circuit(1, lambda c: tqueries.q7(
        *tbuild_inputs(c)[0]), device="cpu")
    rc, _ = Runtime.init_circuit(1, lambda c: queries.q7(
        *build_inputs(c)[0]))

    def bounds_fn(circuit):
        return next(n.operator.fn for n in circuit.nodes
                    if n.operator.name == "q7-bounds")

    tfn, rfn = bounds_fn(tc.circuit), bounds_fn(rc.circuit)
    for w in (cnodes._WM_FLOOR, -10_001, -10_000, -9_999, -1, 0, 9_999,
              10_000, 123_456_789):
        a, b = tfn(torch.tensor(w, dtype=torch.int64))
        assert (int(a), int(b)) == rfn(w), w
        ra, rb = rfn(jnp.asarray(w, jnp.int64))
        assert (int(a), int(b)) == (int(ra), int(rb)), w
    assert rfn(None) is None and tfn(None) is None


# ---------------------------------------------------------------------------
# Nexmark q5 and q7 on the host engine
# ---------------------------------------------------------------------------

HOST_RATE = 50          # events/s of event time: a 500-event tick is 10 s
HOST_EVENTS, HOST_TICKS = 500, 6


@pytest.mark.parametrize("query", ["q5", "q7"])
def test_host_query_equals_reference(query):
    """q5 and q7 at 50 events/s (each tick 10 s of event time, so q7's
    window moves every tick and q5's GC retires windows): the port's host
    engine equals the reference's every tick, q5's GC'd spine holds what
    the reference's holds, and both outputs are non-empty."""
    def rb(c):
        s, h = build_inputs(c)
        return h, getattr(queries, query)(*s).output()

    def tb(c):
        s, h = tbuild_inputs(c)
        return h, getattr(tqueries, query)(*s).output()

    rh, (rin, rout) = Runtime.init_circuit(1, rb)
    th, (tin, tout) = TRuntime.init_circuit(1, tb, device="cpu")
    rgen = NexmarkGenerator(GeneratorConfig(seed=1,
                                            first_event_rate=HOST_RATE))
    tgen = TNexmarkGenerator(TGeneratorConfig(seed=1,
                                              first_event_rate=HOST_RATE))
    rows = 0
    for t in range(HOST_TICKS):
        rgen.feed(rin, t * HOST_EVENTS, (t + 1) * HOST_EVENTS)
        tgen.feed(tin, t * HOST_EVENTS, (t + 1) * HOST_EVENTS)
        rh.step()
        th.step()
        want = rout.to_dict()
        assert tout.to_dict() == want, t
        rows += len(want)
    assert rows > 0
    if query == "q5":
        rsp, tsp = (next(n.operator.spine for n in h.circuit.nodes
                         if n.operator.name == "trace"
                         and len(n.operator.spine.key_dtypes) == 2
                         and not n.operator.spine.val_dtypes)
                    for h in (rh, th))
        held = tsp.to_dict()
        assert held == rsp.to_dict()
        # the retention (40 s) is four ticks: the GC dropped the windows
        # of the first bids
        base = TGeneratorConfig().base_time_ms
        first = (base // tqueries.Q5_HOP_MS) * tqueries.Q5_HOP_MS \
            - 4 * tqueries.Q5_HOP_MS
        assert held and min(k[0] for k in held) > first + 10_000


def test_compiled_scan_q5_matches_reference_scan():
    """q5 in the scanned mode at 40 events/s (each interval of two ticks
    one chunk; on the CPU its ticks run eagerly under the same
    contract): every interval's last-tick output equals the reference's
    scanned run and the port's eager run, and the two port runs end in
    equal states."""
    from dbsp_tpu_torch.compiled.compiler import _layout, _leaves
    from test_torch_compiled import WINDOW_RATE, _compiled_run, \
        _ref_compiled_run

    ticks, every = 6, 2
    comp, ch = _compiled_run("q5", ticks, validate_every=every, scan=True,
                             rate=WINDOW_RATE)
    eager, ech = _compiled_run("q5", ticks, validate_every=every,
                               rate=WINDOW_RATE)
    ref, _ = _ref_compiled_run("q5", ticks, every, scan=True,
                               rate=WINDOW_RATE)
    for t in range(every - 1, ticks, every):
        assert comp[t] == ref[t] == eager[t], t
    assert sum(len(comp[t]) for t in range(every - 1, ticks, every)) > 10
    assert len(ch.step_times_ns) == ticks // every + ch.overflow_replays
    assert _layout(ch.states) == _layout(ech.states)
    assert all(torch.equal(a, b)
               for a, b in zip(_leaves(ch.states), _leaves(ech.states)))
