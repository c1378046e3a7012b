"""The port's compiled engine (dbsp_tpu_torch/compiled/) against the
reference's HOST engine on the same events, tick for tick: Nexmark q4,
q3, q8, q17, q9 and q6 fed by the port's device-side generator, with
initial capacities small enough that grow + restore + replay happen (q9
and q6 also against the reference's compiled engine); a retraction circuit fed
through ``step(feeds=...)`` that engages the aggregate's slow path; a warm
start from host-engine state; a deep ladder whose drains cascade; the
Z-set algebra nodes in feeds mode; and the consolidation placement pass
against the reference's.
The scanned mode (``run_ticks(scan=True)``) against the reference's
scanned run and its host engine, and against the port's eager run state
for state; ``apply`` compiled against the reference's.
The pattern is tests/test_compiled.py's. Everything runs on the CPU, on
the kernels' plain versions."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dbsp_tpu.circuit import Runtime
from dbsp_tpu.nexmark import (GeneratorConfig, NexmarkGenerator, build_inputs,
                              queries)
from dbsp_tpu_torch.circuit import Runtime as TRuntime
from dbsp_tpu_torch.compiled import (CompiledOverflow, cnodes,
                                     compile_circuit)
from dbsp_tpu_torch.nexmark import GeneratorConfig as TGeneratorConfig
from dbsp_tpu_torch.nexmark import NexmarkGenerator as TNexmarkGenerator
from dbsp_tpu_torch.nexmark import build_inputs as tbuild_inputs
from dbsp_tpu_torch.nexmark import device_gen as tdevice_gen
from dbsp_tpu_torch.nexmark import queries as tqueries
from dbsp_tpu_torch.zset.batch import bucket_cap
from test_torch_operators import _arange2, _twice

CFG = GeneratorConfig(seed=1)
TCFG = TGeneratorConfig(seed=1)
EPT = 8           # epochs per tick -> 400 events per tick
_HOST_RUNS = {}   # reference host-engine outputs, shared by the tests


def _ref_build(query):
    def build(c):
        streams, handles = build_inputs(c)
        return handles, getattr(queries, query)(*streams).output()
    return build


def _port_build(query):
    def build(c):
        streams, handles = tbuild_inputs(c)
        return handles, getattr(tqueries, query)(*streams).output()
    return build


def _cfgs(rate):
    """The reference's and the port's generator configs: seed 1, at
    ``rate`` events/s of event time (None: the default rate)."""
    if rate is None:
        return CFG, TCFG
    return (GeneratorConfig(seed=1, first_event_rate=rate),
            TGeneratorConfig(seed=1, first_event_rate=rate))


def _host_run(query, ticks, rate=None):
    """The reference's host engine on the numpy generator's events, one
    output dict per tick (cached: the longest run serves shorter ones)."""
    have = _HOST_RUNS.get((query, rate))
    if have is None or len(have) < ticks:
        gen = NexmarkGenerator(_cfgs(rate)[0])
        handle, (handles, out) = Runtime.init_circuit(1, _ref_build(query))
        have = []
        for t in range(ticks):
            gen.feed(handles, t * EPT * 50, (t + 1) * EPT * 50)
            handle.step()
            b = out.take()
            have.append(b.to_dict() if b is not None else {})
        _HOST_RUNS[(query, rate)] = have
    return have[:ticks]


def _gen_fn(handles, cfg=TCFG):
    hp, ha, hb = handles

    def gen_fn(tick):
        p, a, b = tdevice_gen.generate_tick(cfg, tick * EPT, EPT)
        return {hp: p, ha: a, hb: b}
    return gen_fn


def _compiled_run(query, ticks, validate_every=1, t0=0, handle=None,
                  trace_levels=cnodes.TRACE_LEVELS, scan=False, rate=None,
                  snapshot_every=1):
    if handle is None:
        handle = TRuntime.init_circuit(1, _port_build(query), device="cpu")
    h, (handles, out) = handle
    ch = compile_circuit(h, gen_fn=_gen_fn(handles, _cfgs(rate)[1]),
                         trace_levels=trace_levels)
    outs = {}

    def capture(next_tick):
        b = ch.output(out)
        outs[next_tick - 1] = b.to_dict() if b is not None else {}

    ch.run_ticks(t0, ticks, validate_every=validate_every,
                 on_validated=capture, scan=scan,
                 snapshot_every=snapshot_every)
    return [outs.get(t, {}) for t in range(t0, t0 + ticks)], ch


def _ref_compiled_run(query, ticks, validate_every, scan, rate=None):
    """The reference's compiled engine, each tick or (``scan``) each
    interval one dispatch: {last tick of each validated interval: its
    output}."""
    from dbsp_tpu.compiled import compile_circuit as rcompile_circuit
    from dbsp_tpu.nexmark import device_gen

    h, ((hp, ha, hb), out) = Runtime.init_circuit(1, _ref_build(query))
    cfg = _cfgs(rate)[0]

    def gen_fn(tick):
        p, a, b = device_gen.generate_tick(cfg, tick * EPT, EPT)
        return {hp: p, ha: a, hb: b}

    ch = rcompile_circuit(h, gen_fn=gen_fn)
    outs = {}

    def capture(next_tick):
        b = ch.output(out)
        outs[next_tick - 1] = b.to_dict() if b is not None else {}

    ch.run_ticks(0, ticks, validate_every=validate_every,
                 on_validated=capture, scan=scan)
    return outs, ch


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread for the port's CPU work in these tests. The
    tier-1 run puts six pytest workers on eight cores, where torch's
    default of one OpenMP thread per core oversubscribes them and the
    threads' waits made these tests 10-80x slower (one that takes 4 s
    alone took 117 s beside six busy processes, and 6 s with one
    thread). The tensors here are small: one thread costs nothing
    alone. Other port test modules import this fixture."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def small_caps(monkeypatch):
    """Seed capacities below a few ticks' state, so the run overflows,
    grows, restores its snapshot and replays."""
    monkeypatch.setattr(cnodes, "LEVEL0_CAP", 64)
    monkeypatch.setattr(cnodes.CTrace, "DEFAULT_CAP", 256)


def test_compiled_q4_matches_reference_host(small_caps):
    """q4 = join + general Max (fast path) + linear Average."""
    ticks = 4
    comp, ch = _compiled_run("q4", ticks)
    host = _host_run("q4", ticks)
    assert comp == host
    assert sum(len(t) for t in host) > 10
    assert ch.overflow_replays > 0, "no grow + restore + replay happened"
    maxn = next(cn for cn in ch.cnodes
                if isinstance(cn, cnodes.CAggregate))
    assert not bool(ch.states[str(maxn.node.index)][1]), \
        "q4 only inserts: the fast path's gate must stay off"
    ch.validate()  # no pending overflow


def test_compiled_q3_matches_reference_host(monkeypatch):
    """q3 = filters + index + join; its traces hold a few rows a tick, so
    level 0 and the tail start at 8 rows to force the replay."""
    monkeypatch.setattr(cnodes, "LEVEL0_CAP", 8)
    monkeypatch.setattr(cnodes.CTrace, "DEFAULT_CAP", 8)
    ticks = 4
    comp, ch = _compiled_run("q3", ticks)
    assert comp == _host_run("q3", ticks)
    assert ch.overflow_replays > 0, "no grow + restore + replay happened"
    assert ch.deferred_consolidations == 1  # the join's, to the sink


def test_compiled_validate_every_two_matches(small_caps):
    """Validation every 2 ticks: overflows are caught an interval late and
    the replay re-runs the whole interval from its snapshot."""
    ticks = 4
    comp, ch = _compiled_run("q4", ticks, validate_every=2)
    host = _host_run("q4", ticks)
    assert comp[1] == host[1] and comp[3] == host[3]
    assert ch.overflow_replays > 0


def test_compiled_warm_start_from_host_state():
    """Host-engine warm-up, then compile: the spines migrate into the
    compiled states and the run goes on equal to the reference."""
    gen = TNexmarkGenerator(TCFG)
    h, (handles, out) = TRuntime.init_circuit(1, _port_build("q4"),
                                              device="cpu")
    for t in range(2):
        gen.feed(handles, t * EPT * 50, (t + 1) * EPT * 50)
        h.step()
        out.take()
    comp, ch = _compiled_run("q4", 2, t0=2, handle=(h, (handles, out)))
    host = _host_run("q4", 4)
    assert comp == host[2:]
    maxn = next(cn for cn in ch.cnodes if isinstance(cn, cnodes.CAggregate))
    # a warmed spine has an unknown retraction history: slow path on
    assert bool(ch.states[str(maxn.node.index)][1])


@pytest.mark.parametrize("budget", [None, 40])
def test_compiled_deep_ladder_matches_reference_host(monkeypatch, budget):
    """A 4-level ladder from a 16-row level 0 growing 2x: drains cascade
    through the middle levels (and overflow replays happen) while the
    outputs stay equal to the reference tick for tick. With a 40-row
    maintenance budget the deep drains move prefix slices and resume on
    later calls."""
    from dbsp_tpu_torch.compiled import compiler

    if budget is not None:
        monkeypatch.setattr(compiler, "MAINTAIN_BUDGET_ROWS", budget)
    monkeypatch.setattr(cnodes, "LEVEL0_CAP", 16)
    monkeypatch.setattr(cnodes, "LEVEL_GROWTH", 2)
    ticks = 6
    comp, ch = _compiled_run("q4", ticks, trace_levels=4)
    assert comp == _host_run("q4", ticks)
    leveled = [cn for cn in ch.cnodes if isinstance(cn, cnodes._Leveled)]
    assert leveled and all(len(cn.level_keys) == 4 for cn in leveled)

    def deeper_live(cn):
        levels, _ = ch.states[str(cn.node.index)]
        return sum(int(b.live_count()) for b in levels[1:])

    assert any(deeper_live(cn) > 0 for cn in leveled)
    assert ch.maintain_stats["rows_moved"] > 0
    assert ch.overflow_replays > 0
    if budget is not None:
        assert ch.maintain_stats["partial_drains"] > 0


@pytest.mark.parametrize("query,caps", [("q4", (64, 256)), ("q8", (8, 8)),
                                        ("q9", (64, 256))])
def test_compiled_scan_matches_reference_scan_and_host(monkeypatch, query,
                                                       caps):
    """``run_ticks(scan=True)`` with seed capacities small enough that an
    interval overflows: the chunk grows, restores its snapshot and runs
    again as one chunk. Each interval's last-tick output equals the
    reference's scanned run and its host engine."""
    from dbsp_tpu.compiled import cnodes as rcnodes

    for mod in (cnodes, rcnodes):
        monkeypatch.setattr(mod, "LEVEL0_CAP", caps[0])
        monkeypatch.setattr(mod.CTrace, "DEFAULT_CAP", caps[1])
    ticks, every = 4, 2
    comp, ch = _compiled_run(query, ticks, validate_every=every, scan=True)
    ref, _ = _ref_compiled_run(query, ticks, every, scan=True)
    host = _host_run(query, ticks)
    for t in (1, 3):
        assert comp[t] == ref[t] == host[t], t
    assert sum(len(host[t]) for t in (1, 3)) > 5
    assert ch.overflow_replays > 0, "no grow + restore + replay happened"
    # one latency sample a chunk, the replayed one included
    assert len(ch.step_times_ns) == ticks // every + ch.overflow_replays
    assert ch._tick_host == ticks and int(ch._tick_dev) == ticks


def test_compiled_scan_equals_eager_state_for_state(small_caps):
    """The scanned and the eager run of q4 end in equal states (every
    leaf and every batch's run metadata), requirements and tick cursor;
    the scanned run takes one latency sample a chunk."""
    from dbsp_tpu_torch.compiled.compiler import _layout, _leaves

    runs = {}
    for scan in (False, True):
        outs, ch = _compiled_run("q4", 6, validate_every=3, scan=scan)
        runs[scan] = (outs, ch)
    (eo, e), (so, s) = runs[False], runs[True]
    assert eo[2] == so[2] and eo[5] == so[5]
    assert _layout(e.states) == _layout(s.states)
    assert all(torch.equal(a, b)
               for a, b in zip(_leaves(e.states), _leaves(s.states)))
    assert e.last_req == s.last_req
    assert e.overflow_replays == s.overflow_replays > 0
    assert int(e._tick_dev) == int(s._tick_dev) == 6
    assert len(s.step_times_ns) == 2 + s.overflow_replays
    assert len(e.step_times_ns) == 6 + 3 * e.overflow_replays
    assert ("snapshot" in {c for _, c in s.tick_causes})


def test_step_scanned_needs_a_gen_fn():
    from dbsp_tpu_torch.operators import add_input_zset

    def build(c):
        s, h = add_input_zset(c, [torch.int64], [])
        return h, s.output()

    h, _ = TRuntime.init_circuit(1, build, device="cpu")
    ch = compile_circuit(h)
    with pytest.raises(AssertionError, match="gen_fn"):
        ch.step_scanned(0, 2)


def _apply_circuit(add_input, i64):
    """``apply`` on a batch stream: a negation whose rows then feed a
    distinct, and the stream merged with itself, read at the sink."""
    def build(c):
        s, h = add_input(c, (i64,), (i64,))
        neg = s.apply(lambda b: b.neg(), name="negate")
        neg.schema = s.schema  # apply keeps the batch schema
        o1 = neg.distinct().output()
        o2 = s.apply(lambda b: b.merge_with(b), name="twice").output()
        return h, (o1, o2)
    return build


def test_compiled_apply_matches_reference():
    """``CApply`` (its plain-value branch): the compiled port equals the
    reference's compiled engine and its host engine, tick for tick, with
    retractions."""
    from dbsp_tpu.compiled import compile_circuit as rcompile_circuit
    from dbsp_tpu.operators import add_input_zset
    from dbsp_tpu.zset.batch import Batch
    from dbsp_tpu_torch.operators import add_input_zset as tadd_input_zset
    from dbsp_tpu_torch.zset.batch import Batch as TBatch

    rh, (rin, rout) = Runtime.init_circuit(
        1, _apply_circuit(add_input_zset, jnp.int64))
    ch_ref_h, (cin, cout) = Runtime.init_circuit(
        1, _apply_circuit(add_input_zset, jnp.int64))
    ref_ch = rcompile_circuit(ch_ref_h)
    th, (tin, tout) = TRuntime.init_circuit(
        1, _apply_circuit(tadd_input_zset, torch.int64), device="cpu")
    ch = compile_circuit(th)
    assert sum(type(cn).__name__ == "CApply" for cn in ch.cnodes) == 2
    rng = np.random.default_rng(7)
    seen = 0
    for tick in range(4):
        n = int(rng.integers(3, 10))
        k = rng.integers(0, 6, n).astype(np.int64)
        v = rng.integers(0, 3, n).astype(np.int64)
        w = rng.choice(np.array([-1, 1, 2], np.int64), n)
        rin.push_batch(Batch.from_columns([k], [v], w, cap=16))
        rh.step()
        ref_ch.step(tick, feeds={cin: Batch.from_columns([k], [v], w,
                                                          cap=16)})
        ref_ch.validate()
        ch.step(tick, feeds={tin: TBatch.from_columns([k], [v], w,
                                                       device="cpu", cap=16)})
        ch.validate()
        for r, c, o in zip(rout, cout, tout):
            want = r.to_dict()
            rb, got = ref_ch.output(c), ch.output(o)
            assert (rb.to_dict() if rb is not None else {}) == want, tick
            assert (got.to_dict() if got is not None else {}) == want, tick
            seen += len(want)
    assert seen > 15


def _retraction_circuit(add_input, ops, i64):
    """input -> index -> aggregate Max and linear Average."""
    def build(c):
        s, h = add_input(c, [i64], [i64])
        keyed = s.index_by(lambda k, v: (k[0] % 5,), [i64],
                           val_fn=lambda k, v: (v[0],), val_dtypes=[i64],
                           name="by5")
        mx = keyed.aggregate(ops.Max(0), name="mx")
        avg = keyed.aggregate(ops.Avg(0), name="avg")
        return h, (mx.output(), avg.output())
    return build


def test_compiled_retractions_take_the_slow_path():
    """Batches with negative weights through ``step(feeds=...)``: the
    aggregate's ``ever_negative`` gate flips, the gather re-reads the
    touched groups' histories, and every tick equals the reference's host
    engine."""
    import types

    from dbsp_tpu.operators import add_input_zset
    from dbsp_tpu.operators.aggregate import Max
    from dbsp_tpu.operators.aggregate_linear import LinearAverage
    from dbsp_tpu.zset.batch import Batch
    from dbsp_tpu_torch.operators import LinearAverage as TLinearAverage
    from dbsp_tpu_torch.operators import Max as TMax
    from dbsp_tpu_torch.operators import add_input_zset as tadd_input_zset
    from dbsp_tpu_torch.zset.batch import Batch as TBatch

    rh, (rin, rout) = Runtime.init_circuit(1, _retraction_circuit(
        add_input_zset, types.SimpleNamespace(Max=Max, Avg=LinearAverage),
        jnp.int64))
    th, (tin, tout) = TRuntime.init_circuit(1, _retraction_circuit(
        tadd_input_zset, types.SimpleNamespace(Max=TMax, Avg=TLinearAverage),
        torch.int64), device="cpu")
    ch = compile_circuit(th)
    mx = next(cn for cn in ch.cnodes if isinstance(cn, cnodes.CAggregate))
    rng = np.random.default_rng(12)
    live = []
    seen = gates = 0
    for tick in range(7):
        rows = [(int(rng.integers(0, 40)), int(rng.integers(-60, 60)), 1)
                for _ in range(int(rng.integers(4, 14)))]
        if tick >= 2 and live:  # retract earlier rows from tick 2 on
            idx = rng.choice(len(live), size=min(5, len(live)),
                             replace=False)
            rows += [(*live[i], -1) for i in sorted(idx)]
            live = [r for i, r in enumerate(live) if i not in set(idx)]
        live += [(k, v) for k, v, w in rows if w > 0]
        k = np.array([r[0] for r in rows], np.int64)
        v = np.array([r[1] for r in rows], np.int64)
        w = np.array([r[2] for r in rows], np.int64)
        rin.push_batch(Batch.from_columns([k], [v], w, cap=32))
        rh.step()
        feed = TBatch.from_columns([k], [v], w, device="cpu", cap=32)
        while True:  # the feeds-mode replay: grow, restore, step again
            snap = ch.snapshot()
            ch.step(tick, feeds={tin: feed})
            try:
                ch.validate()
                break
            except CompiledOverflow as e:
                ch.grow(e)
                ch.restore(snap)
        ch.maintain()
        gates += bool(ch.states[str(mx.node.index)][1])
        for r, t in zip(rout, tout):
            want = r.to_dict()
            b = ch.output(t)
            assert (b.to_dict() if b is not None else {}) == want, \
                f"tick {tick}"
            seen += len(want)
    assert seen > 20
    assert gates == 5, "the gate must flip at the first retraction, tick 2"
    assert "gather" in mx.MONOTONE_CAPS, "the slow path never gathered"


def test_compiled_q8_matches_reference_host(monkeypatch):
    """q8 = index + join with a value-less side + distinct (the compiled
    distinct: one two-sided ladder probe over the pre-tick levels, a
    slotted level 0 fanned out into its slots), across grow + restore +
    replay."""
    monkeypatch.setattr(cnodes, "LEVEL0_CAP", 8)
    monkeypatch.setattr(cnodes.CTrace, "DEFAULT_CAP", 8)
    ticks = 4
    comp, ch = _compiled_run("q8", ticks)
    host = _host_run("q8", ticks)
    assert comp == host
    assert sum(len(t) for t in host) > 10
    assert ch.overflow_replays > 0, "no grow + restore + replay happened"
    assert any(isinstance(cn, cnodes.CDistinct) for cn in ch.cnodes)
    ch.validate()


def test_compiled_q8_validate_every_two_matches(monkeypatch):
    """q8 with the overflow caught an interval late: the replay re-runs
    the whole interval, the distinct's trace included."""
    monkeypatch.setattr(cnodes, "LEVEL0_CAP", 8)
    monkeypatch.setattr(cnodes.CTrace, "DEFAULT_CAP", 8)
    ticks = 4
    comp, ch = _compiled_run("q8", ticks, validate_every=2)
    host = _host_run("q8", ticks)
    assert comp[1] == host[1] and comp[3] == host[3]
    assert ch.overflow_replays > 0


def test_compiled_q17_matches_reference_host(small_caps):
    """q17 = map + the general Min and Max (agg_ladder, fast path) + the
    linear Count and Average + three joins over aggregate outputs, which
    retract and insert, across grow + restore + replay."""
    ticks = 4
    comp, ch = _compiled_run("q17", ticks)
    host = _host_run("q17", ticks)
    assert comp == host
    assert sum(len(t) for t in host) > 50
    assert ch.overflow_replays > 0, "no grow + restore + replay happened"
    aggs = [cn for cn in ch.cnodes if isinstance(cn, cnodes.CAggregate)]
    assert sorted(cn.op.agg.name for cn in aggs) == ["max", "min"]
    assert not any(bool(ch.states[str(cn.node.index)][1]) for cn in aggs), \
        "q17 only inserts: the fast path's gate must stay off"
    assert ch.deferred_consolidations == 1  # the last join's, to the sink


@pytest.mark.parametrize("query", ["q9", "q6"])
def test_compiled_topk_query_matches_reference_compiled_and_host(query):
    """q9 = join + filter + per-key top-1 (``CTopK``'s +1 new / -1 old
    diff against its static out trace); q6 = q9's winners -> per-seller
    top-10 -> linear average. Every tick equals the reference's compiled
    engine and its host engine, across grow + restore + replay."""
    ticks = 4
    comp, ch = _compiled_run(query, ticks)
    ref, _ = _ref_compiled_run(query, ticks, 1, scan=False)
    host = _host_run(query, ticks)
    assert comp == [ref[t] for t in range(ticks)] == host
    assert sum(len(t) for t in host) > 50
    assert ch.overflow_replays > 0, "no grow + restore + replay happened"
    topks = [cn for cn in ch.cnodes if isinstance(cn, cnodes.CTopK)]
    assert [cn.op.k for cn in topks] == ([1] if query == "q9" else [1, 10])
    ch.validate()


def test_compiled_topk_warm_start_from_host_state():
    """q9 warmed up on the host engine, then compiled: ``CTopK`` takes
    the host operator's output spine as its out trace, and the run goes
    on equal to the reference."""
    gen = TNexmarkGenerator(TCFG)
    h, (handles, out) = TRuntime.init_circuit(1, _port_build("q9"),
                                              device="cpu")
    for t in range(2):
        gen.feed(handles, t * EPT * 50, (t + 1) * EPT * 50)
        h.step()
        out.take()
    comp, ch = _compiled_run("q9", 2, t0=2, handle=(h, (handles, out)))
    assert comp == _host_run("q9", 4)[2:]
    (topk,) = [cn for cn in ch.cnodes if isinstance(cn, cnodes.CTopK)]
    assert topk.op.out_spine.batches, "the host run left no top-K state"


def _algebra_circuit(add_input, i64):
    """plus, minus, neg and sum_with feeding stream_distinct and distinct,
    and a deferred sum read through a negation."""
    def build(c):
        s1, h1 = add_input(c, (i64,), ())
        s2, h2 = add_input(c, (i64,), ())
        s3, h3 = add_input(c, (i64,), ())
        b = s1.plus(s2).minus(s3)
        d = b.sum_with([s3.neg(), s1])
        o1 = d.stream_distinct().distinct().output()
        o2 = b.sum_with([s2.neg()]).neg().output()
        return (h1, h2, h3), (o1, o2)
    return build


def _algebra_rows(t):
    return ([((i,), 1) for i in range(t, t + 4)],
            [((i,), (-1) ** i) for i in range(0, 3 * t + 1, 3)],
            [((i,), 1 + (i % 2)) for i in range(2 * t, 2 * t + 3)])


def test_compiled_feeds_mode_algebra_matches_reference_host():
    """Feeds mode (no gen_fn) over plus, minus, neg, sum_with,
    stream_distinct and distinct: every tick equals the reference's host
    engine on the same pushed rows, and the placement pass defers what
    the reference's defers."""
    from dbsp_tpu.compiled import compile_circuit as rcompile_circuit
    from dbsp_tpu.operators import add_input_zset
    from dbsp_tpu.zset.batch import Batch
    from dbsp_tpu_torch.operators import add_input_zset as tadd_input_zset
    from dbsp_tpu_torch.zset.batch import Batch as TBatch

    rh, (rin, rout) = Runtime.init_circuit(
        1, _algebra_circuit(add_input_zset, jnp.int64))
    th, (tin, tout) = TRuntime.init_circuit(
        1, _algebra_circuit(tadd_input_zset, torch.int64), device="cpu")
    ch = compile_circuit(th)
    ref_ch = rcompile_circuit(Runtime.init_circuit(
        1, _algebra_circuit(add_input_zset, jnp.int64))[0])
    assert ch.deferred_consolidations == ref_ch.deferred_consolidations == 1
    kinds = {type(cn).__name__ for cn in ch.cnodes}
    assert {"CPlus", "CMinus", "CNeg", "CSumN", "CDistinct"} <= kinds
    # stream distinct is a pure Batch -> Batch node
    assert any(type(cn).__name__ == "CPure"
               and type(cn.op).__name__ == "StreamDistinct"
               for cn in ch.cnodes)
    seen = 0
    for t in range(5):
        rows = _algebra_rows(t)
        for h, r in zip(rin, rows):
            h.push_batch(Batch.from_tuples(r, (jnp.int64,)))
        rh.step()
        feeds = {h: TBatch.from_tuples(r, (torch.int64,), device="cpu")
                 for h, r in zip(tin, rows)}
        ch.step(tick=t, feeds=feeds)
        ch.validate()
        for r, o in zip(rout, tout):
            want = r.to_dict()
            got = ch.output(o)
            assert (got.to_dict() if got is not None else {}) == want, t
            seen += len(want)
    assert seen > 20


def _placement_circuit(add_input, i64):
    """An order-preserving map fed by a join and feeding a trace (the
    distinct's), a join -> filter -> map chain to the sink, a flat_map to
    the sink, a range join to the sink, and a range join feeding an
    order-preserving map and a distinct."""
    def build(c):
        s, h = add_input(c, (i64,), (i64,))
        t, g = add_input(c, (i64,), (i64,))
        j = s.join_index(t, lambda k, a, b: ((k[0],), (a[0], b[0])),
                         (i64,), (i64, i64), name="pj")
        # dropping the trailing column is monotone in the row order
        up = j.map_rows(lambda k, v: (k, (v[0],)), (i64,), (i64,),
                        name="pmap", preserves_order=True)
        o1 = up.distinct().output()
        j2 = s.join_index(t, lambda k, a, b: ((k[0],), (a[0] - b[0],)),
                          (i64,), (i64,), name="pj2")
        o2 = j2.filter_rows(lambda k, v: v[0] > 0).map_rows(
            lambda k, v: ((v[0] % 7,), (k[0],)), (i64,), (i64,),
            name="pflip").output()

        def two(k, v):
            row = _arange2(v[0])
            return ((_twice(k[0]),), (_twice(v[0] % 3) + row,),
                    (_twice(v[0]) % 2 == 0) | (row == 0))

        o3 = s.flat_map_rows(two, 2, (i64,), (i64,), name="pflat").output()
        o4 = s.join_range(t, -1, 2,
                          lambda lk, lv, rk, rv: ((lk[0],), (rk[0], rv[0])),
                          (i64,), (i64, i64), name="prj").output()
        rj2 = s.join_range(t, 0, 1,
                           lambda lk, lv, rk, rv: ((lk[0],), (lv[0], rk[0])),
                           (i64,), (i64, i64), name="prj2")
        o5 = rj2.map_rows(lambda k, v: (k, (v[0],)), (i64,), (i64,),
                          name="prjmap", preserves_order=True
                          ).distinct().output()
        return (h, g), (o1, o2, o3, o4, o5)
    return build


def test_placement_pass_matches_reference():
    """The placement rule as the reference writes it: an order-preserving
    map needs consolidated input, so the join (or range join) feeding it
    keeps its consolidation; a join -> filter -> map chain defers the
    join's and the map's; a flat_map or a range join to the sink defers
    its own. The deferred count equals the reference's and every output
    equals the reference's host engine, tick for tick, with
    retractions."""
    import dbsp_tpu.operators.join_range  # noqa: F401  (registers it)
    from dbsp_tpu.compiled import compile_circuit as rcompile_circuit
    from dbsp_tpu.operators import add_input_zset
    from dbsp_tpu.zset.batch import Batch
    from dbsp_tpu_torch.operators import add_input_zset as tadd_input_zset
    from dbsp_tpu_torch.zset.batch import Batch as TBatch

    rh, (rin, rout) = Runtime.init_circuit(
        1, _placement_circuit(add_input_zset, jnp.int64))
    th, (tin, tout) = TRuntime.init_circuit(
        1, _placement_circuit(tadd_input_zset, torch.int64), device="cpu")
    ch = compile_circuit(th)
    ref_ch = rcompile_circuit(Runtime.init_circuit(
        1, _placement_circuit(add_input_zset, jnp.int64))[0])
    assert ch.deferred_consolidations == ref_ch.deferred_consolidations == 4
    deferred = sorted(cn.op.name for cn in ch.cnodes
                      if getattr(cn, "defer_consolidate", False))
    assert deferred == ["pflat", "pflip", "pj2", "prj"], deferred
    rng = np.random.default_rng(5)
    live = [[], []]
    seen = 0
    for tick in range(5):
        pushed = []
        for side in range(2):
            rows = [(int(rng.integers(0, 12)), int(rng.integers(-20, 20)), 1)
                    for _ in range(int(rng.integers(3, 9)))]
            if tick >= 2 and live[side]:
                drop = int(rng.integers(0, len(live[side])))
                rows.append((*live[side].pop(drop), -1))
            live[side] += [(k, v) for k, v, w in rows if w > 0]
            cols = [np.array([r[i] for r in rows], np.int64)
                    for i in range(3)]
            rin[side].push_batch(Batch.from_columns(
                [cols[0]], [cols[1]], cols[2], cap=16))
            pushed.append(TBatch.from_columns([cols[0]], [cols[1]], cols[2],
                                              device="cpu", cap=16))
        rh.step()
        ch.step(tick, feeds=dict(zip(tin, pushed)))
        ch.validate()
        for r, o in zip(rout, tout):
            want = r.to_dict()
            got = ch.output(o)
            assert (got.to_dict() if got is not None else {}) == want, tick
            seen += len(want)
    assert seen > 30


def test_unported_operator_raises():
    """``apply2`` has a compiled node in neither engine."""
    from dbsp_tpu_torch.operators import add_input_zset

    def build(c):
        s, h = add_input_zset(c, [torch.int64], [])
        return h, s.apply2(s, lambda a, b: a).output()

    h, _ = TRuntime.init_circuit(1, build, device="cpu")
    with pytest.raises(NotImplementedError, match="no compiled equivalent"):
        compile_circuit(h)


def test_scan_graph_buffers_keep_snapshot_identity_honest():
    """The scanned mode's buffer bookkeeping (``_ScanGraph``, without a
    graph): a leaf the handle's state no longer holds is copied into its
    buffer, and a passed-through batch whose buffers a copy changed comes
    back as a new object, so that ``snapshot``, which reuses the copy of a
    level whose batch is the same object, never restores stale rows."""
    from dbsp_tpu_torch.compiled.compiler import _ScanGraph, _leaves
    from dbsp_tpu_torch.zset.batch import Batch as TBatch

    def batch(vals):
        return TBatch.from_columns([np.array(vals, np.int64)], [],
                                   np.ones(len(vals), np.int64),
                                   device="cpu", cap=4)

    deep, l0 = batch([1, 2]), batch([3])
    base = torch.tensor(2)
    bufs = {"0": ((l0, deep), base)}
    written = batch([3, 4])  # what the captured ticks make of level 0
    g = _ScanGraph(None, None, bufs, {"0": ((written, deep), base)}, {},
                   None)
    st = g.state()
    (w0, d0), b0 = st["0"]
    assert w0 is not l0 and w0.weights is l0.weights  # a written leaf
    assert d0 is deep and b0 is base  # passed through
    assert g.copy_in(st, bufs) == 0
    assert g.state()["0"][0][1] is d0  # unchanged: the same object
    # maintain replaces the deep level: its rows are copied in, and the
    # level comes back over the same buffers as a new object
    drained = batch([1, 2, 5])
    moved = g.copy_in({"0": ((w0, drained), b0)}, bufs)
    assert moved == sum(t.numel() * 8 for t in _leaves(drained))
    d1 = g.state()["0"][0][1]
    assert d1 is not d0 and d1.weights is deep.weights
    assert d1.to_dict() == drained.to_dict()


# ---------------------------------------------------------------------------
# Watermarks and windows: Nexmark q5 and q7
# ---------------------------------------------------------------------------

WINDOW_RATE = 40  # events/s of event time: a 400-event tick spans 10 s


def _gc_trace(ch):
    """The trace node that q5's window GCs."""
    (win,) = [cn for cn in ch.cnodes
              if isinstance(cn, cnodes.CWindow) and cn.op.gc]
    return ch.by_index[win.node.inputs[0]]


def _trace_req(ch, trace_cn) -> int:
    """The last validated "trace" requirement of ``trace_cn``."""
    return max(r for (cn, key), r in zip(ch._checks, ch.last_req)
               if cn is trace_cn and key == "trace")


@pytest.mark.parametrize("query", ["q5", "q7"])
def test_compiled_window_query_matches_reference_compiled(query):
    """q5 (hopping windows with window GC, a linear Count, a Max and a
    join) and q7 (a tumbling window and a Max) at 40 events/s, so that
    q7's window moves every tick: the port's compiled run equals the
    reference's compiled run and its host engine, tick for tick."""
    ticks = 5
    comp, ch = _compiled_run(query, ticks, rate=WINDOW_RATE)
    ref, _ = _ref_compiled_run(query, ticks, 1, scan=False, rate=WINDOW_RATE)
    host = _host_run(query, ticks, rate=WINDOW_RATE)
    assert comp == [ref.get(t, {}) for t in range(ticks)] == host
    assert sum(len(t) for t in host) >= (10 if query == "q5" else 3)
    kinds = {type(cn).__name__ for cn in ch.cnodes}
    assert {"CWatermark", "CApply", "CWindow"} <= kinds


def test_compiled_window_gc_bounds_trace_state():
    """The GC'd trace is bounded by the window's span: its validated
    "trace" requirement levels off while the stream doubles, it never
    takes slots, and presize leaves it out of the linear projection (an
    empty ``MONOTONE_CAPS``) where another trace of q5 is projected."""
    _, ch = _compiled_run("q5", 6, rate=WINDOW_RATE)
    tr = _gc_trace(ch)
    assert tr.MONOTONE_CAPS == frozenset() and tr._gc_refresh
    early = _trace_req(ch, tr)
    ch.run_ticks(6, 6, validate_every=1)
    late = _trace_req(ch, tr)
    # without GC the trace would integrate the stream (twice the events
    # by tick 12); with it the rows plateau at the retained span
    assert late < early * 1.6, (early, late)
    assert tr._slot_cap is None and tr._no_slots
    other = next(cn for cn in ch.cnodes
                 if isinstance(cn, cnodes.CTrace) and cn is not tr)
    before = (tr.caps["trace"], other.caps["trace"])
    ch.presize(16.0)
    assert tr.caps["trace"] <= max(before[0], 2 * bucket_cap(2 * late))
    assert other.caps["trace"] > before[1]


def test_compiled_window_gc_replay_across_truncating_ticks(monkeypatch):
    """Seed capacities small enough that intervals of two ticks overflow,
    across ticks whose GC truncates every level of q5's windowed trace:
    each replay from its snapshot ends equal to the reference's host
    engine, the compiled levels hold the reference spine's rows,
    maintain recounts what the truncations left (``base_live`` is the
    deep levels' live rows: a live-count cache that only sees drains
    would hold it high), and snapshot reuses no deep level of the GC'd
    trace."""
    monkeypatch.setattr(cnodes, "LEVEL0_CAP", 64)
    monkeypatch.setattr(cnodes.CTrace, "DEFAULT_CAP", 64)
    ticks, every = 8, 2
    comp, ch = _compiled_run("q5", ticks, validate_every=every,
                             rate=WINDOW_RATE)
    cfg = _cfgs(WINDOW_RATE)[0]
    rh, (rin, rout) = Runtime.init_circuit(1, _ref_build("q5"))
    gen = NexmarkGenerator(cfg)
    for t in range(ticks):
        gen.feed(rin, t * EPT * 50, (t + 1) * EPT * 50)
        rh.step()
        if t % every == every - 1:
            assert comp[t] == rout.to_dict(), t
    assert ch.overflow_replays > 0, "no grow + restore + replay happened"
    tr = _gc_trace(ch)
    levels, base = ch.states[str(tr.node.index)]
    held: dict = {}
    for lvl in levels:
        for r, w in lvl.to_dict().items():
            held[r] = held.get(r, 0) + w
    rspine = next(n.operator.spine for n in rh.circuit.nodes
                  if n.operator.name == "trace"
                  and len(n.operator.spine.key_dtypes) == 2)
    assert {r: w for r, w in held.items() if w} == rspine.to_dict()
    assert int(base) == sum(int(lvl.live_count()) for lvl in levels[1:])
    assert ch.maintain_stats["rows_moved"] > 0
    # snapshot copies every level of the GC'd trace: it keeps no copy of
    # a deep level for reuse, as it does for the other traces
    cached = {key for key, _ in ch._snap_levels}
    assert str(tr.node.index) not in cached and cached

