"""The port's radix time index and partitioned rolling aggregate
(dbsp_tpu_torch/timeseries/radix_tree.py, rolling.py, and the compiled
engine's CRolling) against dbsp_tpu's, on the CPU with the same seeded
inputs: the tree's levels and query answers for Max, Min, Sum and Count
under late inserts and retractions, queries whose lower bound is below
time 0, the O(log range) query cost; the host operator with the tree and
with window recompute under retractions; the compiled operator against
the reference's compiled run of its rolling circuit (bid prices per
auction over 10 s) at two event rates, from capacities that overflow,
and in the scanned mode with an overflow replay, state for state equal to
the eager run. Everything runs on the kernels' plain versions; the
columns are integers and every comparison is exact."""

import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dbsp_tpu.circuit import Runtime
from dbsp_tpu.nexmark import (GeneratorConfig, NexmarkGenerator, build_inputs,
                              device_gen)
from dbsp_tpu.nexmark import model as M
from dbsp_tpu.operators import add_input_zset
from dbsp_tpu.operators.aggregate import Count, Max, Min, Sum
from dbsp_tpu.timeseries.radix_tree import RadixTimeIndex
from dbsp_tpu.trace.spine import Spine
from dbsp_tpu.zset.batch import Batch
from dbsp_tpu_torch.circuit import Runtime as TRuntime
from dbsp_tpu_torch.compiled import cnodes, compile_circuit
from dbsp_tpu_torch.nexmark import GeneratorConfig as TGeneratorConfig
from dbsp_tpu_torch.nexmark import build_inputs as tbuild_inputs
from dbsp_tpu_torch.nexmark import device_gen as tdevice_gen
from dbsp_tpu_torch.nexmark import model as TM
from dbsp_tpu_torch.operators import add_input_zset as tadd_input_zset
from dbsp_tpu_torch.operators import aggregate as TA
from dbsp_tpu_torch.timeseries.radix_tree import \
    RadixTimeIndex as TRadixTimeIndex
from dbsp_tpu_torch.trace.spine import Spine as TSpine
from dbsp_tpu_torch.zset.batch import Batch as TBatch
from test_torch_compiled import one_torch_thread  # noqa: F401  (autouse)

AGGS = {"max": (Max(0), TA.Max(0)), "min": (Min(0), TA.Min(0)),
        "sum": (Sum(0), TA.Sum(0)), "count": (Count(), TA.Count())}


def dict_add(acc: dict, delta: dict) -> dict:
    for r, w in delta.items():
        acc[r] = acc.get(r, 0) + w
        if acc[r] == 0:
            del acc[r]
    return acc


# ---------------------------------------------------------------------------
# The radix tree
# ---------------------------------------------------------------------------


def _model_query(rows, p, lo, hi, kind):
    vals = [v for (pp, t, v), w in rows.items() if pp == p and lo <= t <= hi
            for _ in range(w)]
    if not vals:
        return None
    return {"max": max, "min": min, "sum": sum, "count": len}[kind](vals)


def _drive_trees(kind, events, queries, max_range):
    """The same (p, t, v, w) events through a trace and a tree in both
    libraries, the levels compared after every tick; then one query batch
    through both. Returns (port answers, reference answers, model
    answers, port tree, reference tree)."""
    ragg, tagg = AGGS[kind]
    rsp = Spine((jnp.int64, jnp.int64), (jnp.int64,))
    tsp = TSpine((torch.int64, torch.int64), (torch.int64,), device="cpu")
    rtree = RadixTimeIndex(ragg, jnp.int64, jnp.int64,
                           max_time_range=max_range)
    ttree = TRadixTimeIndex(tagg, torch.int64, torch.int64,
                            max_time_range=max_range, device="cpu")
    assert ttree.nlevels == rtree.nlevels
    model: dict = {}
    for tick in events:
        rows = [((p, t, v), w) for (p, t, v, w) in tick]
        rd = Batch.from_tuples(rows, (jnp.int64, jnp.int64), (jnp.int64,))
        td = TBatch.from_tuples(rows, (torch.int64, torch.int64),
                                (torch.int64,), device="cpu")
        rsp.insert(rd)
        rtree.update(rd, rsp.batches)
        tsp.insert(td)
        ttree.update(td, tsp.batches)
        assert ttree.to_dicts() == rtree.to_dicts()
        for (p, t, v, w) in tick:
            dict_add(model, {(p, t, v): w})
    n = len(queries)
    cols = [[q[i] for q in queries] for i in range(3)]
    (rv,), rp = rtree.query(*(jnp.asarray(c, jnp.int64) for c in cols),
                            jnp.ones((n,), jnp.bool_), rsp.batches, n)
    (tv,), tp = ttree.query(*(torch.tensor(c, dtype=torch.int64)
                              for c in cols),
                            torch.ones((n,), dtype=torch.bool),
                            tsp.batches, n)
    ref = [int(v) if p else None
           for v, p in zip(np.asarray(rv).tolist(), np.asarray(rp).tolist())]
    got = [int(v) if p else None for v, p in zip(tv.tolist(), tp.tolist())]
    want = [_model_query(model, *q, kind) for q in queries]
    return got, ref, want, ttree, rtree


@pytest.mark.parametrize("kind", list(AGGS))
def test_tree_equals_reference(kind):
    """Five ticks of inserts and (possibly late) retractions at times from
    -200 on: the port's tree levels equal the reference's after every
    tick, and 25 range queries, some starting below time 0, answer as
    the reference and a Python model do."""
    rng = random.Random(13)
    live, events = [], []
    for _ in range(5):
        tick = []
        for _ in range(60):
            if rng.random() < 0.3 and live:
                p, t, v, w = live.pop(rng.randrange(len(live)))
                tick.append((p, t, v, -w))
            else:
                e = (rng.randrange(4), rng.randrange(4000) - 200,
                     rng.randrange(100), rng.choice([1, 1, 2]))
                tick.append(e)
                live.append(e)
        events.append(tick)
    queries = [(rng.randrange(4), lo, lo + rng.choice([0, 7, 63, 800, 3999]))
               for lo in [rng.randrange(4200) - 500 for _ in range(25)]]
    got, ref, want, ttree, rtree = _drive_trees(kind, events, queries, 4096)
    assert got == ref == want
    assert sum(a is not None for a in want) > 10
    assert ttree.query_rows_gathered == rtree.query_rows_gathered


@pytest.mark.parametrize("kind", ["max", "count"])
def test_tree_late_insert_and_retraction(kind):
    """A row far in the past arrives late and is retracted a tick later:
    the buckets it touched at every level come back to what they were,
    in both libraries alike."""
    events = [
        [(1, 1000, 50, 1), (1, 2000, 70, 1)],
        [(1, 10, 99, 1)],
        [(1, 10, 99, -1)],
        [(1, 1500, 60, 2)],
    ]
    queries = [(1, 0, 4000), (1, 0, 100), (1, 900, 1600), (1, 3000, 4000),
               (1, 10, 10), (2, 0, 4000)]
    got, ref, want, _, _ = _drive_trees(kind, events, queries, 4096)
    assert got == ref == want
    assert got[1] is None and got[-1] is None


def test_tree_negative_query_bounds():
    """Queries [t - range, t] near time 0 have a negative lower bound;
    the per-level bucket bounds floor it (as jnp's // does): bounds on
    and around multiples of the radix, below 0, answer as the reference
    and the model, and an empty range (qhi < qlo) answers nothing."""
    events = [[(0, t, (t * 37) % 101, 1) for t in range(0, 300, 3)],
              [(0, t, 7, 1) for t in range(1, 40, 5)]]
    queries = [(0, lo, hi) for lo, hi in
               [(-100, 0), (-16, 15), (-17, 16), (-15, 31), (-1, 0),
                (-256, -1), (-4097, 4), (-33, 240), (-300, -200), (5, 4)]]
    for kind in ("max", "sum"):
        got, ref, want, _, _ = _drive_trees(kind, events, queries, 1000)
        assert got == ref == want, kind
        assert got[5] is None and got[-2] is None and got[-1] is None


def test_query_cost_scales_logarithmically():
    """Widening a query 64x over dense data costs only a few extra bucket
    fringes: the rows gathered equal the reference's and stay under 8x
    (the recompute path would gather 64x)."""
    rng = random.Random(7)
    events = [[(1, t, rng.randrange(100), 1)
               for t in range(i * 1000, (i + 1) * 1000)] for i in range(6)]

    def cost(span):
        queries = [(1, 5990 - span, 5990)] * 8
        got, ref, want, ttree, rtree = _drive_trees("sum", events, queries,
                                                    8192)
        assert got == ref == want
        assert ttree.query_rows_gathered == rtree.query_rows_gathered
        return ttree.query_rows_gathered

    c_small, c_large = cost(64), cost(4096)
    assert c_large < c_small * 8, (c_small, c_large)


# ---------------------------------------------------------------------------
# The host operator
# ---------------------------------------------------------------------------


def _rolling_circuit(add_input, i64, aggs, use_tree):
    def build(c):
        s, h = add_input(c, (i64, i64), (i64,))
        return h, [s.partitioned_rolling_aggregate(a, 100, use_tree=use_tree)
                   .output() for a in aggs]
    return build


@pytest.mark.parametrize("use_tree", [True, False])
def test_host_rolling_equals_reference(use_tree):
    """Max, Sum and Count over 100 ms per partition, with the tree or by
    window recompute, under inserts and retractions at times from 0 (so
    windows start below 0): the port's outputs equal the reference's
    every tick, the tree's levels equal the reference tree's, and the
    integrated outputs equal a Python model."""
    kinds = ("max", "sum", "count")
    rb = _rolling_circuit(add_input_zset, jnp.int64,
                          [AGGS[k][0] for k in kinds], use_tree)
    tb = _rolling_circuit(tadd_input_zset, torch.int64,
                          [AGGS[k][1] for k in kinds], use_tree)
    rh, (rin, routs) = Runtime.init_circuit(1, rb)
    th, (tin, touts) = TRuntime.init_circuit(1, tb, device="cpu")
    rops = [n.operator for n in rh.circuit.nodes
            if type(n.operator).__name__ == "RollingAggregateOp"]
    tops = [n.operator for n in th.circuit.nodes
            if type(n.operator).__name__ == "RollingAggregateOp"]
    assert [op.tree is not None for op in tops] == [use_tree] * 3
    rng = random.Random(5)
    live: list = []
    model: dict = {}
    accs = [{} for _ in kinds]
    for tick in range(6):
        rows = []
        for _ in range(25):
            if rng.random() < 0.3 and live:
                row, w = live.pop(rng.randrange(len(live)))
                rows.append((row, -w))
            else:
                row = (rng.randrange(3), rng.randrange(500),
                       rng.randrange(50))
                rows.append((row, 1))
                live.append((row, 1))
        rin.push_batch(Batch.from_tuples(rows, (jnp.int64, jnp.int64),
                                         (jnp.int64,)))
        tin.push_batch(TBatch.from_tuples(rows, (torch.int64, torch.int64),
                                          (torch.int64,), device="cpu"))
        for row, w in rows:
            dict_add(model, {row: w})
        rh.step()
        th.step()
        for acc, ro, to in zip(accs, routs, touts):
            want = ro.to_dict()
            assert to.to_dict() == want, tick
            dict_add(acc, want)
        for rop, top in zip(rops, tops):
            if use_tree:
                assert top.tree.to_dicts() == rop.tree.to_dicts(), tick
    for kind, acc in zip(kinds, accs):
        oracle = {}
        for (p, t, _v) in model:
            vals = [v for (pp, tt, v), w in model.items()
                    if pp == p and t - 100 <= tt <= t for _ in range(w)]
            oracle[(p, t, {"max": max, "sum": sum, "count": len}[kind](
                vals))] = 1
        assert acc == oracle, kind
    assert all(accs)


# ---------------------------------------------------------------------------
# The compiled operator
# ---------------------------------------------------------------------------

EPT = 8            # epochs a tick: 400 events
SLOW_RATE = 40     # events/s of event time: a tick spans 10 s


def _ref_rolling_build(use_tree):
    def build(c):
        streams, handles = build_inputs(c)
        keyed = streams[2].index_by(
            lambda k, v: (k[0], v[M.B_DATE]), (jnp.int64, jnp.int64),
            val_fn=lambda k, v: (v[M.B_PRICE],), val_dtypes=(jnp.int64,),
            name="roll-key")
        return handles, keyed.partitioned_rolling_aggregate(
            Max(0), 10_000, name="roll-max", use_tree=use_tree).output()
    return build


def _port_rolling_build(use_tree):
    def build(c):
        streams, handles = tbuild_inputs(c)
        keyed = streams[2].index_by(
            lambda k, v: (k[0], v[TM.B_DATE]), (torch.int64, torch.int64),
            val_fn=lambda k, v: (v[TM.B_PRICE],), val_dtypes=(torch.int64,),
            name="roll-key")
        return handles, keyed.partitioned_rolling_aggregate(
            TA.Max(0), 10_000, name="roll-max", use_tree=use_tree).output()
    return build


def _cfgs(rate):
    if rate is None:
        return GeneratorConfig(seed=1), TGeneratorConfig(seed=1)
    return (GeneratorConfig(seed=1, first_event_rate=rate),
            TGeneratorConfig(seed=1, first_event_rate=rate))


def ref_host_run(build, ticks, rate):
    """The reference's host engine, one output dict a tick."""
    gen = NexmarkGenerator(_cfgs(rate)[0])
    handle, (handles, out) = Runtime.init_circuit(1, build)
    outs = []
    for t in range(ticks):
        gen.feed(handles, t * EPT * 50, (t + 1) * EPT * 50)
        handle.step()
        b = out.take()
        outs.append(b.to_dict() if b is not None else {})
    return outs


def ref_compiled_run(build, ticks, rate):
    """The reference's compiled engine, validated every tick: one output
    dict a tick."""
    from dbsp_tpu.compiled import compile_circuit as rcompile_circuit

    h, ((hp, ha, hb), out) = Runtime.init_circuit(1, build)
    cfg = _cfgs(rate)[0]

    def gen_fn(tick):
        p, a, b = device_gen.generate_tick(cfg, tick * EPT, EPT)
        return {hp: p, ha: a, hb: b}

    ch = rcompile_circuit(h, gen_fn=gen_fn)
    outs = {}

    def capture(next_tick):
        b = ch.output(out)
        outs[next_tick - 1] = b.to_dict() if b is not None else {}

    ch.run_ticks(0, ticks, validate_every=1, on_validated=capture)
    return [outs[t] for t in range(ticks)], ch


def port_compiled_run(build, ticks, rate, validate_every=1, scan=False):
    """The port's compiled engine on the port's device-side generator:
    {last tick of each validated interval: its output}, and the handle."""
    h, ((hp, ha, hb), out) = TRuntime.init_circuit(1, build, device="cpu")
    cfg = _cfgs(rate)[1]

    def gen_fn(tick):
        p, a, b = tdevice_gen.generate_tick(cfg, tick * EPT, EPT)
        return {hp: p, ha: a, hb: b}

    ch = compile_circuit(h, gen_fn=gen_fn, trace_levels=2)
    outs = {}

    def capture(next_tick):
        b = ch.output(out)
        outs[next_tick - 1] = b.to_dict() if b is not None else {}

    ch.run_ticks(0, ticks, validate_every=validate_every,
                 on_validated=capture, scan=scan)
    return outs, ch


@pytest.mark.parametrize("rate", [None, SLOW_RATE])
def test_compiled_rolling_equals_reference_compiled(monkeypatch, rate):
    """The reference's compiled rolling circuit (a 10 s Max of bid price
    per auction) at the generator's default rate (every window reaches
    back to the first bid) and at 40 events/s (a tick spans 10 s, so the
    windows' lower bounds cut): the port's compiled run equals the
    reference's compiled run and host engine tick for tick, from seed
    capacities small enough to overflow and replay. Its input trace takes
    no slots, as the reference's does."""
    monkeypatch.setattr(cnodes, "LEVEL0_CAP", 64)
    ticks = 4
    comp, ch = port_compiled_run(_port_rolling_build(False), ticks, rate)
    ref, rch = ref_compiled_run(_ref_rolling_build(False), ticks, rate)
    host = ref_host_run(_ref_rolling_build(False), ticks, rate)
    assert [comp[t] for t in range(ticks)] == ref == host
    assert sum(len(t) for t in host) > 100
    assert ch.overflow_replays > 0
    (roll,) = [cn for cn in ch.cnodes if isinstance(cn, cnodes.CRolling)]
    (rroll,) = [cn for cn in rch.cnodes
                if type(cn).__name__ == "CRolling"]
    assert roll.MONOTONE_CAPS == rroll.MONOTONE_CAPS
    tr = ch.by_index[roll.node.inputs[0]]
    rtr = rch.by_index[rroll.node.inputs[0]]
    assert tr._no_slots and rtr._no_slots and tr._slot_cap is None


def test_host_tree_equals_compiled_recompute():
    """The host engine through the radix tree and the compiled engine by
    window recompute (a compiled ``use_tree=True`` operator ignores its
    tree) answer alike at 40 events/s."""
    ticks = 4
    th, (tin, tout) = TRuntime.init_circuit(1, _port_rolling_build(True),
                                            device="cpu")
    from dbsp_tpu_torch.nexmark import NexmarkGenerator as TGen

    gen = TGen(_cfgs(SLOW_RATE)[1])
    host = []
    for t in range(ticks):
        gen.feed(tin, t * EPT * 50, (t + 1) * EPT * 50)
        th.step()
        host.append(tout.to_dict())
    comp, _ = port_compiled_run(_port_rolling_build(True), ticks, SLOW_RATE)
    assert [comp[t] for t in range(ticks)] == host
    assert sum(len(t) for t in host) > 500


def test_scanned_rolling_equals_eager_after_overflow(monkeypatch):
    """The scanned mode (each interval of two ticks one chunk; on the CPU
    its ticks run eagerly under the same contract) from seed capacities
    that overflow in the first interval: after the grow and the replay
    every interval's last-tick output equals the eager run's and the
    reference's host engine, and the two runs end in equal states."""
    from dbsp_tpu_torch.compiled.compiler import _layout, _leaves

    monkeypatch.setattr(cnodes, "LEVEL0_CAP", 64)
    ticks, every = 6, 2
    comp, ch = port_compiled_run(_port_rolling_build(False), ticks,
                                 SLOW_RATE, validate_every=every, scan=True)
    eager, ech = port_compiled_run(_port_rolling_build(False), ticks,
                                   SLOW_RATE, validate_every=every)
    host = ref_host_run(_ref_rolling_build(False), ticks, SLOW_RATE)
    for t in range(every - 1, ticks, every):
        assert comp[t] == eager[t] == host[t], t
    assert ch.overflow_replays > 0
    assert len(ch.step_times_ns) == ticks // every + ch.overflow_replays
    assert _layout(ch.states) == _layout(ech.states)
    assert all(torch.equal(a, b)
               for a, b in zip(_leaves(ch.states), _leaves(ech.states)))
