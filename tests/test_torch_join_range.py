"""The port's range joins (dbsp_tpu_torch/operators/join_range.py and the
compiled engine's CRangeJoin) against dbsp_tpu's, on the CPU with the
same seeded inputs: the incremental relative-range join under inserts and
retractions on both sides, each tick equal to the reference and its
integral to a Python oracle; the per-tick stream_join_range contract;
the compiled join against the reference's compiled run of its range-join
circuit (bids with the auctions within +-2 of their auction), and in
feeds mode with retractions from side capacities that overflow (the
shared buffers' trash slot), with the no-slots flags of the reference's
handle. Everything runs on plain PyTorch; the columns are integers and
every comparison is exact."""

import random

import torch

import jax.numpy as jnp

from dbsp_tpu.circuit import Runtime
from dbsp_tpu.nexmark import build_inputs
from dbsp_tpu.nexmark import model as M
from dbsp_tpu.operators import add_input_zset
from dbsp_tpu.zset.batch import Batch
from dbsp_tpu_torch.circuit import Runtime as TRuntime
from dbsp_tpu_torch.compiled import CompiledOverflow, cnodes, compile_circuit
from dbsp_tpu_torch.nexmark import build_inputs as tbuild_inputs
from dbsp_tpu_torch.nexmark import model as TM
from dbsp_tpu_torch.operators import add_input_zset as tadd_input_zset
from dbsp_tpu_torch.zset.batch import Batch as TBatch
from test_torch_compiled import one_torch_thread  # noqa: F401  (autouse)
from test_torch_rolling import (SLOW_RATE, dict_add, port_compiled_run,
                                ref_compiled_run, ref_host_run)
import dbsp_tpu.operators.join_range  # noqa: F401, E402  (register)


def _oracle_rel(a_rows, b_rows, lo_off, hi_off):
    out = {}
    for (k1, v1), w1 in a_rows.items():
        for (k2, v2), w2 in b_rows.items():
            if k1 + lo_off <= k2 <= k1 + hi_off:
                key = (k1, k2, v1, v2)
                out[key] = out.get(key, 0) + w1 * w2
    return {k: w for k, w in out.items() if w != 0}


def _rel_circuit(add_input, i64):
    def build(c):
        a, ha = add_input(c, (i64,), (i64,))
        b, hb = add_input(c, (i64,), (i64,))
        j = a.join_range(
            b, -2, 3,
            lambda lk, lv, rk, rv: ((lk[0], rk[0]), (lv[0], rv[0])),
            (i64, i64), (i64, i64), name="rj")
        return (ha, hb), j.output()
    return build


def _rel_ticks(seed, ticks, per_tick):
    """Per tick, ([side 0 rows], [side 1 rows]) of ((key, val), w):
    inserts of weight 1 or 2 and retractions of earlier rows (negative
    keys included)."""
    rng = random.Random(seed)
    live: list = []
    out = []
    for _ in range(ticks):
        sides = ([], [])
        for _ in range(per_tick):
            if rng.random() < 0.25 and live:
                s, row, w = live.pop(rng.randrange(len(live)))
                sides[s].append((row, -w))
            else:
                s = rng.randrange(2)
                row = (rng.randrange(20) - 3, rng.randrange(5))
                w = rng.choice([1, 2])
                sides[s].append((row, w))
                live.append((s, row, w))
        out.append(sides)
    return out


def test_join_range_equals_reference():
    """Both sides insert and retract (late matches of either side): the
    port's output equals the reference's every tick, and its integral
    equals the oracle join of the two integrated inputs."""
    rh, ((ra, rb), rout) = Runtime.init_circuit(
        1, _rel_circuit(add_input_zset, jnp.int64))
    th, ((ta, tb), tout) = TRuntime.init_circuit(
        1, _rel_circuit(tadd_input_zset, torch.int64), device="cpu")
    models = ({}, {})
    integral: dict = {}
    for sides in _rel_ticks(3, 5, 25):
        for s, rows in enumerate(sides):
            if not rows:
                continue
            (ra, rb)[s].push_batch(Batch.from_tuples(rows, (jnp.int64,),
                                                     (jnp.int64,)))
            (ta, tb)[s].push_batch(TBatch.from_tuples(
                rows, (torch.int64,), (torch.int64,), device="cpu"))
            for row, w in rows:
                dict_add(models[s], {row: w})
        rh.step()
        th.step()
        want = rout.to_dict()
        assert tout.to_dict() == want
        dict_add(integral, want)
        assert integral == _oracle_rel(*models, -2, 3)
    assert integral, "vacuous range-join test"


def _stream_circuit(add_input, i64):
    def build(c):
        a, ha = add_input(c, (i64,), (i64,))
        b, hb = add_input(c, (i64,), ())
        j = a.stream_join_range(
            b, lambda lk: ((lk[0] * 2,), (lk[0] * 2 + lk[0] + 1,)),
            lambda lkc, lvc, rkc, rvc: ((lkc[0], rkc[0]), (lvc[0],)),
            (i64, i64), (i64,))
        return (ha, hb), j.output()
    return build


def test_stream_join_range_equals_reference():
    """Each left key k matches the right keys in [2k, 3k + 1) of the same
    tick only; a later tick joins only its own batches. Equal to the
    reference and to the hand-computed pairs."""
    rh, ((ra, rb), rout) = Runtime.init_circuit(
        1, _stream_circuit(add_input_zset, jnp.int64))
    th, ((ta, tb), tout) = TRuntime.init_circuit(
        1, _stream_circuit(tadd_input_zset, torch.int64), device="cpu")
    # per tick: left ((key, val), w) rows, right ((key,), w) rows
    ticks = [([((2, 10), 1), ((3, 20), 2)],
              [((4,), 1), ((5,), 1), ((6,), 1), ((7,), 3), ((10,), 1)]),
             ([((2, 99), 1)], []),
             ([((-1, 5), 1), ((4, 6), -1)], [((-2,), 2), ((8,), 2),
                                             ((12,), 1)])]
    got = []
    for arows, brows in ticks:
        for h_r, h_t, rows, nv in ((ra, ta, arows, 1), (rb, tb, brows, 0)):
            if not rows:
                continue
            h_r.push_batch(Batch.from_tuples(rows, [jnp.int64],
                                             [jnp.int64] * nv))
            h_t.push_batch(TBatch.from_tuples(
                rows, [torch.int64], [torch.int64] * nv, device="cpu"))
        rh.step()
        th.step()
        want = rout.to_dict()
        assert tout.to_dict() == want
        got.append(want)
    assert got[0] == {(2, 4, 10): 1, (2, 5, 10): 1, (2, 6, 10): 1,
                      (3, 6, 20): 2, (3, 7, 20): 6}
    assert got[1] == {}
    # k = -1 -> [-2, -3): empty; k = 4 -> [8, 13): 8 and 12, weight -1
    assert got[2] == {(4, 8, 6): -2, (4, 12, 6): -1}


# ---------------------------------------------------------------------------
# The compiled join
# ---------------------------------------------------------------------------


def _ref_range_join_build(c):
    streams, handles = build_inputs(c)
    _p, auctions, bids = streams
    b = bids.index_by(lambda k, v: (k[0],), (jnp.int64,),
                      val_fn=lambda k, v: (v[M.B_PRICE],),
                      val_dtypes=(jnp.int64,), name="rj-bids")
    a = auctions.index_by(lambda k, v: (k[0],), (jnp.int64,),
                          val_fn=lambda k, v: (v[M.A_CATEGORY],),
                          val_dtypes=(jnp.int64,), name="rj-aucs")
    out = b.join_range(
        a, -2, 2, lambda lk, lv, rk, rv: ((lk[0],), (rk[0], lv[0], rv[0])),
        (jnp.int64,), (jnp.int64, jnp.int64, jnp.int64), name="rj")
    return handles, out.output()


def _port_range_join_build(c):
    streams, handles = tbuild_inputs(c)
    _p, auctions, bids = streams
    b = bids.index_by(lambda k, v: (k[0],), (torch.int64,),
                      val_fn=lambda k, v: (v[TM.B_PRICE],),
                      val_dtypes=(torch.int64,), name="rj-bids")
    a = auctions.index_by(lambda k, v: (k[0],), (torch.int64,),
                          val_fn=lambda k, v: (v[TM.A_CATEGORY],),
                          val_dtypes=(torch.int64,), name="rj-aucs")
    out = b.join_range(
        a, -2, 2, lambda lk, lv, rk, rv: ((lk[0],), (rk[0], lv[0], rv[0])),
        (torch.int64,), (torch.int64, torch.int64, torch.int64), name="rj")
    return handles, out.output()


def test_compiled_range_join_equals_reference_compiled(monkeypatch):
    """The reference's compiled range-join circuit: the port's compiled
    run equals the reference's compiled run and host engine tick for
    tick, from trace capacities that overflow and replay; both input
    traces take no slots in either engine, and the join's consolidation
    is deferred to the sink in both."""
    monkeypatch.setattr(cnodes, "LEVEL0_CAP", 64)
    ticks = 4
    comp, ch = port_compiled_run(_port_range_join_build, ticks, SLOW_RATE)
    ref, rch = ref_compiled_run(_ref_range_join_build, ticks, SLOW_RATE)
    host = ref_host_run(_ref_range_join_build, ticks, SLOW_RATE)
    assert [comp[t] for t in range(ticks)] == ref == host
    assert sum(len(t) for t in host) > 500
    assert ch.overflow_replays > 0
    (rj,) = [cn for cn in ch.cnodes if isinstance(cn, cnodes.CRangeJoin)]
    (rrj,) = [cn for cn in rch.cnodes if type(cn).__name__ == "CRangeJoin"]
    flags = [ch.by_index[i]._no_slots for i in rj.node.inputs]
    rflags = [rch.by_index[i]._no_slots for i in rrj.node.inputs]
    assert flags == rflags == [True, True]
    assert rj.defer_consolidate and rrj.defer_consolidate
    assert ch.deferred_consolidations == rch.deferred_consolidations


def test_compiled_range_join_feeds_overflow_replays():
    """Feeds mode with retractions on both sides, from side capacities of
    8 slots: a tick whose matches run past a side's buffer writes them to
    its trash slot, reports the requirement, and after the grow and the
    replay from the snapshot equals the reference's host engine every
    tick."""
    rh, ((ra, rb), rout) = Runtime.init_circuit(
        1, _rel_circuit(add_input_zset, jnp.int64))
    chh, ((ca, cb), cout) = TRuntime.init_circuit(
        1, _rel_circuit(tadd_input_zset, torch.int64), device="cpu")
    ch = compile_circuit(chh)
    (rj,) = [cn for cn in ch.cnodes if isinstance(cn, cnodes.CRangeJoin)]
    rj.caps["left"] = rj.caps["right"] = 8
    overflows = seen = 0
    for tick, sides in enumerate(_rel_ticks(11, 6, 30)):
        feeds = {}
        for s, rows in enumerate(sides):
            if not rows:
                continue
            (ra, rb)[s].push_batch(Batch.from_tuples(rows, (jnp.int64,),
                                                     (jnp.int64,)))
            feeds[(ca, cb)[s]] = TBatch.from_tuples(
                rows, (torch.int64,), (torch.int64,), device="cpu")
        rh.step()
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
        want = rout.to_dict()
        got = ch.output(cout)
        assert (got.to_dict() if got is not None else {}) == want, tick
        seen += len(want)
    assert overflows > 0 and seen > 50
    assert rj.caps["left"] > 8 and rj.caps["right"] > 8
    assert all(ch.by_index[i]._no_slots for i in rj.node.inputs)
