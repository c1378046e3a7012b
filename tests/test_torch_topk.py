"""The port's per-key top-K, semijoin / antijoin / keys_distinct and the
user-defined ``Fold`` against dbsp_tpu's, tick for tick: the same
batches, made with numpy from a seed (retractions, multiplicities above
one and over-retracted rows included), through the reference's host
engine and the port's host and compiled engines (and, for ``Fold``, the
reference's compiled engine too). The compiled top-K also runs from
tiny seeded capacities, so that it must grow and replay. Everything runs
on the CPU, on the kernels' plain versions; the columns are integers and
the comparisons exact."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dbsp_tpu.circuit import Runtime
from dbsp_tpu.compiled import compile_circuit as rcompile_circuit
from dbsp_tpu.operators import add_input_zset
from dbsp_tpu.operators.aggregate import Fold as RFold
from dbsp_tpu.zset.batch import Batch
from dbsp_tpu_torch.circuit import Runtime as TRuntime
from dbsp_tpu_torch.compiled import CompiledOverflow, cnodes, compile_circuit
from dbsp_tpu_torch.operators import Fold
from dbsp_tpu_torch.operators import add_input_zset as tadd_input_zset
from dbsp_tpu_torch.zset import kernels
from dbsp_tpu_torch.zset.batch import Batch as TBatch


def _feeds_step(ch, tick, feeds) -> list:
    """One feeds-mode tick of a compiled handle with the replay contract:
    on an overflow grow, restore the snapshot and step again. Returns the
    capacities that overflowed."""
    grown = []
    while True:
        snap = ch.snapshot()
        ch.step(tick, feeds=feeds)
        try:
            ch.validate()
            break
        except CompiledOverflow as e:
            grown += [key for _, key, _ in e.items]
            ch.grow(e)
            ch.restore(snap)
    ch.maintain()
    return grown


def _out(ch, handle) -> dict:
    b = ch.output(handle)
    return b.to_dict() if b is not None else {}


def _engines(build_ref, build_port):
    """The reference's host engine, the port's host engine and the port's
    compiled engine on one circuit: ((inputs, outputs) of each, the
    compiled handle)."""
    rh, ref = Runtime.init_circuit(1, build_ref)
    th, port = TRuntime.init_circuit(1, build_port, device="cpu")
    ch_h, comp = TRuntime.init_circuit(1, build_port, device="cpu")
    return (rh, ref), (th, port), compile_circuit(ch_h), comp


def _push(rins, tins, cols_per_input, cap):
    """The same columns to the reference's and the port's inputs; returns
    the port's batches (for a compiled feeds-mode step)."""
    feeds = []
    for rin, tin, (keys, vals, w) in zip(rins, tins, cols_per_input):
        rin.push_batch(Batch.from_columns(
            [jnp.asarray(c) for c in keys], [jnp.asarray(c) for c in vals],
            jnp.asarray(w), cap=cap))
        tin.push_batch(TBatch.from_columns(keys, vals, w, device="cpu",
                                           cap=cap))
        feeds.append(TBatch.from_columns(keys, vals, w, device="cpu",
                                         cap=cap))
    return feeds


def _topk_rows(rng, pool, n_new, n_retract, keys=5):
    """One tick's rows: ``n_new`` fresh rows (keys 0..keys-1, signed first
    value column, weight 1 or 2) and ``n_retract`` weight -1 rows drawn
    from every row pushed so far (a row can be retracted more often than
    it was inserted, so it nets below zero)."""
    rows = [(int(rng.integers(0, keys)), int(rng.integers(-12, 12)),
             int(rng.integers(0, 4)), int(rng.choice([1, 1, 1, 2])))
            for _ in range(n_new)]
    if pool:
        idx = rng.integers(0, len(pool), min(n_retract, len(pool)))
        rows += [(*pool[i], -1) for i in idx]
    pool += [r[:3] for r in rows if r[3] > 0]
    cols = [np.array([r[i] for r in rows], np.int64) for i in range(4)]
    return [cols[0]], cols[1:3], cols[3]


def _topk_circuit(add_input, i64, k, largest):
    def build(c):
        s, h = add_input(c, [i64], [i64, i64])
        return h, s.topk(k, largest=largest).output()
    return build


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("largest", [True, False])
def test_topk_equals_reference_tick_for_tick(largest, k, seed):
    """Random Z-sets with retractions through ``topk``: the port's host
    and compiled engines equal the reference's host engine every tick."""
    (rh, (rin, rout)), (th, (tin, tout)), ch, (cin, cout) = _engines(
        _topk_circuit(add_input_zset, jnp.int64, k, largest),
        _topk_circuit(tadd_input_zset, torch.int64, k, largest))
    rng = np.random.default_rng(seed)
    pool: list = []
    seen = 0
    for tick in range(6):
        cols = _topk_rows(rng, pool, int(rng.integers(3, 12)),
                          3 if tick else 0)
        (feed,) = _push([rin], [tin], [cols], cap=32)
        rh.step()
        th.step()
        _feeds_step(ch, tick, {cin: feed})
        want = rout.to_dict()
        assert tout.to_dict() == want, tick
        assert _out(ch, cout) == want, tick
        seen += len(want)
    assert seen > 10


def test_compiled_topk_grows_and_replays_from_tiny_caps(monkeypatch):
    """``CTopK`` seeded with a 4-query, 8-row gather and 8-row out-trace
    capacity: its requirements overflow, the handle grows the caps,
    restores the snapshot and replays, and every tick still equals the
    reference's host engine. Each tick touches ~40 keys, most holding
    their 5 top rows by then, so the old-output gather needs its
    k * q_cap slots (more than the grown query capacity)."""
    seeded = cnodes.CTopK.init_state

    def tiny(self):
        for key, cap in (("queries", 4), ("gather", 8), ("out_trace", 8)):
            self.caps[key] = self.caps.get(key) or cap
        return seeded(self)

    monkeypatch.setattr(cnodes.CTopK, "init_state", tiny)
    rh, (rin, rout) = Runtime.init_circuit(
        1, _topk_circuit(add_input_zset, jnp.int64, 5, True))
    ch_h, (cin, cout) = TRuntime.init_circuit(
        1, _topk_circuit(tadd_input_zset, torch.int64, 5, True),
        device="cpu")
    ch = compile_circuit(ch_h)
    (topk,) = [cn for cn in ch.cnodes if isinstance(cn, cnodes.CTopK)]
    rng = np.random.default_rng(4)
    pool: list = []
    grown: set = set()
    seen = 0
    for tick in range(5):
        cols = _topk_rows(rng, pool, 80, 6 if tick else 0, keys=50)
        rin.push_batch(Batch.from_columns(
            [jnp.asarray(c) for c in cols[0]],
            [jnp.asarray(c) for c in cols[1]], jnp.asarray(cols[2]),
            cap=128))
        rh.step()
        grown |= set(_feeds_step(ch, tick, {cin: TBatch.from_columns(
            *cols, device="cpu", cap=128)}))
        want = rout.to_dict()
        assert _out(ch, cout) == want, tick
        seen += len(want)
    assert seen > 20
    assert {"queries", "gather", "out_trace"} <= grown, grown
    assert topk.caps["gather"] > 8 and topk.caps["out_trace"] > 8


def _semijoin_circuit(add_input, i64, i32):
    def build(c):
        a, ha = add_input(c, [i64], [i32])
        b, hb = add_input(c, [i64], [i32])
        return (ha, hb), (a.semijoin(b).output(), a.antijoin(b).output(),
                          b.keys_distinct().output())
    return build


def _keyed_rows(rng, pool, n):
    """``n`` rows (keys 0..7, an int32 value, weight 1 or 2) and up to two
    retractions of earlier rows."""
    rows = [(int(rng.integers(0, 8)), int(rng.integers(0, 5)),
             int(rng.choice([1, 2]))) for _ in range(n)]
    if pool:
        idx = rng.choice(len(pool), size=min(2, len(pool)), replace=False)
        rows += [(*pool[i], -1) for i in sorted(idx)]
        for i in sorted(idx, reverse=True):
            pool.pop(i)
    pool += [r[:2] for r in rows if r[2] > 0]
    k = np.array([r[0] for r in rows], np.int64)
    v = np.array([r[1] for r in rows], np.int32)
    return [k], [v], np.array([r[2] for r in rows], np.int64)


def test_semijoin_antijoin_keys_distinct_equal_reference():
    """``semijoin``, ``antijoin`` and ``keys_distinct`` tick for tick,
    keys appearing and disappearing on both sides: the port's host and
    compiled engines equal the reference's host engine."""
    (rh, (rins, routs)), (th, (tins, touts)), ch, (cins, couts) = _engines(
        _semijoin_circuit(add_input_zset, jnp.int64, jnp.int32),
        _semijoin_circuit(tadd_input_zset, torch.int64, torch.int32))
    rng = np.random.default_rng(11)
    pools: list = [[], []]
    seen = 0
    for tick in range(6):
        cols = [_keyed_rows(rng, pools[s], int(rng.integers(1, 6)))
                for s in range(2)]
        feeds = _push(rins, tins, cols, cap=16)
        rh.step()
        th.step()
        _feeds_step(ch, tick, dict(zip(cins, feeds)))
        for r, t, c in zip(routs, touts, couts):
            want = r.to_dict()
            assert t.to_dict() == want, tick
            assert _out(ch, c) == want, tick
            seen += len(want)
    assert seen > 20


def _sum_sq(np_mod):
    """A sum of squares over the present rows, in JAX or in torch."""
    if np_mod is jnp:
        return lambda v, w, s, n: (jax.ops.segment_sum(
            v[0] ** 2 * jnp.maximum(w, 0), s, num_segments=n),)
    return lambda v, w, s, n: (kernels.segment_sum(
        v[0] ** 2 * torch.clamp(w, min=0), s, n),)


def _max_present(np_mod):
    """The largest present value, in JAX or in torch."""
    if np_mod is jnp:
        return lambda v, w, s, n: (jax.ops.segment_max(
            jnp.where(w > 0, v[0], jnp.iinfo(v[0].dtype).min), s,
            num_segments=n),)
    return lambda v, w, s, n: (kernels.segment_extreme(
        torch.where(w > 0, v[0], torch.iinfo(v[0].dtype).min), s, n,
        largest=True),)


def _fold_circuit(add_input, fold, np_mod, i64):
    def build(c):
        s, h = add_input(c, [i64], [i64])
        keyed = s.index_by(lambda k, v: (k[0] % 5,), [i64],
                           val_fn=lambda k, v: (v[0],), val_dtypes=[i64],
                           name="by5")
        return h, tuple(keyed.aggregate(fold(reduce_fn=f(np_mod))).output()
                        for f in (_sum_sq, _max_present))
    return build


def test_fold_equals_reference_host_and_compiled(monkeypatch):
    """``Fold`` (a sum of squares and a max, each written once for JAX
    and once for torch) with retractions: the port's host engine and its
    compiled engine equal the reference's host and compiled engines every
    tick. The compiled aggregate takes the stitched route of
    ``cursor.agg_ladder`` by the aggregator's type: the fused kernel's
    wrapper is never called."""
    from dbsp_tpu_torch.zset import cuda_kernels

    def fused(*a, **kw):
        raise AssertionError("a spec-less aggregate took the fused route")

    monkeypatch.setattr(cuda_kernels, "agg_ladder", fused)
    (rh, (rin, routs)), (th, (tin, touts)), ch, (cin, couts) = _engines(
        _fold_circuit(add_input_zset, RFold, jnp, jnp.int64),
        _fold_circuit(tadd_input_zset, Fold, torch, torch.int64))
    rc_h, (rcin, rcouts) = Runtime.init_circuit(
        1, _fold_circuit(add_input_zset, RFold, jnp, jnp.int64))
    ref_ch = rcompile_circuit(rc_h)
    folds = [cn for cn in ch.cnodes if isinstance(cn, cnodes.CAggregate)]
    assert len(folds) == 2 and all(cn.op.agg.reduce_spec() is None
                                   for cn in folds)
    rng = np.random.default_rng(9)
    live: list = []
    seen = 0
    for tick in range(6):
        rows = [(int(rng.integers(0, 30)), int(rng.integers(-50, 50)), 1)
                for _ in range(int(rng.integers(4, 12)))]
        if tick >= 2 and live:
            idx = rng.choice(len(live), size=min(4, len(live)),
                             replace=False)
            rows += [(*live[i], -1) for i in sorted(idx)]
            live = [r for i, r in enumerate(live) if i not in set(idx)]
        live += [(k, v) for k, v, w in rows if w > 0]
        k, v, w = (np.array([r[i] for r in rows], np.int64) for i in range(3))
        (feed,) = _push([rin], [tin], [([k], [v], w)], cap=32)
        rh.step()
        th.step()
        _feeds_step(ch, tick, {cin: feed})
        ref_ch.step(tick, feeds={rcin: Batch.from_columns(
            [jnp.asarray(k)], [jnp.asarray(v)], jnp.asarray(w), cap=32)})
        ref_ch.validate()
        for r, t, c, rc in zip(routs, touts, couts, rcouts):
            want = r.to_dict()
            assert t.to_dict() == want, tick
            assert _out(ch, c) == want, tick
            assert _out(ref_ch, rc) == want, tick
            seen += len(want)
    assert seen > 30
