"""The port's Z-set layer (dbsp_tpu_torch/zset, trace/spine.py) against
dbsp_tpu's on the same seeded inputs, exactly: sort, compaction,
consolidation in each regime, sorted merges with duplicates and sentinel
tails, probes, range expansion, and a spine's levels and contents."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dbsp_tpu.trace.spine import Spine
from dbsp_tpu.zset import kernels
from dbsp_tpu.zset.batch import Batch, concat_batches
from dbsp_tpu_torch.trace.spine import Spine as TSpine
from dbsp_tpu_torch.zset import kernels as tkernels
from dbsp_tpu_torch.zset.batch import Batch as TBatch
from dbsp_tpu_torch.zset.batch import concat_batches as tconcat


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _port(b: Batch) -> TBatch:
    return TBatch.from_numpy([np.asarray(c) for c in b.keys],
                             [np.asarray(c) for c in b.vals],
                             np.asarray(b.weights), runs=b.runs,
                             device="cpu")


def _same(got, want, what=""):
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=what)


def _same_batch(got: TBatch, want: Batch):
    assert got.cap == want.cap and got.runs == want.runs
    for g, w in zip((*got.cols, got.weights), (*want.cols, want.weights)):
        _same(g, w)


def _raw_cols(rng, n, key_range=6):
    """Columns with many duplicate rows, an int32 column and cancelling
    weights."""
    keys = [rng.integers(0, key_range, n).astype(np.int64),
            rng.integers(-3, 3, n).astype(np.int32)]
    vals = [rng.integers(0, 4, n).astype(np.int64)]
    w = rng.integers(-2, 3, n).astype(np.int64)
    return keys, vals, w


def test_sort_rows_matches_lax_sort():
    rng = np.random.default_rng(0)
    for n in (1, 7, 300):
        (k0, k1), (v,), w = _raw_cols(rng, n)
        want_cols, want_pay = kernels.sort_rows(
            (jnp.asarray(k0), jnp.asarray(k1)), (jnp.asarray(v),
                                                jnp.asarray(w)))
        got_cols, got_pay = tkernels.sort_rows((_t(k0), _t(k1)),
                                               (_t(v), _t(w)))
        for g, e in zip((*got_cols, *got_pay), (*want_cols, *want_pay)):
            _same(g, e)


def test_rows_equal_prev_and_compact():
    rng = np.random.default_rng(1)
    (k0, k1), (v,), w = _raw_cols(rng, 64)
    cols = kernels.sort_rows((jnp.asarray(k0), jnp.asarray(k1)), ())[0]
    tcols = tuple(_t(c) for c in cols)
    _same(tkernels.rows_equal_prev(tcols, 64),
          kernels.rows_equal_prev(cols, 64))
    for keep in (rng.integers(0, 2, 64).astype(bool), np.ones(64, bool),
                 np.zeros(64, bool)):
        want = kernels.compact(cols, jnp.asarray(w), jnp.asarray(keep))
        got = tkernels.compact(tcols, _t(w), _t(keep))
        for g, e in zip((*got[0], got[1]), (*want[0], want[1])):
            _same(g, e)


@pytest.mark.parametrize("n,cap", [(5, 8), (100, 128), (128, 128)])
def test_consolidate_sort_regime(n, cap):
    rng = np.random.default_rng(n)
    keys, vals, w = _raw_cols(rng, n)
    want = Batch.from_columns(keys, vals, w, cap=cap)
    got = TBatch.from_columns(keys, vals, w, cap=cap, device="cpu")
    _same_batch(got, want)
    assert got.to_dict() == want.to_dict()


def test_consolidate_rank_fold_regime():
    """A concat of consolidated runs folds rank merges (no sort) and gives
    the canonical batch."""
    rng = np.random.default_rng(3)
    parts = [Batch.from_columns(*_raw_cols(rng, n), cap=c)
             for n, c in ((30, 32), (10, 16), (60, 64))]
    want = concat_batches(parts).consolidate()
    cat = tconcat([_port(p) for p in parts])
    assert cat.runs == (32, 16, 64)
    got = cat.consolidate()
    _same_batch(got, want)


@pytest.mark.parametrize("seed", range(3))
def test_merge_sorted_cols_duplicates_and_sentinels(seed):
    rng = np.random.default_rng(10 + seed)
    a = Batch.from_columns(*_raw_cols(rng, 20, key_range=3), cap=32)
    b = Batch.from_columns(*_raw_cols(rng, 50, key_range=3), cap=64)
    want = kernels.merge_sorted_cols(a.cols, a.weights, b.cols, b.weights)
    pa, pb = _port(a), _port(b)
    got = tkernels.merge_sorted_cols(pa.cols, pa.weights, pb.cols,
                                     pb.weights)
    for g, e in zip((*got[0], got[1]), (*want[0], want[1])):
        _same(g, e)
    # and Z-set addition (merge + shrink) through the batch API
    _same_batch(pa.add(pb), a.add(b))
    assert pa.add(pa.neg()).to_dict() == {}


@pytest.mark.parametrize("side", ["left", "right"])
def test_lex_probe_and_searchsorted(side):
    rng = np.random.default_rng(4)
    table = Batch.from_columns(*_raw_cols(rng, 100), cap=128)
    q0 = rng.integers(-1, 7, 40).astype(np.int64)
    q1 = rng.integers(-4, 4, 40).astype(np.int32)
    want = kernels.lex_probe(table.keys, (jnp.asarray(q0), jnp.asarray(q1)),
                             side)
    got = tkernels.lex_probe(_port(table).keys, (_t(q0), _t(q1)), side)
    _same(got, want)
    t1 = np.sort(rng.integers(0, 50, 30)).astype(np.int32)
    q = rng.integers(-5, 60, 20).astype(np.int64)  # wider query dtype
    _same(tkernels.searchsorted1(_t(t1), _t(q), side),
          kernels.searchsorted1(jnp.asarray(t1), jnp.asarray(q), side))


@pytest.mark.parametrize("out_cap", [64, 5])
def test_expand_ranges(monkeypatch, out_cap):
    """The reference's XLA formulation (native kernels off), including an
    overflowing out_cap and empty ranges."""
    monkeypatch.setenv("DBSP_TPU_NATIVE", "0")
    rng = np.random.default_rng(6)
    lo = rng.integers(0, 20, 12).astype(np.int32)
    hi = (lo + rng.integers(-2, 5, 12)).astype(np.int32)
    want = kernels.expand_ranges(jnp.asarray(lo), jnp.asarray(hi), out_cap)
    got = tkernels.expand_ranges(_t(lo), _t(hi), out_cap)
    for g, e in zip(got[:3], want[:3]):
        _same(g, e)
    assert int(got[3]) == int(want[3])


def test_spine_levels_and_contents():
    """The same inserts give the same level capacities, level contents
    and consolidated trace — merges run through the rank-merge path."""
    rng = np.random.default_rng(7)
    ref = Spine((jnp.int64, jnp.int32), (jnp.int64,))
    port = TSpine((torch.int64, torch.int32), (torch.int64,), device="cpu")
    for i in range(12):
        b = Batch.from_columns(*_raw_cols(rng, int(rng.integers(1, 40)),
                                          key_range=20))
        ref.insert(b)
        port.insert(_port(b))
        assert [x.cap for x in port.batches] == [x.cap for x in ref.batches]
    for g, e in zip(port.batches, ref.batches):
        _same_batch(g, e)
    _same_batch(port.consolidated(), ref.consolidated())
    assert port.to_dict() == ref.to_dict()
    loaded = TSpine.from_levels([_port(b) for b in ref.batches])
    assert loaded.to_dict() == ref.to_dict()
