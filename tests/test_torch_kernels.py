"""The port's six kernel entry points (dbsp_tpu_torch/zset/cuda_kernels.py)
against the reference's Pallas kernels, exactly.

On the CPU each entry point runs its plain version, so these tests hold
the plain versions — the functions the CUDA kernels are checked against on
the card — to the Pallas programs, run through the Pallas interpreter as
tests/test_pallas_kernels.py runs them. Inputs are the adversarial ladders
of that file (duplicate keys across levels, an empty level, a
full-capacity level, heterogeneous caps, a level of no rows) and seeded
random rows; the data are integers, so equality is exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dbsp_tpu.operators.aggregate import _seg_out_dtype
from dbsp_tpu.zset import pallas_kernels
from dbsp_tpu.zset.batch import Batch
from dbsp_tpu_torch.zset import cuda_kernels
from dbsp_tpu_torch.zset.batch import Batch as TBatch
from test_pallas_kernels import _adversarial_ladders, _consolidated


@pytest.fixture
def pallas_interpret(monkeypatch):
    """Run the reference's Pallas kernels in the interpreter."""
    monkeypatch.setenv("DBSP_TPU_PALLAS", "interpret")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _port(b: Batch) -> TBatch:
    """The reference batch's exact state as a port batch on the CPU."""
    return TBatch.from_numpy([np.asarray(c) for c in b.keys],
                             [np.asarray(c) for c in b.vals],
                             np.asarray(b.weights), runs=b.runs,
                             device="cpu")


def _assert_same(got, want, what=""):
    """Exact equality of a port tensor and a reference array, dtype
    included."""
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=what)


def _mixed_ladder(rng):
    """Levels with an int32 value column, as the bids trace has."""
    out = []
    for cap, n in ((64, 40), (16, 9)):
        keys = rng.integers(0, 12, n).astype(np.int64)
        vals = [rng.integers(-5, 5, n).astype(np.int32),
                rng.integers(0, 1000, n).astype(np.int64)]
        out.append(Batch.from_columns([keys], vals,
                                      rng.integers(1, 3, n).astype(np.int64),
                                      cap=cap))
    return out


def _cap0(nk=2, nv=1):
    """A level of no rows (a spine drops empty levels; the compiled
    engine's ladders and the kernels take them)."""
    z = jnp.zeros((0,), jnp.int64)
    return Batch((z,) * nk, (z,) * nv, z, runs=(0,))


def _ladders(rng):
    for ladder in _adversarial_ladders(rng):
        yield ladder, 2, _consolidated(rng, 20, 32)
    # the first ladder again with a cap-0 level in the middle
    ladder = next(_adversarial_ladders(rng))
    yield [ladder[0], _cap0(), *ladder[1:]], 2, _consolidated(rng, 20, 32)
    mixed = _mixed_ladder(rng)
    delta = Batch.from_columns(
        [rng.integers(0, 12, 10).astype(np.int64)],
        [rng.integers(0, 9, 10).astype(np.int64)],
        rng.integers(-2, 3, 10).astype(np.int64), cap=16)
    yield mixed, 1, delta


def _probe_cases(rng):
    """(tables, queries) of the adversarial ladders: key probes with dead
    (sentinel) query rows, all-sentinel queries, and full-row probes whose
    int32 value column the kernel widens."""
    for ladder in _adversarial_ladders(rng):
        delta = _consolidated(rng, 20, 32)  # 12+ dead sentinel rows
        yield [lvl.keys for lvl in ladder], delta.keys
        yield [lvl.keys for lvl in ladder], tuple(
            jnp.full((8,), jnp.iinfo(jnp.int64).max) for _ in delta.keys)
    # a level of no rows at all (spines drop empty levels, the kernel
    # takes them): every lane of it is 0
    yield [lvl.keys for lvl in ladder] + [
        (jnp.zeros((0,), jnp.int64),) * 2], delta.keys
    mixed = _mixed_ladder(rng)
    probe = mixed[1]  # rows found in level 1, mostly not in level 0
    yield [lvl.cols for lvl in mixed], probe.cols
    yield [lvl.cols for lvl in mixed], mixed[0].cols


@pytest.mark.parametrize("side", ["left", "right"])
def test_lex_probe_ladder_plain_equals_pallas(pallas_interpret, side):
    rng = np.random.default_rng(40)
    cases = 0
    for tables, queries in _probe_cases(rng):
        want = pallas_kernels.lex_probe_ladder_pallas(tables, queries, side)
        got = cuda_kernels.lex_probe_ladder(
            [tuple(_t(c) for c in t) for t in tables],
            tuple(_t(q) for q in queries), side)
        _assert_same(got, want, f"case {cases}")
        cases += 1
    assert cases == 9


# out_cap 4 is below the larger ladders' match totals: the overflow
# contract (clamped buffers, unclamped total) is part of what is compared
@pytest.mark.parametrize("out_cap", [1024, 4])
def test_join_ladder_plain_equals_pallas(pallas_interpret, out_cap):
    rng = np.random.default_rng(30)
    totals = []
    for ladder, nk, delta in _ladders(rng):
        want = pallas_kernels.join_ladder_pallas(
            delta.keys[:nk], delta.weights, ladder, nk, out_cap)
        pd = _port(delta)
        got = cuda_kernels.join_ladder(pd.keys[:nk], pd.weights,
                                       [_port(b) for b in ladder], nk,
                                       out_cap)
        qrow, lvals, w, valid, total = got
        wq, wlv, ww, wvalid, wtotal = want
        _assert_same(qrow, wq, "qrow")
        assert len(lvals) == len(wlv)
        for g, e in zip(lvals, wlv):
            _assert_same(g, e, "level vals")
        _assert_same(w, ww, "w")
        _assert_same(valid, wvalid, "valid")
        assert int(total) == int(wtotal)
        totals.append(int(total))
    assert max(totals) > 4  # the small out_cap overflows


@pytest.mark.parametrize("out_cap", [1024, 4])
@pytest.mark.parametrize("mode", ["equal", "range", "gather_keys"])
def test_gather_ladder_plain_equals_pallas(pallas_interpret, out_cap, mode):
    rng = np.random.default_rng(31)
    totals = []
    for ladder, nk, delta in _ladders(rng):
        qkeys = delta.keys[:nk]
        qlive = jnp.asarray(np.asarray(delta.weights) != 0)
        qhi = None
        if mode == "range":  # some ranges empty (qhi < qlo)
            qhi = tuple(k + jnp.asarray(rng.integers(-2, 4, k.shape[0]))
                        for k in qkeys)
        gk = nk if mode == "gather_keys" else 0
        want = pallas_kernels.gather_ladder_pallas(
            qkeys, qlive, ladder, out_cap, qhi_keys=qhi, gather_keys=gk)
        pd = _port(delta)
        got = cuda_kernels.gather_ladder(
            pd.keys[:nk], _t(qlive), [_port(b) for b in ladder], out_cap,
            qhi_keys=None if qhi is None else tuple(_t(k) for k in qhi),
            gather_keys=gk)
        (qrow, vals, w), total = got
        (wq, wv, ww), wtotal = want
        _assert_same(qrow, wq, "qrow")
        assert len(vals) == len(wv)
        for g, e in zip(vals, wv):
            _assert_same(g, e, "vals")
        _assert_same(w, ww, "w")
        assert int(total) == int(wtotal)
        totals.append(int(total))
    assert max(totals) > 4  # the small out_cap overflows


def _cap0_case():
    """The smallest input of the cap-0 fault: one level of keys
    [1, 2, 3, 9], plus a level of no rows; delta keys [1, 3, 4]."""
    lvl = Batch.from_columns([np.array([1, 2, 3, 9], np.int64)],
                             [np.array([10, 20, 30, 90], np.int64)],
                             np.array([2, 1, -1, 1], np.int64), cap=4)
    delta = Batch.from_columns([np.array([1, 3, 4], np.int64)], [],
                               np.ones(3, np.int64), cap=4)
    return [lvl, _cap0(nk=1)], delta


def test_join_ladder_plain_on_cap0_level(pallas_interpret):
    ladder, delta = _cap0_case()
    want = pallas_kernels.join_ladder_pallas(delta.keys, delta.weights,
                                             ladder, 1, 8)
    pd = _port(delta)
    qrow, lvals, w, valid, total = cuda_kernels.join_ladder(
        pd.keys, pd.weights, [_port(b) for b in ladder], 1, 8)
    _assert_same(qrow, want[0], "qrow")
    _assert_same(lvals[0], want[1][0], "vals")
    _assert_same(w, want[2], "w")
    _assert_same(valid, want[3], "valid")
    assert int(total) == int(want[4]) == 2
    assert qrow[:3].tolist() == [0, 1, 0]
    assert lvals[0][:3].tolist() == [10, 30, 0]
    assert w[:3].tolist() == [2, -1, 0]


def test_gather_ladder_plain_on_cap0_level(pallas_interpret):
    ladder, delta = _cap0_case()
    qlive = jnp.asarray(np.asarray(delta.weights) != 0)
    (wq, wv, ww), wtotal = pallas_kernels.gather_ladder_pallas(
        delta.keys, qlive, ladder, 8)
    pd = _port(delta)
    (qrow, vals, w), total = cuda_kernels.gather_ladder(
        pd.keys, _t(qlive), [_port(b) for b in ladder], 8)
    _assert_same(qrow, wq, "qrow")
    _assert_same(vals[0], wv[0], "vals")
    _assert_same(w, ww, "w")
    assert int(total) == int(wtotal) == 2
    assert qrow[:3].tolist() == [0, 1, 4]  # dead slots: qrow == q_cap
    assert vals[0][:2].tolist() == [10, 30]
    assert w[:3].tolist() == [2, -1, 0]


SPEC = (("count", 0), ("sum", 0), ("min", 0), ("max", 1), ("avg", 1),
        ("present", 0))


def _seg_case(rng, n, S):
    v1 = rng.integers(-1000, 1000, n)
    v2 = rng.integers(-9, 9, n).astype(np.int32)
    w = rng.integers(-3, 4, n)
    seg = rng.integers(-2, S + 5, n).astype(np.int32)  # out-of-range ids
    if n >= 4:
        seg[seg == 0] = S + 2  # segment 0 stays empty
        seg[seg == S - 1] = S + 1
        seg[:2] = S - 1  # segment S-1 holds retractions only
        w[:2] = -1
    return (v1, v2), w, seg


@pytest.mark.parametrize("n,S", [(1, 1), (64, 7), (500, 130), (300, 3)])
def test_segment_reduce_plain_equals_pallas(pallas_interpret, n, S):
    rng = np.random.default_rng(20 + n)
    (v1, v2), w, seg = _seg_case(rng, n, S)
    jv = (jnp.asarray(v1), jnp.asarray(v2))
    jw = jnp.asarray(w)
    out_dtypes = tuple(_seg_out_dtype(op, col, jv, jw) for op, col in SPEC)
    want = pallas_kernels.segment_reduce_pallas(
        SPEC, jv, jw, jnp.asarray(seg), S, out_dtypes)
    tdt = {np.dtype(np.int64): torch.int64, np.dtype(np.int32): torch.int32}
    got = cuda_kernels.segment_reduce(
        SPEC, (_t(v1), _t(v2)), _t(w), _t(seg), S,
        tuple(tdt[np.dtype(d)] for d in out_dtypes))
    assert len(got) == len(want)
    for i, (g, e) in enumerate(zip(got, want)):
        _assert_same(g, e, f"op {SPEC[i][0]}")


def test_segment_reduce_avg_truncates_toward_zero(pallas_interpret):
    """avg of negative sums: -7 / 2 == -3 (SQL), not Python's -4."""
    v = np.array([-7, 0, 5, -1], np.int64)
    w = np.array([1, 1, 2, 3], np.int64)
    seg = np.array([0, 0, 1, 1], np.int32)
    want = pallas_kernels.segment_reduce_pallas(
        (("avg", 0),), (jnp.asarray(v),), jnp.asarray(w), jnp.asarray(seg),
        2, (jnp.int64,))
    (got,) = cuda_kernels.segment_reduce(
        (("avg", 0),), (_t(v),), _t(w), _t(seg), 2, (torch.int64,))
    _assert_same(got, want[0])
    assert got.tolist() == [-3, 1]


def _rank_cases(rng):
    for _ in range(4):
        yield (_consolidated(rng, int(rng.integers(0, 50)), 64, key_range=12),
               _consolidated(rng, int(rng.integers(0, 100)), 128,
                             key_range=12))
    # full capacity on both sides (no dead tail), overlapping keys
    yield (Batch.from_columns([jnp.arange(0, 16, dtype=jnp.int64)], [],
                              jnp.ones((16,), jnp.int64), cap=16,
                              consolidated=True),
           Batch.from_columns([jnp.arange(8, 24, dtype=jnp.int64)], [],
                              -jnp.ones((16,), jnp.int64), cap=16,
                              consolidated=True))
    # an empty side, and an int32 value column
    yield (Batch.empty((jnp.int64,), (jnp.int32,), cap=8),
           Batch.from_columns([np.array([3, 1, 3], np.int64)],
                              [np.array([2, 7, -1], np.int32)],
                              np.array([1, 2, 3], np.int64), cap=8))


def test_rank_merge_plain_equals_pallas(pallas_interpret):
    rng = np.random.default_rng(10)
    for a, b in _rank_cases(rng):
        want_cols, want_w = pallas_kernels.rank_merge_scatter(
            a.cols, a.weights, b.cols, b.weights)
        pa, pb = _port(a), _port(b)
        got_cols, got_w = cuda_kernels.rank_merge_scatter(
            pa.cols, pa.weights, pb.cols, pb.weights)
        for g, e in zip(got_cols, want_cols):
            _assert_same(g, e, "cols")
        _assert_same(got_w, want_w, "w")


def test_cpu_tensors_take_the_plain_versions():
    """On CPU tensors no kernel launches: the counts stay where they are."""
    from dbsp_tpu_torch.operators.aggregate import Max

    before = dict(cuda_kernels.LAUNCHES)
    rng = np.random.default_rng(5)
    ladder = [_port(b) for b in _mixed_ladder(rng)]
    d = ladder[1]
    cuda_kernels.lex_probe_ladder([lvl.cols for lvl in ladder], d.cols)
    cuda_kernels.join_ladder(d.keys, d.weights, ladder, 1, 64)
    cuda_kernels.gather_ladder(d.keys, d.weights != 0, ladder, 64)
    cuda_kernels.segment_reduce((("max", 0),), (d.vals[1],), d.weights,
                                torch.zeros(d.cap, dtype=torch.int32), 1,
                                (torch.int64,))
    cuda_kernels.rank_merge_scatter(d.cols, d.weights, d.cols, d.weights)
    cuda_kernels.agg_ladder(d, 1, ladder[0], ladder, Max(0), 8, 64, True,
                            torch.tensor(True))
    assert cuda_kernels.LAUNCHES == before


# ---------------------------------------------------------------------------
# agg_ladder: the compiled aggregate's chain over the gather and the segment
# reduction, against agg_ladder_pallas (the same chain on the Pallas
# gather and segment-reduce kernels)
# ---------------------------------------------------------------------------


def _netting_ladder(rng):
    """Levels whose rows cancel across levels: the second level retracts
    some rows of the first and re-inserts them with other weights, so the
    gathered part holds insert/retract rows of one (qrow, vals)."""
    base = _consolidated(rng, 40, 64, key_range=6, allow_neg=False)
    n = int(np.count_nonzero(np.asarray(base.weights)))
    cols = [np.asarray(c)[:n] for c in base.cols]
    w = np.asarray(base.weights)[:n]
    sel = rng.random(n) < 0.5
    back = Batch.from_columns([c[sel] for c in cols[:2]], [cols[2][sel]],
                              -w[sel], cap=64)
    again = Batch.from_columns([c[sel][::2] for c in cols[:2]],
                               [cols[2][sel][::2]],
                               np.ones(len(w[sel][::2]), np.int64), cap=32)
    return [base, back, again]


def _agg_cases(rng):
    """(ladder, delta, out_trace): the adversarial ladders, a ladder with
    multi-level netting and one with a cap-0 level."""
    ladders = list(_adversarial_ladders(rng))
    ladders.append(_netting_ladder(rng))
    ladders.append([ladders[0][0], _cap0(), ladders[0][2]])
    for ladder in ladders:
        yield (ladder, _consolidated(rng, 20, 32, key_range=6),
               _consolidated(rng, 10, 16, key_range=6, allow_neg=False))


def _flat(out):
    """The 10-tuple's tensors in order, None kept (off the fast path)."""
    flat = []
    for o in out:
        if o is None or not isinstance(o, tuple):
            flat.append(o)
        else:
            flat.extend(o)
    return flat


# (mode, q_cap, gather_cap): the fast path (Max) with its gate off and on,
# the general path, and caps below the queries and the gather totals
AGG_MODES = [("fast", False, 16, 512), ("fast", True, 16, 512),
             ("general", True, 16, 512), ("fast", True, 4, 8),
             ("general", True, 4, 8)]


@pytest.mark.parametrize("mode,flag,q_cap,gather_cap", AGG_MODES)
def test_agg_ladder_plain_equals_pallas(pallas_interpret, mode, flag, q_cap,
                                        gather_cap):
    from dbsp_tpu.operators.aggregate import Max
    from dbsp_tpu_torch.operators.aggregate import Max as TMax

    fast = mode == "fast"
    rng = np.random.default_rng(60)
    cases = 0
    overflow = 0
    for ladder, delta, out_trace in _agg_cases(rng):
        want = pallas_kernels.agg_ladder_pallas(
            delta, 2, out_trace, ladder, Max(0), q_cap, gather_cap, fast,
            jnp.asarray(flag))
        got = cuda_kernels.agg_ladder(
            _port(delta), 2, _port(out_trace), [_port(b) for b in ladder],
            TMax(0), q_cap, gather_cap, fast, torch.tensor(flag))
        g, w = _flat(got), _flat(want)
        assert len(g) == len(w) == 11
        for i, (a, b) in enumerate(zip(g, w)):
            if b is None:
                assert a is None, f"case {cases} leaf {i}"
            else:
                _assert_same(a, b, f"case {cases} leaf {i}")
        # nq and the gather total are the unclamped requirements
        overflow += int(got[2]) > q_cap or int(got[9]) > gather_cap
        cases += 1
    assert cases == 5
    if q_cap == 4:
        assert overflow, "the small caps must overflow for the check to bite"


def test_agg_ladder_fast_gate_masks_the_gather():
    """Fast path, gate off: no query reaches the ladder gather (total 0);
    gate on: the touched groups' rows come back."""
    from dbsp_tpu_torch.operators.aggregate import Max as TMax

    rng = np.random.default_rng(61)
    ladder, delta, out_trace = next(_agg_cases(rng))
    args = (_port(delta), 2, _port(out_trace), [_port(b) for b in ladder],
            TMax(0), 16, 512, True)
    assert int(cuda_kernels.agg_ladder(*args, torch.tensor(False))[9]) == 0
    assert int(cuda_kernels.agg_ladder(*args, torch.tensor(True))[9]) > 0


def test_argument_block_takes_any_ladder_depth():
    """Above the by-value block's 448 slots a launch's argument block goes
    to the kernel as a device table (on the card, an asynchronous upload
    from pinned memory of the packed block, which is checked here)."""
    blk = cuda_kernels._ArgBlock(torch.device("cpu"), 3000, "test")
    assert not blk.by_value
    for i in range(3000):
        blk.slots[i] = 7 * i - 5
    table = blk.packed()
    assert table.dtype == torch.int64 and table.shape == (3000,)
    assert table.tolist() == [7 * i - 5 for i in range(3000)]
    small = cuda_kernels._ArgBlock(torch.device("cpu"),
                                   cuda_kernels.ARGS_MAX, "test")
    assert small.by_value
