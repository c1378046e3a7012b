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

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dbsp_tpu.operators.aggregate import Aggregator as RefAggregator
from dbsp_tpu.operators.aggregate import Average as RefAverage
from dbsp_tpu.operators.aggregate import Count as RefCount
from dbsp_tpu.operators.aggregate import Max as RefMax
from dbsp_tpu.operators.aggregate import Min as RefMin
from dbsp_tpu.operators.aggregate import Sum as RefSum
from dbsp_tpu.operators.aggregate import _seg_out_dtype
from dbsp_tpu.zset import pallas_kernels
from dbsp_tpu.zset.batch import Batch
from dbsp_tpu_torch.operators.aggregate import Aggregator as TAggregator
from dbsp_tpu_torch.zset import cuda_kernels
from dbsp_tpu_torch.zset.batch import Batch as TBatch
from test_pallas_kernels import _adversarial_ladders, _consolidated
from test_torch_compiled import one_torch_thread  # noqa: F401  (autouse)


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


def _sorted_rows(rng, n, specs):
    """n rows sorted lexicographically, column i drawn from [lo, hi) as
    ``specs[i] = (lo, hi, numpy dtype)``: narrow ranges give runs of
    equal rows."""
    cols = [rng.integers(lo, hi, n).astype(dt) for lo, hi, dt in specs]
    order = np.lexsort(cols[::-1])
    return [c[order] for c in cols]


I64 = np.int64
SENTINEL = np.iinfo(np.int64).max


def _probe_both_case(name, rng):
    """(tables, queries) as numpy columns, for the two-sided probe."""
    if name.startswith("dup-runs"):
        ncols = int(name.split("-")[2][:-3])
        # two varying columns at most, the rest constant: runs of equal rows
        spec = [(0, 4 if ncols == 1 else 2, I64)] * min(ncols, 2) + \
            [(7, 8, I64)] * (ncols - 2)
        qspec = [(-1, 5 if ncols == 1 else 3, I64)] * min(ncols, 2) + \
            [(7, 8, I64)] * (ncols - 2)
        return ([_sorted_rows(rng, n, spec) for n in (40, 17, 5)],
                _sorted_rows(rng, 30, qspec))
    spec = [(0, 6, I64)] * 2
    tables = [_sorted_rows(rng, n, spec) for n in (50, 9)]
    queries = _sorted_rows(rng, 25, [(-1, 7, I64)] * 2)
    if name == "cap0-level":
        return tables[:1] + [[np.zeros(0, I64)] * 2] + tables[1:], queries
    if name == "one-row-level":
        return tables + [_sorted_rows(rng, 1, spec)], queries
    if name == "sentinel-queries":
        return tables, [np.concatenate([q, np.full(6, SENTINEL)])
                        for q in queries]
    assert name == "narrow-columns"
    spec = [(0, 5, np.int32), (0, 2, np.bool_), (-3, 3, np.int8)]
    return ([_sorted_rows(rng, n, spec) for n in (60, 12)],
            _sorted_rows(rng, 20, [(0, 6, I64), (0, 2, np.bool_),
                                   (-4, 4, np.int32)]))


@pytest.mark.parametrize("case", [
    "dup-runs-1col", "dup-runs-3col", "dup-runs-16col", "cap0-level",
    "one-row-level", "sentinel-queries", "narrow-columns"])
def test_lex_probe_ladder_both_plain_equals_pallas(pallas_interpret, case):
    """Both sides of one probe against the Pallas probe's left and right
    sides, on tables with runs of equal rows (so hi - lo > 1), a cap-0
    level, a one-row level, sentinel queries and narrow columns."""
    rng = np.random.default_rng(41)
    tables, queries = _probe_both_case(case, rng)
    lo, hi = cuda_kernels.lex_probe_ladder_both(
        [tuple(_t(c) for c in t) for t in tables],
        tuple(_t(q) for q in queries))
    for side, got in (("left", lo), ("right", hi)):
        want = pallas_kernels.lex_probe_ladder_pallas(
            [tuple(jnp.asarray(c) for c in t) for t in tables],
            tuple(jnp.asarray(q) for q in queries), side)
        _assert_same(got, want, f"{case} side {side}")
    if case.startswith("dup-runs"):
        assert int((hi - lo).max()) > 1, "no run of equal rows was probed"


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


# SPEC over two more narrow columns: an int16 max and a bool sum
NARROW_SPEC = SPEC + (("max", 2), ("sum", 3))


def _seg_ordered(rng, n, S, order):
    """Ids in ``order`` (all int32) with the value columns of
    NARROW_SPEC: sorted runs broken by out-of-range ids and by rows of
    w <= 0 (one run of retractions only), one segment holding every row,
    or alternating ids (every run one row long)."""
    (v1, v2), w, _ = _seg_case(rng, n, S)
    if order == "sorted":
        seg = np.sort(rng.integers(0, S, n))
        cut = rng.random(n) < 0.05
        seg[cut] = rng.choice([-1, S, S + 7], int(cut.sum()))
        w[rng.random(n) < 0.2] = 0
        w[seg == seg[n // 2]] = -1
    elif order == "one":
        seg = np.full(n, S // 2)
    else:
        seg = np.arange(n) % 2  # id 1 is out of range when S == 1
    v3 = rng.integers(-300, 300, n).astype(np.int16)
    v4 = rng.integers(0, 2, n).astype(np.bool_)
    return (v1, v2, v3, v4), w, seg.astype(np.int32)


@pytest.mark.parametrize("order,n,S", [
    *(pytest.param("random", n, S, id=f"{n}-{S}")
      for n, S in ((1, 1), (64, 7), (500, 130), (300, 3))),
    *((order, n, S) for order in ("sorted", "one", "alternating")
      for n, S in ((1, 1), (64, 7), (500, 130), (300, 3)))])
def test_segment_reduce_plain_equals_pallas(pallas_interpret, order, n, S):
    """Random ids (SPEC), and int32 ids in sorted runs, in one segment or
    alternating, with int32, int16 and bool value columns
    (NARROW_SPEC)."""
    rng = np.random.default_rng(20 + n)
    if order == "random":
        spec = SPEC
        vals, w, seg = _seg_case(rng, n, S)
    else:
        spec = NARROW_SPEC
        vals, w, seg = _seg_ordered(rng, n, S, order)
    jv = tuple(jnp.asarray(v) for v in vals)
    jw = jnp.asarray(w)
    out_dtypes = tuple(_seg_out_dtype(op, col, jv, jw) for op, col in spec)
    want = pallas_kernels.segment_reduce_pallas(
        spec, jv, jw, jnp.asarray(seg), S, out_dtypes)
    got = cuda_kernels.segment_reduce(
        spec, tuple(_t(v) for v in vals), _t(w), _t(seg), S,
        tuple(torch.from_numpy(np.empty(0, d)).dtype for d in out_dtypes))
    assert len(got) == len(want)
    for i, (g, e) in enumerate(zip(got, want)):
        _assert_same(g, e, f"op {spec[i][0]}")


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


def _rank_case(name, rng):
    """(cols_a, w_a, cols_b, w_b) as numpy arrays: two sorted runs."""
    def w(n):
        return rng.integers(-3, 4, n).astype(I64)

    two = [(0, 9, I64)] * 2
    if name == "ties-first-column":
        spec = [(0, 3, I64), (0, 1000, I64)]
        a, b = _sorted_rows(rng, 40, spec), _sorted_rows(rng, 60, spec)
    elif name == "equal-rows-both-sides":
        a = _sorted_rows(rng, 30, two)
        # every third row of a, and a's rows again: equal rows across sides
        both = [np.concatenate([c, c[::3]]) for c in a]
        order = np.lexsort(both[::-1])
        b = [c[order] for c in both]
    elif name == "a-empty":
        a, b = _sorted_rows(rng, 0, two), _sorted_rows(rng, 30, two)
    elif name == "b-empty":
        a, b = _sorted_rows(rng, 30, two), _sorted_rows(rng, 0, two)
    elif name == "skew-1-20":  # q4's 92k delta against a 2M level, scaled
        spec = [(0, 5_000, I64), (0, 1 << 40, I64), (0, 16, np.int32)]
        a, b = _sorted_rows(rng, 50, spec), _sorted_rows(rng, 1_000, spec)
    elif name == "all-rows-equal":
        spec = [(4, 5, I64)] * 2
        a, b = _sorted_rows(rng, 30, spec), _sorted_rows(rng, 50, spec)
    else:
        assert name == "int32-bool-columns"
        spec = [(0, 5, np.int32), (0, 2, np.bool_), (-9, 9, np.int32)]
        a, b = _sorted_rows(rng, 45, spec), _sorted_rows(rng, 35, spec)
    return a, w(len(a[0])), b, w(len(b[0]))


def _assert_rank_merge(a_cols, a_w, b_cols, b_w, what):
    if len(a_w) and len(b_w):
        want_cols, want_w = pallas_kernels.rank_merge_scatter(
            tuple(jnp.asarray(c) for c in a_cols), jnp.asarray(a_w),
            tuple(jnp.asarray(c) for c in b_cols), jnp.asarray(b_w))
    else:
        # the Pallas interpreter takes no zero-row block: with one side
        # empty the merge is the other side as it is, in a's dtypes
        want_cols = [np.concatenate([ca, cb.astype(ca.dtype)])
                     for ca, cb in zip(a_cols, b_cols)]
        want_w = np.concatenate([a_w, b_w.astype(a_w.dtype)])
    got_cols, got_w = cuda_kernels.rank_merge_scatter(
        tuple(_t(c) for c in a_cols), _t(a_w),
        tuple(_t(c) for c in b_cols), _t(b_w))
    assert len(got_cols) == len(want_cols)
    for g, e in zip(got_cols, want_cols):
        _assert_same(g, e, f"{what} cols")
    _assert_same(got_w, want_w, f"{what} w")


@pytest.mark.parametrize("case", [
    "consolidated-batches", "ties-first-column", "equal-rows-both-sides",
    "a-empty", "b-empty", "skew-1-20", "all-rows-equal",
    "int32-bool-columns"])
def test_rank_merge_plain_equals_pallas(pallas_interpret, case):
    """The plain rank merge against the Pallas one: consolidated batches
    (dead tails, full capacity, an empty side), ties on the first column
    only, rows present on both sides, either side empty, a 1:20 size
    skew, runs of equal rows within each side, int32 and bool columns.
    An empty side is held to the other side as it is."""
    if case != "consolidated-batches":
        _assert_rank_merge(*_rank_case(case, np.random.default_rng(11)),
                           case)
        return
    rng = np.random.default_rng(10)
    for i, (a, b) in enumerate(_rank_cases(rng)):
        pa, pb = _port(a), _port(b)
        _assert_rank_merge([c.numpy() for c in pa.cols], pa.weights.numpy(),
                           [c.numpy() for c in pb.cols], pb.weights.numpy(),
                           f"pair {i}")


def test_kernel_stages_fit():
    """The rank merge's tile fits what the kernel accepts (csrc: a tile
    that is a multiple of 256 threads, within 227 KB) for every column
    count it takes."""
    for ncols in range(1, cuda_kernels.MAX_COLS + 1):
        t = cuda_kernels.rank_merge_tile(ncols)
        assert t % cuda_kernels.MERGE_THREADS == 0 and t >= 256
        assert ((ncols + 1) * 8 + 4) * t <= cuda_kernels.MERGE_STAGE_BYTES
    assert cuda_kernels.rank_merge_tile(5) == 1024  # q4's bids rows


def test_column_kinds_match_the_kernels():
    """The wrapper's element-type codes are csrc/common.cuh's ColKind, and
    a column of another type is refused, not misread."""
    import re
    from pathlib import Path

    src = (Path(cuda_kernels.__file__).resolve().parent.parent / "csrc" /
           "common.cuh").read_text()
    enum = {name: int(v) for name, v in
            re.findall(r"KIND_(\w+) = (\d+)", src)}
    names = {torch.int64: "I64", torch.int32: "I32", torch.int16: "I16",
             torch.int8: "I8", torch.uint8: "U8", torch.bool: "BOOL"}
    assert {names[d]: k for d, k in cuda_kernels._KINDS.items()} == enum
    blk = cuda_kernels._ArgBlock(torch.device("cuda", 0), 4, "test")
    with pytest.raises(ValueError, match="bool columns only"):
        blk.col_at_width(0, torch.zeros(4, dtype=torch.float32))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        blk.col_at_width(0, torch.zeros(4, dtype=torch.int64))


def _csrc(name: str) -> str:
    from pathlib import Path

    return (Path(cuda_kernels.__file__).resolve().parent.parent / "csrc" /
            name).read_text()


def test_segment_reduce_constants_match_the_kernel():
    """The wrapper's opcodes and tile are csrc/segment_reduce.cu's (its
    opcodes are common.cuh's, which the fused aggregate shares), and the
    kernel's extra ops (avg's weight sum, the no-op) take codes the spec
    does not use."""
    import re

    src = _csrc("segment_reduce.cu")
    enum = re.search(r"enum Op \{([^}]*)\}", _csrc("common.cuh")).group(1)
    codes = {name.lower(): int(v)
             for name, v in re.findall(r"(\w+) = (\d+)", enum)}
    assert {k: codes[k] for k in cuda_kernels.SEG_OPS} == \
        cuda_kernels.SEG_OPS
    assert len(set(codes.values())) == len(codes) == 8
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
    assert int(consts["THREADS"]) * int(consts["ITEMS"]) == \
        cuda_kernels.SEG_TILE


def test_agg_ladder_constants_match_the_kernel():
    """The fused aggregate's limits, opcodes and tile are
    csrc/agg_ladder.cu's: the op and column limits the wrapper checks, the
    opcodes of common.cuh it includes, and the run-wise fold's tile,
    which it shares with segment reduce."""
    import re

    src = _csrc("agg_ladder.cu")
    consts = dict(re.findall(r"constexpr int (\w+) = (\w+);", src))
    assert int(consts["MAX_OPS"]) == cuda_kernels.AGG_MAX_OPS
    assert consts["ITEMS"] == "RUN_ITEMS"
    common = _csrc("common.cuh")
    assert int(re.search(r"constexpr int RUN_ITEMS = (\d+);",
                         common).group(1)) * int(consts["THREADS"]) == \
        cuda_kernels.SEG_TILE
    assert int(re.search(r"#define MAX_COLS (\d+)", common).group(1)) == \
        cuda_kernels.MAX_COLS
    enum = re.search(r"enum Op \{([^}]*)\}", common).group(1)
    codes = {name.lower(): int(v)
             for name, v in re.findall(r"(\w+) = (\d+)", enum)}
    assert {k: codes[k] for k in cuda_kernels.SEG_OPS} == \
        cuda_kernels.SEG_OPS
    assert '#include "common.cuh"' in src and "enum Op" not in src


def test_agg_ladder_refuses_what_the_kernel_does_not_take():
    """The fused kernel takes the reference's ``fusable`` calls only: a
    spec, key columns, caps of at least 1, one out-trace value column per
    op, levels of the delta's value schema; anything else raises
    ValueError with the reason (checked before any launch)."""
    rng = np.random.default_rng(63)
    ladder = [_port(b) for b in _netting_ladder(rng)]
    delta = _port(_consolidated(rng, 20, 32, key_range=6))
    out_trace = _port(_consolidated(rng, 10, 16, key_range=6))
    ok = (delta, 2, out_trace, ladder, _PortSpec((("max", 0),)), 16, 64)
    assert cuda_kernels._agg_spec(*ok) == (("max", 0),)

    def refused(match, **kw):
        names = ("delta", "nk", "out_trace", "levels", "agg", "q_cap",
                 "gather_cap")
        args = dict(zip(names, ok), **kw)
        with pytest.raises(ValueError, match=match):
            cuda_kernels._agg_spec(*(args[n] for n in names))

    refused("no reduce spec", agg=TAggregator())
    refused("no levels", levels=[])
    refused("key columns", nk=0)
    refused("must be >= 1", q_cap=0)
    refused("must be >= 1", gather_cap=0)
    refused("value columns, the spec 2 ops",
            agg=_PortSpec((("max", 0), ("count", 0))))
    refused("value schema", levels=[*ladder, _port(_cap0(nv=2))])
    refused("reads column 3", agg=_PortSpec((("sum", 3),)))
    refused("unknown op", agg=_PortSpec((("median", 0),)))
    refused("at most", agg=_PortSpec((("count", 0),) *
                                     (cuda_kernels.AGG_MAX_OPS + 1)))


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


def _narrow_batch(b: Batch, key_dtype, w_dtype) -> Batch:
    """``b`` with its key columns and weights stored at narrower dtypes
    (dead rows keep the narrow dtype's sentinel)."""
    live = np.asarray(b.weights) != 0
    keys = tuple(jnp.asarray(np.where(live, np.asarray(k),
                                      np.iinfo(key_dtype).max)
                             .astype(key_dtype)) for k in b.keys)
    return Batch(keys, b.vals, jnp.asarray(np.asarray(b.weights)
                                           .astype(w_dtype)), runs=b.runs)


def _rows_batch(cols, w, nk: int, cap: int) -> Batch:
    """A batch of exactly these sorted rows (int64 columns, key columns
    first) and weights, sentinel-padded to ``cap`` and not consolidated:
    a zero-weight row stays where it is."""
    n = len(w)

    def pad(c, fill):
        return jnp.asarray(np.concatenate([np.asarray(c, np.int64),
                                           np.full(cap - n, fill, np.int64)]))

    top = np.iinfo(np.int64).max
    return Batch(tuple(pad(c, top) for c in cols[:nk]),
                 tuple(pad(c, top) for c in cols[nk:]), pad(w, 0),
                 runs=(cap,))


def _dead_row_case(rng):
    """(ladder, delta, out_trace) whose delta holds a zero-weight row
    between two live rows of one key, and a zero-weight row just ahead of
    a key's first live row (that row then heads no group: its keys equal
    the row before's)."""
    k0 = [1, 1, 2, 2, 2, 3, 4, 4]
    k1 = [1, 1, 5, 5, 5, 0, 2, 2]
    v = [4, 7, 1, 3, 8, 2, 5, 6]
    w = [0, 2, 1, 0, -1, 3, 2, 0]
    delta = _rows_batch([k0, k1, v], w, 2, 16)
    level = _consolidated(rng, 30, 64, key_range=6)
    extra = Batch.from_columns([np.array(k0[1:6], np.int64),
                                np.array(k1[1:6], np.int64)],
                               [np.array([9, 9, 9, 9, 9], np.int64)],
                               np.array([1, 2, -1, 1, 3], np.int64), cap=8)
    out_trace = Batch.from_columns([np.array([1, 2, 2, 3], np.int64),
                                    np.array([1, 5, 5, 0], np.int64)],
                                   [np.array([40, 10, 12, 5], np.int64)],
                                   np.array([1, 1, -1, 1], np.int64), cap=8)
    return [level, extra], delta, out_trace


def _agg_cases(rng):
    """(name, ladder, delta, out_trace, aggregator name): the adversarial
    ladders, a ladder with multi-level netting and one with a cap-0
    level, then the cases the fused kernel finds hard: zero value columns
    (a count), an out trace with several rows per key, a delta with a
    zero-weight row inside a group, an all-retraction delta, int32 keys
    and weights, and a ladder deep enough (90 levels) that the argument
    block exceeds the 448 by-value slots."""
    ladders = list(_adversarial_ladders(rng))
    ladders.append(_netting_ladder(rng))
    ladders.append([ladders[0][0], _cap0(), ladders[0][2]])
    for i, ladder in enumerate(ladders):
        yield (f"ladder {i}", ladder, _consolidated(rng, 20, 32, key_range=6),
               _consolidated(rng, 10, 16, key_range=6, allow_neg=False),
               "max")
    yield ("zero value columns",
           [_consolidated(rng, 40, 64, nv=0, key_range=6),
            _consolidated(rng, 12, 16, nv=0, key_range=6)],
           _consolidated(rng, 20, 32, nv=0, key_range=6),
           _consolidated(rng, 10, 16, key_range=6, allow_neg=False), "count")
    yield ("out trace with several rows per key", ladders[3],
           _consolidated(rng, 20, 32, key_range=3),
           _consolidated(rng, 14, 16, key_range=3), "max")
    yield ("zero-weight rows in the delta", *_dead_row_case(rng), "max")
    delta = _consolidated(rng, 20, 32, key_range=6)
    yield ("all retractions", ladders[3],
           Batch(delta.keys, delta.vals, -jnp.abs(delta.weights),
                 delta.runs),
           _consolidated(rng, 10, 16, key_range=6, allow_neg=False), "max")
    yield ("int32 keys and weights",
           [_narrow_batch(b, np.int32, np.int32) for b in ladders[3]],
           _narrow_batch(_consolidated(rng, 20, 32, key_range=6), np.int32,
                         np.int32),
           _narrow_batch(_consolidated(rng, 10, 16, key_range=6,
                                       allow_neg=False), np.int32,
                         np.int32), "max")
    yield ("90 levels (argument table)",
           [_consolidated(rng, 3, 4, key_range=4) for _ in range(90)],
           _consolidated(rng, 12, 16, key_range=4),
           _consolidated(rng, 8, 16, key_range=4, allow_neg=False), "max")


def _flat(out):
    """The 10-tuple's tensors in order, None kept (off the fast path)."""
    flat = []
    for o in out:
        if o is None or not isinstance(o, tuple):
            flat.append(o)
        else:
            flat.extend(o)
    return flat


@dataclasses.dataclass(frozen=True)
class _PortSpec(TAggregator):
    """A spec-only aggregator of the port: ``spec`` as given, int64
    outputs."""

    spec: tuple = (("max", 0),)

    def reduce_spec(self):
        return self.spec

    @property
    def out_dtypes(self):
        return (torch.int64,) * len(self.spec)


@dataclasses.dataclass(frozen=True)
class _RefSpec(RefAggregator):
    """The same on the reference's side, for the specs no built-in
    aggregator of the reference has."""

    spec: tuple = (("max", 0),)

    def reduce_spec(self):
        return self.spec

    @property
    def out_dtypes(self):
        return (jnp.int64,) * len(self.spec)


ALL_OPS = (("count", 0), ("sum", 0), ("min", 0), ("max", 0), ("avg", 0),
           ("present", 0))
# aggregator name -> (the port's spec, the reference's aggregator)
SPEC_AGGS = {
    "max": ((("max", 0),), RefMax(0)),
    "min": ((("min", 0),), RefMin(0)),
    "count": ((("count", 0),), RefCount()),
    "sum": ((("sum", 0),), RefSum(0)),
    "avg": ((("avg", 0),), RefAverage(0)),
    "all six ops": (ALL_OPS, _RefSpec(ALL_OPS)),
}


def _assert_agg_equal(ladder, delta, out_trace, agg, nk, q_cap, gather_cap,
                      fast, flag, what):
    """``cuda_kernels.agg_ladder`` (its plain version, on the CPU) against
    ``agg_ladder_pallas`` on the same inputs, every leaf exactly; returns
    the port's 10-tuple."""
    spec, ref_agg = SPEC_AGGS[agg]
    want = pallas_kernels.agg_ladder_pallas(
        delta, nk, out_trace, ladder, ref_agg, q_cap, gather_cap, fast,
        jnp.asarray(flag))
    got = cuda_kernels.agg_ladder(
        _port(delta), nk, _port(out_trace), [_port(b) for b in ladder],
        _PortSpec(spec), q_cap, gather_cap, fast, torch.tensor(flag))
    g, w = _flat(got), _flat(want)
    assert len(g) == len(w), what
    for i, (a, b) in enumerate(zip(g, w)):
        if b is None:
            assert a is None, f"{what} leaf {i}"
        else:
            _assert_same(a, b, f"{what} leaf {i}")
    return got


# (mode, flag, q_cap, gather_cap): the fast path with its gate off and on,
# the general path, and caps below the queries and the gather totals, with
# the gate on and off
AGG_MODES = [("fast", False, 16, 512), ("fast", True, 16, 512),
             ("general", True, 16, 512), ("fast", True, 4, 8),
             ("general", True, 4, 8), ("fast", False, 4, 8)]


@pytest.mark.parametrize("mode,flag,q_cap,gather_cap", AGG_MODES)
def test_agg_ladder_plain_equals_pallas(pallas_interpret, mode, flag, q_cap,
                                        gather_cap):
    rng = np.random.default_rng(60)
    cases = 0
    overflow = 0
    for name, ladder, delta, out_trace, agg in _agg_cases(rng):
        got = _assert_agg_equal(ladder, delta, out_trace, agg, 2, q_cap,
                                gather_cap, mode == "fast", flag,
                                f"case {name}")
        # nq and the gather total are the unclamped requirements
        overflow += int(got[2]) > q_cap or int(got[9]) > gather_cap
        cases += 1
    assert cases == 11
    if q_cap == 4:
        assert overflow, "the small caps must overflow for the check to bite"


@pytest.mark.parametrize("agg", list(SPEC_AGGS))
def test_agg_ladder_spec_ops_plain_equals_pallas(pallas_interpret, agg):
    """Every op of the spec vocabulary (count, sum, min, max, avg,
    present) through a spec-only aggregator of the port, against the
    reference's Max, Min, Count, Sum and Average and a spec-only
    aggregator: signed values (avg truncates toward zero), a netting
    ladder, the fast and the general path, roomy and overflowing caps."""
    rng = np.random.default_rng(62)
    ladder = _netting_ladder(rng)
    nops = len(SPEC_AGGS[agg][0])

    def signed(b):  # values shifted below zero, sentinels kept
        live = np.asarray(b.weights) != 0
        vals = tuple(jnp.asarray(np.where(live, np.asarray(v) - 3,
                                          np.asarray(v))) for v in b.vals)
        return Batch(b.keys, vals, b.weights, runs=b.runs)

    ladder = [signed(b) for b in ladder]
    delta = signed(_consolidated(rng, 20, 32, key_range=6))
    out_trace = _consolidated(rng, 10, 16, nv=nops, key_range=6,
                              allow_neg=False)
    for fast, flag, q_cap, gather_cap in ((True, True, 16, 512),
                                          (False, True, 4, 8),
                                          (True, False, 4, 8)):
        _assert_agg_equal(ladder, delta, out_trace, agg, 2, q_cap,
                          gather_cap, fast, flag,
                          f"{agg} fast {fast} caps {q_cap}/{gather_cap}")


def test_agg_ladder_fast_gate_masks_the_gather():
    """Fast path, gate off: no query reaches the ladder gather (total 0);
    gate on: the touched groups' rows come back."""
    from dbsp_tpu_torch.operators.aggregate import Max as TMax

    rng = np.random.default_rng(61)
    _, ladder, delta, out_trace, _ = next(_agg_cases(rng))
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


# ---------------------------------------------------------------------------
# The ladder consumer (join_ladder / gather_ladder): narrow columns, long
# and empty ranges, the clamp inside a range, and the kernel's plan
# ---------------------------------------------------------------------------


def _cast(b: Batch, key_dts, val_dts, w_dt) -> Batch:
    """``b`` with its key and value columns and weights stored at numpy
    dtypes ``key_dts``, ``val_dts`` and ``w_dt``; dead rows keep each
    dtype's sentinel. Casts of non-negative values are monotone, so the
    rows stay sorted."""
    live = np.asarray(b.weights) != 0

    def cast(c, dt):
        top = True if dt == np.bool_ else np.iinfo(dt).max
        return jnp.asarray(np.where(live, np.asarray(c).astype(dt), top)
                           .astype(dt))

    return Batch(tuple(cast(c, dt) for c, dt in zip(b.keys, key_dts)),
                 tuple(cast(c, dt) for c, dt in zip(b.vals, val_dts)),
                 jnp.asarray(np.asarray(b.weights).astype(w_dt)),
                 runs=b.runs)


def _port_exact(b: Batch) -> TBatch:
    """The reference batch as a port batch on the CPU, its weights kept at
    their dtype (``_port`` loads them as int64)."""
    return TBatch(tuple(_t(k) for k in b.keys), tuple(_t(v) for v in b.vals),
                  _t(b.weights), runs=b.runs)


def _assert_join(ladder, delta_keys, delta_w, nk, out_cap):
    """join_ladder (plain, on the CPU) against join_ladder_pallas; returns
    the total."""
    want = pallas_kernels.join_ladder_pallas(delta_keys, delta_w, ladder,
                                             nk, out_cap)
    got = cuda_kernels.join_ladder(tuple(_t(k) for k in delta_keys),
                                   _t(delta_w),
                                   [_port_exact(b) for b in ladder], nk,
                                   out_cap)
    _assert_same(got[0], want[0], "qrow")
    assert len(got[1]) == len(want[1])
    for g, e in zip(got[1], want[1]):
        _assert_same(g, e, "level vals")
    _assert_same(got[2], want[2], "w")
    _assert_same(got[3], want[3], "valid")
    assert int(got[4]) == int(want[4])
    return int(got[4])


def _assert_gather(ladder, qkeys, qlive, out_cap, qhi=None, gk=0):
    """gather_ladder (plain, on the CPU) against gather_ladder_pallas;
    returns the total."""
    (wq, wv, ww), wtotal = pallas_kernels.gather_ladder_pallas(
        qkeys, qlive, ladder, out_cap, qhi_keys=qhi, gather_keys=gk)
    (qrow, vals, w), total = cuda_kernels.gather_ladder(
        tuple(_t(k) for k in qkeys), _t(qlive),
        [_port_exact(b) for b in ladder], out_cap,
        qhi_keys=None if qhi is None else tuple(_t(k) for k in qhi),
        gather_keys=gk)
    _assert_same(qrow, wq, "qrow")
    assert len(vals) == len(wv)
    for g, e in zip(vals, wv):
        _assert_same(g, e, "vals")
    _assert_same(w, ww, "w")
    assert int(total) == int(wtotal)
    return int(total)


def _assert_consumer(ladder, delta, nk, out_caps, qhi=None):
    """Both entry points, the gather in its three modes, at every cap."""
    qkeys = delta.keys[:nk]
    qlive = jnp.asarray(np.asarray(delta.weights) != 0)
    totals = []
    for out_cap in out_caps:
        totals.append(_assert_join(ladder, qkeys, delta.weights, nk,
                                   out_cap))
        _assert_gather(ladder, qkeys, qlive, out_cap)
        _assert_gather(ladder, qkeys, qlive, out_cap, gk=nk)
        if qhi is not None:
            _assert_gather(ladder, qkeys, qlive, out_cap, qhi=qhi)
    return totals


I8, I16, I32, BOOL, U8 = np.int8, np.int16, np.int32, np.bool_, np.uint8


# (key dtypes, value dtypes, level weights, query keys, delta weights,
# key range)
NARROW = {
    "int32 keys, values of every width": (
        (I32,), (I8, I16, I32, BOOL, U8), I32, (I32,), I16, 40),
    "int16 keys, int64 queries": ((I16, I16), (I64,), I64, (I64, I64), I64,
                                  9),
    "int8 keys and weights": ((I8,), (BOOL, I8), I8, (I8,), I8, 30),
    "bool key": ((BOOL, I64), (I16, U8), I16, (BOOL, I32), I32, 2),
}


@pytest.mark.parametrize("case", list(NARROW))
def test_ladder_consumer_narrow_columns_plain_equals_pallas(
        pallas_interpret, case):
    """Key, value, weight and query columns of int8, int16, int32 and bool
    (the kernel reads each at its own width and writes its outputs at
    their final dtypes)."""
    key_dts, val_dts, w_dt, q_dts, dw_dt, kr = NARROW[case]
    rng = np.random.default_rng(70)
    nk, nv = len(key_dts), len(val_dts)
    ladder = [_cast(_consolidated(rng, n, cap, nk=nk, nv=nv, key_range=kr),
                    key_dts, val_dts, w_dt)
              for n, cap in ((60, 64), (20, 32), (5, 8))]
    delta = _cast(_consolidated(rng, 25, 32, nk=nk, nv=0, key_range=kr),
                  q_dts, (), dw_dt)
    qhi = tuple(jnp.asarray(np.minimum(
        np.asarray(k).astype(np.int64) + rng.integers(0, 3, k.shape[0]),
        1 if k.dtype == jnp.bool_ else np.iinfo(k.dtype).max)
        .astype(k.dtype)) for k in delta.keys)
    totals = _assert_consumer(ladder, delta, nk, (256, 5), qhi)
    assert max(totals) > 5  # the small cap overflows


def _hot_ladder(rng, hot_rows=(1500, 600)):
    """Two levels of one-key rows with one hot key (7) holding
    ``hot_rows`` rows: its ranges are longer than the kernel's expansion
    tile."""
    out = []
    for hot, (n, cap) in zip(hot_rows, ((200, 2048), (100, 1024))):
        keys = np.concatenate([rng.integers(0, 50, n), np.full(hot, 7)])
        vals = rng.integers(0, 1 << 20, n + hot)
        w = rng.integers(1, 3, n + hot)
        out.append(Batch.from_columns([keys.astype(np.int64)],
                                      [vals.astype(np.int64),
                                       (vals % 7).astype(np.int32)],
                                      w.astype(np.int64), cap=cap))
    return out


def _consumer_case(name, rng):
    """(ladder, delta, out_caps, totals wanted: "positive" or "zero")."""
    if name in ("hot key", "out_cap inside a range"):
        ladder = _hot_ladder(rng)
        delta = Batch.from_columns([np.array([3, 7, 9, 40], np.int64)], [],
                                   np.array([1, 2, -1, 1], np.int64), cap=8)
        lvl0 = np.asarray(ladder[0].keys[0])
        before = int(np.count_nonzero(lvl0 == 3))
        hot = int(np.count_nonzero(lvl0 == 7))
        if name == "hot key":
            return ladder, delta, (4096, cuda_kernels.LADDER_TILE), \
                "positive"
        # caps that end inside the hot key's level-0 range
        return ladder, delta, (before + 1, before + hot // 2,
                               before + hot - 1), "positive"
    ladder = [_consolidated(rng, n, cap, key_range=30)
              for n, cap in ((60, 64), (20, 32))]
    if name == "queries past every key":
        delta = Batch.from_columns([np.arange(100, 120), np.zeros(20)],
                                   [], np.ones(20, np.int64), cap=32)
    else:  # every query dead
        d = _consolidated(rng, 20, 32, key_range=30)
        delta = Batch(d.keys, d.vals, jnp.zeros_like(d.weights), d.runs)
    return ladder, delta, (16, 1), "zero"


@pytest.mark.parametrize("case", ["hot key", "out_cap inside a range",
                                  "queries past every key",
                                  "every query dead"])
def test_ladder_consumer_cases_plain_equals_pallas(pallas_interpret, case):
    """A hot key whose ranges span more than one expansion tile, out_cap
    ending inside a range, and ladders where every range is empty (total
    0, every slot dead)."""
    rng = np.random.default_rng(71)
    ladder, delta, out_caps, want = _consumer_case(case, rng)
    nk = len(delta.keys)
    totals = _assert_consumer(ladder, delta, nk, out_caps)
    if want == "zero":
        assert totals == [0] * len(out_caps)
    else:
        assert min(totals) > cuda_kernels.LADDER_TILE
        assert max(out_caps) > min(totals) or case != "hot key"


def _ladder_layout():
    """csrc/ladder_consumer.cu's ``Layout``, its slot formulas evaluated
    in Python: ``layout(K, nk, ng)`` has the kernel's methods."""
    import re

    src = _csrc("ladder_consumer.cu")
    body = re.search(r"struct Layout \{(.*?)\n\};", src, re.S).group(1)
    methods = re.findall(r"int (\w+)\(([^)]*)\) const \{(?:\s*//[^\n]*)?"
                         r"\s*return ([^;]+);", body)
    assert {"caps", "kinds", "out", "dead", "n_slots"} <= \
        {name for name, _, _ in methods}

    class Layout:
        def __init__(self, K, nk, ng):
            self.K, self.nk, self.ng = K, nk, ng

    for name, params, expr in methods:
        args = ", ".join(p.split()[-1] for p in params.split(",") if p)
        expr = re.sub(r"\b(\w+)\(", r"self.\1(", expr)
        expr = re.sub(r"\b(K|nk|ng)\b", r"self.\1", expr)
        scope = {}
        exec(f"def {name}(self{', ' if args else ''}{args}):\n"
             f"    return {expr}", scope)
        setattr(Layout, name, scope[name])
    return Layout


def test_ladder_consumer_constants_match_the_kernel():
    """The wrapper's warp tile and launch count are
    csrc/ladder_consumer.cu's, and the argument block its plan builds has
    the kernels' layout: the level caps, the columns' kinds, the outputs
    and the dead-slot values where the kernels read them, for joins and
    gathers of several shapes."""
    import re

    src = _csrc("ladder_consumer.cu")
    consts = dict(re.findall(r"constexpr int (\w+) = ([^;]+);", src))
    assert consts["WARP_TILE"] == "32 * ITEMS"
    assert 32 * int(consts["ITEMS"]) == cuda_kernels.LADDER_TILE
    launches = src[src.index("int launch("):]
    assert launches[:launches.index("\n}\n")].count("<<<") == \
        cuda_kernels.LADDER_KERNELS
    assert '#include "common.cuh"' in src and "equal_range(" in src
    Layout = _ladder_layout()
    i8, i32, i64, b1 = torch.int8, torch.int32, torch.int64, torch.bool
    for K, nk, ng, join in ((1, 1, 0, True), (2, 1, 4, True),
                            (3, 2, 1, False), (100, 1, 4, False)):
        key_dts, g_dts = (i32, i64)[:nk], (i8, b1, i64, i32)[:ng]
        q_dts = (i64,) * nk * 2 + ((i32,) if join else (b1,))
        dtypes = (*(dt for dt in key_dts for _ in range(K)),
                  *(dt for dt in g_dts for _ in range(K)), *(i64,) * K,
                  *q_dts)
        plan = cuda_kernels._ladder_plan(K, nk, ng, dtypes, join, False)
        L = Layout(K, nk, ng)
        assert plan.n_slots == L.n_slots()
        assert plan.caps == L.caps() and plan.out == L.out()
        assert len(dtypes) == L.caps()  # every pointer slot before the caps
        kinds = cuda_kernels._KINDS
        t = plan.template
        assert [t[L.kinds() + c] for c in range(nk)] == \
            [kinds[dt] for dt in key_dts]
        assert [t[L.gathered_kind(c)] for c in range(ng)] == \
            [kinds[dt] for dt in g_dts]
        assert t[L.weights_kind()] == kinds[i64]
        assert [t[L.q_kind(c)] for c in range(2 * nk + 1)] == \
            [kinds[dt] for dt in q_dts]
        dead = [t[L.dead() + c] for c in range(ng)]
        assert dead == ([0] * ng if join else
                        [int(cuda_kernels.kernels.sentinel_scalar(dt))
                         for dt in g_dts])
        assert plan.out_dtypes == (*g_dts, q_dts[-1] if join else i64)
        assert (plan.n_slots <= cuda_kernels.ARGS_MAX) == (K < 100)


def test_ladder_plan_refuses_what_the_kernel_does_not_take():
    """The plan takes integer and bool columns of 1-8 bytes and one dtype
    per column across the levels; a float column or levels whose column
    dtypes differ raise ValueError before any launch."""
    i32, i64 = torch.int32, torch.int64
    ok = (i64, i64, i32, i32, i64, i64, i64, i64, i64)  # K=2, nk=1, ng=1
    assert cuda_kernels._ladder_plan(2, 1, 1, ok, True, True).out_dtypes == \
        (i32, i64)
    with pytest.raises(ValueError, match="bool columns only"):
        cuda_kernels._ladder_plan(2, 1, 1, (*ok[:2], torch.float32,
                                            torch.float32, *ok[4:]),
                                  True, True)
    with pytest.raises(ValueError, match="bool columns only"):
        cuda_kernels._ladder_plan(2, 1, 1, (*ok[:-1], torch.float64), True,
                                  True)
    with pytest.raises(ValueError, match="share a dtype"):
        cuda_kernels._ladder_plan(2, 1, 1, (*ok[:2], i32, i64, *ok[4:]),
                                  False, True)
