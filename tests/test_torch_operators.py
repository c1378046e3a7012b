"""The port's operators of the Nexmark slice against dbsp_tpu's on the
same inputs: the string dictionaries on every channel code, the
order-preserving map and the flat_map on random batches with dead rows
(every column and weight compared, sentinels included), Batch.from_tuples,
and the general aggregators Count, Sum, Min and Average on the host and
the compiled engine, with retractions. Inputs are made with numpy from a
seed; comparisons are exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dbsp_tpu.circuit import Runtime
from dbsp_tpu.nexmark import strings
from dbsp_tpu.operators import aggregate as ragg
from dbsp_tpu.operators import add_input_zset
from dbsp_tpu.operators.filter_map import FlatMapOp, MapOp
from dbsp_tpu.zset.batch import Batch
from dbsp_tpu_torch.circuit import Runtime as TRuntime
from dbsp_tpu_torch.compiled import compile_circuit
from dbsp_tpu_torch.nexmark import strings as tstrings
from dbsp_tpu_torch.operators import Average, Count, Min, Sum
from dbsp_tpu_torch.operators import add_input_zset as tadd_input_zset
from dbsp_tpu_torch.operators.filter_map import FlatMapOp as TFlatMapOp
from dbsp_tpu_torch.operators.filter_map import MapOp as TMapOp
from dbsp_tpu_torch.zset.batch import Batch as TBatch


def test_strings_equal_reference_on_every_channel_code():
    # every code the dictionaries' mod/div arithmetic distinguishes, and
    # past it
    for code in range(0, 7 * 11 * 13 + 50):
        name = tstrings.decode_channel(code)
        assert name == strings.decode_channel(code)
        assert tstrings.encode_channel(name) == code
        assert tstrings.channel_url(code) == strings.channel_url(code)
        assert tstrings.channel_id_of(code) == strings.channel_id_of(code)
        assert tstrings.url_dirs_arith(code) == strings.url_dirs_arith(code)
        assert tstrings.url_dirs_of(code) == strings.url_dirs_of(code)
        # the arithmetic q21 and q22 run on the device equals the string
        # operations over the decoded text
        assert tstrings.channel_id_of(code) == \
            (code if code < 4 else tstrings.URL_CHANNEL_BASE + code)
        assert tstrings.url_dirs_of(code) == tuple(
            f"d{d}" for d in tstrings.url_dirs_arith(code))


def _batches(seed, n_live, cap):
    """One consolidated batch of ``n_live`` random rows at capacity
    ``cap`` (dead rows past them), as the reference's and the port's."""
    rng = np.random.default_rng(seed)
    cols = [rng.integers(0, 6, n_live).astype(np.int64),
            rng.integers(-5, 5, n_live).astype(np.int64),
            rng.integers(0, 1_000_000, n_live).astype(np.int64)]
    w = rng.integers(-2, 3, n_live).astype(np.int64)
    w[w == 0] = 1
    ref = Batch.from_columns([jnp.asarray(c) for c in cols[:2]],
                             [jnp.asarray(cols[2])], jnp.asarray(w), cap=cap)
    port = TBatch.from_columns(cols[:2], cols[2:], w, device="cpu", cap=cap)
    return ref, port


def _assert_same(ref: Batch, port: TBatch):
    """Every column and the weights equal, dead rows included."""
    assert ref.runs == port.runs
    assert len(ref.cols) == len(port.cols)
    for r, p in zip((*ref.cols, ref.weights), (*port.cols, port.weights)):
        np.testing.assert_array_equal(np.asarray(r), p.numpy())


# monotone in the row order: scale the first key, floor-scale the value
# column (collides neighbours), or drop the value column. "middle"
# floor-scales a column that is not the last, as q1 does with the price:
# rows that collide there can leave the later columns out of order, and
# equal rows apart, yet the output is stamped as one run. The reference
# does the same; the port must equal it there too.
_MAPS = {
    "scale": (lambda k, v: ((k[0] * 2, k[1]), (v[0] * 908 // 1000,)), 2, 1),
    "drop": (lambda k, v: ((k[0], k[1]), ()), 2, 0),
    "coarse": (lambda k, v: ((k[0],), (k[1], v[0] // 100_000)), 1, 2),
    "middle": (lambda k, v: ((k[0], k[1] // 3), (v[0] // 400_000,)), 2, 1),
}


@pytest.mark.parametrize("case", sorted(_MAPS))
@pytest.mark.parametrize("seed,n_live,cap", [(1, 50, 64), (2, 200, 256),
                                             (3, 0, 8), (4, 7, 8)])
def test_order_preserving_map_equals_reference(case, seed, n_live, cap):
    fn, nk, nv = _MAPS[case]
    ref_b, port_b = _batches(seed, n_live, cap)
    ref_op = MapOp(fn, "m", preserves_order=True,
                   out_schema=((jnp.int64,) * nk, (jnp.int64,) * nv))
    port_op = TMapOp(fn, ((torch.int64,) * nk, (torch.int64,) * nv), "m",
                     preserves_order=True)
    _assert_same(ref_op.eval(ref_b), port_op.eval(port_b))
    # the raw path (the compiled engine's, when deferred)
    _assert_same(ref_op._inner_raw(ref_b), port_op.eval_raw(port_b))


def _twice(col):
    """Two stacked copies of ``col``, in its array library."""
    if isinstance(col, torch.Tensor):
        return col.expand(2, -1)
    return jnp.broadcast_to(col, (2, col.shape[0]))


def _arange2(col):
    """[[0...], [1...]] shaped like ``_twice(col)``."""
    if isinstance(col, torch.Tensor):
        return torch.arange(2, dtype=col.dtype).reshape(2, 1).expand(
            2, col.shape[0])
    return jnp.broadcast_to(jnp.arange(2, dtype=col.dtype).reshape(2, 1),
                            (2, col.shape[0]))


def _fan(k, v):
    """Each row to (k0, k1 + i) for i in 0..1, value v // 7, kept where
    i == 0 or the value is even: collisions across rows and dropped
    slots."""
    i = _arange2(k[0])
    keep = (i == 0) | (_twice(v[0]) % 2 == 0)
    return ((_twice(k[0]), _twice(k[1]) + i), (_twice(v[0]) // 7,), keep)


@pytest.mark.parametrize("seed,n_live,cap", [(5, 60, 64), (6, 300, 512),
                                             (7, 0, 8)])
def test_flat_map_equals_reference(seed, n_live, cap):
    ref_b, port_b = _batches(seed, n_live, cap)
    ref_op = FlatMapOp(_fan, 2, "f", out_schema=((jnp.int64,) * 2,
                                                 (jnp.int64,)))
    port_op = TFlatMapOp(_fan, 2, ((torch.int64,) * 2, (torch.int64,)), "f")
    _assert_same(ref_op.eval(ref_b), port_op.eval(port_b))
    _assert_same(ref_op._inner_raw(ref_b), port_op.eval_raw(port_b))


def test_from_tuples_equals_reference():
    rows = [((3, 10, -1), 2), ((1, 5, 7), 1), ((3, 10, -1), -2),
            ((2, 2**40, 0), 5), ((1, 5, 7), 3)]
    ref = Batch.from_tuples(rows, (jnp.int64, jnp.int64), (jnp.int32,))
    port = TBatch.from_tuples(rows, (torch.int64, torch.int64),
                              (torch.int32,), device="cpu")
    _assert_same(ref, port)
    assert port.to_dict() == {(1, 5, 7): 4, (2, 2**40, 0): 5}
    with pytest.raises(ValueError, match="sentinel"):
        TBatch.from_tuples([((2**31 - 1,), 1)], (torch.int32,),
                           device="cpu")


def _agg_circuit(add_input, aggs, i64):
    """input -> index by k % 5 -> each general aggregator."""
    def build(c):
        s, h = add_input(c, [i64], [i64])
        keyed = s.index_by(lambda k, v: (k[0] % 5,), [i64],
                           val_fn=lambda k, v: (v[0],), val_dtypes=[i64],
                           name="by5")
        return h, tuple(keyed.aggregate(a).output() for a in aggs)
    return build


def test_general_aggregators_equal_reference_host_and_compiled():
    """Count, Sum, Min and Average on the general (trace-gather) path,
    on the port's host engine and on its compiled engine (agg_ladder's
    plain version; Min on its fast path until the first retraction, then
    the slow path), against the reference's host engine, with
    retractions from tick 2 on."""
    rh, (rin, rout) = Runtime.init_circuit(1, _agg_circuit(
        add_input_zset, [ragg.Count(), ragg.Sum(0), ragg.Min(0),
                         ragg.Average(0)], jnp.int64))
    build = _agg_circuit(tadd_input_zset, [Count(), Sum(0), Min(0),
                                           Average(0)], torch.int64)
    th, (tin, tout) = TRuntime.init_circuit(1, build, device="cpu")
    ch_h, (cin, cout) = TRuntime.init_circuit(1, build, device="cpu")
    ch = compile_circuit(ch_h)
    rng = np.random.default_rng(9)
    live = []
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
        rin.push_batch(Batch.from_columns([k], [v], w, cap=32))
        rh.step()
        tin.push_batch(TBatch.from_columns([k], [v], w, device="cpu", cap=32))
        th.step()
        ch.step(tick, feeds={cin: TBatch.from_columns([k], [v], w,
                                                      device="cpu", cap=32)})
        ch.validate()
        ch.maintain()
        for r, t, c in zip(rout, tout, cout):
            want = r.to_dict()
            assert t.to_dict() == want, tick
            got = ch.output(c)
            assert (got.to_dict() if got is not None else {}) == want, tick
            seen += len(want)
    assert seen > 40
