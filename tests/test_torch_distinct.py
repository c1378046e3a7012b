"""Incremental distinct on the port against dbsp_tpu's, exactly: the
ladder's old-weight probe on the same levels, and the operators over
ticks of signed deltas (rows whose accumulated weight rises above 0,
falls back to 0 and goes negative), which Nexmark's insert-only streams
never produce."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dbsp_tpu.circuit import Runtime
from dbsp_tpu.operators import add_input_zset
from dbsp_tpu.zset import cursor
from dbsp_tpu.zset.batch import Batch
from dbsp_tpu_torch.circuit import Runtime as TRuntime
from dbsp_tpu_torch.circuit.builder import Circuit as TCircuit
from dbsp_tpu_torch.circuit.builder import CircuitError
from dbsp_tpu_torch.operators import add_input_zset as tadd_input_zset
from dbsp_tpu_torch.zset import cursor as tcursor
from dbsp_tpu_torch.zset.batch import Batch as TBatch
from test_pallas_kernels import _adversarial_ladders, _consolidated


def _port(b: Batch) -> TBatch:
    return TBatch.from_numpy([np.asarray(c) for c in b.keys],
                             [np.asarray(c) for c in b.vals],
                             np.asarray(b.weights), runs=b.runs,
                             device="cpu")


def _deltas(rng, ladder):
    """A random delta, and one of rows taken from the ladder's levels (so
    most rows are found), with dead sentinel tails."""
    yield _consolidated(rng, 20, 32)
    rows = {}
    for lvl in ladder:
        cols = [np.asarray(c) for c in lvl.cols]
        for i in range(0, lvl.cap, 3):
            rows[tuple(int(c[i]) for c in cols)] = int(rng.integers(-2, 3)) \
                or 1
    keys = sorted(rows)
    cols = [np.array([r[i] for r in keys], np.int64) for i in range(3)]
    yield Batch.from_columns(cols[:2], cols[2:],
                             np.array([rows[r] for r in keys], np.int64))


def test_old_weights_ladder_equals_reference():
    rng = np.random.default_rng(7)
    found = 0
    for ladder in _adversarial_ladders(rng):
        for delta in _deltas(rng, ladder):
            want = np.asarray(cursor.old_weights_ladder(delta, ladder))
            got = tcursor.old_weights_ladder(_port(delta),
                                             [_port(b) for b in ladder])
            assert got.dtype == torch.int64
            np.testing.assert_array_equal(got.numpy(), want)
            found += int(np.count_nonzero(want))
    assert found > 20  # rows were found in the levels, not only missed


def _distinct_circuit(add_input, key_t, val_t):
    def build(c):
        s, h = add_input(c, [key_t], [val_t])
        return h, (s.distinct().output(), s.stream_distinct().output())

    return build


def _signed_ticks(rng, ticks=10):
    """Per tick, (key, val, weight) rows over a small universe, so rows
    meet again: accumulated weights cross 0 both ways and go negative.
    Tick 0 meets an empty trace."""
    acc = {}
    for tick in range(ticks):
        delta = {}
        for _ in range(int(rng.integers(0, 10))):
            r = (int(rng.integers(0, 4)), int(rng.integers(-2, 2)))
            # pull rows with positive weight back down often
            w = -int(rng.integers(1, 3)) if acc.get(r, 0) > 0 and \
                rng.random() < 0.5 else int(rng.integers(-2, 4))
            delta[r] = delta.get(r, 0) + w
        delta = {r: w for r, w in delta.items() if w}
        for r, w in delta.items():
            acc[r] = acc.get(r, 0) + w
        yield tick, delta, dict(acc)


def test_distinct_equals_reference_with_retractions():
    rh, (rin, (rdist, rsd)) = Runtime.init_circuit(
        1, _distinct_circuit(add_input_zset, jnp.int64, jnp.int32))
    th, (tin, (tdist, tsd)) = TRuntime.init_circuit(
        1, _distinct_circuit(tadd_input_zset, torch.int64, torch.int32),
        device="cpu")
    rng = np.random.default_rng(3)
    seen = {"up": 0, "down": 0, "negative": 0}
    for tick, delta, acc in _signed_ticks(rng, ticks=12):
        rows = sorted(delta)
        k = np.array([r[0] for r in rows], np.int64)
        v = np.array([r[1] for r in rows], np.int32)
        w = np.array([delta[r] for r in rows], np.int64)
        rin.push_batch(Batch.from_columns([k], [v], w), consolidated=True)
        tin.push_batch(TBatch.from_columns([k], [v], w, device="cpu"),
                       consolidated=True)
        rh.step()
        th.step()
        want = rdist.to_dict()
        assert tdist.to_dict() == want, f"distinct, tick {tick}"
        assert tsd.to_dict() == rsd.to_dict(), f"stream_distinct, {tick}"
        seen["up"] += sum(1 for x in want.values() if x > 0)
        seen["down"] += sum(1 for x in want.values() if x < 0)
        seen["negative"] += sum(1 for x in acc.values() if x < 0)
    assert all(seen.values()), seen  # every branch was exercised


def test_stream_distinct_equals_reference():
    def build(add_input, key_t):
        def b(c):
            s, h = add_input(c, [key_t], [])
            return h, s.stream_distinct().output()
        return b

    rh, (rin, rout) = Runtime.init_circuit(1, build(add_input_zset,
                                                    jnp.int64))
    th, (tin, tout) = TRuntime.init_circuit(1, build(tadd_input_zset,
                                                     torch.int64),
                                            device="cpu")
    k = np.array([1, 2, 3, 4], np.int64)
    w = np.array([5, -3, 1, 0], np.int64)
    rin.push_batch(Batch.from_columns([k], [], w))
    tin.push_batch(TBatch.from_columns([k], [], w, device="cpu"))
    rh.step()
    th.step()
    assert tout.to_dict() == rout.to_dict() == {(1,): 1, (3,): 1}


def test_distinct_refuses_a_nested_circuit():
    """The port's circuits are root circuits: distinct outside one raises
    instead of giving the root-scope answer where the reference would
    take its nested (recursive-scope) variant."""
    child = TCircuit("cpu")
    s, _ = tadd_input_zset(child, [torch.int64], [])
    with pytest.raises(CircuitError, match="root circuits only"):
        s.distinct()
