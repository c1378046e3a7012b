"""Nexmark q4 on the port's host runtime against dbsp_tpu's, tick for tick:
the same events (the generator is a numpy copy), the same consolidated
output rows each tick, and the same state in the operators' spines."""

import numpy as np
import pytest
import torch

from dbsp_tpu.circuit import Runtime
from dbsp_tpu.nexmark import (GeneratorConfig, NexmarkGenerator,
                              build_inputs, queries)
from dbsp_tpu_torch.circuit import Runtime as TRuntime
from dbsp_tpu_torch.nexmark import GeneratorConfig as TGeneratorConfig
from dbsp_tpu_torch.nexmark import NexmarkGenerator as TNexmarkGenerator
from dbsp_tpu_torch.nexmark import build_inputs as tbuild_inputs
from dbsp_tpu_torch.nexmark import queries as tqueries
from test_torch_compiled import one_torch_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize("n0,n1", [(0, 5000), (123, 4567)])
def test_generator_events_equal_reference(n0, n1):
    want = NexmarkGenerator(GeneratorConfig(seed=1))
    got = TNexmarkGenerator(TGeneratorConfig(seed=1)).generate(n0, n1)
    for ref in (want.generate(n0, n1), want.generate_fast(n0, n1)):
        assert got.keys() == ref.keys()
        for rel in got:
            assert got[rel].keys() == ref[rel].keys()
            for col in got[rel]:
                np.testing.assert_array_equal(got[rel][col], ref[rel][col],
                                              err_msg=f"{rel}.{col}")
                assert got[rel][col].dtype == ref[rel][col].dtype


def _circuit(runtime, build_inputs_fn, q4, **kw):
    def build(c):
        streams, handles = build_inputs_fn(c)
        return handles, q4(*streams).output()

    return runtime.init_circuit(1, build, **kw)


def test_q4_equals_reference_tick_for_tick():
    per, ticks = 2000, 4
    rh, (rhandles, rout) = _circuit(Runtime, build_inputs, queries.q4)
    th, (thandles, tout) = _circuit(TRuntime, tbuild_inputs, tqueries.q4,
                                    device="cpu")
    rgen = NexmarkGenerator(GeneratorConfig(seed=1))
    tgen = TNexmarkGenerator(TGeneratorConfig(seed=1))
    rows = 0
    for i in range(ticks):
        rgen.feed(rhandles, i * per, (i + 1) * per)
        tgen.feed(thandles, i * per, (i + 1) * per)
        rh.step()
        th.step()
        want = rout.to_dict()
        assert tout.to_dict() == want, f"tick {i}"
        rows += len(want)
    assert rows, "q4 emitted nothing: the comparison would be vacuous"
    # the traced and aggregated state agrees too, operator by operator
    rstate = [n.operator for n in rh.circuit.nodes]
    tstate = [n.operator for n in th.circuit.nodes]
    pairs = [(r.spine, t.spine) for r, t in zip(rstate, tstate)
             if hasattr(t, "spine")]
    pairs += [(r.out_spine, t.out_spine) for r, t in zip(rstate, tstate)
              if hasattr(t, "out_spine")]
    pairs += [(r.acc_spine, t.acc_spine) for r, t in zip(rstate, tstate)
              if hasattr(t, "acc_spine")]
    # the two join traces, q4-max's trace and outputs, q4-avg's state
    assert len(pairs) == 5
    for r, t in pairs:
        assert t.to_dict() == r.to_dict()
    assert len(th.step_times_ns) == ticks


def _ops_circuit(add_input, ops, key_t, i32):
    """join -> filter -> map -> Max -> re-key -> linear average, over two
    inputs (the q4 operator chain on a schema with negative values)."""
    def build(c):
        a, ha = add_input(c, [key_t], [key_t])
        b, hb = add_input(c, [key_t], [i32])
        j = a.join_index(b, lambda k, av, bv: ((k[0], bv[0]), (av[0],)),
                         [key_t, i32], [key_t], name="j")
        f = j.filter_rows(lambda k, v: v[0] != 7, name="f")
        m = f.map_rows(lambda k, v: (k, (v[0] * 3,)), [key_t, i32], [key_t],
                       name="m").aggregate(ops.Max(0), name="mx")
        avg = m.index_by(lambda k, v: (k[1],), [i32],
                         val_fn=lambda k, v: (v[0],), val_dtypes=[key_t],
                         name="by").aggregate(ops.Avg(0), name="avg")
        return (ha, hb), (m.output(), avg.output())

    return build


def test_operators_equal_reference_with_retractions():
    """Both aggregates under retractions and negative values (q4 itself
    only inserts, with positive prices): the same signed deltas into the
    reference and the port, equal output deltas every tick."""
    import types

    import jax.numpy as jnp

    from dbsp_tpu.operators import add_input_zset
    from dbsp_tpu.operators.aggregate import Max
    from dbsp_tpu.operators.aggregate_linear import LinearAverage
    from dbsp_tpu.zset.batch import Batch
    from dbsp_tpu_torch.operators import Max as TMax
    from dbsp_tpu_torch.operators import LinearAverage as TLinearAverage
    from dbsp_tpu_torch.operators import add_input_zset as tadd_input_zset
    from dbsp_tpu_torch.zset.batch import Batch as TBatch

    ref_ops = types.SimpleNamespace(Max=Max, Avg=LinearAverage)
    port_ops = types.SimpleNamespace(Max=TMax, Avg=TLinearAverage)
    rh, (rin, rout) = Runtime.init_circuit(
        1, _ops_circuit(add_input_zset, ref_ops, jnp.int64, jnp.int32))
    th, (tin, tout) = TRuntime.init_circuit(
        1, _ops_circuit(tadd_input_zset, port_ops, torch.int64, torch.int32),
        device="cpu")
    rng = np.random.default_rng(11)
    live = [[], []]  # rows pushed so far per input, for retractions
    seen = 0
    for tick in range(8):
        for side, vdt in ((0, np.int64), (1, np.int32)):
            n = int(rng.integers(5, 40))
            rows = [(int(rng.integers(0, 12)), int(rng.integers(-50, 50)), 1)
                    for _ in range(n)]
            if live[side] and tick > 1:  # retract some earlier rows
                idx = rng.choice(len(live[side]),
                                 size=min(6, len(live[side])), replace=False)
                rows += [(*live[side][i], -1) for i in sorted(idx)]
                live[side] = [r for i, r in enumerate(live[side])
                              if i not in set(idx)]
            live[side] += [(k, v) for k, v, w in rows if w > 0]
            k = np.array([r[0] for r in rows], np.int64)
            v = np.array([r[1] for r in rows], vdt)
            w = np.array([r[2] for r in rows], np.int64)
            rin[side].push_batch(Batch.from_columns([k], [v], w),
                                 consolidated=True)
            tin[side].push_batch(TBatch.from_columns([k], [v], w,
                                                     device="cpu"),
                                 consolidated=True)
        rh.step()
        th.step()
        for r, t in zip(rout, tout):
            want = r.to_dict()
            assert t.to_dict() == want, f"tick {tick}"
            seen += len(want)
    assert seen > 20


def test_init_circuit_runs_on_the_card_by_default():
    """Without ``device`` the port asks for the card: with no CUDA it
    raises instead of carrying on on the CPU."""
    if torch.cuda.is_available():
        h, _ = TRuntime.init_circuit(1, lambda c: None)
        assert h.runtime.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TRuntime.init_circuit(1, lambda c: None)
    with pytest.raises(ValueError, match="one worker"):
        TRuntime.init_circuit(2, lambda c: None, device="cpu")
