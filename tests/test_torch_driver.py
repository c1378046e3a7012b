"""The port's serving driver (dbsp_tpu_torch/compiled/driver.py) against
the reference's ``CompiledCircuitDriver``: the same rows pushed through
the host input handles of a compiled circuit, the same outputs delivered
tick for tick at validation cadences 1 and 3, through an overflow's exact
replay. At cadence 3 nothing is visible inside an open interval, a
validated interval delivers its ticks in order, and ``flush`` delivers a
partial one (the reference's
``test_compiled_driver_deferred_validation_matches_per_tick``, on a
``ZSetInput`` circuit). Everything runs on the CPU."""

import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dbsp_tpu.circuit import Runtime
from dbsp_tpu_torch.circuit import Runtime as TRuntime
from dbsp_tpu_torch.compiled import cnodes
from dbsp_tpu_torch.compiled.driver import CompiledCircuitDriver
from test_torch_compiled import _retraction_circuit

TICKS = 7


def _rows(rng, tick, live):
    """A tick's rows: inserts, and from tick 2 on retractions of earlier
    rows (live is updated in place)."""
    rows = [(int(rng.integers(0, 40)), int(rng.integers(-60, 60)), 1)
            for _ in range(int(rng.integers(4, 14)))]
    if tick >= 2 and live:
        idx = set(rng.choice(len(live), size=min(5, len(live)),
                             replace=False).tolist())
        rows += [(*live[i], -1) for i in sorted(idx)]
        live[:] = [r for i, r in enumerate(live) if i not in idx]
    live += [(k, v) for k, v, w in rows if w > 0]
    return [np.array([r[i] for r in rows], np.int64) for i in range(3)]


def _drive(engine, validate_every):
    """Push the same rows through one engine's driver: per tick (after
    step) and after the closing flush, each output's visible value, and
    whether an interval was open."""
    if engine == "port":
        from dbsp_tpu_torch.operators import LinearAverage, Max
        from dbsp_tpu_torch.operators import add_input_zset
        from dbsp_tpu_torch.zset.batch import Batch

        build = _retraction_circuit(add_input_zset, types.SimpleNamespace(
            Max=Max, Avg=LinearAverage), torch.int64)
        handle, (h, outs) = TRuntime.init_circuit(1, build, device="cpu")
        drv = CompiledCircuitDriver(handle, validate_every=validate_every)

        def push(k, v, w):
            h.push_batch(Batch.from_columns([k], [v], w, device="cpu",
                                            cap=32))
    else:
        from dbsp_tpu.compiled.driver import \
            CompiledCircuitDriver as RDriver
        from dbsp_tpu.operators import add_input_zset
        from dbsp_tpu.operators.aggregate import Max
        from dbsp_tpu.operators.aggregate_linear import LinearAverage
        from dbsp_tpu.zset.batch import Batch

        build = _retraction_circuit(add_input_zset, types.SimpleNamespace(
            Max=Max, Avg=LinearAverage), jnp.int64)
        handle, (h, outs) = Runtime.init_circuit(1, build)
        drv = RDriver(handle, validate_every=validate_every)

        def push(k, v, w):
            h.push_batch(Batch.from_columns([k], [v], w, cap=32))

    rng = np.random.default_rng(12)
    live = []
    seen, opened = [], []
    for tick in range(TICKS):
        push(*_rows(rng, tick, live))
        drv.step()
        seen.append([o.to_dict() for o in outs])
        opened.append(drv.interval_open)
    drv.flush()
    seen.append([o.to_dict() for o in outs])
    opened.append(drv.interval_open)
    return seen, opened, drv


@pytest.mark.parametrize("validate_every", [1, 3])
def test_driver_matches_reference(monkeypatch, validate_every):
    """Seed capacities of 8 rows overflow the trace in the first interval:
    the driver grows, restores the interval's snapshot and replays the
    retained feeds; what it delivers equals the reference's driver tick
    for tick."""
    from dbsp_tpu.compiled import cnodes as rcnodes

    for mod in (cnodes, rcnodes):
        monkeypatch.setattr(mod, "LEVEL0_CAP", 8)
        monkeypatch.setattr(mod.CTrace, "DEFAULT_CAP", 8)
    seen, opened, drv = _drive("port", validate_every)
    ref_seen, ref_opened, _ = _drive("reference", validate_every)
    assert seen == ref_seen
    assert opened == ref_opened
    assert drv.ch.overflow_replays > 0, "no grow + replay happened"
    assert sum(len(d) for tick in seen for d in tick) > 20
    assert drv.open_interval_age_s is None and not drv.interval_open
    assert len(drv.step_latencies_ns) >= TICKS


def test_driver_deferred_validation_matches_per_tick():
    """Cadence 3 against cadence 1: nothing is visible inside an open
    interval, a validated interval delivers its ticks in order (the last
    one stays visible), and ``flush`` delivers the trailing partial
    interval."""
    per_tick, opened1, _ = _drive("port", 1)
    deferred, opened3, _ = _drive("port", 3)
    assert not any(opened1)
    assert opened3 == [True, True, False, True, True, False, True, False]
    assert deferred[0] == deferred[1] == [{}, {}]
    assert deferred[2] == per_tick[2]
    assert deferred[3] == deferred[4] == per_tick[2]  # stale until flushed
    assert deferred[5] == per_tick[5]
    assert deferred[6] == per_tick[5]
    # the trailing partial interval arrives through flush()
    assert deferred[-1] == per_tick[-1] == per_tick[6]
    assert per_tick[6] != per_tick[5]


def test_driver_open_interval_age():
    """An open interval has an age; a flushed driver has none."""
    from dbsp_tpu_torch.operators import add_input_zset

    def build(c):
        s, h = add_input_zset(c, [torch.int64], [])
        return h, s.output()

    handle, (h, out) = TRuntime.init_circuit(1, build, device="cpu")
    drv = CompiledCircuitDriver(handle, validate_every=4)
    assert drv.open_interval_age_s is None
    drv.step()
    assert drv.interval_open and drv.open_interval_age_s >= 0.0
    assert out.to_dict() == {}
    drv.flush()
    assert not drv.interval_open and drv.open_interval_age_s is None
