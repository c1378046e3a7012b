"""Nexmark queries on the port's host runtime against dbsp_tpu's, tick
for tick: the same events (the generator is a numpy copy) and the same
consolidated output rows each tick. q8 runs the ladder join with a
zero-value-column side and incremental distinct; q15 runs distinct over
the bids stream and the linear count, which has no accumulator columns;
q0, q1, q21 and q22 are maps (q0 and q1 order-preserving, sort-free);
q2 and q14 filter and map; q12 folds a tick counter and attaches it with
apply2; q13 joins a generator's side table; q17 joins the general Min
and Max with the linear Count and Average; q20 joins bids with filtered
auctions; q9 ranks the in-window bids of each auction with a per-key
top-1 on (price, -date_time), q6 feeds q9's winners to a per-seller
top-10 and a linear average, q18 and q19 are per-key top-1 and top-10
over the bids, and q16 sums twelve Count streams, eight of them over
distinct, in one 12-column linear sum."""

import pytest

from dbsp_tpu.circuit import Runtime
from dbsp_tpu.nexmark import (GeneratorConfig, NexmarkGenerator,
                              build_inputs, queries)
from dbsp_tpu_torch.circuit import Runtime as TRuntime
from dbsp_tpu_torch.nexmark import GeneratorConfig as TGeneratorConfig
from dbsp_tpu_torch.nexmark import NexmarkGenerator as TNexmarkGenerator
from dbsp_tpu_torch.nexmark import build_inputs as tbuild_inputs
from dbsp_tpu_torch.nexmark import queries as tqueries
from test_torch_compiled import one_torch_thread  # noqa: F401  (autouse)


def _circuit(runtime, build_inputs_fn, query, **kw):
    def build(c):
        streams, handles = build_inputs_fn(c)
        return handles, query(*streams).output()

    return runtime.init_circuit(1, build, **kw)


# (events a tick, ticks): q12's windows span Q12_WINDOW_TICKS ticks, so
# it runs past the first window's end
_SCHEDULE = {"q12": (400, 2 + tqueries.Q12_WINDOW_TICKS)}


@pytest.mark.parametrize("name,min_rows", [
    ("q3", 5), ("q8", 50), ("q15", 3), ("q0", 8000), ("q1", 8000),
    ("q2", 30), ("q12", 400), ("q13", 8000), ("q14", 1000), ("q17", 1000),
    ("q20", 1000), ("q21", 8000), ("q22", 8000), ("q6", 300), ("q9", 600),
    ("q16", 60), ("q18", 400), ("q19", 5000)])
def test_query_equals_reference_tick_for_tick(name, min_rows):
    per, ticks = _SCHEDULE.get(name, (3000, 3))
    rh, (rhandles, rout) = _circuit(Runtime, build_inputs,
                                    getattr(queries, name))
    th, (thandles, tout) = _circuit(TRuntime, tbuild_inputs,
                                    getattr(tqueries, name), device="cpu")
    rgen = NexmarkGenerator(GeneratorConfig(seed=1))
    tgen = TNexmarkGenerator(TGeneratorConfig(seed=1))
    rows = 0
    for i in range(ticks):
        rgen.feed(rhandles, i * per, (i + 1) * per)
        tgen.feed(thandles, i * per, (i + 1) * per)
        rh.step()
        th.step()
        want = rout.to_dict()
        assert tout.to_dict() == want, f"{name} tick {i}"
        rows += len(want)
    # a query that emits nothing would make the comparison vacuous
    assert rows >= min_rows, rows
