"""Where a Nexmark query's tick time goes on the card.

    python3 -m dbsp_tpu_torch.profile_query [QUERY ...]

QUERY is any builder of ``nexmark/queries.py`` (q0-q4, q6, q8, q9,
q12-q22).

Runs each named query (default q4) on the host runtime on the card at
chip_smoke.py's size (100,000 events per tick, 24 ticks, seed 1), then
over 3 more ticks:

* per operator: wall time of each node's eval, each followed by a device
  synchronize (so device work is charged to the node that queued it);
* per device kernel: torch.profiler's device time by kernel name, the
  summed device time per tick, and the device's busy share of the tick
  (one stream, so kernels do not overlap and their sum is the busy time).

Prints one JSON line per view and query and writes the profiler's Chrome
trace to ``chiprun_out/<query>_trace.json``.
"""

from __future__ import annotations

import json
import os
import re
import sys
import time
from collections import defaultdict

import torch

from dbsp_tpu_torch.circuit import Runtime
from dbsp_tpu_torch.nexmark import (GeneratorConfig, NexmarkGenerator,
                                    build_inputs, queries)

EVENTS_PER_TICK = 100_000
STATE_TICKS = 24
PROFILE_TICKS = 3


# The port's hand-written kernels: the __global__ functions of csrc/*.cu.
PORT_KERNELS = ("probe_ladder_kernel", "consumer_probe_kernel",
                "consumer_expand_kernel", "rank_merge_kernel", "fill_kernel",
                "rows_kernel", "fin_avg_kernel", "agg_ladder_kernel")


def port_kernel(event: str):
    """The name in PORT_KERNELS that the profiler event ``event`` (mangled
    or demangled) is a launch of, else None: the name must stand alone,
    not inside a longer name of another kernel."""
    return next((k for k in PORT_KERNELS
                 if re.search(rf"(?<![A-Za-z_]){k}(?![a-z0-9_])", event)),
                None)


def _port_view(kernels: dict) -> dict:
    """Device ms and launches per profiled tick of each port kernel (its
    template instances summed)."""
    view = defaultdict(lambda: {"ms_per_tick": 0.0, "calls_per_tick": 0.0})
    for event, (ms, calls) in kernels.items():
        k = port_kernel(event)
        if k:
            view[k]["ms_per_tick"] += ms / PROFILE_TICKS
            view[k]["calls_per_tick"] += calls / PROFILE_TICKS
    return dict(view)


def _tick(gen, handle, handles, out, n):
    gen.feed(handles, n, n + EVENTS_PER_TICK)
    handle.step()
    out.take()
    return n + EVENTS_PER_TICK


def main(argv) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: profile_query needs the "
                         "card")
    for name in argv or ["q4"]:
        profile(name)


def profile(name: str) -> None:
    query = getattr(queries, name)

    def build(c):
        streams, handles = build_inputs(c)
        return handles, query(*streams).output()

    handle, (handles, out) = Runtime.init_circuit(1, build)
    gen = NexmarkGenerator(GeneratorConfig(seed=1))
    n = 0
    for _ in range(STATE_TICKS):
        n = _tick(gen, handle, handles, out, n)

    # per operator, synchronized after each node
    node_ms = defaultdict(float)
    for node in handle.circuit.nodes:
        op = node.operator
        label = f"{node.index}:{op.name}"

        def timed(*args, _eval=op.eval, _label=label):
            t0 = time.perf_counter()
            r = _eval(*args)
            torch.cuda.synchronize()
            node_ms[_label] += (time.perf_counter() - t0) * 1e3
            return r

        op.eval = timed
    feed_ms = step_ms = 0.0
    for _ in range(PROFILE_TICKS):
        t0 = time.perf_counter()
        gen.feed(handles, n, n + EVENTS_PER_TICK)
        t1 = time.perf_counter()
        handle.step()
        out.take()
        t2 = time.perf_counter()
        feed_ms += (t1 - t0) * 1e3
        step_ms += (t2 - t1) * 1e3
        n += EVENTS_PER_TICK
    for node in handle.circuit.nodes:
        del node.operator.eval  # back to the class's eval
    print(json.dumps({
        "view": "operators", "query": name, "ticks": PROFILE_TICKS,
        "feed_ms_per_tick": feed_ms / PROFILE_TICKS,
        "step_ms_per_tick": step_ms / PROFILE_TICKS,
        "node_ms_per_tick": {k: v / PROFILE_TICKS
                             for k, v in sorted(node_ms.items(),
                                                key=lambda kv: -kv[1])},
    }), flush=True)

    # per device kernel, unsynchronized ticks under the profiler
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILE_TICKS):
            n = _tick(gen, handle, handles, out, n)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = defaultdict(lambda: [0.0, 0])
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            k = kernels[ev.name]
            k[0] += ev.device_time_total / 1e3
            k[1] += 1
    busy = sum(v[0] for v in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:15]
    print(json.dumps({
        "view": "device", "query": name, "ticks": PROFILE_TICKS,
        "wall_ms_per_tick": wall_ms / PROFILE_TICKS,
        "device_busy_ms_per_tick": busy / PROFILE_TICKS,
        "device_busy_share": busy / wall_ms,
        "device_ops_per_tick": sum(v[1] for v in kernels.values())
        / PROFILE_TICKS,
        "top": [{"name": k[:90], "ms_per_tick": v[0] / PROFILE_TICKS,
                 "calls_per_tick": v[1] / PROFILE_TICKS}
                for k, v in top],
        # the port's own kernels, whatever their rank
        "port_kernels": _port_view(kernels),
    }), flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    prof.export_chrome_trace(os.path.join("chiprun_out",
                                          f"{name}_trace.json"))


if __name__ == "__main__":
    main(sys.argv[1:])
