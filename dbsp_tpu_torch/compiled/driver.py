"""Run a pipeline fed through host input handles on the compiled engine.
Counterpart of ``dbsp_tpu/compiled/driver.py`` (``CompiledCircuitDriver``).

:class:`CompiledCircuitDriver` has the host handle's ``step`` while
running each tick through
:class:`~dbsp_tpu_torch.compiled.compiler.CompiledHandle`.

Feed and overflow protocol: inputs arrive through the host
``InputHandle`` buffers (``push_batch``); each ``step`` drains them with
``ZSetInput.eval`` (the host path's canonicalization), runs the tick, and
validates the capacity requirements at the validation cadence. On
overflow it grows, restores the interval-start snapshot and replays the
retained feeds: the compiled tick writes no feed in place, so the replay
is exact.

Validation cadence (``validate_every``, default 1): at 1, every tick
snapshots, validates and delivers at once. At N > 1 ticks queue without a
sync, the feeds are retained for a replay, and the outputs wait until the
interval validates, then go out in tick order: one snapshot and one
device read per N ticks, and outputs visible up to N-1 ticks late.
:meth:`flush` delivers a partial interval.

The driver steps eagerly: pushed feeds are host values, and the scanned
mode runs only under a ``gen_fn``. Outputs go back through the host
``OutputOperator.eval``, so a reader sees compiled and host pipelines
alike.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

from dbsp_tpu_torch.compiled.compiler import (CompiledOverflow,
                                              compile_circuit)


class CompiledCircuitDriver:
    """A host handle's ``step`` over a compiled circuit (see module doc)."""

    def __init__(self, handle, validate_every: int = 1):
        from dbsp_tpu_torch.operators.io_handles import (OutputOperator,
                                                         ZSetInput)

        self.ch = compile_circuit(handle)
        self._tick = 0
        self.validate_every = max(1, validate_every)
        self._inputs = [cn.op for cn in self.ch.cnodes
                        if isinstance(cn.op, ZSetInput)]
        self._outputs = [(cn.node.index, cn.op) for cn in self.ch.cnodes
                         if isinstance(cn.op, OutputOperator)]
        # the open interval: its start snapshot, the retained (tick,
        # feeds) for an exact replay, the outputs awaiting validation, and
        # the wall time its first tick came
        self._snap = None
        self._retained: List[Tuple[int, Dict]] = []
        self._out_buffer: List[Dict[int, object]] = []
        self._interval_open_ts: Optional[float] = None

    @property
    def step_latencies_ns(self):
        return self.ch.step_times_ns

    @property
    def interval_open(self) -> bool:
        """True while ticks sit in an unvalidated interval: their outputs
        are not visible yet (cadence > 1 only)."""
        return bool(self._retained)

    @property
    def open_interval_age_s(self) -> Optional[float]:
        """Seconds since the open interval's first tick, or None when
        every tick has been delivered."""
        ts = self._interval_open_ts
        return None if ts is None else max(0.0, time.time() - ts)

    def step(self) -> None:
        """One serving tick: drain the input buffers, run the compiled
        tick and, at the validation cadence, validate (grow and replay the
        interval on overflow), maintain and deliver."""
        feeds: Dict = {op: op.eval() for op in self._inputs}
        if not self._retained:
            h0 = time.perf_counter_ns()
            self._snap = self.ch.snapshot()
            self.ch.host_overhead_ns["snapshot"].append(
                time.perf_counter_ns() - h0)
            self._interval_open_ts = time.time()
        self._retained.append((self._tick, feeds))
        self.ch.step(tick=self._tick, feeds=feeds)
        self._out_buffer.append(dict(self.ch.last_outputs))
        self._tick += 1
        if len(self._retained) >= self.validate_every:
            self._flush()

    def _flush(self) -> None:
        """Validate the open interval, growing and replaying the retained
        feeds from its start snapshot on overflow; then one maintenance
        pass, and the outputs delivered in tick order."""
        ch = self.ch
        h0 = time.perf_counter_ns()
        while True:
            try:
                ch.validate()
                break
            except CompiledOverflow as e:
                ch.overflow_replays += 1
                ch.grow(e)
                ch.restore(self._snap)
                self._out_buffer.clear()
                for tick, feeds in self._retained:
                    ch.step(tick=tick, feeds=feeds)
                    self._out_buffer.append(dict(ch.last_outputs))
        ch.host_overhead_ns["validate"].append(time.perf_counter_ns() - h0)
        h0 = time.perf_counter_ns()
        ch.maintain()
        ch.host_overhead_ns["maintain"].append(time.perf_counter_ns() - h0)
        for outputs in self._out_buffer:
            for idx, out_op in self._outputs:
                batch = outputs.get(idx)
                if batch is not None:
                    # a consolidation deferred to the sink happens here,
                    # the policy CompiledHandle.output() shares
                    canon = ch.canonicalize_sink(batch)
                    if canon is not batch and \
                            ch.last_outputs.get(idx) is batch:
                        ch.last_outputs[idx] = canon
                    out_op.eval(canon)
        self._out_buffer.clear()
        self._retained.clear()
        self._snap = None
        self._interval_open_ts = None

    def flush(self) -> None:
        """Validate and deliver a partly filled interval (call it before a
        read that must see every tick)."""
        if self._retained:
            self._flush()
