#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (dbsp_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--parent DIR]...

Phases, each of which fails the run (nonzero exit, no result line):

1. device  — the card's name, and name + power limit from nvidia-smi;
2. build   — compile every CUDA source of the port (one nvcc per source,
             all at once) and print the build seconds;
3. kernels — each kernel entry point against its plain PyTorch version
             on the card, exactly, on adversarial cases (empty levels,
             dead and all-sentinel queries, duplicates, full capacity,
             total > out_cap, no gathered columns, cap-0 levels, ladders
             wider than the by-value argument block, empty /
             retraction-only / out-of-range segments; the ladder join
             and gather (each call one call of csrc/ladder_consumer.cu
             and of nothing else) also on key, value, weight and query
             columns of every width, hot keys whose ranges span many
             expansion tiles, ladders where every range is empty, and
             out_cap at, under and over a tile's edge; the fused
             aggregate chain as the call's one launch, on its fast path
             with the gate off and on and its general path, with caps
             under the unclamped totals, on netting ladders, a cap-0
             level, zero value columns, an out trace with several rows
             per key, zero-weight rows inside a delta's group, an
             all-retraction delta, int32 keys and weights, 90 levels (the
             argument table), every op of the vocabulary on signed
             values, and deltas of several tiles (with four hot groups)
             over a multi-block grid; the lex probe one side at a time
             and both in one launch, on levels of 0, 1 and 127-129 rows
             and larger, with runs of equal rows and narrow columns; the
             rank merge at 0, 1, T-1, T, T+1 and 3T+7 rows for its tile
             T, with equal runs longer than a tile, all rows equal, 1, 5
             and 16 columns and narrow columns; segment reduce on random
             ids and on runs across a warp, block and tile edge, one
             segment, alternating ids, runs broken by out-of-range ids
             and w <= 0, a trash-segment tail, 0, 1, T-1, T and T+1 rows
             for its tile T, int32 / int64 ids, int64 / int32 / int16 /
             bool values, unaligned columns, wrapping sums, an avg at
             INT64_MIN and a spec wide enough for the argument table,
             each with Max + present, Count + present, Max alone, three
             ops without an avg and all six ops)
             and on inputs of the queries' sizes (ladders up to 2M rows,
             100k-row deltas); the ladder gather also with distinct upper
             bounds and the trailing key column gathered back at once
             (qhi_keys with gather_keys=1, the rolling aggregate's and
             the radix tree's call) over key-only levels and levels with
             values, with empty ranges and dead queries whose bounds
             wrapped past int64 (counted apart in the "kernels:" line);
4. queries — Nexmark q4, q3, q8 and q15, one after the other, each on the
             host runtime on the card at 100,000 events per tick: 4 warm
             ticks then 20 measured (2,000,000 events, a cut of Nexmark's
             usual 100M made for the run's time limit); then q0, q1, q2,
             q13, q14, q17, q20, q21 and q22 the same way at a smaller
             depth, 2 warm ticks then 6 measured, and q12 at 4 warm and 8
             measured (across the end of its first 10-tick window); then
             the per-key top-K queries q9 (winning bids: a join, an
             in-window filter, a top-1), q6 (q9's winners, a per-seller
             top-10 by expiry, an average), q18 (top-1 per bidder) and
             q19 (top-10 per auction), and q16 (four Counts, eight
             distinct + Counts, a 12-column sum), each at 2 warm and 6
             measured ticks; then the windowed queries q5 (hot items:
             hopping windows as a fan-out of 5, a watermark, a window
             whose GC truncates its trace, a linear Count, a Max and a
             join) and q7 (the highest bid of the latest completed
             tumbling window: a watermark, a window, a Max), at 2 warm
             and 8 measured ticks with event time at 10,000 events/s (a
             tick spans 10 s, so the windows move every tick and q5's 40
             s retention truncates from the sixth; q5's GC'd spine must
             have dropped its earliest window). Each
             query's launch counts are set to 0 just before its run and
             read just after it (and per measured tick), the kernels its
             path must launch are checked (q0, q1, q2, q14, q21 and q22
             are maps and filters that launch none of the port's
             kernels; each distinct's lookup: one lex-probe launch per
             measured tick, q16 eight), the largest ladder gather of a
             top-K query is printed with its argument slots, and the
             accumulated output is held against
             a numpy oracle of the query over all events (q12's
             simulates its 10-tick windows, q13's joins the 16-row side
             table; the top-K oracles sort each group once with
             np.lexsort; q7's is the latest completed period's max price
             by its end, q5's every retained window's most-bid auctions);
             then the range-gather family, whose circuits are the
             reference's own compiled test circuits (no public Nexmark
             query has a rolling aggregate or a band join): "rolling", a
             10 s Max of bid price per auction keyed (auction,
             date_time), through the radix tree, at 10,000 events/s of
             event time, and "range_join", bids joined with the auctions
             whose id lies within +-2 of theirs, each at 2 warm and 6
             measured ticks; their oracles are numpy (the rolling
             window's start by searchsorted, then a range max; one
             equi-join for each offset) and their outputs, millions of
             rows, are integrated as numpy rows; the rolling path must
             launch the ladder gather with range queries (counted);
4b. compiled — Nexmark q4, q3 and q8 on the compiled engine, events
             generated on the card (device_gen), 100,000 events per tick,
             the reference bench's protocol: 4 warm ticks validated every
             tick, presize, one more tick, then 24 measured ticks
             validated every 8, pipelined; then 8 more ticks under the
             profiler for the card's busy share; q17 (the general Min and
             Max in agg_ladder, joins over aggregate outputs) the same way
             at 3 warm and 8 measured ticks, 4 profiled, and rolling
             (CRolling: window recompute, its three gathers a tick) and
             range_join (CRangeJoin: a shared buffer a side) at 4 warm
             and 8 measured, 4 profiled (compiled rolling against the
             host engine's radix tree, tick for tick), and q9 and q6
             (the compiled top-K, CTopK, whose gathers launch the ladder
             consumer) at 4 warm and 8 measured, 4 profiled, and q5 and q7
             (CWatermark, CApply on its validity, CWindow; q5's window GC
             truncates every level of its trace each tick) the same way,
             fed at 10,000 events/s of event time; compiled q5's GC'd
             trace must never slot nor be projected by presize, and its
             validated "trace" requirement after the measured ticks must
             stay within 1.6x of its value after the warm-up (it levels
             off). Launch counts are
             set to 0 just before each query's run and read just after it.
             Every tick's output equals the port's host engine on the card
             for the same events, and the integrated output equals the
             numpy oracle. Host syncs inside the measured ticks are counted
             with torch.cuda.set_sync_debug_mode("warn") (its one-time
             prototype notice is listed apart) and must be 0; compiled
             q8's distinct must launch the lex probe once per measured
             tick, and its probe's level and argument-slot counts are
             printed, with the device ops of one old-weights lookup (the
             probe and the per-level sum after it) and their share of the
             tick's. Printed: events/s, p50/p99, busy share, device ops
             per tick and the device ms per profiled tick of each of the
             port's kernels;
4c. algebra — a feeds-mode circuit of plus, minus, neg, sum_with,
             stream_distinct and distinct, compiled on the card, pushed
             20,000 random rows per input per tick for 5 ticks (grow,
             restore and replay on overflow): every tick equal to the same
             circuit on the host engine on the card; then a feeds-mode
             circuit of two user-defined Folds (a sum of squares and a
             max, by k % 1000), 20,000 random rows a tick for 5 ticks with
             retractions: compiled (the aggregate's stitched route, whose
             gathers launch the ladder consumer; the fused aggregate
             kernel must not launch) equal every tick to the host engine
             on the card;
4d. scanned — in a process of its own (profiling graph replays left
             later profiler sessions of the process without their first
             device events): compiled q3, q4, q8, q17, q9, q5 and rolling
             as in 4b
             (q5's window GC writes every level of its trace each tick, so
             each replay copies them back into the graph's buffers), each
             run twice from the same warm-up: eagerly, then in the scanned mode (each
             validation interval of 8 ticks one replay of a CUDA graph,
             captured on first use), then 4 more intervals, the eager
             run's each under the profiler, the scanned run's under it
             until one is readable in both; the first that both runs'
             profiles can read (their sentinels kept, no capture inside)
             is the profiled interval of both. At every interval's end the
             scanned run's state (every leaf, bit for bit, and its layout)
             and last-tick output equal the eager run's at the same tick
             (copied to the host); exactly one graph replay an interval; 0
             host syncs in the host work around the replays (a capture's
             own synchronize is outside it); in the profiled interval each
             kernel of the path launches a tick on the card (the wrappers'
             counts see only the captures) as often as in the eager run's
             same interval, and more than 0 times; no interval readable in
             both runs fails the phase.
             Printed beside the eager
             run's: events/s (with and without the capture), chunk times
             and their p50 / p99 (and over the 8 ticks), dispatch ms a
             tick, busy share, device ops and port-kernel launches a tick,
             captures by cause, peak allocated memory, the bytes copied
             into the graph's buffers before each interval and the bytes
             a replay copies back into them. A capture that fails
             fails the run;
4e. driver — compiled q4 behind CompiledCircuitDriver, fed through its
             input handles by the numpy generator at 100,000 events a tick
             for 12 ticks, at validation cadences 1 and 4, with flush()
             after 10 ticks (a partial interval at cadence 4): every
             delivered tick equals the host engine on the card, nothing is
             delivered inside an open interval, and the default seed
             capacities force grows with exact replays;
5. cross   — for each host query, the first 3 ticks of 10,000 events
             through the port on the CPU (plain versions) and on the card:
             equal rows per tick (q7 at 1,000 events/s of event time, so
             its window moves every tick; q5 at 250, so its GC truncates
             in the third; rolling at 1,000, so its windows' lower bounds
             cut);
6. timing  — each kernel, its plain version and (where one exists) one
             PyTorch library call, on the largest inputs the queries gave
             it: ``ms`` per call by CUDA events (host gaps between
             launches included), ``device_ms`` the kernel's device time
             alone by torch.profiler, and the device operations a call
             queues, whole and by name; the ladder join's and gather's
             call also with every query dead and with out_cap 1 (the
             time without the searches, and without the slots), and
             their main-path call with the most queries (the join's:
             q4's bids against its auctions, the matched rows' expansion);
             segment reduce also on the same call with uniformly
             random ids, the aggregate chain also on its call with the
             gate on and on a skewed rebuild of that call (4,000 hot
             groups, each with ~1,500 history rows: few queries, long
             merges), each with gather_cap at the bucket of its total;
7. turns   — only with ``--parent DIR`` (another tree of the repo, such as
             the parent commit unpacked with ``git archive``; repeat the
             option for more trees): every kernel entry point's largest
             main-path call and the variants phase 6 timed, saved as
             tensors and plain values (a batch or an aggregator of the
             package field by field, rebuilt with each tree's own
             classes) and
             timed in each tree that has that entry point, in turns (the
             other trees, this, this, the others in reverse), each turn a
             process of its own, after one timing in this process; the
             outputs are checked equal across the turns;
8. graph   — the largest main-path call of the aggregate kernel, of the
             ladder join and of the ladder gather, each captured in a
             CUDA graph and replayed: equal to the eager call, or the
             capture's refusal reported; and a lex probe over 606
             argument slots (a table uploaded from the host per launch),
             whose capture must raise.

Each phase prints its wall time on a line of its own ("phase ...: s").
Output: the phase summaries, then one line {"kernels": [...]}, then the
nvidia-smi line, then the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

WARM_TICKS = 4
TICKS = 20
EVENTS_PER_TICK = 100_000
CROSS_TICKS, CROSS_EVENTS = 3, 10_000
# Event time advances at first_event_rate events/s (the generator's default
# is 10,000,000: a 100,000-event tick is 10 ms). The windowed queries run
# at 10,000, the Apache Beam Nexmark suite's default firstEventRate, so that
# a tick spans 10 s and their windows move and retire; in the cross-check
# (10,000-event ticks) q7's window moves every 10 s tick and q5's GC
# truncates from the third 40 s tick.
GEN_RATE = {"q5": 10_000, "q7": 10_000, "rolling": 10_000}
CROSS_RATE = {"q5": 250, "q7": 1_000, "rolling": 1_000}

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, data sheet
# The data sheet gives no integer rate outside the tensor cores. This one
# is derived from the H100 SXM's layout: 132 SMs x 64 INT32 lanes x the
# 1.98 GHz boost clock, halved because an int64 compare or add issues as
# two 32-bit instructions. The kernels' operations are int64 compares.
INT64_OPS_PER_S = 132 * 64 * 1.98e9 / 2


def bound(nbytes, ops) -> tuple:
    """The least ms for ``nbytes`` moved and ``ops`` int64 operations, and
    which of the two sets it ("bytes" or "operations")."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / INT64_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), \
        "bytes" if bytes_ms >= ops_ms else "operations"

REPLACES = {
    "lex_probe_ladder": "dbsp_tpu/zset/pallas_kernels.py:145",
    "join_ladder": "dbsp_tpu/zset/pallas_kernels.py:338",
    "gather_ladder": "dbsp_tpu/zset/pallas_kernels.py:357",
    "segment_reduce": "dbsp_tpu/zset/pallas_kernels.py:430",
    "rank_merge": "dbsp_tpu/zset/pallas_kernels.py:519",
    "agg_ladder": "dbsp_tpu/zset/pallas_kernels.py:472",
}
SOURCE = {
    "lex_probe_ladder": "dbsp_tpu_torch/csrc/probe_ladder.cu",
    "join_ladder": "dbsp_tpu_torch/csrc/ladder_consumer.cu",
    "gather_ladder": "dbsp_tpu_torch/csrc/ladder_consumer.cu",
    "segment_reduce": "dbsp_tpu_torch/csrc/segment_reduce.cu",
    "rank_merge": "dbsp_tpu_torch/csrc/rank_merge.cu",
    "agg_ladder": "dbsp_tpu_torch/csrc/agg_ladder.cu",
}
# the entry point that calls a kernel, where it is not the kernel's name
ENTRY = {"lex_probe_ladder": "lex_probe_ladder_both",  # both sides
         "rank_merge": "rank_merge_scatter"}
# the queries driven on the card, in order, and the kernels each one's
# path must launch
QUERIES = {
    "q4": ("join_ladder", "gather_ladder", "segment_reduce", "rank_merge"),
    "q3": ("join_ladder", "rank_merge"),
    "q8": ("lex_probe_ladder", "join_ladder", "rank_merge"),
    "q15": ("lex_probe_ladder", "gather_ladder", "rank_merge"),
    # maps and filters: no kernel of the port on their path
    "q0": (), "q1": (), "q2": (), "q14": (), "q21": (), "q22": (),
    "q12": ("gather_ladder", "rank_merge"),
    "q13": ("join_ladder", "rank_merge"),
    "q17": ("join_ladder", "gather_ladder", "segment_reduce", "rank_merge"),
    "q20": ("join_ladder", "rank_merge"),
    # the per-key top-K (its gathers), q9's and q6's join, q16's eight
    # distincts; q6's and q16's Average and Counts are linear (an
    # accumulator gather, no segment reduce)
    "q9": ("join_ladder", "gather_ladder", "rank_merge"),
    "q6": ("join_ladder", "gather_ladder", "rank_merge"),
    "q16": ("lex_probe_ladder", "gather_ladder", "rank_merge"),
    "q18": ("gather_ladder", "rank_merge"),
    "q19": ("gather_ladder", "rank_merge"),
    # the windowed queries: q5's Count (linear: an accumulator gather),
    # Max and join, q7's Max; the window's slices are searchsorted pairs
    # and masked gathers, its GC a compaction (no kernel of the port)
    "q5": ("join_ladder", "gather_ladder", "segment_reduce", "rank_merge"),
    "q7": ("gather_ladder", "segment_reduce", "rank_merge"),
    # the rolling aggregate through the radix tree: every level's range
    # gathers, its reductions, the tree's and the traces' merges; the
    # range join's probes and expansions are plain torch (XLA in the
    # reference), its traces merge
    "rolling": ("gather_ladder", "segment_reduce", "rank_merge"),
    "range_join": ("rank_merge",),
}
# (warm, measured) ticks of a host query, where not WARM_TICKS, TICKS
HOST_DEPTH = {q: (2, 6) for q in ("q0", "q1", "q2", "q13", "q14", "q17",
                                  "q20", "q21", "q22", "q9", "q6", "q16",
                                  "q18", "q19")}
HOST_DEPTH["q12"] = (4, 8)  # 12 ticks: across a 10-tick window's end
# 10 ticks of 10 s: q5's 40 s retention truncates from the sixth
HOST_DEPTH["q5"] = HOST_DEPTH["q7"] = (2, 8)
HOST_DEPTH["rolling"] = HOST_DEPTH["range_join"] = (2, 6)
# lex-probe launches a measured tick: one per distinct (its old-weights
# lookup probes both sides in one launch)
PROBES_PER_TICK = {"q8": 1, "q15": 1, "q16": 8}
# the compiled engine's paths, driven after the host engine's
COMPILED = {
    "q4": ("join_ladder", "agg_ladder", "gather_ladder", "rank_merge"),
    "q3": ("join_ladder", "rank_merge"),
    "q8": ("lex_probe_ladder", "join_ladder", "rank_merge"),
    "q17": ("agg_ladder", "join_ladder", "gather_ladder", "rank_merge"),
    "q9": ("join_ladder", "gather_ladder", "rank_merge"),
    "q6": ("join_ladder", "gather_ladder", "rank_merge"),
    # the compiled aggregate's fused kernel for both Maxes; q5's linear
    # Count gathers its accumulator with the ladder consumer
    "q5": ("join_ladder", "gather_ladder", "agg_ladder", "rank_merge"),
    "q7": ("agg_ladder", "rank_merge"),
    # CRolling's three gathers (the affected rows and the windows in
    # range mode, the old outputs), its window reduce and its merges;
    # CRangeJoin's traces merge
    "rolling": ("gather_ladder", "segment_reduce", "rank_merge"),
    "range_join": ("rank_merge",),
}
# the compiled paths phase 4d runs eagerly and scanned
SCANNED = ("q3", "q4", "q8", "q17", "q9", "q5", "rolling")
# the device kernels (profile_query.PORT_KERNELS) that each wrapper on a
# compiled path launches: the profiler sees these, and join_ladder and
# gather_ladder launch the same two
DEVICE_KERNELS = {
    "lex_probe_ladder": ("probe_ladder_kernel",),
    "join_ladder": ("consumer_probe_kernel", "consumer_expand_kernel"),
    "gather_ladder": ("consumer_probe_kernel", "consumer_expand_kernel"),
    "rank_merge": ("rank_merge_kernel",),
    "agg_ladder": ("agg_ladder_kernel",),
    "segment_reduce": ("rows_kernel",),
}
# the device kernels whose launches the wrappers' counts fix: one per
# launch of each wrapper named (segment reduce's rows_kernel and
# fin_avg_kernel launch by a call's rows and spec, fill_kernel always).
# A profile whose launches of these differ from the counts lost events.
ACCOUNTED_KERNELS = {
    "probe_ladder_kernel": ("lex_probe_ladder",),
    "consumer_probe_kernel": ("join_ladder", "gather_ladder"),
    "consumer_expand_kernel": ("join_ladder", "gather_ladder"),
    "rank_merge_kernel": ("rank_merge",),
    "fill_kernel": ("segment_reduce",),
    "agg_ladder_kernel": ("agg_ladder",),
}
C_WARM, C_TICKS, C_VALIDATE, C_PROFILE = 4, 24, 8, 8
# intervals after phase 4d's measured ones, each held to the eager run and
# profiled; the first both runs' profiles can read (each kept its
# sentinels, lost no launch the counts account for, and scanned, held no
# capture) is the compared one
SCAN_PROFILE_INTERVALS = 4
# (warm, measured, profiled) ticks of a compiled query, where not C_WARM,
# C_TICKS, C_PROFILE
COMPILED_DEPTH = {"q17": (3, 8, 4), "q9": (4, 8, 4), "q6": (4, 8, 4),
                  "q5": (4, 8, 4), "q7": (4, 8, 4), "rolling": (4, 8, 4),
                  "range_join": (4, 8, 4)}
# trace levels of a compiled query, where not the reference bench's pick
# for its measured ticks (one level at 8): q5's GC'd trace on two, so that
# a tick truncates a deep level too, maintain drains into it, and a
# scanned replay writes it back
COMPILED_LEVELS = {"q5": 2}
# the GC'd trace's validated "trace" requirement at the end of compiled
# q5's measured ticks, against its value after the warm-up (50 s of event
# time, about the retained span): above this ratio it grows with the run
# (without the GC it would hold 13 ticks' rows against 5)
GC_LEVEL_RATIO = 1.6
ALGEBRA_TICKS, ALGEBRA_ROWS = 5, 20_000
FOLD_TICKS, FOLD_ROWS = 5, 20_000
# torch's sync debug mode warns at each host sync ("called a synchronizing
# CUDA operation"); the first time it is switched on it also warns that it
# "is a prototype feature and does not yet detect all synchronizing
# operations", which is no sync
SYNC_NOTICE = "is a prototype feature"


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(*parts) -> None:
    print(*parts, flush=True)


@contextlib.contextmanager
def phase(label: str):
    """Print the wall time of the enclosed phase on a line of its own."""
    t0 = time.perf_counter()
    yield
    say(f"phase {label}: {time.perf_counter() - t0:.3f} s")


# nvidia-smi's name and power limit of the card, set in main() and
# printed beside every query's numbers
CARD = [""]


# ---------------------------------------------------------------------------
# Exact comparison of a kernel with its plain version
# ---------------------------------------------------------------------------


def flat_outputs(out):
    """Every tensor of a (nested) kernel result, in order."""
    import torch

    if out is None:  # the aggregate chain's fast-path slots, general path
        return []
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for o in out for t in flat_outputs(o)]


class Checker:
    """Runs kernel-vs-plain comparisons and keeps the largest absolute
    difference seen per kernel (0 when they agree, as they must)."""

    def __init__(self):
        self.max_err = {k: 0.0 for k in REPLACES}
        self.cases = {k: 0 for k in REPLACES}
        # of the gather's cases, those in range mode with gather_keys=1
        self.range_gather_keys = 0

    def check(self, name: str, what: str, kernel_fn, plain_fn, *args,
              **kw):
        import torch

        got = flat_outputs(kernel_fn(*args, **kw))
        want = flat_outputs(plain_fn(*args, **kw))
        torch.cuda.synchronize()
        if len(got) != len(want):
            fail(f"{name} [{what}]: {len(got)} outputs vs {len(want)}")
        err = 0.0
        for i, (g, w) in enumerate(zip(got, want)):
            if g.dtype != w.dtype or g.shape != w.shape:
                fail(f"{name} [{what}] output {i}: {g.dtype}{tuple(g.shape)}"
                     f" vs plain {w.dtype}{tuple(w.shape)}")
            if g.numel():
                d = (g.to(torch.float64) - w.to(torch.float64)).abs().max()
                err = max(err, float(d))
            if not torch.equal(g, w):
                fail(f"{name} [{what}] output {i} differs from the plain "
                     f"version (max abs diff {err})")
        self.max_err[name] = max(self.max_err[name], err)
        self.cases[name] += 1
        return got


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------


def consolidated(rng, n_live, cap, dev, nk=2, nv=1, key_range=40,
                 spec=None, extra=()):
    """A consolidated batch of up to ``n_live`` random rows (weights in
    [-3, 3] without 0) at capacity ``cap`` — dead rows past the live
    prefix. Column i is drawn from [lo, hi) as ``spec[i] = (lo, hi, numpy
    dtype)``, by default ``nk + nv`` int64 columns in [0, key_range); the
    first ``nk`` are keys. ``extra`` holds the columns of more rows to
    add (duplicates sum)."""
    from dbsp_tpu_torch.zset.batch import Batch

    spec = spec or ((0, key_range, np.int64),) * (nk + nv)
    cols = [rng.integers(lo, hi, n_live).astype(dt) for lo, hi, dt in spec]
    if len(extra):
        cols = [np.concatenate([x, c]) for x, c in zip(extra, cols)]
    w = rng.integers(-3, 4, len(cols[0]))
    w[w == 0] = 1
    return Batch.from_columns(cols[:nk], cols[nk:], w, cap=cap, device=dev)


def adversarial_ladders(rng, dev):
    """Duplicate keys across levels, an EMPTY level, a FULL-capacity level
    (no dead tail), heterogeneous caps."""
    import torch

    from dbsp_tpu_torch.zset.batch import Batch

    full = Batch.from_columns(
        [np.arange(64, dtype=np.int64), np.arange(64, dtype=np.int64) % 7],
        [np.zeros(64, np.int64)], np.ones(64, np.int64), cap=64, device=dev)
    yield [consolidated(rng, max(2, c // 3), c, dev)
           for c in (256, 64, 32, 16)]
    yield [consolidated(rng, 20, 64, dev),
           Batch.empty((torch.int64, torch.int64), (torch.int64,), cap=32,
                       device=dev),
           consolidated(rng, 10, 16, dev)]
    yield [full, consolidated(rng, 30, 64, dev, key_range=8)]


def bids_row(key_range):
    """The bids schema: int64 key; int64, int64, int32, int64 values."""
    return ((0, key_range, np.int64), (0, 1 << 40, np.int64),
            (1, 10_000_000, np.int64), (0, 16, np.int32),
            (0, 1 << 41, np.int64))


SPEC = (("count", 0), ("sum", 0), ("min", 0), ("max", 1), ("avg", 1),
        ("present", 0))


# q8's distinct input: (person id, window start) keys, int32 name value
Q8_ROW = ((1000, 3000, np.int64), (0, 40, np.int64), (0, 1000, np.int32))
# q15's distinct input: (day, bidder) keys, no value
Q15_ROW = ((0, 4, np.int64), (0, 500_000, np.int64))


def seg_case(rng, n, S, dev):
    import torch

    v1 = rng.integers(-1000, 1000, n)
    v2 = rng.integers(-9, 9, n).astype(np.int32)
    w = rng.integers(-3, 4, n)
    seg = rng.integers(-2, S + 5, n).astype(np.int32)  # out-of-range ids
    if n >= 4:
        seg[seg == 0] = S + 2  # segment 0 stays empty
        seg[seg == S - 1] = S + 1
        seg[:2] = S - 1  # segment S-1 holds retractions only
        w[:2] = -1
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return (t(v1), t(v2)), t(w), t(seg)


# segment-reduce specs: the main path's two, odd op counts without an avg
# (the kernel reduces ops two at a time), and all six ops
SEG_SPECS = {
    "max+present": (("max", 0), ("present", 0)),
    "count+present": (("count", 0), ("present", 0)),
    "max alone": (("max", 0),),
    "max, max, present": (("max", 0), ("max", 2), ("present", 0)),
    "all six": (("count", 0), ("sum", 0), ("min", 1), ("max", 2),
                ("avg", 0), ("present", 0), ("sum", 3)),
}


def seg_layouts(rng, tile: int):
    """Segment-reduce inputs aimed at the run-wise reduction: ``{name:
    (ids, w, nseg)}``, numpy, ids int32 unless named otherwise."""
    def runs(bounds, n):  # sorted ids, a run per gap, odd ids empty
        return (2 * np.repeat(np.arange(len(bounds) - 1),
                              np.diff(bounds)))[:n].astype(np.int32)

    def sorted_runs(n, mean=7):
        bounds = np.concatenate([[0], np.cumsum(
            rng.integers(1, 2 * mean, n + 1))])
        return runs(bounds[bounds <= n].tolist() + [n], n)

    def w_of(n):
        return rng.integers(-3, 4, n)

    W, T = 128, tile  # rows per warp, per tile
    n = 3 * T + 7
    # runs across a thread's stretch (2-6), a warp edge (W - 28 .. W + 12),
    # a tile edge (T - 24 .. T + 26) and a whole tile (2T - 8 .. 3T + 2)
    bounds = [0, 1, 2, 6, W - 28, W + 12, 300, T - 24, T + 26, T + 36,
              T + 37, T + 38, 2 * T - 8, 3 * T + 2, n]
    ids = runs(bounds, n)
    assert ids[W - 1] == ids[W] and ids[T - 1] == ids[T]
    out = {"runs across warp, block and tile edges":
           (ids, w_of(n), int(ids.max()) + 2)}
    out["one segment, all rows"] = (np.zeros(n, np.int32), w_of(n), 1)
    out["alternating ids"] = ((np.arange(n) % 2 * 5).astype(np.int32),
                              w_of(n), 6)
    ids = np.sort(rng.integers(0, 300, n)).astype(np.int32)
    w = w_of(n)
    w[rng.random(n) < 0.2] = 0
    w[ids == ids[n // 2]] = -1  # a run of retractions only
    cut = rng.random(n) < 0.05
    ids[cut] = rng.choice([-1, 300, 2**31 - 1], int(cut.sum()))
    out["sorted runs broken by out-of-range ids and w <= 0"] = (ids, w, 300)
    out["the same, int64 ids"] = (ids.astype(np.int64), w, 300)
    n = 2 * T + 100  # a gathered part: the dead rows in the trash segment
    ids = np.full(n, 50, np.int32)
    ids[:n // 3] = np.sort(rng.integers(0, 50, n // 3))
    w = w_of(n)
    w[n // 3:] = 0
    out["trash segment nseg - 1 holding a long tail"] = (ids, w, 51)
    for n in (0, 1, T - 1, T, T + 1):
        out[f"n {n}"] = (sorted_runs(n), w_of(n), 2 * n + 1)
    return out


def seg_vals(rng, n, dev, big=False):
    """int64 (+-2^62 with ``big``: sums wrap), int32, int16 and bool
    value columns on the card."""
    import torch

    v1 = (rng.integers(-2**62, 2**62, n) if big
          else rng.integers(-1000, 1000, n))
    cols = (v1, rng.integers(-2**31, 2**31, n).astype(np.int32),
            rng.integers(-2**15, 2**15, n).astype(np.int16),
            rng.integers(0, 2, n).astype(np.bool_))
    return tuple(torch.from_numpy(c).to(dev) for c in cols)


def check_segment_runs(ck: Checker, rng, dev) -> None:
    """Segment reduce against its plain version on inputs aimed at the
    run-wise reduction, each with every spec of ``SEG_SPECS``; then
    wrapping sums and an avg at INT64_MIN, columns at unaligned addresses,
    a one-segment 2M-row input, and a spec wide enough for the argument
    table."""
    import torch

    from dbsp_tpu_torch.zset import cuda_kernels as ck_mod

    def check(what, spec, vals, w, ids, nseg):
        ck.check("segment_reduce", what, ck_mod.segment_reduce,
                 ck_mod.segment_reduce_plain, spec, vals, w, ids, nseg,
                 seg_out_dtypes(spec, vals, w))

    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    for name, (ids, w, nseg) in seg_layouts(rng, ck_mod.SEG_TILE).items():
        vals = seg_vals(rng, len(ids), dev)
        for sname, spec in SEG_SPECS.items():
            check(f"{name}, {sname}", spec, vals, t(w), t(ids), nseg)
    # sums that wrap; segment 3 averages INT64_MIN exactly, segment 5
    # holds INT64_MIN times 3 (wraps)
    n = ck_mod.SEG_TILE + 5
    vals = seg_vals(rng, n, dev, big=True)
    ids = rng.integers(0, 40, n)
    ids[2:][ids[2:] == 3] = 4
    ids[2:][ids[2:] == 5] = 6
    ids[:2] = (3, 5)
    w = rng.integers(-3, 4, n)
    w[:2] = (1, 3)
    v1 = vals[0].cpu().numpy().copy()
    v1[:2] = np.iinfo(np.int64).min
    order = np.argsort(ids, kind="stable")
    on_dev = torch.from_numpy(order).to(dev)
    vals = (t(v1[order]), *(v[on_dev] for v in vals[1:]))
    check("wrapping sums, avg at INT64_MIN", SEG_SPECS["all six"], vals,
          t(w[order]), t(ids[order].astype(np.int32)), 40)
    # every column one row past an aligned address: no vector loads
    ids, w, nseg = seg_layouts(rng, ck_mod.SEG_TILE)[
        "sorted runs broken by out-of-range ids and w <= 0"]
    vals = tuple(v[1:] for v in seg_vals(rng, len(ids) + 1, dev))
    check("unaligned columns, all six", SEG_SPECS["all six"], vals,
          t(np.concatenate([[0], w]))[1:],
          t(np.concatenate([[0], ids]).astype(np.int32))[1:], nseg)
    # one segment of 2M rows: runs across 1,954 tiles
    n = 2_000_000
    vals = seg_vals(rng, n, dev)
    for sname, spec in SEG_SPECS.items():
        check(f"one segment of {n} rows, {sname}", spec, vals,
              t(rng.integers(-3, 4, n)), t(np.full(n, 6, np.int32)), 7)
    # 121 ops over 4 columns: 2 * 4 + 4 + 4 * 121 = 496 slots, above the
    # by-value block
    spec = SEG_SPECS["all six"] * 17 + SEG_SPECS["max+present"]
    ids, w, nseg = seg_layouts(rng, ck_mod.SEG_TILE)[
        "runs across warp, block and tile edges"]
    check(f"{len(spec)} ops (argument table)", spec,
          seg_vals(rng, len(ids), dev), t(w), t(ids), nseg)


def seg_out_dtypes(spec, vals, w):
    from dbsp_tpu_torch.operators.aggregate import _seg_out_dtype

    return tuple(_seg_out_dtype(op, c, vals, w) for op, c in spec)


def check_probe_sides(ck: Checker, what: str, tables, queries):
    """The two-sided probe (one launch) and each one-sided probe against
    their plain versions. Returns the two-sided ``(lo, hi)``."""
    from dbsp_tpu_torch.zset import cuda_kernels as ck_mod

    for side in ("left", "right"):
        ck.check("lex_probe_ladder", f"{what} side {side}",
                 ck_mod.lex_probe_ladder, ck_mod.lex_probe_ladder_plain,
                 tables, queries, side)
    return ck.check("lex_probe_ladder", f"{what} both sides",
                    ck_mod.lex_probe_ladder_both,
                    ck_mod.lex_probe_ladder_both_plain, tables, queries)


def sorted_rows(rng, n, spec, dev, extra=None):
    """``n`` rows sorted lexicographically on the card, column i drawn
    from [lo, hi) as ``spec[i] = (lo, hi, numpy dtype)`` (narrow ranges
    give runs of equal rows), plus ``extra`` copies of the row of each
    column's ``lo``."""
    import torch

    cols = [rng.integers(lo, hi, n).astype(dt) for lo, hi, dt in spec]
    if extra:
        cols = [np.concatenate([c, np.full(extra, lo, dt)])
                for c, (lo, _, dt) in zip(cols, spec)]
    order = np.lexsort(cols[::-1])
    return tuple(torch.from_numpy(c[order]).to(dev) for c in cols)


def check_probe_runs(ck: Checker, rng, dev) -> None:
    """The probe on levels of 127, 128 and 129 rows, much larger, of one
    row and of none; runs of equal rows (hi - lo > 1), sentinel queries,
    1, 2, 3 and 16 columns, columns of every narrower integer type and
    bool."""
    import torch

    i64max = torch.iinfo(torch.int64).max
    for ncols in (1, 2, 3, 16):
        # two varying columns at most, the rest constant: equal rows
        spec = [(0, 40 if ncols == 1 else 6, np.int64)] * min(ncols, 2) + \
            [(3, 4, np.int64)] * (ncols - 2)
        qspec = [(-1, 41 if ncols == 1 else 7, np.int64)] * min(ncols, 2) + \
            [(3, 4, np.int64)] * (ncols - 2)
        q = sorted_rows(rng, 700, qspec, dev)
        q = tuple(torch.cat([c, torch.full((9,), i64max, device=dev)])
                  for c in q)
        for caps in ((127, 128, 129, 1, 0), (37 * 128 + 5, 7)):
            tables = [sorted_rows(rng, c, spec, dev) for c in caps]
            lo, hi = check_probe_sides(ck, f"{ncols} columns, levels "
                                       f"{caps}", tables, q)
            if int((hi - lo).max()) <= 1:
                fail(f"lex_probe_ladder [{ncols} columns {caps}]: no run "
                     "of equal rows was probed")
    narrow = ((0, 5, np.int32), (0, 2, np.bool_), (-3, 3, np.int8),
              (-3, 3, np.int16), (0, 3, np.uint8))
    tables = [sorted_rows(rng, n, narrow, dev) for n in (5000, 300, 12)]
    q = sorted_rows(rng, 900, ((-1, 6, np.int64), (0, 2, np.bool_),
                               (-4, 4, np.int32), (-3, 3, np.int64),
                               (0, 4, np.uint8)), dev)
    check_probe_sides(ck, "int32, bool, int8, int16 and uint8 columns",
                      tables, q)


def check_merge_tiles(ck: Checker, rng, dev) -> None:
    """The rank merge around its tile T: merges of 0, 1, T-1, T, T+1 and
    3T+7 rows split three ways between the sides; a run of equal rows
    longer than a tile on both sides; all rows equal; 1, 5 (q4's bids
    rows) and 16 columns; int32, bool, int8, int16 and uint8 columns with
    int32 weights."""
    import torch

    from dbsp_tpu_torch.zset import cuda_kernels as ck_mod

    def merge(what, na, nb, spec, extra=(0, 0), wdt=np.int64):
        a = sorted_rows(rng, na, spec, dev, extra[0])
        b = sorted_rows(rng, nb, spec, dev, extra[1])
        wa = torch.from_numpy(rng.integers(-3, 4, len(a[0])).astype(wdt))
        wb = torch.from_numpy(rng.integers(-3, 4, len(b[0])).astype(wdt))
        ck.check("rank_merge", what, ck_mod.rank_merge_scatter,
                 ck_mod.rank_merge_scatter_plain, a, wa.to(dev), b,
                 wb.to(dev))

    bids = ((0, 300, np.int64), (0, 1 << 40, np.int64),
            (1, 10_000, np.int64), (0, 16, np.int32), (0, 1 << 41, np.int64))
    for spec in (((0, 50, np.int64),), bids, ((0, 3, np.int64),) * 16):
        ncols = len(spec)
        T = ck_mod.rank_merge_tile(ncols)
        for n in (0, 1, T - 1, T, T + 1, 3 * T + 7):
            for na in sorted({0, n // 3, n}):
                merge(f"{ncols} columns, tile {T}, {na} + {n - na} rows",
                      na, n - na, spec)
        merge(f"{ncols} columns, tile {T}: an equal run of {2 * T + 3} + "
              f"{T + 9} rows", 3 * T, T + 40, spec, extra=(2 * T + 3, T + 9))
        same = tuple((lo, lo + 1, dt) for lo, _, dt in spec)
        merge(f"{ncols} columns, tile {T}: all rows equal", 2 * T + 5,
              3 * T + 1, same)
    narrow = ((0, 5, np.int32), (0, 2, np.bool_), (-9, 9, np.int8),
              (-9, 9, np.int16), (0, 9, np.uint8))
    merge("int32, bool, int8, int16 and uint8 columns, int32 weights", 5000,
          7000, narrow, wdt=np.int32)


def check_lex_probe(ck: Checker, rng, dev) -> None:
    """lex_probe_ladder against its plain version, both sides, one at a
    time and in one launch."""
    import torch

    from dbsp_tpu_torch.zset import cuda_kernels as ck_mod

    def both_sides(what, tables, queries):
        check_probe_sides(ck, what, tables, queries)

    i64max = torch.iinfo(torch.int64).max
    sentinel = tuple(torch.full((8,), i64max, device=dev) for _ in range(2))
    empty = tuple(torch.empty((0,), dtype=torch.int64, device=dev)
                  for _ in range(2))
    for li, ladder in enumerate(adversarial_ladders(rng, dev)):
        # 20 rows at capacity 32: the tail is dead (weight 0, sentinel keys)
        delta = consolidated(rng, 20, 32, dev)
        keys = [lvl.keys for lvl in ladder]
        both_sides(f"ladder {li} keys, dead tail", keys, delta.keys)
        both_sides(f"ladder {li} all-sentinel queries", keys, sentinel)
        both_sides(f"ladder {li} full rows", [lvl.cols for lvl in ladder],
                   delta.cols)
        both_sides(f"ladder {li} + a cap-0 level", [*keys, empty],
                   delta.keys)
    # q8-shaped: full-row probes of (id, window) keys + an int32 name
    ladder = [consolidated(rng, n, cap, dev, spec=Q8_ROW)
              for n, cap in ((30_000, 1 << 15), (6_000, 1 << 13),
                             (1_500, 1 << 11))]
    # 1,000 live rows of the deepest level, which a full-row probe finds
    hits = [c[:1_000].cpu().numpy() for c in ladder[0].cols]
    delta = consolidated(rng, 1_000, 1 << 11, dev, spec=Q8_ROW, extra=hits)
    both_sides("q8-shaped", [lvl.cols for lvl in ladder], delta.cols)
    # q15-shaped: (day, bidder) keys, no value column
    ladder = [consolidated(rng, n, cap, dev, spec=Q15_ROW)
              for n, cap in ((60_000, 1 << 16), (3_000, 1 << 12),
                             (200, 1 << 8))]
    delta = consolidated(rng, 4_000, 1 << 12, dev, spec=Q15_ROW)
    both_sides("q15-shaped", [lvl.cols for lvl in ladder], delta.cols)
    # large: 8 levels from 2M rows down, 100k queries of a 131,072 cap
    ladder = [consolidated(rng, (1 << c) - (1 << (c - 3)), 1 << c, dev,
                           spec=Q15_ROW) for c in range(21, 13, -1)]
    delta = consolidated(rng, 100_000, 1 << 17, dev, spec=Q15_ROW)
    both_sides("large (K 8, 2M rows, m 131072)",
               [lvl.cols for lvl in ladder], delta.cols)


def empty_level(dev, nk=2, nv=1):
    """A level of no rows (cap 0): spines drop them, the compiled engine's
    ladders and the kernels take them."""
    import torch

    from dbsp_tpu_torch.zset.batch import Batch

    return Batch.empty((torch.int64,) * nk, (torch.int64,) * nv, cap=0,
                       device=dev)


def check_cap0_and_wide(ck: Checker, rng, dev) -> None:
    """The ladder consumer on a cap-0 level, and the lex probe and the
    ladder consumer on ladders whose argument block is wider than the
    by-value block (it then travels as a device table)."""
    import torch

    from dbsp_tpu_torch.zset import cuda_kernels as ck_mod
    from dbsp_tpu_torch.zset.batch import Batch

    # the smallest input of the cap-0 fault: keys [1, 2, 3, 9] and a level
    # of no rows; delta keys [1, 3, 4]
    lvl = Batch.from_columns([np.array([1, 2, 3, 9], np.int64)],
                             [np.array([10, 20, 30, 90], np.int64)],
                             np.array([2, 1, -1, 1], np.int64), cap=4,
                             device=dev)
    d = Batch.from_columns([np.array([1, 3, 4], np.int64)], [],
                           np.ones(3, np.int64), cap=4, device=dev)
    ladder = [lvl, empty_level(dev, nk=1)]
    got = ck.check("join_ladder", "cap-0 level, smallest input",
                   JOIN, ck_mod.join_ladder_plain,
                   d.keys, d.weights, ladder, 1, 8)
    # flat outputs: qrow, the level's value column, w, valid, total
    if got[1][:3].tolist() != [10, 30, 0] or \
            got[2][:3].tolist() != [2, -1, 0] or int(got[-1]) != 2:
        fail(f"join_ladder on a cap-0 level: vals {got[1][:3].tolist()}, "
             f"w {got[2][:3].tolist()}, total {int(got[-1])}; want "
             "[10, 30, 0], [2, -1, 0], 2")
    ck.check("gather_ladder", "cap-0 level, smallest input",
             GATHER, ck_mod.gather_ladder_plain,
             d.keys, d.weights != 0, ladder, 8)
    for li, ladder in enumerate(adversarial_ladders(rng, dev)):
        ladder = [ladder[0], empty_level(dev), *ladder[1:]]
        delta = consolidated(rng, 20, 32, dev)
        for out_cap in (1024, 4):
            ck.check("join_ladder", f"ladder {li} + cap-0 level {out_cap}",
                     JOIN, ck_mod.join_ladder_plain,
                     delta.keys, delta.weights, ladder, 2, out_cap)
            ck.check("gather_ladder", f"ladder {li} + cap-0 level "
                     f"{out_cap}", GATHER,
                     ck_mod.gather_ladder_plain, delta.keys,
                     delta.weights != 0, ladder, out_cap)
    # wide ladders: 200 levels of two-column rows for the probe
    # (3 * 200 + 2 + 4 = 606 slots), 100 levels of bids rows for the join
    # and the gather ((1 + 4 + 2) * 100 + 7 = 707 slots)
    two = ((0, 50, np.int64),) * 2
    probe_ladder = [consolidated(rng, 12, 16, dev, spec=two, nv=0)
                    for _ in range(200)]
    q = consolidated(rng, 300, 512, dev, spec=two, nv=0)
    check_probe_sides(ck, "200 levels (606 slots)",
                      [lvl.cols for lvl in probe_ladder], q.cols)
    bids = bids_row(40)
    wide = [consolidated(rng, 20, 32, dev, nk=1, spec=bids)
            for _ in range(100)]
    delta = consolidated(rng, 60, 64, dev, nk=1, spec=bids)
    for out_cap in (1 << 14, 64):
        ck.check("join_ladder", f"100 levels (707 slots) out_cap {out_cap}",
                 JOIN, ck_mod.join_ladder_plain,
                 delta.keys, delta.weights, wide, 1, out_cap)
        ck.check("gather_ladder", f"100 levels (707 slots) {out_cap}",
                 GATHER, ck_mod.gather_ladder_plain,
                 delta.keys, delta.weights != 0, wide, out_cap)
    if ck_mod._ArgBlock(dev, 606, "check").by_value:
        fail("a 606-slot launch did not take the device table")
    # the device table's upload (pinned host copy, asynchronous) must not
    # make the host wait: compiled distinct's probe may cross ARGS_MAX
    tables = [lvl.cols for lvl in probe_ladder]
    torch.cuda.synchronize()
    found = sync_warnings(lambda: ck_mod.lex_probe_ladder_both(tables,
                                                               q.cols))
    if found:
        fail(f"a probe over 606 argument slots synced the host: {found}")
    say("lex probe over 200 levels (606 argument slots, a device table): "
        "0 host syncs under torch.cuda.set_sync_debug_mode('warn')")


def sync_warnings(fn) -> list:
    """The host syncs ``fn`` makes on the card, as the warnings of
    torch.cuda.set_sync_debug_mode("warn") (its one-time prototype notice
    left out)."""
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return [str(w.message)[:160] for w in caught
            if "ynchroniz" in str(w.message)
            and SYNC_NOTICE not in str(w.message)]


def launch_checked(name: str, entry: str | None = None):
    """``cuda_kernels.<entry>`` (``entry`` defaults to ``name``), failing
    unless the call launched kernel ``name`` once and no other kernel."""
    def call(*args, **kw):
        from dbsp_tpu_torch.zset import cuda_kernels as ck_mod

        before = dict(ck_mod.LAUNCHES)
        out = getattr(ck_mod, entry or name)(*args, **kw)
        got = {k: n - before[k] for k, n in ck_mod.LAUNCHES.items()
               if n != before[k]}
        if got != {name: 1}:
            fail(f"{entry or name} launched {got}, want {{{name!r}: 1}}")
        return out

    return call


JOIN, GATHER, AGG = (launch_checked(name) for name in
                     ("join_ladder", "gather_ladder", "agg_ladder"))


def narrow_ladder(rng, dev, key_dts, val_dts, w_dt, caps, key_range,
                  hot=None):
    """Levels of random consolidated rows whose key columns, value columns
    and weights are stored as ``key_dts``, ``val_dts`` and ``w_dt`` (dead
    rows keep each dtype's sentinel); ``hot`` = (key, rows per level)
    adds that many rows of one key to every level."""
    import torch

    from dbsp_tpu_torch.zset import kernels
    from dbsp_tpu_torch.zset.batch import Batch

    nk = len(key_dts)
    spec = ((0, key_range, np.int64),) * nk + \
        ((-100, 100, np.int64),) * len(val_dts)
    out = []
    for n, cap in caps:
        extra = ()
        if hot is not None:
            extra = [np.full(hot[1], hot[0], np.int64) for _ in range(nk)] + \
                [rng.integers(-100, 100, hot[1]) for _ in val_dts]
        b = consolidated(rng, n, cap, dev, nk=nk, spec=spec, extra=extra)
        live = b.weights != 0

        def cast(c, dt):
            return torch.where(live, c, 0).to(dt).masked_fill(
                ~live, kernels.sentinel_scalar(dt))

        out.append(Batch(tuple(cast(c, dt) for c, dt in zip(b.keys, key_dts)),
                         tuple(cast(c, dt) for c, dt in zip(b.vals, val_dts)),
                         b.weights.to(w_dt), runs=b.runs))
    return out


def check_consumer_cases(ck: Checker, rng, dev) -> None:
    """The ladder consumer (csrc/ladder_consumer.cu) on narrow columns of
    every width, hot keys whose ranges span many expansion tiles, ladders
    where every range is empty (total 0), and out_cap below the total at
    and around a tile's edge; each call its one launch."""
    import torch

    from dbsp_tpu_torch.zset import cuda_kernels as ck_mod

    tile = ck_mod.LADDER_TILE

    def both(what, ladder, delta_keys, delta_w, nk, out_caps, qhi=None):
        totals = []
        for out_cap in out_caps:
            got = ck.check("join_ladder", f"{what} out_cap {out_cap}", JOIN,
                           ck_mod.join_ladder_plain, delta_keys, delta_w,
                           ladder, nk, out_cap)
            totals.append(int(got[-1]))
            for mode, kw in (("equal", {}), ("range", {"qhi_keys": qhi}),
                             ("gather_keys", {"gather_keys": nk})):
                if mode == "range" and qhi is None:
                    continue
                ck.check("gather_ladder", f"{what} {mode} out_cap {out_cap}",
                         GATHER, ck_mod.gather_ladder_plain, delta_keys,
                         delta_w != 0, ladder, out_cap, **kw)
        return totals

    i8, i16, i32, i64 = torch.int8, torch.int16, torch.int32, torch.int64
    u8, b1 = torch.uint8, torch.bool
    # narrow columns: (keys, values, level weights, query keys, delta w)
    for key_dts, val_dts, w_dt, q_dts, dw_dt, kr in (
            ((i32,), (i8, i16, i32, b1, u8), i32, (i32,), i16, 40),
            ((i16, i16), (i64,), i64, (i64, i64), i64, 9),
            ((i8,), (b1, i8), i8, (i8,), i8, 30),
            ((b1, i64), (i16, u8), i16, (b1, i32), i32, 2)):
        ladder = narrow_ladder(rng, dev, key_dts, val_dts, w_dt,
                               ((60, 64), (20, 32), (5, 8)), kr)
        d = narrow_ladder(rng, dev, q_dts, (), dw_dt, ((25, 32),), kr)[0]
        qhi = tuple(torch.clamp(k.to(i64) + torch.from_numpy(
            rng.integers(-1, 3, d.cap)).to(dev), max=torch.iinfo(k.dtype).max
            if k.dtype != b1 else 1).to(k.dtype) for k in d.keys)
        what = (f"keys {[str(t)[6:] for t in key_dts]} vals "
                f"{[str(t)[6:] for t in val_dts]} w {str(w_dt)[6:]} queries "
                f"{[str(t)[6:] for t in q_dts]} dw {str(dw_dt)[6:]}")
        both(what, ladder, d.keys, d.weights, len(key_dts), (512, 5), qhi)
    # hot keys: one key with 9,000 and 3,000 rows in two levels, so its
    # ranges span ~12 tiles; out_cap at, under and over tile edges
    bids = bids_row(300)
    ladder = [narrow_ladder(rng, dev, (i64,), (i64, i64, i32, i64), i64,
                            ((n, cap),), 300, hot=(7, hot))[0]
              for n, cap, hot in ((6_000, 1 << 14, 9_000),
                                  (2_000, 1 << 13, 3_000))]
    # three live queries of the hot key (distinct rows, so none cancels)
    d = consolidated(rng, 400, 512, dev, nk=1, spec=bids,
                     extra=[np.full(3, 7, np.int64)] +
                     [np.arange(3).astype(dt) for _, _, dt in bids[1:]])
    total = int(ck_mod.join_ladder_plain(d.keys, d.weights, ladder, 1,
                                         1 << 16)[4])
    if total < 4 * tile:
        fail(f"the hot-key ladder matched only {total} rows")
    qhi = (d.keys[0] + 2,)
    both(f"hot key (total {total})", ladder, d.keys, d.weights, 1,
         (1 << 16, 3 * tile, 3 * tile - 1, 3 * tile + 1, tile, total - 1,
          total, total + 1), qhi)
    # every range empty: queries outside the levels' keys, then all dead
    far = consolidated(rng, 40, 64, dev, nk=1, spec=((1000, 2000, np.int64),
                                                     *bids[1:]))
    for what, dw in (("queries past every key", far.weights),
                     ("every query dead", torch.zeros_like(d.weights))):
        keys = far.keys if dw is far.weights else d.keys
        totals = both(what, ladder, keys, dw, 1, (64, 1))
        if any(totals):
            fail(f"{what}: total {totals}, want 0")


def check_range_gather_keys(ck: Checker, rng, dev) -> int:
    """The ladder gather with distinct upper bounds AND the trailing key
    column gathered back (``qhi_keys`` with ``gather_keys=1``), as the
    rolling aggregate and the radix tree call it: (p, t)-keyed levels
    without value columns (the rolling aggregate's key-only levels) and
    with one and two; live queries with empty ranges (qhi < qlo) and
    ranges reaching below time 0; dead queries whose bounds cover live
    rows, or wrapped past int64 (a sentinel row's t + range, or the
    padding's sentinel - range), which must gather nothing; out_cap
    roomy, at the total, one under it and tiny. Returns the cases."""
    import torch

    from dbsp_tpu_torch.zset import cuda_kernels as ck_mod
    from dbsp_tpu_torch.zset.batch import Batch

    big = torch.iinfo(torch.int64).max
    n0 = ck.cases["gather_ladder"]
    m = 700
    for nv in (0, 1, 2):
        spec = ((0, 40, np.int64), (0, 5_000, np.int64)) + \
            ((-100, 100, np.int64),) * nv
        ladder = [consolidated(rng, n, cap, dev, nk=2, spec=spec)
                  for n, cap in ((3_000, 4096), (700, 1024), (60, 64))]
        qp = torch.from_numpy(rng.integers(0, 40, m)).to(dev)
        qlo = torch.from_numpy(rng.integers(-600, 5_000, m)).to(dev)
        # widths below 0 make empty ranges
        qhi = qlo + torch.from_numpy(rng.integers(-60, 900, m)).to(dev)
        live = torch.from_numpy(rng.random(m) < 0.7).to(dev)
        # dead queries: a third wrapped past int64 above, a third at the
        # padding's (sentinel - range, sentinel), the rest plain bounds
        kind = torch.from_numpy(rng.integers(0, 3, m)).to(dev)
        sent = torch.full_like(qp, big)
        wrap = ~live & (kind == 0)
        pad = ~live & (kind == 1)
        qp = torch.where(wrap | pad, sent, qp)
        qlo = torch.where(wrap, sent, torch.where(pad, sent - 900, qlo))
        qhi = torch.where(wrap, sent + 900, torch.where(pad, sent, qhi))
        if not bool((qhi[wrap] < 0).all()):
            fail("range gather: the wrapped bounds did not wrap")
        args = ((qp, qlo), live, ladder)
        kw = {"qhi_keys": (qp, qhi), "gather_keys": 1}
        total = int(ck_mod.gather_ladder_plain(*args, 1 << 16, **kw)[1])
        if total < 1_000:
            fail(f"range gather over {nv} value columns matched only "
                 f"{total} rows")
        for out_cap in (1 << 16, total, total - 1, 7):
            ck.check("gather_ladder", f"range + gather_keys, {nv} value "
                     f"columns, out_cap {out_cap}", GATHER,
                     ck_mod.gather_ladder_plain, *args, out_cap, **kw)
        # every query dead, the wrapped ones included: nothing gathered
        none = ck.check("gather_ladder", f"range + gather_keys, {nv} value "
                        "columns, every query dead", GATHER,
                        ck_mod.gather_ladder_plain, args[0],
                        torch.zeros_like(live), ladder, 64, **kw)
        if int(none[-1]):
            fail(f"range gather: dead queries gathered {int(none[-1])} "
                 "rows")
        if nv:
            # the same levels stripped of their values: key-only levels
            key_only = [Batch(b.keys, (), b.weights) for b in ladder]
            ck.check("gather_ladder", f"range + gather_keys, key-only "
                     f"levels of {nv}", GATHER, ck_mod.gather_ladder_plain,
                     args[0], live, key_only, 1 << 16, **kw)
    return ck.cases["gather_ladder"] - n0


def netting_ladder(rng, dev):
    """Levels whose rows cancel across levels: the second retracts some
    rows of the first, the third re-inserts some of those."""
    from dbsp_tpu_torch.zset.batch import Batch

    spec = ((0, 6, np.int64),) * 3
    base = consolidated(rng, 40, 64, dev, spec=spec)
    n = int((base.weights != 0).sum())
    cols = [c[:n].cpu().numpy() for c in base.cols]
    w = base.weights[:n].cpu().numpy()
    sel = rng.random(n) < 0.5
    back = Batch.from_columns([c[sel] for c in cols[:2]], [cols[2][sel]],
                              -w[sel], cap=64, device=dev)
    again = Batch.from_columns([c[sel][::2] for c in cols[:2]],
                               [cols[2][sel][::2]],
                               np.ones(len(w[sel][::2]), np.int64), cap=32,
                               device=dev)
    return [base, back, again]


class SpecAgg:
    """A spec-only aggregator: ``spec`` as given, int64 outputs."""

    def __init__(self, spec):
        import torch

        self.spec = tuple(spec)
        self.out_dtypes = (torch.int64,) * len(self.spec)

    def reduce_spec(self):
        return self.spec


AGG_OPS = (("count", 0), ("sum", 0), ("min", 0), ("max", 0), ("avg", 0),
           ("present", 0))


def narrowed(b, dtype):
    """Batch ``b`` with its key columns and weights stored as ``dtype``
    (dead rows keep that dtype's sentinel)."""
    import torch

    from dbsp_tpu_torch.zset.batch import Batch

    live = b.weights != 0
    top = torch.iinfo(dtype).max
    return Batch(tuple(torch.where(live, k, top).to(dtype) for k in b.keys),
                 b.vals, b.weights.to(dtype), runs=b.runs)


def signed(b, by=3):
    """Batch ``b`` with its live rows' values shifted down by ``by``."""
    from dbsp_tpu_torch.zset.batch import Batch

    live = b.weights != 0
    return Batch(b.keys, tuple(v.where(~live, v - by) for v in b.vals),
                 b.weights, runs=b.runs)


def dead_row_case(rng, dev):
    """A delta with a zero-weight row between two live rows of one key and
    one just ahead of a key's first live row, with its ladder and out
    trace."""
    import torch

    from dbsp_tpu_torch.zset.batch import Batch

    k0 = [1, 1, 2, 2, 2, 3, 4, 4]
    k1 = [1, 1, 5, 5, 5, 0, 2, 2]
    v = [4, 7, 1, 3, 8, 2, 5, 6]
    w = [0, 2, 1, 0, -1, 3, 2, 0]
    top = np.iinfo(np.int64).max

    def pad(c, fill):
        return torch.tensor(c + [fill] * (16 - len(c)), device=dev)

    delta = Batch((pad(k0, top), pad(k1, top)), (pad(v, top),), pad(w, 0),
                  runs=(16,))
    extra = Batch.from_columns([np.array(k0[1:6]), np.array(k1[1:6])],
                               [np.full(5, 9)], np.array([1, 2, -1, 1, 3]),
                               cap=8, device=dev)
    out_trace = Batch.from_columns([np.array([1, 2, 2, 3]),
                                    np.array([1, 5, 5, 0])],
                                   [np.array([40, 10, 12, 5])],
                                   np.array([1, 1, -1, 1]), cap=8, device=dev)
    return ([consolidated(rng, 30, 64, dev, key_range=6), extra], delta,
            out_trace)


def agg_cases(rng, dev):
    """``(name, ladder, delta, out_trace, spec, modes)`` for the aggregate
    chain: the adversarial ladders, a netting ladder and a cap-0 level
    (Max), zero value columns (a count), an out trace with several rows
    per key, zero-weight rows in the delta, an all-retraction delta, int32
    keys and weights, 90 levels (the device argument table), every op of
    the vocabulary on signed values, and deltas of several tiles against
    q_cap over several blocks' query slots (a multi-block grid)."""
    from dbsp_tpu_torch.zset.batch import Batch

    small = ((True, False, 16, 512), (True, True, 16, 512),
             (False, True, 16, 512), (True, True, 4, 8),
             (False, True, 4, 8), (True, False, 4, 8))
    mx = (("max", 0),)
    spec3 = ((0, 6, np.int64),) * 3
    ladders = list(adversarial_ladders(rng, dev))
    ladders.append(netting_ladder(rng, dev))
    ladders.append([ladders[0][0], empty_level(dev), ladders[0][2]])
    for li, ladder in enumerate(ladders):
        yield (f"ladder {li}", ladder,
               consolidated(rng, 20, 32, dev, spec=spec3),
               consolidated(rng, 10, 16, dev, spec=spec3), mx, small)
    net = ladders[3]
    yield ("zero value columns",
           [consolidated(rng, 40, 64, dev, nv=0, key_range=6),
            consolidated(rng, 12, 16, dev, nv=0, key_range=6)],
           consolidated(rng, 20, 32, dev, nv=0, key_range=6),
           consolidated(rng, 10, 16, dev, key_range=6), (("count", 0),),
           small)
    yield ("out trace with several rows per key", net,
           consolidated(rng, 20, 32, dev, key_range=3),
           consolidated(rng, 14, 16, dev, key_range=3), mx, small)
    yield ("zero-weight rows in the delta", *dead_row_case(rng, dev), mx,
           small)
    d = consolidated(rng, 20, 32, dev, key_range=6)
    yield ("all retractions", net,
           Batch(d.keys, d.vals, -d.weights.abs(), runs=d.runs),
           consolidated(rng, 10, 16, dev, key_range=6), mx, small)
    import torch

    yield ("int32 keys and weights",
           [narrowed(b, torch.int32) for b in net],
           narrowed(consolidated(rng, 20, 32, dev, key_range=6),
                    torch.int32),
           narrowed(consolidated(rng, 10, 16, dev, key_range=6),
                    torch.int32), mx, small)
    yield ("90 levels (argument table)",
           [consolidated(rng, 3, 4, dev, key_range=4) for _ in range(90)],
           consolidated(rng, 12, 16, dev, key_range=4),
           consolidated(rng, 8, 16, dev, key_range=4), mx, small)
    for spec in ((("min", 0),), (("count", 0),), (("sum", 0),),
                 (("avg", 0),), AGG_OPS):
        yield (f"ops {[op for op, _ in spec]}",
               [signed(b) for b in net],
               signed(consolidated(rng, 20, 32, dev, key_range=6)),
               consolidated(rng, 10, 16, dev, nv=len(spec), key_range=6),
               spec, small[1:5])
    # several tiles and blocks; four hot groups of ~1,250 rows each
    hot = ((0, 2, np.int64),) * 2 + ((0, 100_000, np.int64),)
    for n, cap, kr, row in ((3_000, 1 << 12, 60, None),
                            (20_000, 1 << 15, 200, None),
                            (5_000, 1 << 13, 2, hot)):
        big = (True, False, cap, 64), (True, True, cap, 1 << 17), \
            (False, True, cap // 4, 3_000), (True, True, 256, 100)
        ladder = [consolidated(rng, k, c, dev, key_range=kr, spec=row)
                  for k, c in ((6 * n, 8 * cap), (n, 2 * cap), (50, 64))]
        d = consolidated(rng, n, cap, dev, key_range=kr, spec=row)
        for spec in (mx, AGG_OPS):
            yield (f"{n}-row delta, key range {kr}, "
                   f"{[op for op, _ in spec]}", ladder, d,
                   consolidated(rng, n // 2, cap, dev, nv=len(spec),
                                key_range=kr), spec, big)


def check_agg_ladder(ck: Checker, rng, dev) -> None:
    """agg_ladder against agg_ladder_plain on ``agg_cases``, each with the
    fast path's gate off and on, the general path and caps under the
    unclamped totals (the small caps must overflow); the kernel must be
    the call's one launch."""
    import torch

    from dbsp_tpu_torch.zset import cuda_kernels as ck_mod

    overflow = 0
    for name, ladder, delta, out_trace, spec, modes in agg_cases(rng, dev):
        for fast, flag, q_cap, g_cap in modes:
            got = ck.check("agg_ladder", f"{name}: fast {fast} gate {flag} "
                           f"caps {q_cap}/{g_cap}", AGG,
                           ck_mod.agg_ladder_plain, delta, 2, out_trace,
                           ladder, SpecAgg(spec), q_cap, g_cap, fast,
                           torch.tensor(flag, device=dev))
            # flat outputs: qkeys, qlive, nq, ..., the gather total
            nq, gtot = int(got[len(delta.keys) + 1]), int(got[-1])
            overflow += nq > q_cap or gtot > g_cap
    if not overflow:
        fail("no agg_ladder case overflowed its caps: the clamp went "
             "unchecked")


def check_kernels(ck: Checker, dev) -> None:
    import torch

    from dbsp_tpu_torch.zset import cuda_kernels as ck_mod

    rng = np.random.default_rng(2024)
    # -- ladder consumers: adversarial ladders, roomy and overflowing caps
    for li, ladder in enumerate(adversarial_ladders(rng, dev)):
        delta = consolidated(rng, 20, 32, dev)
        for out_cap in (1024, 4):
            ck.check("join_ladder", f"ladder {li} out_cap {out_cap}",
                     JOIN, ck_mod.join_ladder_plain,
                     delta.keys, delta.weights, ladder, 2, out_cap)
            qlive = delta.weights != 0
            qhi = tuple(k + torch.from_numpy(
                rng.integers(-2, 4, delta.cap)).to(dev) for k in delta.keys)
            for mode, kw in (("equal", {}), ("range", {"qhi_keys": qhi}),
                             ("gather_keys", {"gather_keys": 2})):
                ck.check("gather_ladder", f"ladder {li} {mode} {out_cap}",
                         GATHER, ck_mod.gather_ladder_plain,
                         delta.keys, qlive, ladder, out_cap, **kw)
    # -- the same with no gathered column (ng = 0): q8's auction side
    for li in range(2):
        ladder = [consolidated(rng, max(2, c // 3), c, dev, nv=0)
                  for c in ((64, 32), (256, 64, 16))[li]]
        delta = consolidated(rng, 20, 32, dev, nv=0)
        for out_cap in (1024, 4):
            ck.check("join_ladder", f"ng 0 ladder {li} out_cap {out_cap}",
                     JOIN, ck_mod.join_ladder_plain,
                     delta.keys, delta.weights, ladder, 2, out_cap)
            ck.check("gather_ladder", f"ng 0 ladder {li} {out_cap}",
                     GATHER, ck_mod.gather_ladder_plain,
                     delta.keys, delta.weights != 0, ladder, out_cap)
    # q8-sized: a persons delta against the auctions-by-(seller, window)
    # trace, which has no value column
    a_row = Q8_ROW[:2]
    ladder = [consolidated(rng, n, cap, dev, spec=a_row)
              for n, cap in ((120_000, 1 << 17), (30_000, 1 << 15),
                             (6_000, 1 << 13))]
    delta = consolidated(rng, 2_000, 1 << 11, dev, spec=Q8_ROW)
    ck.check("join_ladder", "q8-sized ng 0", JOIN,
             ck_mod.join_ladder_plain, delta.keys, delta.weights, ladder, 2,
             1 << 14)
    check_lex_probe(ck, rng, dev)
    check_probe_runs(ck, rng, dev)
    check_cap0_and_wide(ck, rng, dev)
    check_consumer_cases(ck, rng, dev)
    ck.range_gather_keys = check_range_gather_keys(ck, rng, dev)
    check_agg_ladder(ck, rng, dev)
    # -- q4-sized ladder: bids-schema levels up to 2M rows, 100k delta
    bids = bids_row(60_000)
    big = [consolidated(rng, n, cap, dev, nk=1, spec=bids)
           for n, cap in ((1_900_000, 1 << 21), (400_000, 1 << 19),
                          (90_000, 1 << 17))]
    delta = consolidated(rng, 92_000, 1 << 17, dev, nk=1, spec=bids)
    total = int(ck_mod.join_ladder_plain(delta.keys, delta.weights, big, 1,
                                         1 << 20)[4])
    for out_cap in (1 << 23, total // 2):
        ck.check("join_ladder", f"q4-sized out_cap {out_cap} total {total}",
                 JOIN, ck_mod.join_ladder_plain,
                 delta.keys, delta.weights, big, 1, out_cap)
        ck.check("gather_ladder", f"q4-sized out_cap {out_cap}",
                 GATHER, ck_mod.gather_ladder_plain,
                 delta.keys, delta.weights != 0, big, out_cap)
    # -- segment reduce: random ids, then runs
    for n, S in ((1, 1), (64, 7), (500, 130), (300, 3), (2_000_000, 100_000)):
        vals, w, seg = seg_case(rng, n, S, dev)
        ck.check("segment_reduce", f"n {n} segments {S}",
                 ck_mod.segment_reduce, ck_mod.segment_reduce_plain,
                 SPEC, vals, w, seg, S, seg_out_dtypes(SPEC, vals, w))
    check_segment_runs(ck, rng, dev)
    # -- rank merge: duplicates, sentinel tails, full capacity, empty side
    from dbsp_tpu_torch.zset.batch import Batch

    pairs = [(consolidated(rng, int(rng.integers(0, 50)), 64, dev, nk=1,
                           key_range=12),
              consolidated(rng, int(rng.integers(0, 100)), 128, dev, nk=1,
                           key_range=12)) for _ in range(4)]
    ones = torch.ones(16, dtype=torch.int64)
    pairs.append((Batch.from_columns([torch.arange(0, 16)], [], ones,
                                     cap=16, device=dev, consolidated=True),
                  Batch.from_columns([torch.arange(8, 24)], [], -ones,
                                     cap=16, device=dev, consolidated=True)))
    pairs.append((Batch.empty((torch.int64,), (torch.int32,), cap=8,
                              device=dev),
                  Batch.from_columns([torch.tensor([3, 1, 3])],
                                     [torch.tensor([2, 7, -1],
                                                   dtype=torch.int32)],
                                     torch.tensor([1, 2, 3]), cap=8,
                                     device=dev)))
    pairs.append((big[0], big[1]))  # 2M + 512k rows, bids schema
    for i, (a, b) in enumerate(pairs):
        ck.check("rank_merge", f"pair {i} ({a.cap} + {b.cap})",
                 ck_mod.rank_merge_scatter, ck_mod.rank_merge_scatter_plain,
                 a.cols, a.weights, b.cols, b.weights)
    check_merge_tiles(ck, rng, dev)


# ---------------------------------------------------------------------------
# Queries
# ---------------------------------------------------------------------------


def q4_oracle(cols) -> dict:
    """Batch recomputation of q4 over all events (numpy): per auction the
    max price of the bids inside [date_time, expires], then per category
    the truncated average of those maxima."""
    a, b = cols["auctions"], cols["bids"]
    pos = np.clip(np.searchsorted(a["id"], b["auction"]), 0,
                  len(a["id"]) - 1)
    exists = a["id"][pos] == b["auction"]
    ts = b["date_time"]
    ok = exists & (a["date_time"][pos] <= ts) & (ts <= a["expires"][pos])
    aids, inv = np.unique(b["auction"][ok], return_inverse=True)
    best = np.zeros(len(aids), np.int64)
    np.maximum.at(best, inv, b["price"][ok])
    cat = a["category"][np.searchsorted(a["id"], aids)]
    out = {}
    for c in np.unique(cat):
        ps = best[cat == c]
        out[(int(c), int(ps.sum()) // len(ps))] = 1
    return out


def accumulate(acc: dict, delta: dict) -> None:
    for r, w in delta.items():
        acc[r] = acc.get(r, 0) + w
        if acc[r] == 0:
            del acc[r]


def q3_oracle(cols) -> dict:
    """Sellers in the q3 states with auctions in category 10: (auction id,
    name, city, state) per matching auction."""
    from dbsp_tpu_torch.nexmark.queries import Q3_CATEGORY, Q3_STATES

    p, a = cols["persons"], cols["auctions"]
    keep = np.isin(p["state"], Q3_STATES)
    sellers = dict(zip(p["id"][keep].tolist(),
                       zip(p["name"][keep].tolist(), p["city"][keep].tolist(),
                           p["state"][keep].tolist())))
    cat = a["category"] == Q3_CATEGORY
    return {(aid, *sellers[s]): 1 for aid, s in
            zip(a["id"][cat].tolist(), a["seller"][cat].tolist())
            if s in sellers}


def q8_oracle(cols) -> dict:
    """(person id, window start, name) of every person who created an
    auction in the 10 s window they registered in."""
    from dbsp_tpu_torch.nexmark.queries import Q8_WINDOW_MS as W

    p, a = cols["persons"], cols["auctions"]
    opened = set(zip(a["seller"].tolist(),
                     (a["date_time"] // W * W).tolist()))
    return {(pid, w, name): 1 for pid, w, name in
            zip(p["id"].tolist(), (p["date_time"] // W * W).tolist(),
                p["name"].tolist()) if (pid, w) in opened}


def q15_oracle(cols) -> dict:
    """(day, number of distinct bidders that day)."""
    from dbsp_tpu_torch.nexmark.queries import DAY_MS

    b = cols["bids"]
    pairs = np.unique(np.stack([b["date_time"] // DAY_MS, b["bidder"]], 1),
                      axis=0)
    days, counts = np.unique(pairs[:, 0], return_counts=True)
    return {(int(d), int(c)): 1 for d, c in zip(days, counts)}


def count_rows(*cols) -> dict:
    """{row tuple: multiplicity} of the rows the columns make."""
    if not len(cols[0]):
        return {}
    rows, counts = np.unique(np.stack([np.asarray(c, np.int64)
                                       for c in cols], 1),
                             axis=0, return_counts=True)
    return {tuple(r): int(c) for r, c in zip(rows.tolist(), counts.tolist())}


def bid_cols(cols):
    b = cols["bids"]
    return b["auction"], b["bidder"], b["price"], b["channel"], b["date_time"]


def q0_oracle(cols) -> dict:
    """Every bid, as it came."""
    return count_rows(*bid_cols(cols))


def q1_oracle(cols) -> dict:
    """Every bid with its price in milli-euros (price * 908 // 1000)."""
    auction, bidder, price, channel, ts = bid_cols(cols)
    return count_rows(auction, bidder, price * 908 // 1000, channel, ts)


def q2_oracle(cols) -> dict:
    """(auction, price) of the bids on auctions whose id is a multiple of
    123."""
    auction, _, price, _, _ = bid_cols(cols)
    keep = auction % 123 == 0
    return count_rows(auction[keep], price[keep])


def q12_oracle(cols) -> dict:
    """(bidder, window, bids) per bidder per processing-time window of 10
    ticks: a tick holds EVENTS_PER_TICK events, 46 of each 50 of them
    bids, in event order."""
    from dbsp_tpu_torch.nexmark import model as M
    from dbsp_tpu_torch.nexmark.queries import Q12_WINDOW_TICKS

    bidder = cols["bids"]["bidder"]
    per_tick = EVENTS_PER_TICK // M.PROPORTION_DENOMINATOR * M.BID_PROPORTION
    window = np.arange(len(bidder)) // per_tick // Q12_WINDOW_TICKS
    return {(*r, n): 1 for r, n in count_rows(bidder, window).items()}


def q13_oracle(cols) -> dict:
    """Every bid joined with the side table channel -> 1000 + channel:
    (auction, bidder, price, date_time, side value)."""
    auction, bidder, price, channel, ts = bid_cols(cols)
    keep = (channel >= 0) & (channel < 16)
    return count_rows(auction[keep], bidder[keep], price[keep], ts[keep],
                      1000 + channel[keep])


def q14_oracle(cols) -> dict:
    """Bids over 1M milli-euros: (auction, bidder, eur, time of day class,
    date_time); class 0 = [8, 18) h, 1 = [0, 6) | [20, 24) h, 2 = other."""
    auction, bidder, price, _, ts = bid_cols(cols)
    eur = price * 908 // 1000
    hour = ts // 3_600_000 % 24
    kind = np.where((hour >= 8) & (hour < 18), 0,
                    np.where((hour < 6) | (hour >= 20), 1, 2))
    keep = eur > 1_000_000
    return count_rows(auction[keep], bidder[keep], eur[keep], kind[keep],
                      ts[keep])


def q17_oracle(cols) -> dict:
    """(auction, day, count, min, max, truncated average) of the bid
    prices per auction per day."""
    from dbsp_tpu_torch.nexmark.queries import DAY_MS

    auction, _, price, _, ts = bid_cols(cols)
    keys = np.stack([auction, ts // DAY_MS], 1)
    uniq, inv = np.unique(keys, axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    n = len(uniq)
    cnt = np.bincount(inv, minlength=n)
    total = np.zeros(n, np.int64)
    np.add.at(total, inv, price)
    lo = np.full(n, np.iinfo(np.int64).max)
    np.minimum.at(lo, inv, price)
    hi = np.full(n, np.iinfo(np.int64).min)
    np.maximum.at(hi, inv, price)
    avg = np.where(total >= 0, total // cnt, -((-total) // cnt))
    return {(*k, c, a, b, v): 1 for k, c, a, b, v in zip(
        uniq.tolist(), cnt.tolist(), lo.tolist(), hi.tolist(),
        avg.tolist())}


def q20_oracle(cols) -> dict:
    """Bids on category-10 auctions with the auction's item and seller:
    (auction, bidder, price, item, seller)."""
    from dbsp_tpu_torch.nexmark.queries import Q3_CATEGORY

    a = cols["auctions"]
    auction, bidder, price, _, _ = bid_cols(cols)
    cat = a["category"] == Q3_CATEGORY
    ids, item, seller = a["id"][cat], a["item"][cat], a["seller"][cat]
    pos = np.clip(np.searchsorted(ids, auction), 0, max(len(ids) - 1, 0))
    keep = (ids[pos] == auction) if len(ids) else np.zeros(len(auction),
                                                           bool)
    return count_rows(auction[keep], bidder[keep], price[keep],
                      item[pos][keep], seller[pos][keep])


def q21_oracle(cols) -> dict:
    """(auction, bidder, price, channel, channel id): the channel id is
    taken over the decoded strings, as the query's CASE and regex."""
    from dbsp_tpu_torch.nexmark import strings

    auction, bidder, price, channel, _ = bid_cols(cols)
    ids = {c: strings.channel_id_of(c) for c in np.unique(channel).tolist()}
    chan_id = np.array([ids[c] for c in channel.tolist()], np.int64)
    return count_rows(auction, bidder, price, channel, chan_id)


def q22_oracle(cols) -> dict:
    """(auction, bidder, price, dir1, dir2, dir3): the directories split
    out of the decoded URL string."""
    from dbsp_tpu_torch.nexmark import strings

    auction, bidder, price, channel, _ = bid_cols(cols)
    dirs = {c: [int(d[1:]) for d in strings.url_dirs_of(c)]
            for c in np.unique(channel).tolist()}
    d = np.array([dirs[c] for c in channel.tolist()], np.int64).reshape(-1, 3)
    return count_rows(auction, bidder, price, d[:, 0], d[:, 1], d[:, 2])


def last_of_groups(group, k: int):
    """For rows sorted by ``group`` (and within a group ascending): the
    mask of each group's last ``k`` rows."""
    n = len(group)
    if not n:
        return np.zeros(0, bool)
    starts = np.r_[0, np.flatnonzero(group[1:] != group[:-1]) + 1]
    ends = np.r_[starts[1:], n]
    end_of_row = np.repeat(ends, ends - starts)
    return end_of_row - np.arange(n) <= k


def winning_bids(cols):
    """The winning bid of every auction over all events, as q9 defines
    it: among the bids inside [date_time, expires] of their auction the
    largest (price, -date_time, bidder). Returns the columns (auction,
    price, date_time, bidder, seller, expires), one row per auction."""
    a = cols["auctions"]
    auction, bidder, price, _, ts = bid_cols(cols)
    pos = np.clip(np.searchsorted(a["id"], auction), 0, len(a["id"]) - 1)
    ok = (a["id"][pos] == auction) & (a["date_time"][pos] <= ts) \
        & (ts <= a["expires"][pos])
    auction, bidder, price, ts, pos = (c[ok] for c in (auction, bidder,
                                                       price, ts, pos))
    order = np.lexsort((bidder, -ts, price, auction))
    win = order[last_of_groups(auction[order], 1)]
    return (auction[win], price[win], ts[win], bidder[win],
            a["seller"][pos[win]], a["expires"][pos[win]])


def q9_oracle(cols) -> dict:
    """(auction, price, date_time, bidder) of each auction's winning
    bid."""
    auction, price, ts, bidder, _, _ = winning_bids(cols)
    return count_rows(auction, price, ts, bidder)


def q6_oracle(cols) -> dict:
    """(seller, truncated average price) over each seller's 10 winning
    bids of the latest (expires, auction)."""
    auction, price, _, _, seller, expires = winning_bids(cols)
    order = np.lexsort((price, auction, expires, seller))
    keep = order[last_of_groups(seller[order], 10)]
    sellers, inv = np.unique(seller[keep], return_inverse=True)
    inv = inv.reshape(-1)
    total = np.zeros(len(sellers), np.int64)
    np.add.at(total, inv, price[keep])
    n = np.bincount(inv, minlength=len(sellers))
    avg = np.where(total >= 0, total // n, -((-total) // n))
    return {(s, v): 1 for s, v in zip(sellers.tolist(), avg.tolist())}


def q18_oracle(cols) -> dict:
    """(bidder, date_time, auction, price) of each bidder's largest
    (date_time, auction, price) bid."""
    auction, bidder, price, _, ts = bid_cols(cols)
    order = np.lexsort((price, auction, ts, bidder))
    last = order[last_of_groups(bidder[order], 1)]
    return count_rows(bidder[last], ts[last], auction[last], price[last])


def q19_oracle(cols) -> dict:
    """(auction, price, date_time, bidder) of each auction's 10 largest
    distinct (price, date_time, bidder) bids."""
    auction, bidder, price, _, ts = bid_cols(cols)
    rows = np.unique(np.stack([auction, price, ts, bidder], 1), axis=0)
    rows = rows[last_of_groups(rows[:, 0], 10)]
    return {tuple(r): 1 for r in rows.tolist()}


def q16_oracle(cols) -> dict:
    """(channel, day) -> bids, distinct bidders and distinct auctions, in
    all and per price rank (< Q16_RANK1, < Q16_RANK2, the rest)."""
    from dbsp_tpu_torch.nexmark.queries import DAY_MS, Q16_RANK1, Q16_RANK2

    auction, bidder, price, channel, ts = bid_cols(cols)
    rank = np.where(price < Q16_RANK1, 1, np.where(price < Q16_RANK2, 2, 3))
    key = np.stack([channel.astype(np.int64), ts // DAY_MS], 1)
    keys, kid = np.unique(key, axis=0, return_inverse=True)
    kid = kid.reshape(-1)
    stats = np.zeros((len(keys), 12), np.int64)
    for base, col in ((0, None), (4, bidder), (8, auction)):
        for r in range(4):
            sel = np.ones(len(kid), bool) if r == 0 else rank == r
            ids = kid[sel]
            if col is not None:  # distinct (key, column) pairs
                ids = np.unique(np.stack([ids, col[sel]], 1), axis=0)[:, 0]
            stats[:, base + r] = np.bincount(ids, minlength=len(keys))
    return {(*k, *s): 1 for k, s in zip(keys.tolist(), stats.tolist())}


def q5_oracle(cols) -> dict:
    """(window start, auction) of the auctions with the most bids in each
    hopping window that the last watermark retains: every bid counts in
    the five 10 s windows that start at its 2 s hop and the four hops
    before, and a window is retired once it starts below the largest bid
    time less Q5_RETAIN_MS."""
    from dbsp_tpu_torch.nexmark.queries import (Q5_HOP_MS, Q5_RETAIN_MS,
                                                Q5_WINDOW_MS)

    auction, _, _, _, ts = bid_cols(cols)
    fan = Q5_WINDOW_MS // Q5_HOP_MS
    hop = ts // Q5_HOP_MS * Q5_HOP_MS
    starts = np.concatenate([hop - k * Q5_HOP_MS for k in range(fan)])
    auctions = np.tile(auction, fan)
    keep = starts >= int(ts.max()) - Q5_RETAIN_MS
    pairs, counts = np.unique(np.stack([starts[keep], auctions[keep]], 1),
                              axis=0, return_counts=True)
    if not len(pairs):
        return {}
    new = np.r_[True, pairs[1:, 0] != pairs[:-1, 0]]
    most = np.maximum.reduceat(counts, np.flatnonzero(new))
    win = counts == most[np.cumsum(new) - 1]
    return {(w, a): 1 for w, a in pairs[win].tolist()}


def q5_first_window(cols) -> int:
    """The earliest window start any bid counts in: a GC'd q5 trace that
    still holds it dropped nothing."""
    from dbsp_tpu_torch.nexmark.queries import Q5_HOP_MS, Q5_WINDOW_MS

    ts = bid_cols(cols)[4]
    return int(ts.min()) // Q5_HOP_MS * Q5_HOP_MS - Q5_WINDOW_MS + Q5_HOP_MS


def q7_oracle(cols) -> dict:
    """(end, max price) of the latest completed 10 s period: the bids in
    [end - 10 s, end), where end is the largest bid time floored to 10 s
    (empty if that period has no bid)."""
    from dbsp_tpu_torch.nexmark.queries import Q7_WINDOW_MS as W

    _, _, price, _, ts = bid_cols(cols)
    end = int(ts.max()) // W * W
    inside = (ts >= end - W) & (ts < end)
    return {(end, int(price[inside].max())): 1} if inside.any() else {}


# The rolling and range-join paths: no public Nexmark query uses a rolling
# aggregate or a band join, so these are the reference's own compiled test
# circuits (tests/test_compiled.py: _rolling_build, _range_join_build) over
# the Nexmark streams
ROLLING_RANGE_MS = 10_000
RANGE_JOIN_OFFSETS = (-2, 2)


def rolling_circuit(persons, auctions, bids):
    """A rolling 10 s Max of bid price per auction, keyed (auction,
    date_time): SQL's MAX(price) OVER (PARTITION BY auction ORDER BY
    date_time RANGE BETWEEN INTERVAL '10' SECOND PRECEDING AND CURRENT
    ROW). The host engine answers it from the radix tree, the compiled
    engine by window recompute."""
    import torch

    from dbsp_tpu_torch.nexmark import model as M
    from dbsp_tpu_torch.operators import Max

    keyed = bids.index_by(
        lambda k, v: (k[0], v[M.B_DATE]), (torch.int64, torch.int64),
        val_fn=lambda k, v: (v[M.B_PRICE],), val_dtypes=(torch.int64,),
        name="roll-key")
    return keyed.partitioned_rolling_aggregate(Max(0), ROLLING_RANGE_MS,
                                               name="roll-max")


def range_join_circuit(persons, auctions, bids):
    """Bids (auction, price) with the auctions (id, category) whose id
    lies within +-2 of the bid's auction: (auction, id, price,
    category)."""
    import torch

    from dbsp_tpu_torch.nexmark import model as M

    i64 = torch.int64
    b = bids.index_by(lambda k, v: (k[0],), (i64,),
                      val_fn=lambda k, v: (v[M.B_PRICE],), val_dtypes=(i64,),
                      name="rj-bids")
    a = auctions.index_by(lambda k, v: (k[0],), (i64,),
                          val_fn=lambda k, v: (v[M.A_CATEGORY],),
                          val_dtypes=(i64,), name="rj-aucs")
    return b.join_range(
        a, *RANGE_JOIN_OFFSETS,
        lambda lk, lv, rk, rv: ((lk[0],), (rk[0], lv[0], rv[0])),
        (i64,), (i64, i64, i64), name="rj")


CIRCUITS = {"rolling": rolling_circuit, "range_join": range_join_circuit}


def net_rows(rows: np.ndarray) -> np.ndarray:
    """Rows [n, columns + weight] netted: sorted by the columns, the
    weights of equal rows summed, zero-weight rows dropped."""
    if not len(rows):
        return rows
    r = rows[np.lexsort(rows[:, :-1].T[::-1])]
    starts = np.flatnonzero(np.r_[True, (r[1:, :-1] != r[:-1, :-1]).any(1)])
    w = np.add.reduceat(r[:, -1], starts)
    out = np.concatenate([r[starts, :-1], w[:, None]], 1)
    return out[w != 0]


def live_rows(b) -> np.ndarray:
    """The live rows of a batch as an int64 array [n, columns + weight],
    in the batch's order."""
    import torch

    if b is None:
        return np.zeros((0, 1), np.int64)
    live = b.weights != 0
    return torch.stack([c[live].to(torch.int64)
                        for c in (*b.cols, b.weights)], 1).cpu().numpy()


class RowsAcc:
    """An integrated output kept as numpy rows and netted when read: the
    form of the paths whose outputs run to millions of rows (a dict of
    them would take most of the phase)."""

    def __init__(self):
        self.parts: list = []

    def add(self, b) -> None:
        self.parts.append(live_rows(b))

    def rows(self) -> np.ndarray:
        return net_rows(np.concatenate(self.parts)) if self.parts else \
            np.zeros((0, 1), np.int64)


def rolling_oracle(cols) -> np.ndarray:
    """(auction, date_time, max price) of every distinct (auction,
    date_time) of the bids: sorted by (auction, date_time), each row's
    window starts at the first row of its auction at or after date_time
    less 10 s (one searchsorted) and ends after its last row of the same
    time; the max is taken over the window's span."""
    auction, _, price, _, ts = bid_cols(cols)
    order = np.lexsort((ts, auction))
    a, t, p = auction[order], ts[order], price[order]
    group = np.cumsum(np.r_[True, a[1:] != a[:-1]]) - 1
    span = int(t.max() - t.min()) + 2 * ROLLING_RANGE_MS + 1
    key = group * span + (t - t.min())
    start = np.searchsorted(key, key - ROLLING_RANGE_MS, "left")
    end = np.searchsorted(key, key, "right")
    best = p.copy()
    for k in range(int((end - start).max())):
        best = np.maximum(best, p[np.minimum(start + k, end - 1)])
    first = np.r_[True, (a[1:] != a[:-1]) | (t[1:] != t[:-1])]
    return net_rows(np.stack([a[first], t[first], best[first],
                              np.ones(int(first.sum()), np.int64)], 1))


def range_join_oracle(cols) -> np.ndarray:
    """One equi-join of each bid's auction + d with the auction ids for
    each d in -2..2: (auction, id, price, category) with the bids'
    multiplicity."""
    auction, _, price, _, _ = bid_cols(cols)
    a = cols["auctions"]
    order = np.argsort(a["id"])
    ids, cat = a["id"][order], a["category"][order]
    parts = []
    for d in range(RANGE_JOIN_OFFSETS[0], RANGE_JOIN_OFFSETS[1] + 1):
        target = auction + d
        pos = np.minimum(np.searchsorted(ids, target), len(ids) - 1)
        hit = ids[pos] == target
        parts.append(np.stack([auction[hit], target[hit], price[hit],
                               cat[pos[hit]],
                               np.ones(int(hit.sum()), np.int64)], 1))
    return net_rows(np.concatenate(parts))


# the paths whose outputs and oracles are numpy rows (RowsAcc)
ROW_PATHS = ("rolling", "range_join")


def new_integral(name: str):
    return RowsAcc() if name in ROW_PATHS else {}


def integrate(acc, b) -> int:
    """Add one tick's output batch to ``acc``; returns its rows."""
    if isinstance(acc, RowsAcc):
        acc.add(b)
        return len(acc.parts[-1])
    d = b.to_dict() if b is not None else {}
    accumulate(acc, d)
    return len(d)


def check_integral(what: str, acc, want) -> int:
    """Fail unless the integrated output equals the oracle's, which must
    not be empty; returns the oracle's rows."""
    if not len(want):
        fail(f"{what}: the oracle is empty, the check would be vacuous")
    if isinstance(acc, RowsAcc):
        got = acc.rows()
        if not np.array_equal(got, want):
            bad = next((i for i in range(min(len(got), len(want)))
                        if not np.array_equal(got[i], want[i])),
                       min(len(got), len(want)))
            fail(f"{what}: the integrated output differs from the oracle "
                 f"({len(got)} vs {len(want)} rows; first difference at "
                 f"row {bad}: {got[bad:bad + 2].tolist()} vs "
                 f"{want[bad:bad + 2].tolist()})")
    elif acc != want:
        fail(f"{what}: the integrated output differs from the oracle: "
             f"{sorted(acc.items())[:5]} vs {sorted(want.items())[:5]}")
    return len(want)


def same_output(name: str, got, want) -> bool:
    """One tick's output batches equal (both canonical)."""
    if name in ROW_PATHS:
        return np.array_equal(live_rows(got), live_rows(want))
    return (got.to_dict() if got is not None else {}) == \
        (want.to_dict() if want is not None else {})


ORACLES = {"q4": q4_oracle, "q3": q3_oracle, "q8": q8_oracle,
           "q15": q15_oracle, "q0": q0_oracle, "q1": q1_oracle,
           "q2": q2_oracle, "q12": q12_oracle, "q13": q13_oracle,
           "q14": q14_oracle, "q17": q17_oracle, "q20": q20_oracle,
           "q21": q21_oracle, "q22": q22_oracle, "q6": q6_oracle,
           "q9": q9_oracle, "q16": q16_oracle, "q18": q18_oracle,
           "q19": q19_oracle, "q5": q5_oracle, "q7": q7_oracle,
           "rolling": rolling_oracle, "range_join": range_join_oracle}


def gen_config(name: str, rates: dict = GEN_RATE):
    """The generator's config for query ``name``: seed 1, at its event
    rate in ``rates`` (else the default rate)."""
    from dbsp_tpu_torch.nexmark import GeneratorConfig

    rate = rates.get(name)
    if rate is None:
        return GeneratorConfig(seed=1)
    return GeneratorConfig(seed=1, first_event_rate=rate)


def gc_spine(handle):
    """The spine that a window with ``gc=True`` truncates in a host-engine
    circuit (None if there is none)."""
    from dbsp_tpu_torch.timeseries import WindowOp

    nodes = handle.circuit.nodes
    for node in nodes:
        if isinstance(node.operator, WindowOp) and node.operator.gc:
            return nodes[node.inputs[0]].operator.spine
    return None


def build_query(name: str, device=None):
    from dbsp_tpu_torch.circuit import Runtime
    from dbsp_tpu_torch.nexmark import build_inputs, queries

    query = CIRCUITS.get(name) or getattr(queries, name)

    def build(c):
        streams, handles = build_inputs(c)
        return handles, query(*streams).output()

    return Runtime.init_circuit(1, build, device=device)


class Recorder:
    """Wraps a kernel entry point to keep the arguments of its largest
    call on the main paths (for timing at the shapes the queries give
    it), and which query made it: ``best``, by the first of
    ``size_fns``; ``alt``, by the second (if any); ``kept[i]``, by the
    i-th, as (size, args, kwargs, query)."""

    query = None  # the query being driven
    paused = 0  # > 0: record nothing (a chain's own kernels, a check)
    # gather_ladder calls (one launch each) with range queries (qhi_keys),
    # by the query that made them
    range_calls: dict = {}

    def __init__(self, module, name: str, *size_fns):
        self.module, self.name = module, name
        self.size_fns = size_fns
        self.orig = getattr(module, name)
        self.kept = [(None, None, None, None)] * len(self.size_fns)

    best = property(lambda self: self.kept[0])
    alt = property(lambda self: self.kept[min(1, len(self.kept) - 1)])

    def __call__(self, *args, **kw):
        if Recorder.paused:
            return self.orig(*args, **kw)
        if kw.get("qhi_keys") is not None:
            Recorder.range_calls[Recorder.query] = \
                Recorder.range_calls.get(Recorder.query, 0) + 1
        for i, size_fn in enumerate(self.size_fns):
            size = size_fn(*args, **kw)
            if self.kept[i][0] is None or size > self.kept[i][0]:
                # a spine's level list changes after the tick: keep a
                # snapshot
                self.kept[i] = (size, tuple(
                    tuple(a) if isinstance(a, list) else a for a in args),
                    kw, Recorder.query)
        return self.orig(*args, **kw)

    def __enter__(self):
        setattr(self.module, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def _ladder_size(*args, **kw):
    levels = args[2]
    return sum(lvl.cap for lvl in levels) + args[1].shape[0]


def _ladder_queries(*args, **kw):
    return args[1].shape[0], _ladder_size(*args)


def _ladder_range_size(*args, **kw):
    """A gather call's size if it carries range queries (qhi_keys), else
    -1: its largest such call is timed apart."""
    return _ladder_size(*args) if kw.get("qhi_keys") is not None else -1


def _ladder_slots(qkeys, qlive, levels, *a, **kw):
    """The argument slots of a ladder-consumer call (above ARGS_MAX its
    table comes from a host buffer, which a CUDA graph cannot capture)."""
    from dbsp_tpu_torch.zset import cuda_kernels as ck_mod

    return ck_mod.load_library("ladder_consumer").ladder_slots(
        len(levels), len(qkeys), len(levels[0].vals))


def _probe_size(tables, query_cols, *a, **kw):
    return sum(t[0].shape[0] for t in tables) + query_cols[0].shape[0]


def recorders():
    from dbsp_tpu_torch.zset import cuda_kernels as ck_mod

    return [
        Recorder(ck_mod, "lex_probe_ladder_both", _probe_size),
        Recorder(ck_mod, "join_ladder", _ladder_size, _ladder_queries),
        Recorder(ck_mod, "gather_ladder", _ladder_size, _ladder_queries,
                 _ladder_slots, _ladder_range_size),
        Recorder(ck_mod, "segment_reduce",
                 lambda spec, vals, w, *a, **k: w.shape[0]),
        Recorder(ck_mod, "rank_merge_scatter",
                 lambda ca, wa, cb, wb: wa.shape[0] + wb.shape[0]),
        Recorder(ck_mod, "agg_ladder",
                 lambda d, nk, ot, levels, *a: d.cap + ot.cap
                 + sum(lvl.cap for lvl in levels)),
    ]


host_metrics: dict = {}  # the host engine's numbers, beside the compiled


def check_range_gathers(label: str) -> None:
    """A rolling path must have launched the ladder gather with range
    queries (its windows and affected rows)."""
    if label.split("-")[0] == "rolling" and \
            not Recorder.range_calls.get(label):
        fail(f"{label}: no gather_ladder launch carried range queries")


def run_query(name: str, all_events: dict):
    """Drive one query on the card for its warm and measured ticks
    (``HOST_DEPTH``, else WARM_TICKS + TICKS), with the launch counts set
    to 0 just before and read just after; hold the accumulated output to
    the query's oracle. Returns (launches over the run, launches per
    measured tick)."""
    import torch

    from dbsp_tpu_torch.nexmark import NexmarkGenerator
    from dbsp_tpu_torch.zset import cuda_kernels as ck_mod

    warm_ticks, ticks = HOST_DEPTH.get(name, (WARM_TICKS, TICKS))
    cfg = gen_config(name)
    gen = NexmarkGenerator(cfg)
    handle, (handles, out) = build_query(name)  # device=None: the card
    if handle.runtime.device.type != "cuda":
        fail(f"{name} built on {handle.runtime.device}, not the card")
    spine = gc_spine(handle)
    gc_rows: list = []  # the GC'd spine's live rows after each tick
    Recorder.query = name
    acc = new_integral(name)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ck_mod.reset_launches()
    n = 0
    for _ in range(warm_ticks):
        gen.feed(handles, n, n + EVENTS_PER_TICK)
        handle.step()
        integrate(acc, out.take())
        if spine is not None:
            gc_rows.append(sum(int(b.live_count()) for b in spine.batches))
        n += EVENTS_PER_TICK
    handle.step_times_ns.clear()
    per_tick = {k: [] for k in ck_mod.LAUNCHES}
    t0 = time.perf_counter()
    acc_s = 0.0  # the oracle's bookkeeping: every output row to the host
    for _ in range(ticks):
        before = dict(ck_mod.LAUNCHES)
        gen.feed(handles, n, n + EVENTS_PER_TICK)
        handle.step()
        ta = time.perf_counter()
        integrate(acc, out.take())
        if spine is not None:
            gc_rows.append(sum(int(b.live_count()) for b in spine.batches))
        acc_s += time.perf_counter() - ta
        n += EVENTS_PER_TICK
        for k, count in ck_mod.LAUNCHES.items():
            per_tick[k].append(count - before[k])
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = dict(ck_mod.LAUNCHES)
    Recorder.query = None
    for k in QUERIES[name]:
        if launches[k] <= 0:
            fail(f"kernel {k} was not launched on the {name} path")
    if "lex_probe_ladder" in QUERIES[name] and \
            set(per_tick["lex_probe_ladder"]) != {PROBES_PER_TICK[name]}:
        fail(f"{name}: its distincts' old-weights lookups made "
             f"{per_tick['lex_probe_ladder']} probe launches per measured "
             f"tick, not {PROBES_PER_TICK[name]} (both sides in one "
             "launch)")
    if (cfg, n) not in all_events:
        all_events.clear()
        all_events[(cfg, n)] = gen.generate(0, n)
    events = all_events[(cfg, n)]
    out_rows = check_integral(name, acc, ORACLES[name](events))
    check_range_gathers(name)
    gc_report = None
    if spine is not None:
        # the GC dropped rows when the earliest window the bids count in
        # is gone from the spine (bids only insert: nothing else removes)
        held = torch.cat([b.keys[0][b.weights != 0] for b in spine.batches])
        first = q5_first_window(events)
        if not held.numel() or int(held.min()) <= first:
            fail(f"{name}: its GC'd spine never dropped a row (earliest "
                 f"window {first} still held)")
        gc_report = {"live_rows_per_tick": gc_rows,
                     "earliest_window_held_ms_after_first":
                     int(held.min()) - first,
                     "levels": [b.cap for b in spine.batches]}
    lat = sorted(handle.step_times_ns)
    host_metrics[name] = {"events_per_s": ticks * EVENTS_PER_TICK / elapsed,
                          "tick_p50_ms": lat[len(lat) // 2] / 1e6,
                          "tick_p99_ms": lat[min(len(lat) - 1,
                                                 int(len(lat) * 0.99))] / 1e6}
    spine_bytes = sum(sp.nbytes() for node in handle.circuit.nodes
                      for sp in (getattr(node.operator, attr, None)
                                 for attr in ("spine", "out_spine",
                                              "acc_spine"))
                      if sp is not None)
    say(json.dumps({
        "phase": name, "device": "cuda", "card": CARD[0],
        "events_per_tick": EVENTS_PER_TICK,
        "warm_ticks": warm_ticks, "ticks": ticks,
        "events_measured": ticks * EVENTS_PER_TICK, "events_total": n,
        "events_per_s": ticks * EVENTS_PER_TICK / elapsed,
        # the same without the oracle's accumulation of the output rows
        # on the host, which dominates a query of one row per bid
        "events_per_s_feed_and_step": ticks * EVENTS_PER_TICK
        / (elapsed - acc_s),
        "tick_p50_ms": lat[len(lat) // 2] / 1e6,
        "tick_p99_ms": lat[min(len(lat) - 1, int(len(lat) * 0.99))] / 1e6,
        "tick_max_ms": lat[-1] / 1e6,
        "spine_device_bytes": spine_bytes,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "first_event_rate": cfg.first_event_rate,
        "gc_trace": gc_report,
        "launches": launches,
        "launches_per_measured_tick": {k: [min(c), max(c)]
                                       for k, c in per_tick.items()},
        "output_rows": out_rows, "oracle_equal": True,
        "gather_launches_with_range_queries": Recorder.range_calls.get(name),
        "note": f"{ticks * EVENTS_PER_TICK} measured events: a cut of "
                "Nexmark's usual 100M events, made for the run's time limit",
    }))
    return launches, per_tick


# ---------------------------------------------------------------------------
# The compiled engine
# ---------------------------------------------------------------------------


def profile_run(fn):
    """torch.profiler over ``fn`` and a synchronize: {device op name: [ms,
    launches]}, the wall ms, and whether the session kept its first
    events (it starts with throwaway sentinel kernels, as device_ms's
    sessions do, and leaves them out). It traces the device only: host
    op tracing doubled a compiled interval's dispatch time and tripled
    the reading of its events (compiled q17: an 8-tick interval ran 1.2 s
    and read 6 s device-only, 3.5-13.9 s and 10-18 s with the host's
    ops), and no number here reads a host event."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()  # no earlier work runs inside the session
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILER_SENTINELS):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        tp = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - tp) * 1e3
    dev: dict = {}
    kept = False
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if SENTINEL_KERNEL in ev.name:
            kept = True
            continue
        k = dev.setdefault(ev.name[:80], [0.0, 0])
        k[0] += ev.device_time_total / 1e3
        k[1] += 1
    return dev, wall_ms, kept


def port_kernel_per_tick(dev_kernels: dict, ticks: int,
                         field: int = 0) -> dict:
    """Device ms (``field`` 0) or launches (``field`` 1) per profiled tick
    of each of the port's kernels (its template instances summed), from
    {event name: [ms, launches]} over ``ticks`` ticks."""
    from dbsp_tpu_torch.profile_query import port_kernel

    out: dict = {}
    for event, v in dev_kernels.items():
        k = port_kernel(event)
        if k is not None:
            out[k] = out.get(k, 0) + v[field] / ticks
    return out


def state_bytes(tree) -> int:
    """Device bytes of a compiled state tree (batches, tuples, tensors)."""
    import torch

    from dbsp_tpu_torch.zset.batch import Batch

    if isinstance(tree, torch.Tensor):
        return _nbytes(tree)
    if isinstance(tree, Batch):
        return tree.nbytes()
    if isinstance(tree, (tuple, list)):
        return sum(state_bytes(t) for t in tree)
    if isinstance(tree, dict):
        return sum(state_bytes(t) for t in tree.values())
    return 0


def probe_shape(lookups: list, last_call: tuple, busy_ops: float) -> dict:
    """The measured ticks' old-weights lookups of a compiled distinct:
    their ladders' level and argument-slot counts (``lookups``, a
    (levels, columns) pair each; above ``ARGS_MAX`` slots the probe's
    argument block goes as a device table), and the device ops of one
    lookup (the last, ``last_call``: its delta and ladder), the probe
    kernel and the per-level sum after it, against ``busy_ops``, the
    device ops of a profiled tick, which makes one lookup."""
    from dbsp_tpu_torch.zset import cuda_kernels as ck_mod
    from dbsp_tpu_torch.zset import cursor

    if not lookups:
        fail("the compiled distinct made no old-weights lookup")
    levels = [k for k, _ in lookups]
    slots = [ck_mod.probe_ladder_slots(k, c) for k, c in lookups]
    delta, ladder = last_call
    Recorder.paused += 1
    try:
        ms, ops, by_op = device_ms(
            lambda: cursor.old_weights_ladder(delta, ladder),
            what="old_weights_ladder")
    finally:
        Recorder.paused -= 1
    return {"levels": [min(levels), max(levels)], "columns": lookups[0][1],
            "argument_slots": [min(slots), max(slots)],
            "args_max": ck_mod.ARGS_MAX,
            "device_table": max(slots) > ck_mod.ARGS_MAX,
            "lookups_measured": len(lookups),
            "lookup_device_ms": ms, "lookup_device_ops": ops,
            "lookup_device_ms_by_op": by_op,
            # one lookup a measured tick (checked): all its ops but the
            # probe's one launch are the per-level sum
            "sum_loop_ops_share_of_tick": (ops - 1) / busy_ops}


def compiled_query(name: str, c_ticks: int):
    """Query ``name`` compiled on the card, fed by device-side generation
    at EVENTS_PER_TICK, with the level count the reference bench picks
    for ``c_ticks`` measured ticks (or its ``COMPILED_LEVELS`` entry):
    (the handle, its output's index)."""
    from dbsp_tpu_torch.compiled import cnodes, compile_circuit
    from dbsp_tpu_torch.nexmark import device_gen

    ept = EVENTS_PER_TICK // 50
    cfg = gen_config(name)
    handle, (handles, out) = build_query(name)
    if handle.runtime.device.type != "cuda":
        fail(f"compiled {name} built on {handle.runtime.device}")
    hp, ha, hb = handles

    def gen_fn(tick):
        p, a, b = device_gen.generate_tick(cfg, tick * ept, ept)
        return {hp: p, ha: a, hb: b}

    ch = compile_circuit(handle, gen_fn=gen_fn,
                         trace_levels=COMPILED_LEVELS.get(
                             name, cnodes.levels_for_run(c_ticks)))
    return ch, ch._op_to_index[id(out._op)]


def gc_trace_node(ch):
    """The compiled trace node that a window with ``gc=True`` truncates
    (None if there is none)."""
    from dbsp_tpu_torch.compiled import cnodes

    for cn in ch.cnodes:
        if isinstance(cn, cnodes.CWindow) and cn.op.gc:
            return ch.by_index[cn.node.inputs[0]]
    return None


def trace_requirement(ch, trace_cn) -> int:
    """The last validated "trace" requirement (its live rows) of a
    compiled trace node."""
    return max(r for (cn, key), r in zip(ch._checks, ch.last_req)
               if cn is trace_cn and key == "trace")


def warm_compiled(ch, c_warm: int, c_ticks: int) -> None:
    """The reference bench's warm-up: ``c_warm`` ticks validated every
    tick, presize for the run, one more tick."""
    ch.run_ticks(0, c_warm, validate_every=1, project_ratio=4.0)
    ch.presize((c_warm + 1 + c_ticks) / c_warm, interval=C_VALIDATE)
    ch.run_ticks(c_warm, 1, validate_every=1, project_ratio=4.0)
    ch.block()


def run_compiled(name: str) -> dict:
    """Drive one query on the compiled engine on the card (see the module
    doc, phase 4b); fail on any disagreement. Returns its launches."""
    import gc
    import traceback
    import warnings

    import torch

    from dbsp_tpu_torch.nexmark import NexmarkGenerator
    from dbsp_tpu_torch.zset import cuda_kernels as ck_mod
    from dbsp_tpu_torch.zset import cursor

    c_warm, c_ticks, c_profile = COMPILED_DEPTH.get(
        name, (C_WARM, C_TICKS, C_PROFILE))
    cfg = gen_config(name)
    ch, out_idx = compiled_query(name, c_ticks)
    gc_cn = gc_trace_node(ch)
    gc_req: list = []  # the GC'd trace's validated "trace" requirement
    outs = {}
    syncs = []
    sync_sites: dict = {}
    sync_notices: list = []
    dispatch_ns = []
    per_tick = {k: [] for k in ck_mod.LAUNCHES}
    counting = [False]
    dispatch = ch._dispatch
    # distinct's old-weights lookups in the measured ticks: (levels,
    # columns) of each, and only the last call's arguments, so that no
    # tick's tensors outlive the next
    lookups: list = []
    last_lookup: list = [None]
    old_weights = cursor.old_weights_ladder

    def recorded_old_weights(delta, levels):
        if counting[0]:
            lookups.append((len(levels), len(delta.cols)))
            last_lookup[0] = (delta, levels)
        return old_weights(delta, levels)

    def counted_dispatch(tick, feeds=None):
        # a measured tick's host syncs (the sync debug mode warns at each
        # one) and kernel launches
        if counting[0]:
            before = dict(ck_mod.LAUNCHES)
            found = []

            def note(message, category, filename, lineno, *a, **k):
                msg = str(message)
                if SYNC_NOTICE in msg:
                    # torch's one-time notice that the sync debug mode is
                    # a prototype: kept apart, it is no sync
                    sync_notices.append(msg[:120])
                elif "ynchroniz" in msg:
                    # the innermost frames that led to the sync, and
                    # whether the garbage collector was running then
                    stack = traceback.extract_stack()[:-1][-4:]
                    found.append(("during gc: " if in_gc[0] else "") +
                                 " < ".join(
                        f"{f.filename.rsplit('/', 2)[-1]}:{f.lineno} "
                        f"({f.name})" for f in reversed(stack)))

            with warnings.catch_warnings():
                warnings.simplefilter("always")
                warnings.showwarning = note
                torch.cuda.set_sync_debug_mode("warn")
                td = time.perf_counter_ns()
                try:
                    dispatch(tick, feeds)
                finally:
                    dispatch_ns.append(time.perf_counter_ns() - td)
                    torch.cuda.set_sync_debug_mode(0)
            syncs.append(len(found))
            for site in found:
                sync_sites[site] = sync_sites.get(site, 0) + 1
            for k, c in ck_mod.LAUNCHES.items():
                per_tick[k].append(c - before[k])
        else:
            dispatch(tick, feeds)
        outs[tick] = ch.last_outputs.get(out_idx)  # canonicalized later

    in_gc = [False]

    def gc_phase(phase, info):
        in_gc[0] = phase == "start"

    gc.callbacks.append(gc_phase)
    ch._dispatch = counted_dispatch
    cursor.old_weights_ladder = recorded_old_weights
    Recorder.query = f"{name}-compiled"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ck_mod.reset_launches()
    t0 = time.perf_counter()
    try:
        warm_compiled(ch, c_warm, c_ticks)
        if gc_cn is not None:
            gc_req.append(trace_requirement(ch, gc_cn))
        warm_s = time.perf_counter() - t0
        warm_replays = ch.overflow_replays
        ch.reset_timing()
        m0 = c_warm + 1
        counting[0] = True
        t0 = time.perf_counter()
        ch.run_ticks(m0, c_ticks, validate_every=C_VALIDATE,
                     block_each=True, project_ratio=4.0,
                     snapshot_every=max(1, c_ticks // C_VALIDATE // 2))
        ch.block()
        elapsed = time.perf_counter() - t0
        if gc_cn is not None:
            gc_req.append(trace_requirement(ch, gc_cn))
    finally:
        counting[0] = False
        cursor.old_weights_ladder = old_weights
        gc.callbacks.remove(gc_phase)
    lat = sorted(ch.step_times_ns)
    measured_replays = ch.overflow_replays - warm_replays
    launches = dict(ck_mod.LAUNCHES)
    # the card's busy share over one more validation interval, profiled
    dev_kernels, wall_ms, _ = profile_run(lambda: ch.run_ticks(
        m0 + c_ticks, c_profile, validate_every=C_VALIDATE, block_each=True,
        project_ratio=4.0))
    busy_ms = sum(v[0] for v in dev_kernels.values())
    top = sorted(dev_kernels.items(), key=lambda kv: -kv[1][0])[:12]
    Recorder.query = None
    launches_all = dict(ck_mod.LAUNCHES)
    for k in COMPILED[name]:
        if launches[k] <= 0:
            fail(f"kernel {k} was not launched on the compiled {name} path")
    if sum(syncs):
        fail(f"compiled {name}: {sum(syncs)} host syncs in {len(syncs)} "
             f"measured ticks, at {sync_sites}")
    probe = None
    if "lex_probe_ladder" in COMPILED[name]:
        if set(per_tick["lex_probe_ladder"]) != {1}:
            fail(f"compiled {name}: {per_tick['lex_probe_ladder']} lex-probe "
                 "launches per measured tick, not one")
        probe = probe_shape(lookups, last_lookup[0], busy_ops=sum(
            v[1] for v in dev_kernels.values()) / c_profile)
    n_ticks = m0 + c_ticks + c_profile
    if sorted(outs) != list(range(n_ticks)):
        fail(f"compiled {name}: outputs of ticks {sorted(outs)[:5]}...")
    # every tick against the port's host engine on the card, same events
    # (a check: its kernel calls are not recorded for the timing table)
    Recorder.paused += 1
    gen = NexmarkGenerator(cfg)
    hh, (hhandles, hout) = build_query(name)
    acc = new_integral(name)
    rows = 0
    for t in range(n_ticks):
        gen.feed(hhandles, t * EVENTS_PER_TICK, (t + 1) * EVENTS_PER_TICK)
        hh.step()
        want = hout.take()
        b = ch.canonicalize_sink(outs[t])
        if not same_output(name, b, want):
            fail(f"compiled {name} tick {t} differs from the host engine: "
                 f"{live_rows(b)[:5].tolist()} vs "
                 f"{live_rows(want)[:5].tolist()}")
        rows += integrate(acc, b)
    Recorder.paused -= 1
    n = n_ticks * EVENTS_PER_TICK
    want_rows = check_integral(f"compiled {name}", acc,
                               ORACLES[name](gen.generate(0, n)))
    check_range_gathers(f"{name}-compiled")
    gc_report = None
    if gc_cn is not None:
        # the GC'd trace is bounded by the window's span: its rows level
        # off after the warm-up instead of growing with the ticks
        levels, _ = ch.states[str(gc_cn.node.index)]
        if gc_req[-1] > GC_LEVEL_RATIO * gc_req[0]:
            fail(f"compiled {name}: the GC'd trace's requirement grew from "
                 f"{gc_req[0]} after the warm-up to {gc_req[-1]} rows")
        if gc_cn._slot_cap is not None or gc_cn.MONOTONE_CAPS:
            fail(f"compiled {name}: the GC'd trace slots or is projected")
        gc_report = {"trace_requirement_after_warmup": gc_req[0],
                     "trace_requirement_after_measured": gc_req[-1],
                     "live_rows_by_level": [int(b.live_count())
                                            for b in levels],
                     "level_caps": [b.cap for b in levels]}
    say(json.dumps({
        "phase": f"{name}-compiled", "device": "cuda", "card": CARD[0],
        "events_per_tick": EVENTS_PER_TICK, "warm_ticks": c_warm + 1,
        "ticks": c_ticks, "validate_every": C_VALIDATE,
        "profiled_ticks": c_profile,
        "trace_levels": ch.trace_levels,
        "events_measured": c_ticks * EVENTS_PER_TICK,
        "events_per_s": c_ticks * EVENTS_PER_TICK / elapsed,
        "tick_p50_ms": lat[len(lat) // 2] / 1e6,
        "tick_p99_ms": lat[min(len(lat) - 1, int(len(lat) * 0.99))] / 1e6,
        "tick_max_ms": lat[-1] / 1e6,
        "host_engine": host_metrics.get(name),
        "warmup_s": warm_s,
        "overflow_replays_warmup": warm_replays,
        "overflow_replays_measured": measured_replays,
        "host_overhead_ms": {k: sum(v) / 1e6
                             for k, v in ch.host_overhead_ns.items()},
        "maintain": dict(ch.maintain_stats),
        "busy_share": busy_ms / wall_ms,
        "busy_ms_per_tick": busy_ms / c_profile,
        "wall_ms_per_tick_profiled": wall_ms / c_profile,
        "device_ops_per_tick": sum(v[1] for v in dev_kernels.values())
        / c_profile,
        "device_top_ms_per_tick": {k: v[0] / c_profile for k, v in top},
        "port_kernels_ms_per_tick": port_kernel_per_tick(dev_kernels, c_profile),
        "distinct_lookup": probe,
        "dispatch_ms_per_measured_tick": sum(dispatch_ns) / 1e6
        / max(len(dispatch_ns), 1),
        "host_syncs_per_measured_tick": sum(syncs) / max(len(syncs), 1),
        "host_syncs_measured": sum(syncs),
        "host_sync_sites": sync_sites,
        "sync_debug_notices": sync_notices,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "state_bytes": state_bytes(ch.states),
        "first_event_rate": cfg.first_event_rate,
        "gc_trace": gc_report,
        "caps": {cn.op.name: dict(cn.caps) for cn in ch.cnodes if cn.caps},
        "launches": launches,
        "launches_per_measured_tick": {k: sum(c) / len(c)
                                       for k, c in per_tick.items() if c},
        "launches_with_profiled": launches_all,
        "output_rows": rows, "host_engine_equal": True,
        "oracle_equal": True, "oracle_rows": want_rows,
        "gather_launches_with_range_queries": Recorder.range_calls.get(
            f"{name}-compiled"),
        "note": f"{c_ticks * EVENTS_PER_TICK} measured events: a cut of "
                "Nexmark's usual 100M events, made for the run's time "
                "limit",
    }))
    return launches, per_tick


def algebra_circuit(c):
    """Three int64 inputs through plus, minus, neg and sum_with into
    stream_distinct and distinct, and a sum read through a negation (its
    consolidation deferred to the sink on the compiled engine)."""
    import torch

    from dbsp_tpu_torch.operators import add_input_zset

    i64 = (torch.int64,)
    s1, h1 = add_input_zset(c, i64, i64)
    s2, h2 = add_input_zset(c, i64, i64)
    s3, h3 = add_input_zset(c, i64, i64)
    b = s1.plus(s2).minus(s3)
    d = b.sum_with([s3.neg(), s1])
    o1 = d.stream_distinct().distinct().output()
    o2 = b.sum_with([s2.neg()]).neg().output()
    return (h1, h2, h3), (o1, o2)


def run_algebra() -> dict:
    """Phase 4c (module doc): the feeds-mode algebra circuit compiled on
    the card against the same circuit on the host engine on the card.
    Returns its launches."""
    import torch

    from dbsp_tpu_torch.circuit import Runtime
    from dbsp_tpu_torch.compiled import CompiledOverflow, compile_circuit
    from dbsp_tpu_torch.zset import cuda_kernels as ck_mod
    from dbsp_tpu_torch.zset.batch import Batch

    host, (hin, hout) = Runtime.init_circuit(1, algebra_circuit)
    comp, (cin, cout) = Runtime.init_circuit(1, algebra_circuit)
    ch = compile_circuit(comp)
    if ch.deferred_consolidations != 1:
        fail(f"algebra: {ch.deferred_consolidations} deferred "
             "consolidations, want 1 (the sum read through a negation)")
    rng = np.random.default_rng(13)
    dev = torch.device("cuda")
    rows = replays = 0
    # random rows of an arbitrary size: their calls are not the Nexmark
    # main paths' the kernel table times
    Recorder.paused += 1
    ck_mod.reset_launches()
    for t in range(ALGEBRA_TICKS):
        feeds = {}
        for h, g in zip(hin, cin):
            k = rng.integers(0, 30_000, ALGEBRA_ROWS)
            v = rng.integers(0, 4, ALGEBRA_ROWS)
            w = rng.choice(np.array([-1, 1, 2]), ALGEBRA_ROWS)
            h.push_batch(Batch.from_columns([k], [v], w, device=dev))
            feeds[g] = Batch.from_columns([k], [v], w, device=dev)
        host.step()
        while True:  # feeds mode: on overflow grow, restore, step again
            snap = ch.snapshot()
            ch.step(t, feeds=feeds)
            try:
                ch.validate()
                break
            except CompiledOverflow as e:
                replays += 1
                ch.grow(e)
                ch.restore(snap)
        ch.maintain()
        for h, o in zip(hout, cout):
            want = h.to_dict()
            b = ch.output(o)
            got = b.to_dict() if b is not None else {}
            if got != want:
                fail(f"algebra tick {t}: compiled {sorted(got.items())[:5]} "
                     f"vs host {sorted(want.items())[:5]}")
            rows += len(want)
    Recorder.paused -= 1
    launches = dict(ck_mod.LAUNCHES)
    for k in ("lex_probe_ladder", "rank_merge"):
        if launches[k] <= 0:
            fail(f"kernel {k} was not launched on the algebra circuit")
    if not rows:
        fail("algebra: the comparison held no rows")
    say(json.dumps({"phase": "algebra-compiled", "device": "cuda",
                    "ticks": ALGEBRA_TICKS, "rows_per_input": ALGEBRA_ROWS,
                    "overflow_replays": replays, "output_rows": rows,
                    "host_engine_equal": True, "launches": launches,
                    "nodes": sorted({type(cn).__name__
                                     for cn in ch.cnodes})}))
    return launches, {k: [] for k in launches}


def fold_circuit(c):
    """An int64 input keyed by k % 1000 into two ``Fold``s over the
    present rows: a sum of squares and a max."""
    import torch

    from dbsp_tpu_torch.operators import Fold, add_input_zset
    from dbsp_tpu_torch.zset import kernels

    i64 = torch.int64
    s, h = add_input_zset(c, (i64,), (i64,))
    keyed = s.index_by(lambda k, v: (k[0] % 1000,), (i64,),
                       val_fn=lambda k, v: (v[0],), val_dtypes=(i64,),
                       name="by1000")
    sum_sq = Fold(reduce_fn=lambda v, w, seg, n: (kernels.segment_sum(
        v[0] * v[0] * torch.clamp(w, min=0), seg, n),), name="sum_sq")
    top = Fold(reduce_fn=lambda v, w, seg, n: (kernels.segment_extreme(
        torch.where(w > 0, v[0], torch.iinfo(i64).min), seg, n,
        largest=True),), name="max")
    return h, (keyed.aggregate(sum_sq).output(),
               keyed.aggregate(top).output())


def run_fold() -> dict:
    """The fold circuit (``fold_circuit``) compiled on the card, in feeds
    mode, against the same circuit on the host engine on the card, every
    tick, with retractions from the second tick on. A ``Fold`` has no
    reduce spec, so the compiled aggregate takes the stitched route:
    its gathers must launch the ladder consumer, and the fused
    aggregate kernel must not launch. The counts are set to 0 after each
    host step and read after the compiled tick: the compiled side's
    alone. Returns (launches, launches per tick)."""
    import torch

    from dbsp_tpu_torch.circuit import Runtime
    from dbsp_tpu_torch.compiled import CompiledOverflow, compile_circuit
    from dbsp_tpu_torch.zset import cuda_kernels as ck_mod
    from dbsp_tpu_torch.zset.batch import Batch

    host, (hin, hout) = Runtime.init_circuit(1, fold_circuit)
    comp, (cin, cout) = Runtime.init_circuit(1, fold_circuit)
    ch = compile_circuit(comp)
    rng = np.random.default_rng(17)
    dev = host.runtime.device
    live_k = np.zeros(0, np.int64)
    live_v = np.zeros(0, np.int64)
    rows = replays = 0
    per_tick = {k: [] for k in ck_mod.LAUNCHES}
    Recorder.paused += 1  # random rows: not the Nexmark paths' calls
    for t in range(FOLD_TICKS):
        k = rng.integers(0, 30_000, FOLD_ROWS)
        v = rng.integers(-1_000, 1_000, FOLD_ROWS)
        w = np.ones(FOLD_ROWS, np.int64)
        if t:  # retract a tenth of the rows inserted so far
            gone = rng.choice(len(live_k), len(live_k) // 10, replace=False)
            keep = np.ones(len(live_k), bool)
            keep[gone] = False
            k, v = np.r_[k, live_k[gone]], np.r_[v, live_v[gone]]
            w = np.r_[w, -np.ones(len(gone), np.int64)]
            live_k, live_v = live_k[keep], live_v[keep]
        live_k = np.r_[live_k, k[w > 0]]
        live_v = np.r_[live_v, v[w > 0]]
        hin.push_batch(Batch.from_columns([k], [v], w, device=dev))
        host.step()
        feed = Batch.from_columns([k], [v], w, device=dev)
        ck_mod.reset_launches()  # the compiled tick's own counts
        while True:  # feeds mode: on overflow grow, restore, step again
            snap = ch.snapshot()
            ch.step(t, feeds={cin: feed})
            try:
                ch.validate()
                break
            except CompiledOverflow as e:
                replays += 1
                ch.grow(e)
                ch.restore(snap)
        ch.maintain()
        for name, c in ck_mod.LAUNCHES.items():
            per_tick[name].append(c)
        for h, o in zip(hout, cout):
            want = h.to_dict()
            b = ch.output(o)
            got = b.to_dict() if b is not None else {}
            if got != want:
                fail(f"fold tick {t}: compiled {sorted(got.items())[:5]} "
                     f"vs host {sorted(want.items())[:5]}")
            rows += len(want)
    Recorder.paused -= 1
    launches = {k: sum(c) for k, c in per_tick.items()}
    for name in ("gather_ladder", "segment_reduce", "rank_merge"):
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched on the compiled fold "
                 "circuit")
    if launches["agg_ladder"]:
        fail("fold: a spec-less aggregate launched the fused aggregate "
             "kernel instead of taking the stitched route")
    if not rows:
        fail("fold: the comparison held no rows")
    say(json.dumps({"phase": "fold-compiled", "device": "cuda",
                    "ticks": FOLD_TICKS, "rows_per_tick": FOLD_ROWS,
                    "overflow_replays": replays, "output_rows": rows,
                    "host_engine_equal": True, "launches": launches,
                    "launches_per_tick_with_replays": {
                        k: sum(c) / len(c) for k, c in per_tick.items()},
                    "nodes": sorted({type(cn).__name__
                                     for cn in ch.cnodes})}))
    return launches, per_tick


def state_record(ch, out_idx) -> tuple:
    """A copy on the host of a compiled handle's state and last-tick
    output, to hold another run against (on the host, so that it takes
    no device memory from the runs measured): the state layout
    (structure, shapes, dtypes, run metadata), every state leaf, and the
    canonical output's leaves."""
    from dbsp_tpu_torch.compiled.compiler import _layout, _leaves

    out = ch.canonicalize_sink(ch.last_outputs.get(out_idx))
    return (_layout(ch.states), [t.cpu() for t in _leaves(ch.states)],
            [t.cpu() for t in _leaves(out)] if out is not None else [])


def record_diff(a: tuple, b: tuple):
    """Where two state records differ (None if they are equal bit for
    bit)."""
    import torch

    (la, ta, oa), (lb, tb, ob) = a, b
    if la != lb:
        return "the state layout"
    for i, (x, y) in enumerate(zip(ta, tb)):
        if not torch.equal(x, y):
            return f"state leaf {i} of {len(ta)}"
    if len(oa) != len(ob) or not all(torch.equal(x, y)
                                     for x, y in zip(oa, ob)):
        return "the last tick's output"
    return None


def profile_summary(dev_kernels: dict, wall_ms: float, ticks: int) -> dict:
    """A profiled run of ``ticks`` ticks (profile_run's result), a tick
    at a time: the card's busy share, device ms and ops, the port
    kernels' launches and the largest device consumers."""
    busy_ms = sum(v[0] for v in dev_kernels.values())
    top = sorted(dev_kernels.items(), key=lambda kv: -kv[1][0])[:8]
    return {"busy_share": busy_ms / wall_ms,
            "busy_ms_per_tick": busy_ms / ticks,
            "wall_ms_per_tick": wall_ms / ticks,
            "device_ops_per_tick": sum(v[1] for v in dev_kernels.values())
            / ticks,
            "port_kernel_launches_per_tick": port_kernel_per_tick(
                dev_kernels, ticks, 1),
            "device_top_ms_per_tick": {k: v[0] / ticks for k, v in top}}


def pct(samples: list, q: float) -> float:
    """The ``q`` quantile of ``samples`` (ns), in ms."""
    s = sorted(samples)
    return s[min(len(s) - 1, int(len(s) * q))] / 1e6


@contextlib.contextmanager
def graph_launches():
    """While open, a CUDA graph captured through ``torch.cuda.graph``
    keeps the wrapper launches made inside its capture, and each replay
    of it adds them to the tally yielded (by wrapper name, as
    cuda_kernels.LAUNCHES): a replay calls no wrapper."""
    import torch

    from dbsp_tpu_torch.zset import cuda_kernels as ck_mod

    per_graph: dict = {}
    tally = dict.fromkeys(ck_mod.LAUNCHES, 0)
    orig_graph, orig_replay = torch.cuda.graph, torch.cuda.CUDAGraph.replay

    class counting_graph(orig_graph):
        def __enter__(self):
            self.launches0 = dict(ck_mod.LAUNCHES)
            return super().__enter__()

        def __exit__(self, *exc):
            out = super().__exit__(*exc)
            per_graph[id(self.cuda_graph)] = {
                k: n - self.launches0[k] for k, n in ck_mod.LAUNCHES.items()}
            return out

    def replay(graph):
        orig_replay(graph)
        for k, n in per_graph[id(graph)].items():
            tally[k] += n

    torch.cuda.graph, torch.cuda.CUDAGraph.replay = counting_graph, replay
    try:
        yield tally
    finally:
        torch.cuda.graph, torch.cuda.CUDAGraph.replay = orig_graph, orig_replay


def lost_launches(dev: dict, before: dict, graphs_before: dict,
                  graphs: dict) -> dict:
    """{device kernel: [profiled, launched]} for each ACCOUNTED_KERNELS
    kernel whose launches in a profile (``dev``, profile_run's) differ
    from those its wrappers made since the counts were ``before``
    (cuda_kernels.LAUNCHES) plus those graph replays made since the tally
    ``graphs`` (graph_launches') was ``graphs_before``."""
    from dbsp_tpu_torch.zset import cuda_kernels as ck_mod

    got = port_kernel_per_tick(dev, 1, 1)
    out = {}
    for d, wrappers in ACCOUNTED_KERNELS.items():
        want = sum(ck_mod.LAUNCHES[w] - before[w] + graphs[w]
                   - graphs_before[w] for w in wrappers)
        if got.get(d, 0) != want:
            out[d] = [got.get(d, 0), want]
    return out


def run_scanned(name: str) -> None:
    """Phase 4d (module doc): query ``name`` compiled, run eagerly and
    then scanned (each validation interval one CUDA-graph replay), from
    the same warm-up; at every chunk end the scanned run's states and
    last-tick output equal the eager run's at the same tick, bit for
    bit."""
    with graph_launches() as tally:
        _run_scanned(name, tally)


def _run_scanned(name: str, graph_tally: dict) -> None:
    import torch

    from dbsp_tpu_torch.zset import cuda_kernels as ck_mod

    c_warm, c_ticks, _ = COMPILED_DEPTH.get(name, (C_WARM, C_TICKS,
                                                   C_PROFILE))
    m0 = c_warm + 1
    chunks = c_ticks // C_VALIDATE
    snap_every = max(1, chunks // 2)
    res: dict = {}
    records: dict = {}
    profiles: dict = {}  # mode: each extra interval's profile, or None
    for mode in ("eager", "scanned"):
        scan = mode == "scanned"
        gc_collect()
        ch, out_idx = compiled_query(name, c_ticks)
        warm_compiled(ch, c_warm, c_ticks)
        ch.reset_timing()
        replays0, overflow0 = ch.graph_replays, ch.overflow_replays
        dispatch_ns: list = []
        chunk_ns: list = []
        syncs: list = []
        capture_ns: list = []
        captured: list = []  # whether each chunk captured its graph
        cb_ns = [0]
        # the wrappers hold the handle's own methods as default arguments
        # and leave no name in this frame, whose locals would keep the
        # eager run's handle (and its memory) alive into the scanned run
        if scan:
            def timed_capture(*a, capture=ch._capture):
                # a capture synchronizes by design (torch.cuda.graph):
                # counted apart, outside the chunks' host work
                torch.cuda.set_sync_debug_mode(0)
                t = time.perf_counter_ns()
                try:
                    return capture(*a)
                finally:
                    capture_ns.append(time.perf_counter_ns() - t)
                    torch.cuda.set_sync_debug_mode("warn")

            def counted_chunk(t0, n, block=False,
                              step_scanned=ch.step_scanned):
                n_cap = len(capture_ns)
                t = time.perf_counter_ns()
                found = sync_warnings(lambda: step_scanned(t0, n))
                dispatch_ns.append(time.perf_counter_ns() - t)
                ch.block()
                chunk_ns.append(time.perf_counter_ns() - t)
                syncs.append(found)
                captured.append(len(capture_ns) > n_cap)

            ch._capture = timed_capture
            ch.step_scanned = counted_chunk
            del timed_capture, counted_chunk
        else:
            def timed_dispatch(tick, feeds=None, dispatch=ch._dispatch):
                t = time.perf_counter_ns()
                dispatch(tick, feeds)
                dispatch_ns.append(time.perf_counter_ns() - t)

            ch._dispatch = timed_dispatch
            del timed_dispatch

        def at_chunk_end(next_tick):
            t = time.perf_counter_ns()
            rec = state_record(ch, out_idx)
            if scan:
                want = records.pop(next_tick, None)
                if want is None:
                    fail(f"scanned {name}: a chunk ended at tick "
                         f"{next_tick}, where the eager run validated none")
                where = record_diff(want, rec)
                if where:
                    fail(f"scanned {name} at tick {next_tick}: {where} "
                         "differs from the eager run's")
            else:
                records[next_tick] = rec
            cb_ns[0] += time.perf_counter_ns() - t

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ck_mod.reset_launches()
        t0 = time.perf_counter_ns()
        ch.run_ticks(m0, c_ticks, validate_every=C_VALIDATE,
                     block_each=True, scan=scan, project_ratio=4.0,
                     snapshot_every=snap_every, on_validated=at_chunk_end)
        ch.block()
        elapsed_ns = time.perf_counter_ns() - t0 - cb_ns[0]
        launches = dict(ck_mod.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        replays = ch.graph_replays - replays0
        measured_overflows = ch.overflow_replays - overflow0
        if not scan:
            for k in COMPILED[name]:
                if launches[k] <= 0:
                    fail(f"kernel {k} was not launched on the eager "
                         f"compiled {name} path")
        out = {
            "events_per_s": c_ticks * EVENTS_PER_TICK / elapsed_ns * 1e9,
            "dispatch_ms_per_tick": (sum(dispatch_ns) - sum(capture_ns))
            / 1e6 / c_ticks,
            "peak_allocated": peak,
            "overflow_replays_measured": measured_overflows,
            # scanned, the wrappers run only while a graph is captured
            # (and in the warm-up tick before it), never at a replay: the
            # launches a replay makes are the profiler's
            ("launches_counted_in_python_at_captures" if scan
             else "launches_counted_in_python"): launches,
            "state_bytes": state_bytes(ch.states),
        }
        if scan:
            if replays != len(chunk_ns) or \
                    len(chunk_ns) != chunks + measured_overflows:
                fail(f"scanned {name}: {replays} graph replays for "
                     f"{len(chunk_ns)} chunks of {chunks} intervals")
            bad = [f for f in syncs if f]
            if bad:
                fail(f"scanned {name}: host syncs around the replays: "
                     f"{bad[0][:3]}")
            out.update({
                "dispatch_ms_per_tick_with_capture": sum(dispatch_ns) / 1e6
                / c_ticks,
                "events_per_s_without_capture": c_ticks * EVENTS_PER_TICK
                / (elapsed_ns - sum(capture_ns)) * 1e9,
                "chunk_ms": [c / 1e6 for c in chunk_ns],
                "chunk_captured": captured[:],
                "chunk_p50_ms": pct(chunk_ns, 0.5),
                "chunk_p99_ms": pct(chunk_ns, 0.99),
                "chunk_p50_ms_per_tick": pct(chunk_ns, 0.5) / C_VALIDATE,
                "chunk_p99_ms_per_tick": pct(chunk_ns, 0.99) / C_VALIDATE,
                "capture_ms": [c / 1e6 for c in capture_ns],
                "captures_by_cause": dict(ch.captures),
                "graph_replays": replays,
                "host_syncs_around_replays": 0,
                "bytes_copied_per_interval": list(ch.scan_copy_bytes),
                # the bytes each replay copies back into the graph's
                # buffers: every leaf the ticks wrote (level 0s, out
                # traces, every level of a window-GC'd trace)
                "graph_writeback_bytes_per_replay": {
                    n: g.writeback_bytes for n, g in ch._graphs.items()},
            })
        else:
            lat = ch.step_times_ns
            out.update({"tick_p50_ms": pct(lat, 0.5),
                        "tick_p99_ms": pct(lat, 0.99)})
        # SCAN_PROFILE_INTERVALS more intervals, each held to the eager run
        # too. The eager run profiles each; the scanned run profiles them
        # until one is readable in both runs (reading a session's events
        # takes seconds), and runs the rest unprofiled. An interval's
        # profile is readable where the profiler kept its sentinels, its
        # launches of the ACCOUNTED_KERNELS equal the wrappers' and the
        # graph replays' counts (a session on the H100 once lost 2 of an
        # eager q17 interval's 64 consumer probes), and, scanned, no
        # capture fell in it; the runs are compared in the same interval
        # (a maintain that merges levels launches more kernels in one
        # interval than in the next).
        readable: list = []
        lost_in: dict = {}  # interval: lost_launches' result
        sessions = 0
        for i in range(SCAN_PROFILE_INTERVALS):
            t_int = m0 + c_ticks + i * C_VALIDATE

            def interval(t=t_int):
                ch.run_ticks(t, C_VALIDATE, validate_every=C_VALIDATE,
                             block_each=True, scan=scan, project_ratio=4.0)

            if scan and any(p and e for p, e in
                            zip(readable, profiles["eager"])):
                interval()
                at_chunk_end(t_int + C_VALIDATE)
                readable.append(None)
                continue
            caps_before = sum(ch.captures.values())
            sessions += 1
            counts0, tally0 = dict(ck_mod.LAUNCHES), dict(graph_tally)
            dev, wall_ms, kept = profile_run(interval)
            lost = lost_launches(dev, counts0, tally0, graph_tally)
            at_chunk_end(t_int + C_VALIDATE)
            captured_in = sum(ch.captures.values()) - caps_before
            # a capture counts the launches it records, which run only
            # at the replays: its interval has no accounting
            if lost and not captured_in:
                lost_in[i] = lost
            readable.append(profile_summary(dev, wall_ms, C_VALIDATE)
                            if kept and not captured_in and not lost
                            else None)
        profiles[mode] = readable
        out["profile_readable"] = [p is not None for p in readable]
        out["profile_lost_launches"] = lost_in
        out["profiler_sessions"] = sessions
        res[mode] = out
        del ch
    both = [i for i in range(SCAN_PROFILE_INTERVALS)
            if profiles["eager"][i] and profiles["scanned"][i]]
    if not both:
        fail(f"scanned {name}: in none of {SCAN_PROFILE_INTERVALS} profiled "
             "intervals did both runs' profiles keep their sentinels and "
             "every counted launch with no capture inside (eager "
             f"{res['eager']['profile_readable']}, lost "
             f"{res['eager']['profile_lost_launches']}; scanned "
             f"{res['scanned']['profile_readable']}, lost "
             f"{res['scanned']['profile_lost_launches']})")
    for mode in res:
        prof = dict(profiles[mode][both[0]], interval=both[0])
        res[mode]["profiled"] = prof
        for k in COMPILED[name]:
            for d in DEVICE_KERNELS[k]:
                if prof["port_kernel_launches_per_tick"].get(d, 0) <= 0:
                    fail(f"kernel {k} ({d}) was not launched in the "
                         f"profiled interval of the {mode} compiled "
                         f"{name} path")
    ek = res["eager"]["profiled"]["port_kernel_launches_per_tick"]
    sk = res["scanned"]["profiled"]["port_kernel_launches_per_tick"]
    if ek != sk:
        fail(f"scanned {name}: device launches a tick in interval "
             f"{both[0]} {sk}, eager {ek}")
    if records:
        fail(f"scanned {name}: no chunk ended at ticks {sorted(records)}")
    say(json.dumps({
        "phase": f"{name}-scanned", "device": "cuda", "card": CARD[0],
        "events_per_tick": EVENTS_PER_TICK, "warm_ticks": m0,
        "ticks": c_ticks, "chunk": C_VALIDATE, "profiled_ticks": C_VALIDATE,
        "launches_equal_to_eager": True,
        "states_equal_at_every_chunk_end": True, **res}))


def gc_collect() -> None:
    """Free what the last run left on the card."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


DRIVER_TICKS = 12
DRIVER_CADENCES = (1, 4)
DRIVER_FLUSH_AT = 10  # a flush() after this many ticks: a partial interval


def run_driver() -> tuple:
    """Phase 4e (module doc): compiled q4 behind CompiledCircuitDriver,
    fed through its input handles by the numpy generator, against the
    host engine on the card, at each cadence of DRIVER_CADENCES. Returns
    the launches of the runs."""
    import torch

    from dbsp_tpu_torch.compiled.driver import CompiledCircuitDriver
    from dbsp_tpu_torch.nexmark import GeneratorConfig, NexmarkGenerator
    from dbsp_tpu_torch.zset import cuda_kernels as ck_mod

    name = "q4"
    Recorder.paused += 1  # pushed rows: not the timed main-path calls
    hgen = NexmarkGenerator(GeneratorConfig(seed=1))
    hh, (hhandles, hout) = build_query(name)
    want = []
    for t in range(DRIVER_TICKS):
        hgen.feed(hhandles, t * EVENTS_PER_TICK, (t + 1) * EVENTS_PER_TICK)
        hh.step()
        want.append(hout.to_dict())
    if not any(want):
        fail("driver: the host engine's q4 gave no rows to compare")
    report = {}
    launches = {k: 0 for k in ck_mod.LAUNCHES}
    per_tick = {k: [] for k in ck_mod.LAUNCHES}
    for every in DRIVER_CADENCES:
        gc_collect()
        gen = NexmarkGenerator(GeneratorConfig(seed=1))
        handle, (handles, out) = build_query(name)
        drv = CompiledCircuitDriver(handle, validate_every=every)
        delivered = []
        deliver = out._op.eval
        out._op.eval = lambda v: (delivered.append(v.to_dict()), deliver(v))
        early = []
        ck_mod.reset_launches()
        t0 = time.perf_counter()
        for t in range(DRIVER_TICKS):
            before = dict(ck_mod.LAUNCHES)
            gen.feed(handles, t * EVENTS_PER_TICK, (t + 1) * EVENTS_PER_TICK)
            drv.step()
            for k, c in ck_mod.LAUNCHES.items():
                per_tick[k].append(c - before[k])
            # what is delivered is every tick of the closed intervals, and
            # nothing of the open one
            closed = t + 1 - len(drv._retained)
            if len(delivered) != closed or drv.interval_open != bool(
                    drv._retained):
                early.append(t)
            if t + 1 == DRIVER_FLUSH_AT:
                drv.flush()
                if len(delivered) != t + 1 or drv.interval_open:
                    fail(f"driver (every {every}): flush() left ticks "
                         f"{len(delivered)}..{t} undelivered")
        drv.flush()
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        for k, c in ck_mod.LAUNCHES.items():
            launches[k] += c
        if early:
            fail(f"driver (every {every}): deliveries out of step with the "
                 f"closed intervals after ticks {early}")
        if len(delivered) != DRIVER_TICKS:
            fail(f"driver (every {every}): {len(delivered)} ticks "
                 f"delivered of {DRIVER_TICKS}")
        for t, (got, w) in enumerate(zip(delivered, want)):
            if got != w:
                fail(f"driver (every {every}) tick {t} differs from the host "
                     f"engine: {sorted(got.items())[:5]} vs "
                     f"{sorted(w.items())[:5]}")
        if drv.ch.overflow_replays <= 0:
            fail(f"driver (every {every}): no grow and exact replay")
        lat = drv.step_latencies_ns
        report[f"every_{every}"] = {
            "events_per_s": DRIVER_TICKS * EVENTS_PER_TICK / elapsed,
            "step_p50_ms": pct(lat, 0.5), "step_p99_ms": pct(lat, 0.99),
            "overflow_replays": drv.ch.overflow_replays,
            "host_overhead_ms": {k: sum(v) / 1e6 for k, v in
                                 drv.ch.host_overhead_ns.items()},
            "delivered_ticks": len(delivered),
            "output_rows": sum(len(d) for d in delivered)}
        del drv, handle
    Recorder.paused -= 1
    for k in COMPILED[name]:
        if launches[k] <= 0:
            fail(f"kernel {k} was not launched on the driver's {name} path")
    say(json.dumps({"phase": f"{name}-driver", "device": "cuda",
                    "card": CARD[0], "events_per_tick": EVENTS_PER_TICK,
                    "ticks": DRIVER_TICKS, "flush_after": DRIVER_FLUSH_AT,
                    "host_engine_equal": True, "launches": launches,
                    **report}))
    return launches, per_tick


def cross_check(name: str) -> int:
    """The port on the CPU (plain versions) and on the card, same events:
    equal output rows per tick. Returns the rows compared."""
    from dbsp_tpu_torch.nexmark import NexmarkGenerator

    gen = NexmarkGenerator(gen_config(name, CROSS_RATE))
    cpu_h, (cpu_in, cpu_out) = build_query(name, device="cpu")
    gpu_h, (gpu_in, gpu_out) = build_query(name)
    rows = 0
    for i in range(CROSS_TICKS):
        n0, n1 = i * CROSS_EVENTS, (i + 1) * CROSS_EVENTS
        gen.feed(cpu_in, n0, n1)
        gen.feed(gpu_in, n0, n1)
        cpu_h.step()
        gpu_h.step()
        want, got = cpu_out.to_dict(), gpu_out.to_dict()
        if got != want:
            fail(f"{name} cross-check tick {i}: card "
                 f"{sorted(got.items())[:5]} vs CPU "
                 f"{sorted(want.items())[:5]}")
        rows += len(want)
    if not rows:
        fail(f"{name} cross-check compared no rows")
    return rows


# ---------------------------------------------------------------------------
# Timing and bounds
# ---------------------------------------------------------------------------


def time_ms(fn, reps: int = 10) -> float:
    """Time of one call on the card's clock: CUDA events around ``reps``
    back-to-back calls, after two warm-up calls. It includes the host's
    work between launches (a wrapper's argument block and ctypes call),
    so for a short kernel it is a per-call cost; ``device_ms`` gives the
    device time alone."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# After the kernels are built, a profiler session in the building process
# drops its first device events: one or two at first (seen on the H100:
# 8 of 10 one-kernel calls counted), and later in a long run eight in
# every session (6 of 14 events counted, session after session). Each
# session of device_ms starts with this many throwaway kernels
# (torch.cuda._sleep's), which it does not count. A session that lost all
# of them is run again, up to PROFILER_TRIES times; every such session is
# listed in ``profiler_retries``.
PROFILER_SENTINELS = 64
SENTINEL_KERNEL = "spin_kernel"
PROFILER_TRIES = 6
profiler_retries: list = []
# the first device events a session dropped, by what it timed (where any)
profiler_dropped: dict = {}


def device_ms(fn, reps: int = 10, what: str = ""):
    """Device time of one call and the device operations (kernels and
    copies) it queues: torch.profiler's summed device time of everything
    that ``reps`` calls launched, and their count, over ``reps`` (None
    and 0 if the profiler saw no device activity), and the same split by
    operation name, ``{name: [ms, operations]}`` a call, longest first."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILER_TRIES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILER_SENTINELS):
                torch.cuda._sleep(1)
            torch.cuda.synchronize()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        evs = [ev for ev in prof.events()
               if ev.device_type == torch.autograd.DeviceType.CUDA]
        seen = sum(SENTINEL_KERNEL in ev.name for ev in evs)
        if seen < PROFILER_SENTINELS:
            profiler_dropped[what] = PROFILER_SENTINELS - seen
        if seen:
            break
        profiler_retries.append(f"{what}: {len(evs)} device events")
    else:
        fail(f"the profiler dropped every sentinel kernel of "
             f"{PROFILER_TRIES} sessions timing {what}: the device times "
             f"after them may be short (retries: {profiler_retries[-12:]})")
    evs = [ev for ev in evs if SENTINEL_KERNEL not in ev.name]
    total_us = sum(ev.device_time_total for ev in evs)
    by_op: dict = {}
    for ev in evs:
        x = by_op.setdefault(ev.name[:90], [0.0, 0])
        x[0] += ev.device_time_total / 1e3 / reps
        x[1] += 1 / reps
    return ((total_us / 1e3 / reps if total_us else None), len(evs) / reps,
            dict(sorted(by_op.items(), key=lambda kv: -kv[1][0])))


def random_ids(args):
    """A segment-reduce call's arguments with its ids replaced by ids
    drawn uniformly from [0, num_segments) on the card (seeded), of the
    same dtype and count: every run one row long, almost."""
    import torch

    spec, vals, w, seg, nseg = args[:5]
    gen = torch.Generator(device=seg.device)
    gen.manual_seed(7)
    ids = torch.randint(0, nseg, seg.shape, generator=gen,
                        device=seg.device, dtype=seg.dtype)
    return (spec, vals, w, ids, *args[4:])


# the skewed gate-on variant of the aggregate chain's largest call
SKEW_GROUPS = 4_000
SKEW_DELTA_ROWS = 4  # a hot group's rows in the delta


def skewed_history(args):
    """An aggregate-chain call's arguments rebuilt on the card at the same
    capacities, column dtypes, spec, q_cap and path, with the gate on:
    every level full of SKEW_GROUPS hot groups (cap / SKEW_GROUPS rows of
    each in every level, values interleaved across the levels), a delta
    of SKEW_DELTA_ROWS rows a group (two retract the group's two oldest
    rows of level 0, two are new) and an out trace of one row a group.
    Few queries, each with a history of thousands of rows: the skew of
    Nexmark's hot auctions pushed to the extreme. gather_cap stays the
    call's; the caller raises it."""
    import torch

    from dbsp_tpu_torch.zset.batch import Batch

    delta, nk, out_trace, levels, agg, q_cap, g_cap, fast, _ = args
    dev = delta.weights.device
    groups, depth = SKEW_GROUPS, len(levels)

    def col(like, x, live):
        top = True if like.dtype == torch.bool else \
            torch.iinfo(like.dtype).max
        return torch.where(live, x, top).to(like.dtype)

    def make(like, key, val, w):
        live = w != 0
        zero = torch.zeros_like(key)
        return Batch(tuple(col(c, key if i == 0 else zero, live)
                           for i, c in enumerate(like.keys)),
                     tuple(col(c, val, live) for c in like.vals),
                     w.to(like.weights.dtype), runs=(like.cap,))

    ladder = []
    for k, lvl in enumerate(levels):
        i = torch.arange(lvl.cap, device=dev)
        grp = i * groups // lvl.cap
        first = (grp * lvl.cap + groups - 1) // groups  # the group's row 0
        ladder.append(make(lvl, grp, (i - first) * depth + k,
                           torch.ones_like(i)))
    i = torch.arange(delta.cap, device=dev)
    r = i % SKEW_DELTA_ROWS
    new = 1 << 20  # above every history value
    d = make(delta, i // SKEW_DELTA_ROWS,
             torch.where(r < 2, r * depth, new + r),
             torch.where(i < groups * SKEW_DELTA_ROWS,
                         torch.where(r < 2, -1, 1), 0))
    i = torch.arange(out_trace.cap, device=dev)
    o = make(out_trace, i, torch.full_like(i, new),
             (i < groups).to(torch.int64))
    return (d, nk, o, type(levels)(ladder), agg, q_cap, g_cap, fast,
            torch.ones((), dtype=torch.bool, device=dev))


def _nbytes(t) -> int:
    return t.element_size() * t.numel()


def _steps(n: int) -> int:
    return max(int(n).bit_length(), 1)


def ladder_bound(args, kw, join: bool):
    """Least bytes and operations of one ladder launch on these inputs:
    the queries read once at their width; per (level, query) one search of
    ceil(log2(cap + 1)) probes of the key columns (the right side's few
    compares from its answer are not counted), but no more bytes than the
    level's keys hold; the matched rows' gathered columns and weights read
    once; every output slot written (query row, gathered columns, weight
    and the join's valid flag) and the total. Operations: the probes, and
    one step per range start and per filled slot of the expansion."""
    from dbsp_tpu_torch.zset import cuda_kernels as ck_mod

    if join:
        qkeys, qm, levels, nk, out_cap = args
        total = int(ck_mod.join_ladder_plain(*args)[4])
        gathered, qhi, w_out = levels[0].vals, (), qm.element_size()
    else:
        qkeys, qm, levels, out_cap = args[:4]
        nk = len(qkeys)
        total = int(ck_mod.gather_ladder_plain(*args, **kw)[1])
        gathered = ck_mod._gather_tabs(levels, nk,
                                       kw.get("gather_keys", 0))[0]
        qhi = kw.get("qhi_keys") or ()
        w_out = levels[0].weights.element_size()
    m = qm.shape[0]
    nbytes = sum(_nbytes(c) for c in (*qkeys, *qhi, qm))
    ops = 0
    for lvl in levels:
        steps = m * _steps(lvl.cap)
        nbytes += sum(min(steps * c.element_size(), _nbytes(c))
                      for c in lvl.keys[:nk])
        ops += steps * nk
    filled = min(total, out_cap)
    row = sum(c.element_size() for c in gathered)
    nbytes += filled * (row + levels[0].weights.element_size())
    nbytes += out_cap * (4 + row + w_out + join) + 8
    return nbytes, ops + len(levels) * m + filled


def probe_bound(args):
    """Least bytes and operations of one two-sided ladder probe on these
    inputs: the queries read once; per (level, query) the left side's
    search of ceil(log2(cap + 1)) rows, then the rows the right side must
    compare from the left answer L on: row L where L < cap, and where rows
    equal the query (right > L) the row after their run where right < cap
    and ceil(log2(run)) rows to find its end; each row read is a compare
    of every column, and no more bytes are read than the level holds;
    both [K, m] int32 outputs written once."""
    import torch

    from dbsp_tpu_torch.zset import cuda_kernels as ck_mod

    tables, qcols = args[:2]
    lo, hi = ck_mod.lex_probe_ladder_both(tables, qcols)
    m, ncols = qcols[0].shape[0], len(qcols)
    nbytes = sum(_nbytes(q) for q in qcols) + 2 * 4 * len(tables) * m
    ops = 0
    for k, t in enumerate(tables):
        cap = t[0].shape[0]
        left, right = lo[k].to(torch.int64), hi[k].to(torch.int64)
        run = right - left
        rows = m * int(cap).bit_length() + int(
            (left < cap).sum() + ((run > 0) & (right < cap)).sum()
            + torch.log2(run.clamp(min=1).double()).ceil().sum())
        nbytes += min(rows * sum(c.element_size() for c in t),
                      sum(_nbytes(c) for c in t))
        ops += rows * ncols
    return nbytes, ops


def probe_library(args, kw):
    """One batched ``torch.searchsorted`` over the sentinel-padded
    [K, maxcap] stack of the ladder's FIRST column, clamped to each
    level's cap: the same function for a one-column ladder only."""
    import torch

    tables, qcols = args[:2]
    side = kw.get("side", args[2] if len(args) > 2 else "left")
    dev = qcols[0].device
    caps = torch.tensor([t[0].shape[0] for t in tables], device=dev)
    stack = torch.full((len(tables), int(caps.max())),
                       torch.iinfo(torch.int64).max, device=dev)
    for k, t in enumerate(tables):
        stack[k, :t[0].shape[0]] = t[0]
    q = qcols[0].to(torch.int64).expand(len(tables), -1).contiguous()
    return time_ms(lambda: torch.minimum(
        torch.searchsorted(stack, q, side=side), caps[:, None]))


def seg_bound(args):
    spec, vals, w, seg, nseg, out_dtypes = args[:6]
    used = {c for op, c in spec if op not in ("count", "present")}
    nbytes = sum(_nbytes(vals[c]) for c in used) + _nbytes(w) + _nbytes(seg)
    import torch

    nbytes += sum(nseg * torch.empty((), dtype=d).element_size()
                  for d in out_dtypes)
    return nbytes, w.shape[0] * len(spec)


def rank_bound(args):
    """Least bytes and operations of one rank merge: every row read once
    and written once at its columns' widths; one lexicographic compare
    (one int64 compare per column) per output row, as a merge makes."""
    cols_a, w_a, cols_b, w_b = args
    n = w_a.shape[0] + w_b.shape[0]
    row = sum(c.element_size() for c in cols_a) + w_a.element_size()
    return 2 * n * row, n * len(cols_a)


def agg_bound(args, out):
    """Least bytes and operations of one aggregate-chain call on these
    inputs: the delta and the out trace read once (every column and the
    weights); per ladder level the key bytes the gather's probes touch
    (two searches of ceil(log2(cap + 1)) probes per live query, no more
    than the level's keys) only when a query reaches the gather (the
    fast path's gate can keep every one out), and the gathered rows'
    value and weight bytes; the q_cap-wide outputs written once. The
    operations are those probes, the out trace's two probes per query
    and one per spec op per delta row."""
    delta, nk, out_trace, levels, agg, q_cap, g_cap, fast, flag = args
    gtot = int(out[9])
    live_q = int(out[1].sum()) if bool(flag) else 0
    nbytes = sum(_nbytes(c) for c in (*delta.cols, delta.weights))
    nbytes += sum(_nbytes(c) for c in (*out_trace.cols, out_trace.weights))
    ops = 2 * q_cap * _steps(out_trace.cap) * nk
    ops += delta.cap * (len(agg.reduce_spec()) + 1) * (2 if fast else 1)
    if live_q:
        for lvl in levels:
            probes = 2 * live_q * _steps(lvl.cap) * nk
            nbytes += min(probes * 8,
                          sum(_nbytes(c) for c in lvl.keys[:nk]))
            ops += probes
        row = 8 + sum(c.element_size() for c in levels[0].vals)
        nbytes += min(gtot, g_cap) * row
    nouts = len(agg.out_dtypes)
    nbytes += q_cap * (8 * nk + 1 + 8 + (3 if fast else 2) * (8 * nouts + 1))
    return nbytes, ops


def gate_on_variant(ck: Checker, label: str, call, plain, variants: dict,
                    kw: dict, where: str) -> dict:
    """Check and time one gate-on variant of the aggregate chain's call,
    with gather_cap raised to the bucket of the rows it gathers, and list
    it as "agg_ladder, <label>" in ``variants`` for the turns."""
    from dbsp_tpu_torch.zset import cuda_kernels as ck_mod
    from dbsp_tpu_torch.zset.batch import bucket_cap

    key = f"agg_ladder, {label}"
    total = int(plain(*call)[9])
    if total <= 0:
        fail(f"{key} gathered no rows")
    call = (*call[:6], bucket_cap(total), *call[7:])
    variants[key] = ("agg_ladder", call, kw)
    got = ck.check("agg_ladder", f"largest call, {label}, gather_cap "
                   f"{call[6]} ({where})", AGG, plain, *call)
    if int(got[-1]) != total:
        fail(f"{key}: gathered {int(got[-1])} rows, the plain version "
             f"{total}")
    dev_ms, dev_ops, by_op = device_ms(lambda: ck_mod.agg_ladder(*call),
                                       what=key)
    nbytes, ops = agg_bound(call, ck_mod.agg_ladder(*call))
    return {"queries": int(got[call[1]].sum()),  # qlive, after the qkeys
            "gather_cap": call[6],
            "gathered_rows": total,
            "ms": time_ms(lambda: ck_mod.agg_ladder(*call)),
            "device_ms": dev_ms, "device_ops_per_call": dev_ops,
            "device_ms_by_op": by_op,
            "plain_ms": time_ms(lambda: plain(*call), reps=3),
            "bound_ms": bound(nbytes, ops)[0]}


def graph_capture(name: str, args, kw) -> dict:
    """Whether a CUDA graph takes one call of the kernel entry point
    ``name`` (the aggregate kernel's cooperative launch, the ladder
    consumer's): the call warmed up on a side stream, captured in a
    ``torch.cuda.CUDAGraph``, its outputs zeroed and the graph replayed,
    then held against an eager call's outputs. A capture that raises is
    reported (the finding); a replay that differs fails the run."""
    import torch

    from dbsp_tpu_torch.zset import cuda_kernels as ck_mod

    fn = getattr(ck_mod, name)
    want = [t.clone() for t in flat_outputs(fn(*args, **kw))]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*args, **kw)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            out = flat_outputs(fn(*args, **kw))
    except Exception as e:  # a refusal is what this check reports
        torch.cuda.synchronize()
        return {"captured": False, "error": f"{type(e).__name__}: {e}"[:600]}
    for t in out:
        t.zero_()
    graph.replay()
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(out, want)):
        fail(f"{name} replayed from a CUDA graph differs from the eager "
             f"call")
    return {"captured": True, "replay_equal": True,
            "replay_ms": time_ms(graph.replay),
            "eager_ms": time_ms(lambda: fn(*args, **kw))}


def wide_capture_refused(dev) -> str:
    """A probe over more argument slots than the by-value block takes
    its table from a host buffer per launch, which a CUDA graph would
    read at every replay: its capture must raise. Returns the refusal."""
    import torch

    from dbsp_tpu_torch.zset import cuda_kernels as ck_mod

    rng = np.random.default_rng(17)
    two = ((0, 50, np.int64),) * 2
    tables = [consolidated(rng, 12, 16, dev, spec=two, nv=0).cols
              for _ in range(200)]
    q = consolidated(rng, 300, 512, dev, spec=two, nv=0)
    torch.cuda.synchronize()
    try:
        with torch.cuda.graph(torch.cuda.CUDAGraph()):
            ck_mod.lex_probe_ladder_both(tables, q.cols)
    except RuntimeError as e:
        if "cannot capture" not in str(e):
            raise
        torch.cuda.synchronize()
        return str(e)
    fail("a probe over 606 argument slots was captured in a CUDA graph")


def ladder_shape(args, kw, join: bool) -> dict:
    """The shape of a join or gather call: level caps, queries, out_cap,
    columns and their dtypes, and its unclamped total."""
    from dbsp_tpu_torch.zset import cuda_kernels as ck_mod

    levels = args[2]
    nk = args[3] if join else len(args[0])
    gathered = levels[0].vals if join else ck_mod._gather_tabs(
        levels, nk, kw.get("gather_keys", 0))[0]
    total = ck_mod.join_ladder_plain(*args)[4] if join else \
        ck_mod.gather_ladder_plain(*args, **kw)[1]
    return {"levels": [lvl.cap for lvl in levels],
            "queries": args[1].shape[0],
            "out_cap": args[4] if join else args[3],
            "total": int(total), "key_columns": nk,
            "key_dtypes": [str(c.dtype)[6:] for c in levels[0].keys[:nk]],
            "gathered": [str(c.dtype)[6:] for c in gathered],
            "range_queries": kw.get("qhi_keys") is not None}


LADDER_NO_LIBRARY = (
    "none: torch.searchsorted finds each query's range in one level, but "
    "no one PyTorch call expands the ranges of a ladder of levels into "
    "the matching rows")


def kernel_table(captured, most_queries, runs, ck: Checker,
                 range_call=None):
    """One row per kernel: its launches on each query's run and per
    measured tick, and its times at the largest call the queries gave
    it (``captured``; the ladder join and gather also at their call with
    the most queries, ``most_queries``, and the gather at its largest
    call with range queries, ``range_call``). Also returns the variants
    of those calls it timed, ``{key: (entry point, args, kw)}``, for the
    turns."""
    import torch

    from dbsp_tpu_torch.zset import cuda_kernels as ck_mod

    rows = []
    variants = {}
    for name in REPLACES:
        size, args, kw, query = captured[name]
        if args is None:
            fail(f"no main-path call of {name} was captured")
        entry = ENTRY.get(name, name)
        kern = getattr(ck_mod, entry)  # timed without the launch check
        plain = getattr(ck_mod, entry + "_plain")
        ck.check(name, f"largest call on the queries (size {size}, {query})",
                 launch_checked(name, entry), plain, *args, **kw)
        ms = time_ms(lambda: kern(*args, **kw))
        kernel_device_ms, device_ops, by_op = device_ms(
            lambda: kern(*args, **kw), what=name)
        plain_ms = time_ms(lambda: plain(*args, **kw))
        library_ms = None
        extra = {}
        if name == "lex_probe_ladder":
            nbytes, ops = probe_bound(args)
            library_ms = probe_library(args, kw)
            tables, qcols = args[:2]
            extra["shape"] = {"levels": [t[0].shape[0] for t in tables],
                              "queries": qcols[0].shape[0],
                              "columns": len(qcols)}
            extra["entry"] = "lex_probe_ladder_both (both sides, one launch)"
            extra["library_note"] = (
                "batched torch.searchsorted over the sentinel-padded "
                "[K, maxcap] stack of the first column + clamp to each "
                "level's cap, side left: one side of the same function, "
                "for one key column only")
        elif name in ("join_ladder", "gather_ladder"):
            join = name == "join_ladder"
            nbytes, ops = ladder_bound(args, kw, join=join)
            extra["library_note"] = LADDER_NO_LIBRARY
            extra["shape"] = ladder_shape(args, kw, join)
            # one call of the library: its kernels' device ops, one more
            # where the argument block goes as a device table
            sh = extra["shape"]
            slots = ck_mod.load_library("ladder_consumer").ladder_slots(
                len(sh["levels"]), sh["key_columns"], len(sh["gathered"]))
            want_ops = ck_mod.LADDER_KERNELS + (slots > ck_mod.ARGS_MAX)
            if device_ops != want_ops:
                fail(f"{name}: {device_ops} device ops a call, want "
                     f"{want_ops} ({slots} argument slots)")
            # the call's time split: every query dead (the two launches
            # and the dead slots: no search, no match), and out_cap 1
            # (every search and the expansion's walk over the range
            # starts, one slot filled); and the main-path call with the
            # most queries (the join's: q4's bids delta against its
            # auctions, with matches)
            dead, one = list(args), list(args)
            dead[1] = torch.zeros_like(args[1])
            one[4 if join else 3] = 1
            _, most, most_kw, most_query = most_queries[name]
            calls = [("every query dead", tuple(dead), kw, query),
                     ("out_cap 1", tuple(one), kw, query),
                     ("most queries", most, most_kw, most_query)]
            if not join and range_call and range_call[0] >= 0 and \
                    range_call[1] is not args:
                calls.append(("largest with range queries",
                              *range_call[1:]))
            for label, call, ckw, on in calls:
                ck.check(name, f"{label} ({on})", launch_checked(name),
                         plain, *call, **ckw)
                variants[f"{name}, {label}"] = (name, call, ckw)
                v_ms, v_ops, v_by_op = device_ms(
                    lambda: kern(*call, **ckw), what=f"{name}, {label}")
                extra[label] = {
                    "ms": time_ms(lambda: kern(*call, **ckw)),
                    "device_ms": v_ms, "device_ops_per_call": v_ops,
                    "device_ms_by_op": v_by_op,
                    "bound_ms": bound(*ladder_bound(call, ckw, join))[0],
                    "shape": ladder_shape(call, ckw, join), "timed_on": on}
        elif name == "agg_ladder":
            out = ck_mod.agg_ladder(*args)
            nbytes, ops = agg_bound(args, out)
            extra["gathered_rows"] = int(out[9])
            extra["gate"] = bool(args[8])
            # the same call with the gate on, and on skewed groups (few
            # queries with long histories), gather_cap at the bucket of
            # the rows gathered so the history does not overflow
            on = (*args[:8], torch.ones((), dtype=torch.bool,
                                        device=args[0].device))
            for label, key, call in (("gate on", "gate_on", on),
                                     ("gate on, skewed", "gate_on_skewed",
                                      skewed_history(args))):
                extra[key] = gate_on_variant(ck, label, call,
                                             plain, variants, kw,
                                             f"size {size}, {query}")
            extra["shape"] = {"delta": args[0].cap,
                              "out_trace": args[2].cap,
                              "levels": [lvl.cap for lvl in args[3]],
                              "q_cap": args[5], "gather_cap": args[6]}
            extra["library_note"] = (
                "none: no one PyTorch call groups a delta, gathers its "
                "groups across a ladder of sorted levels and diffs them "
                "against the previous outputs")
        elif name == "segment_reduce":
            nbytes, ops = seg_bound(args)
            spec, vals, w, seg, nseg = args[:5]
            op, col = spec[0]
            v = vals[col]
            red = {"max": "amax", "min": "amin"}.get(op, "sum")
            idx = torch.where((seg >= 0) & (seg < nseg), seg,
                              nseg).to(torch.int64)
            base = torch.zeros(nseg + 1, dtype=v.dtype, device=v.device)
            library_ms = time_ms(lambda: base.scatter_reduce(
                0, idx, v, reduce=red, include_self=True))
            # the same call with uniformly random ids: runs of one row
            rnd = random_ids(args)
            variants[f"{name}, random ids"] = (name, rnd, kw)
            ck.check(name, f"largest call with random ids (size {size})",
                     kern, plain, *rnd, **kw)
            rnd_ms, rnd_ops, rnd_by_op = device_ms(
                lambda: kern(*rnd, **kw), what=f"{name}, random ids")
            extra["random_ids"] = {
                "ms": time_ms(lambda: kern(*rnd, **kw)),
                "device_ms": rnd_ms, "device_ops_per_call": rnd_ops,
                "device_ms_by_op": rnd_by_op}
            extra["shape"] = {"rows": w.shape[0], "segments": nseg,
                              "spec": [op for op, _ in spec],
                              "id_dtype": str(seg.dtype)}
        else:
            nbytes, ops = rank_bound(args)
            extra["tile"] = ck_mod.rank_merge_tile(len(args[0]))
            extra["shape"] = {"a": args[1].shape[0], "b": args[3].shape[0],
                              "columns": len(args[0])}
            # yardstick: one stable sort of the two runs' FIRST column
            # concatenated, which orders one-column rows the same way
            both = torch.cat([args[0][0], args[2][0]])
            library_ms = time_ms(lambda: torch.sort(both, stable=True))
            extra["library_note"] = (
                "stable torch.sort of the one-column concatenation of both "
                "runs: the same order for one-column rows only")
        bound_ms, bound_by = bound(nbytes, ops)
        by_query = {q: launches[name] for q, (launches, _) in runs.items()
                    if launches[name]}
        rows.append({
            "name": name, "route": "cuda", "source": SOURCE[name],
            "replaces": REPLACES[name],
            "launches": sum(by_query.values()),
            "launches_by_query": by_query,
            "launches_per_tick": {
                q: sum(per_tick[name]) / len(per_tick[name])
                for q, (_, per_tick) in runs.items()
                if q in by_query and per_tick[name]},
            "max_abs_err": ck.max_err[name], "ms": ms,
            "device_ms": kernel_device_ms,
            "device_ops_per_call": device_ops, "device_ms_by_op": by_op,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "checks": ck.cases[name],
            "timed_call_size": size, "timed_on": query, **extra,
        })
    return rows, variants


# ---------------------------------------------------------------------------
# Turns: the redesigned kernels of another tree against this one's
# ---------------------------------------------------------------------------


def _portable(x):
    """``x`` with every tensor on the CPU, every list a tuple and every
    dataclass instance of the package (a ``Batch``, an aggregator) a dict
    ``{"__dataclass__": "module:name", "fields": {...}}``, which
    :func:`_to` rebuilds with the classes of whichever tree it runs in."""
    import dataclasses

    import torch

    if isinstance(x, torch.Tensor):
        return x.cpu()
    if isinstance(x, (tuple, list)):
        return tuple(_portable(t) for t in x)
    if isinstance(x, dict):
        return {k: _portable(v) for k, v in x.items()}
    cls = type(x)
    if dataclasses.is_dataclass(x) and \
            cls.__module__.startswith("dbsp_tpu_torch."):
        return {"__dataclass__": f"{cls.__module__}:{cls.__qualname__}",
                "fields": {f.name: _portable(getattr(x, f.name))
                           for f in dataclasses.fields(x) if f.init}}
    return x


def _to(x, dev):
    """A (nested) tuple, list or dict of tensors and plain values, with
    every tensor on ``dev``, every list a tuple and every dataclass that
    :func:`_portable` saved rebuilt."""
    import importlib

    import torch

    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, (tuple, list)):
        return tuple(_to(t, dev) for t in x)
    if isinstance(x, dict) and "__dataclass__" in x:
        module, name = x["__dataclass__"].split(":")
        cls = getattr(importlib.import_module(module), name)
        return cls(**{k: _to(v, dev) for k, v in x["fields"].items()})
    if isinstance(x, dict):
        return {k: _to(v, dev) for k, v in x.items()}
    return x


def _plain_data(x) -> bool:
    """``x`` holds only tensors, numbers, strings, dtypes and None, in
    tuples, lists and dicts: another tree of the package can load it."""
    import torch

    if isinstance(x, (tuple, list)):
        return all(_plain_data(t) for t in x)
    if isinstance(x, dict):
        return all(_plain_data(v) for v in x.values())
    return x is None or isinstance(x, (torch.Tensor, torch.dtype, int,
                                       float, str, bool))


def time_calls(ck_mod, calls: dict, label: str) -> dict:
    """Time each saved call ``{key: (entry point, args, kw)}`` whose entry
    point ``ck_mod`` has: launches per call, a checksum of its outputs,
    ``ms``, ``device_ms`` and the device operations per call, whole and
    by name, as in the kernel table."""
    import torch

    dev = torch.device("cuda")
    out = {"tree": label}
    for name, (entry, args, kw) in calls.items():
        fn = getattr(ck_mod, entry, None)
        if fn is None:
            continue
        args, kw = _to(args, dev), _to(kw, dev)
        ck_mod.reset_launches()
        got = flat_outputs(fn(*args, **kw))
        torch.cuda.synchronize()
        out[name] = {
            "launches_per_call": sum(ck_mod.LAUNCHES.values()),
            "checksum": [int((t.to(torch.int64) * torch.arange(
                1, t.numel() + 1, device=dev).reshape(t.shape)).sum())
                for t in got],
            "ms": time_ms(lambda: fn(*args, **kw))}
        (out[name]["device_ms"], out[name]["device_ops_per_call"],
         out[name]["device_ms_by_op"]) = device_ms(
            lambda: fn(*args, **kw), what=f"{name} ({label})")
    out["profiler_retries"] = list(profiler_retries)
    return out


def time_saved(tree: str, path: str) -> None:
    """One turn: import the package of ``tree``, time the calls saved in
    ``path`` (:func:`time_calls`), print one JSON line."""
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import torch

    from dbsp_tpu_torch.zset import cuda_kernels as ck_mod

    if not os.path.abspath(ck_mod.__file__).startswith(tree + os.sep):
        fail(f"imported {ck_mod.__file__}, not the package in {tree}")
    print(json.dumps(time_calls(ck_mod, torch.load(path), tree)),
          flush=True)


def time_in_turns(calls: dict, others: list) -> list:
    """The kernels' largest main-path calls ``{key: (entry point, args,
    kw)}`` that can be saved (:func:`_plain_data`), timed in every tree of
    ``others`` and in this one, in turns (the others, this, this, the
    others in reverse), each turn a process of its own; first, the same
    saved calls in this process. A tree times the entry points it has.
    Fails unless the outputs of an entry point are equal in every turn
    that timed it."""
    import torch

    from dbsp_tpu_torch.zset import cuda_kernels as ck_mod

    here = os.path.dirname(os.path.abspath(__file__))
    saved = {name: _portable(call) for name, call in calls.items()}
    saved = {name: call for name, call in saved.items()
             if _plain_data(call)}
    path = os.path.join(os.path.abspath(others[0]), "timed_inputs.pt")
    torch.save(saved, path)
    turns = [time_calls(ck_mod, torch.load(path), "this, in this process")]
    try:
        for tree in (*others, here, here, *others[::-1]):
            r = subprocess.run([sys.executable, os.path.abspath(__file__),
                                "--time-saved", tree, path],
                               capture_output=True, text=True, timeout=600)
            if r.returncode != 0:
                fail(f"timing turn in {tree} failed:\n{r.stderr[-3000:]}")
            turns.append(json.loads(r.stdout.strip().splitlines()[-1]))
    finally:
        os.remove(path)
    for name in saved:
        sums = {json.dumps(t[name]["checksum"]) for t in turns if name in t}
        if len(sums) > 1:
            fail(f"{name}: the trees' outputs differ on the same inputs")
    return turns


# ---------------------------------------------------------------------------


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", metavar="DIR", action="append",
                    help="also time the kernels' largest calls in the tree "
                         "in DIR against this tree's, in turns (repeat for "
                         "more trees)")
    ap.add_argument("--time-saved", nargs=2, metavar=("TREE", "FILE"),
                    help=argparse.SUPPRESS)  # one turn, run by --parent
    ap.add_argument("--scanned", metavar="CARD",
                    help=argparse.SUPPRESS)  # phase 4d, run by phase 4
    opts = ap.parse_args()
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("CUDA is not available: this script needs an NVIDIA GPU")
    if opts.time_saved:
        time_saved(*opts.time_saved)
        return 0
    if opts.scanned:
        CARD[0] = opts.scanned
        for name in SCANNED:
            with phase(f"scanned {name}"):
                run_scanned(name)
        return 0
    try:
        from dbsp_tpu_torch.zset import cuda_kernels as ck_mod
    except ImportError as e:
        fail(f"the dbsp_tpu_torch package is not beside this script ({e})")

    # 1. device
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    say(f"device: {kind} (count {count}); torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    say(f"nvidia-smi: {smi_line}")
    dev = torch.device("cuda")

    CARD[0] = smi_line

    # 2. build
    with phase("build"):
        ck_mod.build(verbose=True)
        for src in ck_mod.SOURCES:
            ck_mod.load_library(src.rsplit(".", 1)[0])

    # 3. kernels vs plain versions on the card
    ck = Checker()
    with phase("kernels"):
        check_kernels(ck, dev)
    say(f"kernels: {json.dumps(ck.cases)} cases equal to the plain "
        f"versions, tolerance 0 (exact: integer data); of gather_ladder's, "
        f"{ck.range_gather_keys} in range mode with gather_keys=1")

    # 4. the queries' paths on the card, one after the other, each with
    #    the launch counts set to 0 just before it and read just after
    runs = {}
    all_events: dict = {}
    with contextlib.ExitStack() as stack:
        recs = [stack.enter_context(r) for r in recorders()]
        for name in QUERIES:
            with phase(f"query {name}"):
                runs[name] = run_query(name, all_events)
        all_events.clear()
        # 4b. the compiled engine's paths, each with its own counts
        for name in COMPILED:
            with phase(f"compiled {name}"):
                runs[f"{name}-compiled"] = run_compiled(name)
        # 4c. the Z-set algebra nodes, compiled, in feeds mode
        with phase("algebra"):
            runs["algebra-compiled"] = run_algebra()
        # 4c'. a user-defined Fold, compiled: the aggregate's stitched route
        with phase("fold"):
            runs["fold-compiled"] = run_fold()
        # 4d. the scanned mode: each interval one CUDA-graph replay, state
        #     for state equal to the eager run; in a process of its own,
        #     since torch.profiler sessions over graph replays left this
        #     process's later sessions without their first device events
        #     (the kernel table's device times)
        with phase("scanned"):
            r = subprocess.run([sys.executable, os.path.abspath(__file__),
                                "--scanned", smi_line], timeout=900)
            if r.returncode != 0:
                fail("phase 4d (the scanned mode) failed")
        # 4e. the serving driver, fed through the input handles
        with phase("driver"):
            runs["q4-driver"] = run_driver()
    # the largest ladder gather by argument slots (the top-K queries'
    # old-output gathers among them) must take its table by value
    slots, args, _, query = next(
        r for r in recs if r.name == "gather_ladder").kept[2]
    say(json.dumps({"largest_gather_by_slots": {
        "query": query, "levels": len(args[2]), "argument_slots": slots,
        "args_max": ck_mod.ARGS_MAX}}))
    if slots > ck_mod.ARGS_MAX:
        fail(f"{query}'s ladder gather over {len(args[2])} levels takes "
             f"{slots} argument slots, above {ck_mod.ARGS_MAX}: its table "
             "would come from a host buffer")
    captured = {r.name: r.best for r in recs}
    most_queries = {r.name: r.alt for r in recs}
    calls = {name: (name, args, kw) for name, (_, args, kw, _) in
             captured.items() if args is not None}
    captured["rank_merge"] = captured.pop("rank_merge_scatter")
    captured["lex_probe_ladder"] = captured.pop("lex_probe_ladder_both")

    # 5. cross-check CPU vs card
    with phase("cross"):
        for name in QUERIES:
            rows = cross_check(name)
            say(f"cross-check {name}: {CROSS_TICKS} ticks of {CROSS_EVENTS} "
                f"events, {rows} output rows equal on the CPU and on the "
                "card")

    # 6. kernel table at the shapes the queries gave each kernel
    with phase("timing"):
        table, variants = kernel_table(
            captured, most_queries, runs, ck,
            next(r for r in recs if r.name == "gather_ladder").kept[3])
    if opts.parent:
        # 7. the other trees' kernels against this tree's, in turns
        with phase("turns"):
            say(json.dumps({"turns": time_in_turns({**calls, **variants},
                                                    opts.parent)}))
    # 8. whether a CUDA graph captures the cooperative launches of the
    #    aggregate kernel and the ladder consumer (a join and a gather)
    with phase("graph"):
        say(json.dumps({"graph_capture": {
            name: graph_capture(name, *captured[name][1:3])
            for name in ("agg_ladder", "join_ladder", "gather_ladder")}}))
        say(json.dumps({"wide_probe_capture": wide_capture_refused(dev)}))
    say(json.dumps({"profiler_retries": profiler_retries,
                    "profiler_dropped_first_events": profiler_dropped}))
    say(json.dumps({"kernels": table}))
    say(smi_line)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind, "count": count}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
