"""The hand-written CUDA kernels of the port, each wrapper beside its plain
PyTorch version — counterpart of ``dbsp_tpu/zset/pallas_kernels.py``.

* ``lex_probe_ladder`` (``csrc/probe_ladder.cu``) replaces
  ``lex_probe_ladder_pallas`` (pallas_kernels.py:145);
* ``join_ladder`` and ``gather_ladder`` (``csrc/ladder_consumer.cu``)
  replace ``join_ladder_pallas`` (pallas_kernels.py:338) and
  ``gather_ladder_pallas`` (:357);
* ``segment_reduce`` (``csrc/segment_reduce.cu``) replaces
  ``segment_reduce_pallas`` (:430);
* ``rank_merge_scatter`` (``csrc/rank_merge.cu``) replaces
  ``rank_merge_scatter`` (:519);
* ``agg_ladder`` (``csrc/agg_ladder.cu``) replaces ``agg_ladder_pallas``
  (:472), which has no ``pallas_call`` of its own: the compiled
  aggregate's whole chain, which the Pallas version composes of its
  gather and segment-reduce kernels, in one cooperative launch.

Dispatch is by the device of the tensors a wrapper is given: on a CPU
tensor it runs its plain version (``*_plain``, same module), on a CUDA
tensor it launches its kernel or raises. There is no fallback from one to
the other. Each launch adds one to ``LAUNCHES[name]``.

The kernels are compiled at first use with ``nvcc`` for ``sm_90a``, one
shared library per source with a plain C interface, all sources at once,
into ``dbsp_tpu_torch/_build/<hash of the sources>/``, and loaded with
``ctypes``. Every kernel reads (and writes) each column at its own width,
with its element type in the argument block (``_KINDS``); float columns
are refused. A launch's pointers and sizes travel in one argument block:
by value as a kernel parameter up to ``ARGS_MAX`` slots, above that as a
device table uploaded from pinned memory without a sync, so a ladder of
any depth launches. The ladder consumer and the aggregate chain build
their argument block from a per-signature plan (slot layout, element
types, constants) and return their outputs as views of one buffer.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, NamedTuple, Sequence, Tuple

import torch

from dbsp_tpu_torch.zset import kernels

Cols = Tuple[torch.Tensor, ...]

# launches per wrapper; a run resets them with reset_launches()
LAUNCHES: Dict[str, int] = dict.fromkeys(
    ("lex_probe_ladder", "join_ladder", "gather_ladder", "segment_reduce",
     "rank_merge", "agg_ladder"), 0)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# Build and load
# ---------------------------------------------------------------------------

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
SOURCES = ("probe_ladder.cu", "ladder_consumer.cu", "segment_reduce.cu",
           "rank_merge.cu", "agg_ladder.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
# slots of the by-value argument block, above which a launch takes a
# device table instead; widest searched row (csrc/common.cuh ARGS_MAX,
# MAX_COLS)
ARGS_MAX = 448
MAX_COLS = 16
# element type of a column read at its own width (ColKind, csrc/common.cuh)
_KINDS = {torch.int64: 0, torch.int32: 1, torch.int16: 2, torch.int8: 3,
          torch.uint8: 4, torch.bool: 5}

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOAD_LOCK = threading.Lock()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: nvcc is needed to build "
                           "the port's kernels")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def build(verbose: bool = False) -> Dict[str, Path]:
    """Compile every source into its own shared library, with one ``nvcc``
    per source, all started together. Libraries already built for the same
    sources and flags are reused. Returns {source stem: library path}.
    ``verbose`` adds ``-Xptxas -v`` and prints the compiler's report."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        digest.update(f.name.encode())
        digest.update(f.read_bytes())
    out_dir = BUILD_DIR / digest.hexdigest()[:16]
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {Path(s).stem: out_dir / (Path(s).stem + ".so") for s in SOURCES}
    todo = [(src, stem, so) for src, (stem, so) in zip(SOURCES, libs.items())
            if not so.exists()]
    nvcc = _nvcc() if todo else None
    procs = []
    for src, stem, so in todo:
        tmp = so.with_name(f"{stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
               "-o", str(tmp), str(CSRC / src)]
        procs.append((so, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for so, tmp, proc in procs:  # wait for every one, failed or not
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{so.stem}: nvcc exit {proc.returncode}\n{log}")
            continue
        if verbose and log.strip():
            print(f"[nvcc {so.stem}]\n{log}", flush=True)
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return libs


def _declare(lib: ctypes.CDLL) -> None:
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    # every launcher starts with (host slots, slot count, device table)
    block = [P, I, P]
    if hasattr(lib, "lex_probe_ladder"):
        lib.lex_probe_ladder.argtypes = block + [I, I, L, P, P, P]
        lib.lex_probe_ladder.restype = I
    if hasattr(lib, "ladder_consumer"):
        lib.ladder_slots.argtypes = [I, I, I]
        lib.ladder_slots.restype = I
        lib.ladder_scratch_elems.argtypes = [I, L]
        lib.ladder_scratch_elems.restype = L
        lib.ladder_consumer.argtypes = block + [I, I, I, L, L, I, I, P]
        lib.ladder_consumer.restype = I
    if hasattr(lib, "segment_reduce"):
        lib.segment_reduce.argtypes = block + [I, I, L, L, P, P]
        lib.segment_reduce.restype = I
    if hasattr(lib, "rank_merge"):
        lib.rank_merge.argtypes = block + [I, L, L, I, P]
        lib.rank_merge.restype = I
    if hasattr(lib, "agg_ladder"):
        lib.agg_ladder_scratch_elems.argtypes = [I, I, L, L, I]
        lib.agg_ladder_scratch_elems.restype = L
        lib.agg_ladder.argtypes = block + [I, I, I, I, L, L, L, L, L, I, I,
                                           P, P, P]
        lib.agg_ladder.restype = I


def load_library(stem: str) -> ctypes.CDLL:
    """The loaded kernel library built from ``csrc/<stem>.cu`` (building
    all of them at first use). Raises when CUDA is not available."""
    with _LOAD_LOCK:
        if not _LIBS:
            if not torch.cuda.is_available():
                raise RuntimeError("CUDA is not available: the port's "
                                   "kernels need an NVIDIA GPU")
            for name, path in build().items():
                lib = ctypes.CDLL(str(path))
                _declare(lib)
                _LIBS[name] = lib
    return _LIBS[stem]


# ---------------------------------------------------------------------------
# Launch plumbing
# ---------------------------------------------------------------------------


def _on_cpu(t: torch.Tensor) -> bool:
    return t.device.type == "cpu"


class _ArgBlock:
    """The argument block of one launch (``Args`` / ``ArgTable`` in
    csrc/common.cuh): ``n_slots`` int64 slots of pointers and sizes. Up to
    ``ARGS_MAX`` slots the kernels take it by value as a kernel parameter;
    above that :meth:`table` uploads it to the device (pinned host copy,
    asynchronous, no sync) and the kernels read it there. Keeps every
    contiguous copy it makes referenced until the launch is queued."""

    def __init__(self, device: torch.device, n_slots: int, what: str):
        self.device = device
        self.index = device.index
        self.n_slots = n_slots
        self.slots = (ctypes.c_longlong * max(n_slots, 1))()
        self.keep: List[torch.Tensor] = []
        self.what = what

    @property
    def by_value(self) -> bool:
        return self.n_slots <= ARGS_MAX

    def col_at_width(self, slot: int, t: torch.Tensor) -> int:
        """Put column ``t`` in ``slot`` as it is (made contiguous if it is
        not); returns its ColKind."""
        kind = _kind(t.dtype, self.what)
        self.ptrs(slot, (t,))
        return kind

    def ptrs(self, slot0: int, cols: Sequence[torch.Tensor]) -> None:
        """Put ``cols`` in the slots from ``slot0`` on as they are (made
        contiguous if they are not); their ColKinds are the caller's."""
        for i, t in enumerate(cols):
            if t.get_device() != self.index:  # -1 off CUDA
                raise ValueError(f"{self.what}: needs CUDA tensors on "
                                 f"{self.device}, got one on {t.device}")
            if not t.is_contiguous():
                t = t.contiguous()
                self.keep.append(t)
            self.slots[slot0 + i] = t.data_ptr()

    def cols_at_width(self, slot0: int, cols: Sequence[torch.Tensor]) -> int:
        """Put ``cols``, which share one ColKind, in the slots from
        ``slot0`` on; returns that ColKind."""
        kinds = {self.col_at_width(slot0 + i, c) for i, c in enumerate(cols)}
        if len(kinds) != 1:
            raise ValueError(f"{self.what}: one column of every level must "
                             f"share a dtype, got {[c.dtype for c in cols]}")
        return kinds.pop()

    def out(self, slot: int, n: int) -> torch.Tensor:
        t = torch.empty((n,), dtype=torch.int64, device=self.device)
        self.slots[slot] = t.data_ptr()
        return t

    def packed(self) -> torch.Tensor:
        """The slots as an int64 host tensor (a view of the block)."""
        return torch.frombuffer(self.slots, dtype=torch.int64)[:self.n_slots]

    def table(self) -> torch.Tensor:
        """The slots as an int64 tensor on the block's (CUDA) device. The
        copy goes through pinned memory and does not block; the caching
        allocators keep both buffers until the copy and the kernels
        reading the table are done (stream order)."""
        return self.packed().pin_memory().to(self.device, non_blocking=True)

    def launch(self, fn, *argv) -> None:
        """Launch ``fn`` on the current stream of the block's device (made
        the current device for the launch if it is not)."""
        if torch.cuda.current_device() != self.index:
            with torch.cuda.device(self.device):
                return self.launch(fn, *argv)
        table = None
        if not self.by_value:
            if torch.cuda.is_current_stream_capturing():
                # a captured copy would read the host buffer at every
                # replay, long after this block is gone
                raise RuntimeError(
                    f"{self.what}: {self.n_slots} argument slots (more than "
                    f"{ARGS_MAX}) go through a device table uploaded per "
                    "launch, which a CUDA graph cannot capture")
            table = self.table()
            self.keep.append(table)
        rc = fn(ctypes.addressof(self.slots), self.n_slots,
                None if table is None else table.data_ptr(), *argv,
                _current_stream(self.index))
        if rc != 0:
            raise RuntimeError(f"{self.what}: kernel launch failed with CUDA "
                               f"error {rc}")


def _current_stream(index: int) -> int:
    """The handle of device ``index``'s current CUDA stream; without
    building a ``torch.cuda.Stream`` where torch offers that."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    return raw(index) if raw else torch.cuda.current_stream(index).cuda_stream


def _cuda_device(t: torch.Tensor, what: str) -> torch.device:
    if not t.is_cuda:
        raise ValueError(f"{what}: needs a CPU tensor (plain version) or a "
                         f"CUDA tensor (kernel), got one on {t.device}")
    return t.device


def _kind(dtype: torch.dtype, what: str) -> int:
    kind = _KINDS.get(dtype)
    if kind is None:
        raise ValueError(f"{what}: integer columns of 1, 2, 4 or 8 bytes and "
                         f"bool columns only, got {dtype}")
    return kind


class _Carve(NamedTuple):
    """Outputs of several dtypes as views of one int64 buffer
    (:func:`_carve_plan`, :func:`_carve`)."""

    # the outputs of one dtype lie side by side: per dtype (dtype, first
    # and last int64 element, its outputs' indices, their lengths and the
    # padding after them)
    regions: tuple
    zero_d: tuple  # the outputs that are 0-d tensors
    byte_offsets: tuple  # each output's place in the buffer
    n_out: int  # int64 elements of the outputs
    n: int  # outputs


def _carve_plan(shapes) -> _Carve:
    """The carving of outputs ``shapes``, (dtype, length or None for a 0-d
    tensor) each, out of one int64 buffer."""
    regions, byte_offsets, off = [], [0] * len(shapes), 0
    for dtype in dict.fromkeys(dt for dt, _ in shapes):
        idx = tuple(x for x, (dt, _) in enumerate(shapes) if dt == dtype)
        sizes = tuple(shapes[x][1] or 1 for x in idx)
        per, at = 8 // dtype.itemsize, 0
        for x, n in zip(idx, sizes):
            byte_offsets[x] = 8 * off + at * dtype.itemsize
            at += n
        n64 = max(1, -(-at // per))
        regions.append((dtype, off, off + n64, idx, sizes, n64 * per - at))
        off += n64
    return _Carve(tuple(regions),
                  tuple(x for x, (_, n) in enumerate(shapes) if n is None),
                  tuple(byte_offsets), off, len(shapes))


def _carve(buf: torch.Tensor, c: _Carve) -> list:
    """The outputs of ``c`` as views of ``buf`` (int64, at least
    ``c.n_out`` elements)."""
    outs = [None] * c.n
    for dtype, lo, hi, idx, sizes, pad in c.regions:
        parts = buf[lo:hi].view(dtype).split_with_sizes((*sizes, pad))
        for x, part in zip(idx, parts):
            outs[x] = part
    for x in c.zero_d:
        outs[x] = outs[x][0]
    return outs


# ---------------------------------------------------------------------------
# Ladder-wide lex probe; its plain version heads the stitched chain that the
# ladder consumers' plain versions are built of
# ---------------------------------------------------------------------------


def probe_ladder_slots(K: int, ncols: int) -> int:
    """Argument slots of one probe launch over ``K`` levels of ``ncols``
    columns: the level columns, the query columns, the level caps and the
    columns' kinds (csrc/probe_ladder.cu's layout)."""
    return K * (ncols + 1) + 3 * ncols


def _probe_ladder(tables: Sequence[Cols], query_cols: Cols):
    """One launch of csrc/probe_ladder.cu: the [K, m] int32 ``(lo, hi)``
    of side left and side right."""
    what = "lex_probe_ladder"
    dev = _cuda_device(query_cols[0], what)
    K, ncols, m = len(tables), len(query_cols), query_cols[0].shape[0]
    if K < 1 or not 1 <= ncols <= MAX_COLS:
        raise ValueError(f"{what}: needs levels and 1..{MAX_COLS} columns "
                         f"(K={K}, ncols={ncols})")
    lo, hi = torch.empty((2, K, m), dtype=torch.int32, device=dev)
    if m == 0:
        return lo, hi
    q = ncols * K
    caps = q + ncols
    kinds = caps + K
    args = _ArgBlock(dev, probe_ladder_slots(K, ncols), what)
    for k, t in enumerate(tables):
        if len(t) != ncols:
            raise ValueError(f"{what}: level {k} has {len(t)} columns, the "
                             f"queries {ncols}")
        args.slots[caps + k] = t[0].shape[0]
    for c in range(ncols):
        args.slots[kinds + c] = args.cols_at_width(
            c * K, [t[c] for t in tables])
        args.slots[kinds + ncols + c] = args.col_at_width(q + c,
                                                          query_cols[c])
    args.launch(load_library("probe_ladder").lex_probe_ladder, K, ncols, m,
                lo.data_ptr(), hi.data_ptr())
    LAUNCHES[what] += 1
    return lo, hi


def lex_probe_ladder(tables: Sequence[Cols], query_cols: Cols,
                     side: str = "left") -> torch.Tensor:
    """Insertion points of ``query`` rows into EVERY sorted table: [K, m]
    int32, lane (k, i) == ``lex_probe(tables[k], query_cols, side)[i]``;
    each level's lanes are clamped to its own row count. Every lane gets
    its raw insertion point, sentinel queries included: callers mask dead
    rows themselves. On a CUDA tensor it is one side of
    :func:`lex_probe_ladder_both`'s launch."""
    if _on_cpu(query_cols[0]):
        return lex_probe_ladder_plain(tables, query_cols, side)
    if side not in ("left", "right"):
        raise ValueError(f"lex_probe_ladder: side must be 'left' or "
                         f"'right', got {side!r}")
    return _probe_ladder(tables, query_cols)[side == "right"]


def lex_probe_ladder_both(tables: Sequence[Cols], query_cols: Cols
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both sides of :func:`lex_probe_ladder` in one launch: ``(lo, hi)``,
    the [K, m] int32 insertion points of side left and side right. Exact
    on any sorted tables, duplicate rows included."""
    if _on_cpu(query_cols[0]):
        return lex_probe_ladder_both_plain(tables, query_cols)
    return _probe_ladder(tables, query_cols)


def lex_probe_ladder_both_plain(tables: Sequence[Cols], query_cols: Cols
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`lex_probe_ladder_both`: the two plain
    one-sided probes."""
    return (lex_probe_ladder_plain(tables, query_cols, "left"),
            lex_probe_ladder_plain(tables, query_cols, "right"))


def lex_probe_ladder_plain(tables: Sequence[Cols], query_cols: Cols,
                           side: str = "left") -> torch.Tensor:
    """Plain version of :func:`lex_probe_ladder`: one vectorized binary
    search over all levels at once (reference ``cursor.lex_probe_ladder``,
    XLA branch)."""
    assert tables, "lex_probe_ladder: empty ladder"
    m = query_cols[0].shape[0]
    dev = query_cols[0].device
    caps = [t[0].shape[0] for t in tables]
    strict = side == "left"
    lo = torch.zeros((len(tables), m), dtype=torch.int64, device=dev)
    hi = torch.stack([torch.full((m,), c, dtype=torch.int64, device=dev)
                      for c in caps])
    for _ in range(max(c.bit_length() for c in caps)):
        active = lo < hi
        mid = (lo + hi) >> 1
        # an empty level's lanes are never active: it reads nothing
        go_right = torch.stack([
            kernels._lex_le_rows(t, torch.clamp(mid[k], 0, c - 1),
                                 query_cols, strict) if c
            else torch.zeros((m,), dtype=torch.bool, device=dev)
            for k, (t, c) in enumerate(zip(tables, caps))])
        lo = torch.where(active & go_right, mid + 1, lo)
        hi = torch.where(active & ~go_right, mid, hi)
    return lo.to(torch.int32)


def expand_ladder(lo: torch.Tensor, hi: torch.Tensor, out_cap: int):
    """Flatten [K, m] per-(level, query) ranges into ONE buffer, level-major
    (level 0's matches, query-major within it, then level 1's, ...).
    Returns ``(level, qrow, src, valid, total)``, each [out_cap] except the
    unclamped int64 ``total``."""
    K, m = lo.shape
    flat, src, valid, total = kernels.expand_ranges(
        lo.reshape(K * m), hi.reshape(K * m), out_cap)
    flat = flat.to(torch.int64)
    level = flat // m
    return level, flat - level * m, src, valid, total


def _select_gather(cols_per_level: Sequence[Cols], level: torch.Tensor,
                   src: torch.Tensor) -> Cols:
    """Gather column values from the level each output slot resolved to:
    one clamped gather per level per column, combined by level-id select.
    A level of no rows owns no slot, so it is skipped (its slots, if any
    were dead, keep the zeros every consumer masks)."""
    if not cols_per_level[0]:
        return ()
    src = src.to(torch.int64)
    outs: List[torch.Tensor] = []
    for ci in range(len(cols_per_level[0])):
        c0 = cols_per_level[0][ci]
        acc = torch.zeros(src.shape, dtype=c0.dtype, device=src.device)
        for k, cols in enumerate(cols_per_level):
            c = cols[ci]
            if c.shape[0] == 0:
                continue
            v = c[torch.clamp(src, 0, c.shape[0] - 1)]
            acc = torch.where(level == k, v, acc)
        outs.append(acc)
    return tuple(outs)


# ---------------------------------------------------------------------------
# Ladder consumer: join_ladder / gather_ladder
# ---------------------------------------------------------------------------


# merged items (range starts and slots) of a warp tile of the expansion,
# and kernels a call launches (csrc/ladder_consumer.cu WARP_TILE =
# 32 x ITEMS, the probe and the expansion)
LADDER_TILE = 128
LADDER_KERNELS = 2


class _LadderPlan(NamedTuple):
    """What a launch of csrc/ladder_consumer.cu takes that depends only on
    the call's signature (:func:`_ladder_plan`)."""

    n_slots: int
    template: tuple  # every slot but the pointers, level caps and outputs
    caps: int  # the slot of level 0's row count
    out: int  # the slot of the first output's pointer
    out_dtypes: tuple  # each gathered column's, then w's


@functools.lru_cache(maxsize=64)
def _ladder_plan(K: int, nk: int, ng: int, dtypes: tuple, join: bool,
                 same_hi: bool) -> _LadderPlan:
    """The plan of a call whose columns have ``dtypes``, in the order of
    their pointer slots (csrc/ladder_consumer.cu): per key column every
    level's, per gathered column every level's, every level's weights,
    the lower query columns, the upper ones and the query weights (join)
    or live flags (gather). ``same_hi``: the upper queries are the lower
    ones. A column must share its dtype across the levels."""
    what = "join_ladder" if join else "gather_ladder"
    per_level = [dtypes[g * K:(g + 1) * K] for g in range(nk + ng + 1)]
    for g, dts in enumerate(per_level):
        if any(dt != dts[0] for dt in dts):
            raise ValueError(f"{what}: one column of every level must share "
                             f"a dtype, got {dts} (column {g})")
    level_dts = tuple(dts[0] for dts in per_level)
    query_dts = dtypes[(nk + ng + 1) * K:]
    kinds = tuple(_kind(dt, what) for dt in (*level_dts, *query_dts))
    gathered = level_dts[nk:nk + ng]
    w_dt = query_dts[-1] if join else level_dts[-1]
    dead = tuple(0 if join else int(kernels.sentinel_scalar(dt))
                 for dt in gathered)
    caps = (nk + ng + 1) * K + 2 * nk + 1
    out = caps + K + len(kinds)
    template = (0,) * (caps + K) + kinds + (0,) * (ng + 4) + dead
    return _LadderPlan(len(template), template, caps, out, (*gathered, w_dt))


class _LadderBuffers(NamedTuple):
    """The one buffer of a call (:func:`_ladder_buffers`)."""

    carve: _Carve  # gathered columns, w, qrow, (valid,) total
    out_slots: tuple  # each output's slot, from the plan's first output's
    n_scratch: int  # int64 elements of the kernel's scratch


@functools.lru_cache(maxsize=64)
def _ladder_buffers(K: int, m: int, out_cap: int, out_dtypes: tuple,
                    join: bool) -> _LadderBuffers:
    """The outputs of a call of K levels, m queries and ``out_cap`` slots
    whose gathered columns and w have ``out_dtypes``, and its scratch."""
    ng = len(out_dtypes) - 1
    shapes = [(dt, out_cap) for dt in out_dtypes] + [(torch.int32, out_cap)]
    if join:
        shapes.append((torch.bool, out_cap))
    shapes.append((torch.int64, None))
    n_scratch = load_library("ladder_consumer").ladder_scratch_elems(K, m)
    slots = tuple(range(ng + 2)) + ((ng + 2,) if join else ()) + (ng + 3,)
    return _LadderBuffers(_carve_plan(shapes), slots, n_scratch)


def _ladder_consumer(key_tabs, gather_tabs, weight_tab, qlo_cols, qhi_cols,
                     qmask: torch.Tensor, out_cap: int, join: bool):
    """One call of csrc/ladder_consumer.cu (its ``LADDER_KERNELS``
    launches on the current stream). ``qhi_cols`` None: the upper
    queries are the lower ones. Returns ``(gathered cols, w, qrow,
    total)``, and ``valid`` before ``total`` for a join, each at its final
    dtype with its dead slots written; ``total`` is the unclamped match
    count (0-d, on the device)."""
    what = "join_ladder" if join else "gather_ladder"
    dev = _cuda_device(qmask, what)
    K, nk, m = len(weight_tab), len(qlo_cols), qmask.shape[0]
    ng = len(gather_tabs[0]) if K else 0
    if not (K >= 1 and nk >= 1 and m >= 1 and out_cap >= 1):
        raise ValueError(f"{what}: needs levels, key columns, queries and "
                         f"out_cap >= 1 (K={K}, nk={nk}, m={m}, "
                         f"out_cap={out_cap})")
    if nk > MAX_COLS or K * m >= 1 << 31:
        raise ValueError(f"{what}: at most {MAX_COLS} key columns and 2^31 "
                         f"(level, query) pairs (nk={nk}, K={K}, m={m})")
    if any(len(t) != nk for t in key_tabs) or \
            any(len(t) != ng for t in gather_tabs):
        raise ValueError(f"{what}: every level needs {nk} key and {ng} "
                         f"gathered columns")
    same_hi = qhi_cols is None
    cols = (*(t[c] for c in range(nk) for t in key_tabs),
            *(t[c] for c in range(ng) for t in gather_tabs), *weight_tab,
            *qlo_cols, *(qlo_cols if same_hi else qhi_cols), qmask)
    plan = _ladder_plan(K, nk, ng, tuple(c.dtype for c in cols), join,
                        same_hi)
    bufs = _ladder_buffers(K, m, out_cap, plan.out_dtypes, join)
    args = _ArgBlock(dev, plan.n_slots, what)
    args.slots[:] = plan.template
    args.ptrs(0, cols)
    args.slots[plan.caps:plan.caps + K] = tuple(t.shape[0]
                                                for t in weight_tab)
    buf = torch.empty((bufs.carve.n_out + bufs.n_scratch,),
                      dtype=torch.int64, device=dev)
    base = buf.data_ptr()
    for slot, off in zip(bufs.out_slots, bufs.carve.byte_offsets):
        args.slots[plan.out + slot] = base + off
    args.launch(load_library("ladder_consumer").ladder_consumer, K, nk, ng,
                m, out_cap, int(join), int(same_hi),
                base + 8 * bufs.carve.n_out)
    LAUNCHES[what] += 1
    return _carve(buf, bufs.carve)


def join_ladder(delta_keys: Cols, delta_w: torch.Tensor,
                levels: Sequence, nk: int, out_cap: int):
    """The incremental-join core over a trace ladder: both probes per delta
    row, dead rows zeroed, level-major expansion into ``out_cap`` slots,
    the level's vals gathered and ``w = delta_w * level_w``. Returns
    ``(qrow, level_val_cols, w, valid, total)`` as ``join_ladder_pallas``
    does: dead slots hold qrow 0, vals 0 and weight 0; ``total`` is the
    unclamped match count."""
    if _on_cpu(delta_w):
        return join_ladder_plain(delta_keys, delta_w, levels, nk, out_cap)
    *lvals, w, qrow, valid, total = _ladder_consumer(
        [lvl.keys[:nk] for lvl in levels], [lvl.vals for lvl in levels],
        [lvl.weights for lvl in levels], delta_keys, None, delta_w,
        out_cap, join=True)
    return qrow, tuple(lvals), w, valid, total


def join_ladder_plain(delta_keys: Cols, delta_w: torch.Tensor,
                      levels: Sequence, nk: int, out_cap: int):
    """Plain version of :func:`join_ladder`: the stitched probe-ladder /
    expand / gather chain (reference ``cursor.join_ladder``, XLA branch)."""
    tables = [lvl.keys[:nk] for lvl in levels]
    lo = lex_probe_ladder_plain(tables, delta_keys, side="left")
    hi = lex_probe_ladder_plain(tables, delta_keys, side="right")
    live = (delta_w != 0)[None, :]
    lo = torch.where(live, lo, 0)
    hi = torch.where(live, hi, lo)
    level, qrow, src, valid, total = expand_ladder(lo, hi, out_cap)
    (lw,) = _select_gather([(lvl.weights,) for lvl in levels], level,
                                  src)
    w = torch.where(valid, delta_w[qrow] * lw, 0).to(delta_w.dtype)
    # masked_fill keeps a bool column bool (where(valid, c, 0) would
    # promote it to int64)
    rvals = tuple(c.masked_fill(~valid, 0) for c in _select_gather(
        [lvl.vals for lvl in levels], level, src))
    qrow = torch.where(valid, qrow, 0).to(torch.int32)
    return qrow, rvals, w, valid, total


def _gather_tabs(levels, nk: int, gather_keys: int):
    return [(*lvl.keys[nk - gather_keys:nk], *lvl.vals) if gather_keys
            else tuple(lvl.vals) for lvl in levels]


def gather_ladder(qkeys: Cols, qlive: torch.Tensor, levels: Sequence,
                  out_cap: int, qhi_keys: Cols = None, gather_keys: int = 0):
    """Every row of all levels matching the m group keys (or, with
    ``qhi_keys``, the key range [qkeys[i], qhi_keys[i]]), with
    ``gather_keys`` trailing key columns ahead of the vals. Returns
    ``((qrow, vals, w), total)`` as ``gather_ladder_pallas`` does: dead
    slots hold qrow == q_cap, sentinel vals and weight 0; ``total`` is the
    unclamped match count."""
    if _on_cpu(qlive):
        return gather_ladder_plain(qkeys, qlive, levels, out_cap, qhi_keys,
                                   gather_keys)
    nk = len(qkeys)
    *vals, w, qrow, total = _ladder_consumer(
        [lvl.keys[:nk] for lvl in levels],
        _gather_tabs(levels, nk, gather_keys),
        [lvl.weights for lvl in levels], qkeys, qhi_keys, qlive, out_cap,
        join=False)
    return (qrow, tuple(vals), w), total


def gather_ladder_plain(qkeys: Cols, qlive: torch.Tensor, levels: Sequence,
                        out_cap: int, qhi_keys: Cols = None,
                        gather_keys: int = 0):
    """Plain version of :func:`gather_ladder`: the stitched chain
    (reference ``cursor.gather_ladder``, XLA branch)."""
    nk = len(qkeys)
    q_cap = qlive.shape[-1]
    tables = [lvl.keys[:nk] for lvl in levels]
    lo = lex_probe_ladder_plain(tables, qkeys, side="left")
    hi = lex_probe_ladder_plain(tables, qkeys if qhi_keys is None
                                else qhi_keys, side="right")
    live = qlive[None, :] != 0
    lo = torch.where(live, lo, 0)
    # probes are monotone: with distinct bounds an empty range (qhi < qlo)
    # lands hi <= lo, and the clamp makes it gather nothing
    hi = torch.where(live, torch.maximum(hi, lo), lo)
    level, qrow, src, valid, total = expand_ladder(lo, hi, out_cap)
    (lw,) = _select_gather([(lvl.weights,) for lvl in levels], level,
                                  src)
    w = torch.where(valid, lw, 0)
    vals = tuple(v.masked_fill(~valid, kernels.sentinel_scalar(v.dtype))
                 for v in _select_gather(
                     _gather_tabs(levels, nk, gather_keys), level, src))
    qrow = torch.where(valid, qrow, q_cap).to(torch.int32)
    return (qrow, vals, w), total


# ---------------------------------------------------------------------------
# Segment reduce
# ---------------------------------------------------------------------------

SEG_OPS = {"count": 0, "sum": 1, "min": 2, "max": 3, "avg": 4, "present": 5}
# rows per segment-reduce block (csrc/segment_reduce.cu: THREADS x ITEMS)
SEG_TILE = 1024


def _seg_ident(op: str, src: torch.dtype) -> int:
    """Empty-segment fill of one op: what the segment_* formulation leaves
    there (min: the source dtype's max; max and present: its min; 0 for
    the additive ops)."""
    if op == "min":
        return torch.iinfo(src).max
    if op in ("max", "present"):
        return torch.iinfo(src).min
    return 0


def segment_reduce(spec, val_cols: Cols, weights: torch.Tensor,
                   seg: torch.Tensor, num_segments: int, out_dtypes):
    """A whole reduce spec ``((op, src_col), ...)`` per segment id, each
    output narrowed to its ``out_dtypes`` entry (see the plain version for
    the semantics of each op)."""
    if _on_cpu(weights):
        return segment_reduce_plain(spec, val_cols, weights, seg,
                                    num_segments, out_dtypes)
    what = "segment_reduce"
    dev = _cuda_device(weights, what)
    for (op, _), d in zip(spec, out_dtypes):
        if op == "avg" and d != torch.int64:
            # the kernel divides int64 accumulators: narrower avg results
            # would differ from a narrow accumulation
            raise ValueError(f"{what}: avg needs an int64 result, got {d}")
    nv, nops, n = len(val_cols), len(spec), weights.shape[0]
    if num_segments < 1:
        raise ValueError(f"{what}: num_segments must be >= 1")
    # slots: the columns, the op triples, the outputs, the columns' kinds
    kinds = nv + 2 + 4 * nops
    args = _ArgBlock(dev, kinds + nv + 2, what)
    for c, t in enumerate((*val_cols, weights, seg)):
        args.slots[kinds + c] = args.col_at_width(c, t)
    for o, (op, col) in enumerate(spec):
        src = val_cols[col].dtype if op in ("min", "max") else torch.int64
        args.slots[nv + 2 + 3 * o] = SEG_OPS[op]
        args.slots[nv + 3 + 3 * o] = col
        args.slots[nv + 4 + 3 * o] = _seg_ident(op, src)
    outs = [args.out(nv + 2 + 3 * nops + o, num_segments)
            for o in range(nops)]
    # avg's weight sums, which its finishing pass divides by
    wsum = (torch.empty((num_segments,), dtype=torch.int64, device=dev)
            if any(op == "avg" for op, _ in spec) else None)
    args.launch(load_library("segment_reduce").segment_reduce, nv, nops, n,
                num_segments, None if wsum is None else wsum.data_ptr())
    LAUNCHES[what] += 1
    return tuple(o.to(d) for o, d in zip(outs, out_dtypes))


def segment_reduce_plain(spec, val_cols: Cols, weights: torch.Tensor,
                         seg: torch.Tensor, num_segments: int, out_dtypes):
    """Plain version of :func:`segment_reduce` (the reference's
    ``jax.ops.segment_*`` formulation): count = sum max(w, 0); sum =
    sum v * max(w, 0); min/max over rows with w > 0, the source dtype's
    identity for empty segments; avg = truncating sum / max(count, 1);
    present = max of (w > 0) over every row, int64-min when empty.
    Out-of-range ids are dropped."""
    wpos = torch.clamp(weights, min=0)
    outs = []
    for op, col in spec:
        if op == "count":
            out = kernels.segment_sum(wpos, seg, num_segments)
        elif op in ("sum", "avg"):
            out = kernels.segment_sum(val_cols[col] * wpos, seg, num_segments)
            if op == "avg":
                c = torch.clamp(kernels.segment_sum(wpos, seg, num_segments),
                                min=1)
                out = torch.where(out >= 0, out // c, -((-out) // c))
        elif op in ("min", "max"):
            v = val_cols[col]
            fill = _seg_ident(op, v.dtype)
            out = kernels.segment_extreme(
                torch.where(weights > 0, v, fill), seg, num_segments,
                largest=op == "max")
        elif op == "present":
            out = kernels.segment_extreme(
                (weights > 0).to(torch.int64), seg, num_segments,
                largest=True)
        else:
            raise ValueError(f"unknown segment-reduce op {op!r}")
        outs.append(out)
    return tuple(o.to(d) for o, d in zip(outs, out_dtypes))


# ---------------------------------------------------------------------------
# Rank-merge scatter
# ---------------------------------------------------------------------------


# threads of a rank-merge block, and the shared-memory bytes its tile may
# take (csrc/rank_merge.cu): three blocks fit on one SM's 228 KB
MERGE_THREADS = 256
MERGE_STAGE_BYTES = 64 * 1024


def rank_merge_tile(ncols: int) -> int:
    """Output rows per rank-merge block: MERGE_THREADS times the most rows
    per thread (at most 16) whose staged values (``ncols`` columns and the
    weights, int64 each, and one int32 source index) fit in
    ``MERGE_STAGE_BYTES``."""
    per_row = 8 * (ncols + 1) + 4
    per = MERGE_STAGE_BYTES // (MERGE_THREADS * per_row)
    return MERGE_THREADS * max(1, min(16, per))


def rank_merge_scatter(cols_a: Cols, w_a: torch.Tensor, cols_b: Cols,
                       w_b: torch.Tensor):
    """The rank-merge inner loop: cross-rank both sorted row sets and write
    every row (and weight) to its index plus its rank. Returns the
    pre-netting ``(cols, w)`` of capacity na + nb in a's dtypes."""
    if _on_cpu(w_a):
        return rank_merge_scatter_plain(cols_a, w_a, cols_b, w_b)
    what = "rank_merge"
    dev = _cuda_device(w_a, what)
    ncols = len(cols_a)
    if not 1 <= ncols <= MAX_COLS or len(cols_b) != ncols:
        raise ValueError(f"{what}: needs 1..{MAX_COLS} columns on both "
                         f"sides, got {ncols} and {len(cols_b)}")
    na, nb = w_a.shape[0], w_b.shape[0]
    if na + nb == 0:  # nothing to merge: no launch, so no count
        return (tuple(torch.empty((0,), dtype=c.dtype, device=dev)
                      for c in cols_a),
                torch.empty((0,), dtype=w_a.dtype, device=dev))
    nc = ncols + 1
    args = _ArgBlock(dev, 5 * nc, what)
    outs = []
    for c, (ca, cb) in enumerate(zip((*cols_a, w_a), (*cols_b, w_b))):
        args.slots[3 * nc + c] = args.col_at_width(c, ca)
        args.slots[4 * nc + c] = args.col_at_width(nc + c, cb)
        out = torch.empty((na + nb,), dtype=ca.dtype, device=dev)
        args.slots[2 * nc + c] = out.data_ptr()
        outs.append(out)
    args.launch(load_library("rank_merge").rank_merge, ncols, na, nb,
                rank_merge_tile(ncols))
    LAUNCHES[what] += 1
    return tuple(outs[:ncols]), outs[ncols]


def rank_merge_scatter_plain(cols_a: Cols, w_a: torch.Tensor, cols_b: Cols,
                             w_b: torch.Tensor):
    """Plain version of :func:`rank_merge_scatter`: two vectorized binary
    searches and position scatters into sentinel-filled buffers."""
    na, nb = w_a.shape[0], w_b.shape[0]
    dev = w_a.device
    ra = kernels.lex_probe(cols_b, cols_a, side="left")   # b-rows < a_i
    rb = kernels.lex_probe(cols_a, cols_b, side="right")  # a-rows <= b_j
    pos_a = torch.arange(na, device=dev) + ra
    pos_b = torch.arange(nb, device=dev) + rb
    out_cols = []
    for ca, cb in zip(cols_a, cols_b):
        buf = kernels.sentinel_fill((na + nb,), ca.dtype, dev)
        buf[pos_a] = ca
        buf[pos_b] = cb.to(ca.dtype)
        out_cols.append(buf)
    w = torch.zeros((na + nb,), dtype=w_a.dtype, device=dev)
    w[pos_a] = w_a
    w[pos_b] = w_b.to(w_a.dtype)
    return tuple(out_cols), w


# ---------------------------------------------------------------------------
# Aggregate ladder: the compiled aggregate's whole chain in one launch
# ---------------------------------------------------------------------------

# most spec ops one call takes (csrc/agg_ladder.cu MAX_OPS)
AGG_MAX_OPS = 16


def _agg_spec(delta, nk: int, out_trace, levels: Sequence, agg, q_cap: int,
              gather_cap: int):
    """The reduce spec of a call the fused kernel takes: the reference's
    ``fusable`` conditions (``cursor.agg_ladder``) and the kernel's
    limits. Raises ``ValueError`` with the reason otherwise."""
    what = "agg_ladder"
    spec = agg.reduce_spec()
    nv = len(delta.vals)
    if not spec:
        raise ValueError(f"{what}: the aggregator has no reduce spec")
    spec = tuple(spec)
    if not levels:
        raise ValueError(f"{what}: the trace has no levels")
    if not 1 <= nk <= MAX_COLS:
        raise ValueError(f"{what}: needs 1..{MAX_COLS} key columns, got {nk}")
    if q_cap < 1 or gather_cap < 1:
        raise ValueError(f"{what}: q_cap and gather_cap must be >= 1 (got "
                         f"{q_cap}, {gather_cap})")
    if len(spec) > AGG_MAX_OPS or nv > MAX_COLS:
        raise ValueError(f"{what}: at most {AGG_MAX_OPS} ops and {MAX_COLS} "
                         f"value columns (got {len(spec)}, {nv})")
    if len(out_trace.vals) != len(spec):
        raise ValueError(f"{what}: the out trace has {len(out_trace.vals)} "
                         f"value columns, the spec {len(spec)} ops")
    if any(len(lvl.vals) != nv for lvl in levels):
        raise ValueError(f"{what}: the levels must share the delta's value "
                         f"schema ({nv} columns)")
    for op, col in spec:
        if op not in SEG_OPS:
            raise ValueError(f"{what}: unknown op {op!r}")
        if op in ("sum", "min", "max", "avg") and not 0 <= col < nv:
            raise ValueError(f"{what}: op {op!r} reads column {col} of {nv}")
    return spec


class _AggPlan(NamedTuple):
    """What a launch of csrc/agg_ladder.cu takes that depends only on the
    call's shapes and dtypes (:func:`_agg_plan`)."""

    n_slots: int
    template: tuple  # every slot but the columns' and outputs' pointers
    carve: _Carve  # the outputs of the 10-tuple, flattened
    r0: int  # the slot of the first output's pointer
    n_scratch: int  # int64 elements of the kernel's scratch
    dims: tuple  # the launcher's integer arguments


@functools.lru_cache(maxsize=64)
def _agg_plan(dev: torch.device, nk: int, spec: tuple, fast: bool,
              q_cap: int, gather_cap: int, m: int, ocap: int, caps: tuple,
              dtypes: tuple) -> _AggPlan:
    """The plan of a call whose delta, out trace and levels have the
    column ``dtypes`` (keys, values, weights: the delta's, the out
    trace's, then each level's), the row counts ``m``, ``ocap`` and
    ``caps``. The slot layout is csrc/agg_ladder.cu's: the columns, the
    level caps, the columns' kinds, the ops, the key sentinels, the old
    outputs' identities, the outputs and their kinds."""
    from dbsp_tpu_torch.operators.aggregate import _seg_out_dtype

    what = "agg_ladder"
    d_dt, o_dt, l_dt = dtypes[0], dtypes[1], dtypes[2]
    if any(dt != l_dt for dt in dtypes[2:]):
        raise ValueError(f"{what}: one column of every level must share a "
                         f"dtype, got {dtypes[2:]}")
    K, nd, no, nops = len(caps), len(d_dt), len(o_dt), len(spec)
    nv = nd - nk - 1

    def out_dtypes(cols):  # the reference's result dtype of each op
        vals = tuple(torch.empty(0, dtype=d) for d in cols[nk:-1])
        w = torch.empty(0, dtype=cols[-1])
        return tuple(_seg_out_dtype(op, c, vals, w) for op, c in spec)

    lad_dts, d_dts = out_dtypes(l_dt), out_dtypes(d_dt)
    if any(op == "avg" and (ld, dd) != (torch.int64, torch.int64)
           for (op, _), ld, dd in zip(spec, lad_dts, d_dts)):
        # the kernel divides int64 sums: a narrower avg would differ
        raise ValueError(f"{what}: avg needs an int64 result")
    qn = min(q_cap, m)
    nq = q_cap if fast else 0
    shapes = (*((dt, qn) for dt in d_dt[:nk]), (torch.bool, qn),
              (torch.int64, None), *((dt, q_cap) for dt in o_dt[nk:-1]),
              (torch.bool, q_cap), *((dt, q_cap) for dt in lad_dts),
              (torch.bool, q_cap), *((dt, nq) for dt in d_dts),
              (torch.bool, nq), (torch.int64, None))
    kinds = [_kind(dt, what)
             for dt in (*d_dt, *o_dt, *l_dt, *(dt for dt, _ in shapes))]
    ops = []
    for op, col in spec:
        minmax = op in ("min", "max")
        ops += [SEG_OPS[op], col,
                _seg_ident(op, d_dt[nk + col] if minmax else torch.int64),
                _seg_ident(op, l_dt[nk + col] if minmax else torch.int64)]
    template = ((0,) * (nd + no + nd * K) + caps + tuple(kinds[:nd + no + nd])
                + tuple(ops)
                + tuple(int(kernels.sentinel_scalar(dt)) for dt in d_dt[:nk])
                + tuple(_seg_ident("max", dt) for dt in o_dt[nk:-1])
                + (0,) * len(shapes) + tuple(kinds[nd + no + nd:]))
    lib = load_library("agg_ladder")
    with torch.cuda.device(dev):
        n_scratch = lib.agg_ladder_scratch_elems(K, nops, m, q_cap,
                                                 int(fast))
    if n_scratch < 0:
        raise RuntimeError(f"{what}: no block of the kernel fits on {dev}")
    avg = any(op == "avg" for op, _ in spec)
    return _AggPlan(len(template), template, _carve_plan(shapes),
                    len(template) - 2 * len(shapes), n_scratch,
                    (K, nk, nv, nops, m, ocap, q_cap, qn,
                                gather_cap, int(fast), int(avg)))


def agg_ladder(delta, nk: int, out_trace, levels: Sequence, agg, q_cap: int,
               gather_cap: int, fast: bool, flag: torch.Tensor):
    """The compiled general aggregate's whole chain for one delta: unique
    touched keys, previous outputs from the out trace, the touched groups'
    ladder histories netted and reduced (only while the device bool
    ``flag`` is on), and on the fast path the delta's own reduction.
    Returns the reference's 10-tuple ``(qkeys, qlive, nq, old_vals,
    old_present, lad_vals, lad_present, d_vals, d_present,
    gather_total)``; ``nq`` and ``gather_total`` are the unclamped
    requirements, ``d_vals`` and ``d_present`` None off the fast path. On
    CUDA tensors it is one launch of ``csrc/agg_ladder.cu`` (its outputs
    views of one buffer), for the calls the reference's fused backends
    take (:func:`_agg_spec`; others raise ``ValueError``)."""
    if _on_cpu(delta.weights):
        return agg_ladder_plain(delta, nk, out_trace, levels, agg, q_cap,
                                gather_cap, fast, flag)
    what = "agg_ladder"
    dev = _cuda_device(delta.weights, what)
    spec = _agg_spec(delta, nk, out_trace, levels, agg, q_cap, gather_cap)
    if flag.dtype != torch.bool or flag.numel() != 1 or flag.device != dev:
        raise ValueError(f"{what}: the gate must be one bool on {dev}, got "
                         f"{flag.dtype}{tuple(flag.shape)} on {flag.device}")
    cols = [(*delta.keys[:nk], *delta.vals, delta.weights),
            (*out_trace.keys[:nk], *out_trace.vals, out_trace.weights),
            *((*lvl.keys[:nk], *lvl.vals, lvl.weights) for lvl in levels)]
    plan = _agg_plan(dev, nk, spec, bool(fast), q_cap, gather_cap, delta.cap,
                     out_trace.cap, tuple(lvl.cap for lvl in levels),
                     tuple(tuple(c.dtype for c in cs) for cs in cols))
    args = _ArgBlock(dev, plan.n_slots, what)
    args.slots[:] = plan.template
    # the columns' slots are consecutive: the delta's, the out trace's,
    # then each column of every level (column-major)
    nd = len(cols[0])
    args.ptrs(0, (*cols[0], *cols[1],
                  *(lc[c] for c in range(nd) for lc in cols[2:])))
    c = plan.carve
    buf = torch.empty((c.n_out + plan.n_scratch,), dtype=torch.int64,
                      device=dev)
    base = buf.data_ptr()
    args.slots[plan.r0:plan.r0 + c.n] = tuple(base + off
                                              for off in c.byte_offsets)
    outs = _carve(buf, c)
    args.launch(load_library("agg_ladder").agg_ladder, *plan.dims,
                flag.data_ptr(), base + 8 * c.n_out)
    LAUNCHES[what] += 1
    nops = len(spec)
    qkeys, (qlive, nq), rest = tuple(outs[:nk]), outs[nk:nk + 2], \
        outs[nk + 2:]
    old_vals, lad_vals, d_vals = (tuple(rest[i * (nops + 1):
                                              i * (nops + 1) + nops])
                                  for i in range(3))
    old_present, lad_present, d_present = rest[nops:3 * (nops + 1):nops + 1]
    if not fast:
        d_vals = d_present = None
    return (qkeys, qlive, nq, old_vals, old_present, lad_vals, lad_present,
            d_vals, d_present, rest[-1])


def agg_ladder_plain(delta, nk: int, out_trace, levels: Sequence, agg,
                     q_cap: int, gather_cap: int, fast: bool,
                     flag: torch.Tensor):
    """Plain version of :func:`agg_ladder`, and its oracle: the stitched
    chain (``cursor.agg_ladder_stitched``) over
    :func:`gather_ladder_plain` and :func:`segment_reduce_plain`."""
    from dbsp_tpu_torch.zset import cursor

    return cursor.agg_ladder_stitched(
        delta, nk, out_trace, levels, agg, q_cap, gather_cap, fast, flag,
        gather=gather_ladder_plain, seg_reduce=segment_reduce_plain)
