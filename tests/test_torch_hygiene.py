"""The port stands alone: nothing under dbsp_tpu_torch/, and not
chip_smoke.py, imports JAX or the JAX package; importing the port loads
neither; and a kernel wrapper given tensors that are not on the CPU
launches its kernel or raises — it never falls back to its plain
version."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

from dbsp_tpu_torch.zset import cuda_kernels
from dbsp_tpu_torch.zset.batch import Batch

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "dbsp_tpu")


def _port_files():
    files = sorted((ROOT / "dbsp_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    return files


def _imported_modules(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_sources_import_no_jax():
    files = _port_files()
    assert len(files) > 20 and all(f.exists() for f in files)
    bad = [(f.relative_to(ROOT).as_posix(), m) for f in files
           for m in _imported_modules(f)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import dbsp_tpu_torch.nexmark, dbsp_tpu_torch.operators\n"
        "import dbsp_tpu_torch.zset.cuda_kernels, dbsp_tpu_torch.zset.cursor\n"
        "import dbsp_tpu_torch.compiled, dbsp_tpu_torch.nexmark.device_gen\n"
        "import dbsp_tpu_torch.compiled.driver\n"
        "new = set(sys.modules) - before\n"
        "bad = sorted(m for m in new if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "assert 'dbsp_tpu_torch.zset.cuda_kernels' in new\n"
        "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def _meta_batch(cap=8, nvals=1):
    """A batch on the meta device: neither the CPU nor a built kernel."""
    z = torch.zeros(cap, dtype=torch.int64, device="meta")
    return Batch((z,), (z,) * nvals, z, runs=(cap,))


def test_wrappers_off_the_cpu_launch_or_raise():
    from dbsp_tpu_torch.operators.aggregate import Max

    b = _meta_batch()
    seg = torch.zeros(8, dtype=torch.int32, device="meta")
    before = dict(cuda_kernels.LAUNCHES)
    calls = [
        lambda: cuda_kernels.lex_probe_ladder([b.cols], b.cols),
        lambda: cuda_kernels.join_ladder(b.keys, b.weights, [b], 1, 64),
        lambda: cuda_kernels.gather_ladder(b.keys, b.weights != 0, [b], 64),
        lambda: cuda_kernels.segment_reduce(
            (("max", 0),), b.vals, b.weights, seg, 4, (torch.int64,)),
        lambda: cuda_kernels.rank_merge_scatter(b.cols, b.weights, b.cols,
                                                b.weights),
        lambda: cuda_kernels.agg_ladder(
            b, 1, b, [b], Max(0), 8, 64, True,
            torch.zeros((), dtype=torch.bool, device="meta")),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="CUDA tensor"):
            call()
    assert cuda_kernels.LAUNCHES == before


def test_kernel_library_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py builds and runs the "
                    "kernels there")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cuda_kernels.load_library("rank_merge")


def test_profile_query_knows_every_kernel():
    """profile_query's view of the port's kernels names every __global__
    function of csrc/, and picks them, and nothing else, out of profiler
    event names, mangled or not."""
    import re

    from dbsp_tpu_torch.profile_query import PORT_KERNELS, port_kernel

    names = {n for src in (ROOT / "dbsp_tpu_torch" / "csrc").glob("*.cu")
             for n in re.findall(r"__global__\s+void\s+(\w+)",
                                 src.read_text())}
    assert set(PORT_KERNELS) == names
    events = {
        "void (anonymous namespace)::probe_ladder_kernel<true>(Args, int, "
        "int, long, int*)": "probe_ladder_kernel",
        "_ZN12_GLOBAL__N_121consumer_probe_kernelI4ArgsEEvT_NS_4DimsEPx":
        "consumer_probe_kernel",
        "void (anonymous namespace)::consumer_expand_kernel<ArgTable>("
        "ArgTable, (anonymous namespace)::Dims, long long const*)":
        "consumer_expand_kernel",
        "void at::native::vectorized_gather_kernel<16, long>(char*, char*, "
        "long*, int, long, long, long, long, bool)": None,
        "void at::native::vectorized_elementwise_kernel<4, "
        "at::native::FillFunctor<long>, std::array<char*, 1ul> >(int, "
        "at::native::FillFunctor<long>, std::array<char*, 1ul>)": None,
    }
    assert {e: port_kernel(e) for e in events} == events
