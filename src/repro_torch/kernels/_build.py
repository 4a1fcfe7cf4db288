"""Build and bind the hand-written CUDA kernels (``csrc/*.cu``).

Each ``.cu`` file is compiled by its own ``nvcc -c`` (all started at
once) for ``sm_90a``, then the objects are linked into one shared library
with a plain C interface, loaded with :mod:`ctypes`.  No PyTorch header is
included, so a cold build takes seconds, not minutes.

The library lands in ``build/repro_torch/<hash>/`` at the repository
root, keyed by a hash of the sources and flags, and is built on first use
— never at import time (the CPU tests import every module and have no
``nvcc``).

Every C entry point takes raw pointers, ints and the CUDA stream, and
returns ``cudaGetLastError()``; :func:`call` raises on a non-zero code
and counts the launch.
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures of the entry points in csrc/*.cu
SIGNATURES = {
    "sfc_matmul": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    # the assigns: (x, centroid panel, cn, table, steps, table columns, column
    # of i, [tiles: column of j,] bp, Kp or [tiles:] bc, ct, D, k_valid or
    # [shard] lim, min, arg, stream)
    "sfc_kmeans_assign": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P),
    "sfc_kmeans_update": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P),
    "sfc_kmeans_assign_tiles": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P),
    "sfc_matmul3d": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    # the join's passes: (D, panel, panel width, norms scratch, table,
    # [hits_rows: table columns,] steps, bp, eps², n_valid, outputs, host
    # int[2] the entry sets to its grid and kernel, stream)
    "sfc_join_hits": (_I, _P, _I, _P, _P, _I, _I, _F, _I, _P, _P, _P, _P),
    "sfc_join_emit": (_I, _P, _I, _P, _P, _I, _I, _F, _I, _P, _P, _P),
    # the sharded paths: lim is a device int32[2] (n_valid_local, k_valid)
    "sfc_kmeans_shard_assign": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P),
    "sfc_kmeans_shard_update": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _I, _I, _I, _P, _P, _P),
    "sfc_kmeans_fold": (_P, _P, _I, _I, _I, _P, _P),
    "sfc_join_hits_rows": (_I, _P, _I, _P, _P, _I, _I, _I, _F, _I, _P, _P, _P),
    "sfc_join_emit_halo": (_I, _P, _I, _P, _P, _I, _I, _F, _I, _P, _P, _P),
    # (o, a, b, table, steps, persistent CTAs, M, N, Kp, bm, bn, alpha, stream)
    "sfc_tile_update": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P),
    # phased kernels: (matrix, [workspace,] table, table columns, column of
    # i, first row, CTAs (table rows), [FW panels: strips a tile,] k, n, b,
    # stream)
    "sfc_fw_diag": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    "sfc_fw_row": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    "sfc_fw_col": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    "sfc_fw_trailing": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    "sfc_chol_diag": (_P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    "sfc_chol_panel": (_P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    "sfc_chol_trailing": (_P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    # flash kernels: (q, k, v, out, [decode: workspace,] table, runs, runs,
    # [prefill: q tiles a CTA,] heads, ...shape, [decode: split pages,
    # splits,] scale, dtype (the pools'), [paged: the core's code,
    # kernels/attention.py::PREFILL_CORE_CODE / DECODE_CORE_CODE,] stream)
    "sfc_flash_attention": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _F, _I, _P),
    "sfc_flash_decode": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F,
                         _I, _I, _P),
    "sfc_flash_prefill": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                          _F, _I, _I, _P),
}


# entry points that read a kernel's build attributes and launch nothing
# (not counted): (which kernel, out int32[8]), read by kernel_info
QUERIES = {"sfc_matmul_simt_info": (_I, _P), "sfc_flash_tiled_info": (_I, _P),
           "sfc_prefill_tiled_info": (_I, _P), "sfc_kmeans_info": (_I, _P),
           "sfc_simjoin_info": (_I, _P), "sfc_fw_info": (_I, _P),
           "sfc_flash_latent_info": (_I, _P), "sfc_flash_wgmma_info": (_I, _P)}
# the first five of a query's eight values (csrc/kernel_info.cuh); the
# last three are constants of the kernel's design
INFO_KEYS = ("registers", "spill_bytes", "ctas_per_sm", "smem_bytes", "threads")


# the entry points that dispatch to more than one kernel, and their cores:
# bf16 on the tensor cores (TMA + wgmma), f32 (and the shapes the tensor-core
# core does not take) on the SIMT kernels; the flash entries' f32 at the
# tensor-core core's shapes (prefill: pages of 4 to 64 rows) on the
# register-tiled SIMT core ("tiled"); the paged entries' MLA calls (one
# latent pool as K and V, f32 queries) on the latent core, GQA decode on
# the split-KV core ("split")
CORES = {
    "sfc_matmul": ("wgmma", "simt"),
    "sfc_matmul3d": ("wgmma", "simt"),
    "sfc_flash_attention": ("wgmma", "tiled", "simt"),
    "sfc_flash_decode": ("split", "latent"),
    "sfc_flash_prefill": ("wgmma", "tiled", "simt", "latent"),
}


class LaunchCounter:
    """Launches per kernel name, counted where a kernel is launched, and
    per core for the entry points of :data:`CORES`.

    ``reset()`` before a run, read ``counts()`` (per entry point) and
    ``cores()`` (``"sfc_matmul.wgmma"``, ...) after it: a kernel with a
    count of 0 did not run on the device.  Launches made inside
    ``scoped(key)`` (a thread's block: a mesh program's) are also counted
    under ``key`` (``scoped_counts()``).  Thread-safe: the programs of a
    mesh launch from threads of their own.
    """

    def __init__(self):
        self._n: collections.Counter = collections.Counter()
        self._scoped: dict = {}
        self._lock = threading.Lock()
        self._local = threading.local()

    def add(self, name: str, core: str | None = None) -> None:
        keys = [name] if core is None else [name, f"{name}.{core}"]
        scope = getattr(self._local, "key", None)
        with self._lock:
            self._n.update(keys)
            if scope is not None:
                self._scoped.setdefault(scope, collections.Counter()).update(keys)

    @contextlib.contextmanager
    def scoped(self, key):
        """Count this thread's launches in the block under ``key`` too."""
        old = getattr(self._local, "key", None)
        self._local.key = key
        try:
            yield
        finally:
            self._local.key = old

    def scoped_counts(self) -> dict:
        """{key: {name or "name.core": launches}} of the scopes since the
        last reset."""
        with self._lock:
            return {k: dict(c) for k, c in self._scoped.items()}

    def reset(self) -> None:
        with self._lock:
            self._n.clear()
            self._scoped.clear()

    def counts(self) -> dict[str, int]:
        return {name: int(self._n[name]) for name in SIGNATURES}

    def cores(self) -> dict[str, int]:
        return {f"{name}.{core}": int(self._n[f"{name}.{core}"])
                for name, cores in CORES.items() for core in cores}


LAUNCHES = LaunchCounter()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if not cand.exists():
        raise RuntimeError(
            "nvcc not found (PATH, CUDA_HOME): the CUDA kernels cannot be built"
        )
    return str(cand)


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile ``csrc/*.cu`` into ``libsfc_kernels.so`` unless an
    up-to-date build exists; returns the library path.  Raises with the
    compiler's output if a build fails."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / "libsfc_kernels.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        procs = []
        for src in sorted(CSRC.glob("*.cu")):
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )))
        logs, failed = [], []
        for src, _obj, proc in procs:
            text, _ = proc.communicate()
            logs.append(f"== {src.name}\n{text}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        tmp_lib = Path(tmp) / lib.name
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp_lib),
             *[str(obj) for _s, obj, _p in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        (out_dir / "build.log").write_text("\n".join(logs))
        os.replace(tmp_lib, lib)  # atomic: a reader never sees half a library
    return lib


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in {**SIGNATURES, **QUERIES}.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def call(name: str, *args, core: str | None = None) -> None:
    """Launch kernel ``name`` with C arguments ``args``; raise if the
    launch was refused, else count it (and, for an entry point of
    :data:`CORES`, the ``core`` its wrapper's rule picked)."""
    if (core is None) != (name not in CORES) or (core is not None and core not in CORES[name]):
        raise ValueError(f"{name}: core {core!r}; the entry point's cores are {CORES.get(name)}")
    err = getattr(library(), name)(*args)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")
    LAUNCHES.add(name, core)


def kernel_info(query: str, which: int, design: tuple[str, str, str]) -> dict[str, int]:
    """Kernel ``which``'s build and residency on the current card, through
    the query entry point ``query`` of :data:`QUERIES`: registers and
    spilled (local) bytes a thread, resident CTAs an SM
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), dynamic shared
    memory and threads a CTA, and three constants of its design, named by
    ``design``.  Launches nothing and counts nothing."""
    out = (ctypes.c_int * 8)()
    err = getattr(library(), query)(which, out)
    if err != 0:
        raise RuntimeError(f"{query}({which}): cudaError {err}")
    return dict(zip(INFO_KEYS + design, out))


def stream_of(tensor) -> int:
    """The raw current CUDA stream of ``tensor``'s device."""
    import torch

    return torch.cuda.current_stream(tensor.device).cuda_stream
