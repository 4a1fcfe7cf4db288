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
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
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
    "sfc_kmeans_assign": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P),
    "sfc_kmeans_update": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P),
    "sfc_kmeans_assign_tiles": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P),
    "sfc_matmul3d": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    "sfc_join_hits": (_P, _I, _P, _I, _I, _F, _I, _P, _P, _P),
    "sfc_join_emit": (_P, _I, _P, _I, _I, _F, _I, _P, _P),
    # the sharded paths: lim is a device int32[2] (n_valid_local, k_valid)
    "sfc_kmeans_shard_assign": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P),
    "sfc_kmeans_shard_update": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _I, _I, _I, _P, _P, _P),
    "sfc_kmeans_fold": (_P, _P, _I, _I, _I, _P, _P),
    "sfc_join_hits_rows": (_P, _I, _P, _I, _I, _I, _F, _I, _P, _P),
    "sfc_join_emit_halo": (_P, _I, _P, _I, _I, _F, _I, _P, _P),
    "sfc_tile_update": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P),
    # phased kernels: (matrix, [workspace,] table, table columns, column of
    # i, first row, CTAs, k, n, b, stream)
    "sfc_fw_diag": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    "sfc_fw_row": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    "sfc_fw_col": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    "sfc_fw_trailing": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    "sfc_chol_diag": (_P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    "sfc_chol_panel": (_P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    "sfc_chol_trailing": (_P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    # flash kernels: (q, k, v, out, table, runs, runs, heads, ...shape, scale,
    # dtype, stream)
    "sfc_flash_attention": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _F, _I, _P),
    "sfc_flash_decode": (_P, _P, _P, _P, _P, _P, _I, _I, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P),
    "sfc_flash_prefill": (_P, _P, _P, _P, _P, _P, _I, _I, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _P),
}


class LaunchCounter:
    """Launches per kernel name, counted where a kernel is launched.

    ``reset()`` before a run, read ``counts()`` after it: a kernel with a
    count of 0 did not run on the device.
    """

    def __init__(self):
        self._n: collections.Counter = collections.Counter()

    def add(self, name: str) -> None:
        self._n[name] += 1

    def reset(self) -> None:
        self._n.clear()

    def counts(self) -> dict[str, int]:
        return {name: int(self._n[name]) for name in SIGNATURES}


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
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def call(name: str, *args) -> None:
    """Launch kernel ``name`` with C arguments ``args``; raise if the
    launch was refused, else count it."""
    err = getattr(library(), name)(*args)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")
    LAUNCHES.add(name)


def stream_of(tensor) -> int:
    """The raw current CUDA stream of ``tensor``'s device."""
    import torch

    return torch.cuda.current_stream(tensor.device).cuda_stream
