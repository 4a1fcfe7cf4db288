"""repro_torch.kernels — hand-written Hopper kernels for the paper's
applications.

Each kernel module (<name>.py) holds the tile math's plain PyTorch
version plus a :class:`repro_torch.core.GpuProgram` declaration whose
launcher calls the CUDA kernel in ``csrc/<name>.cu``; launch.py is the
single dispatcher every program goes through, _build.py compiles and
binds the CUDA sources, ops.py holds the public entry points (padding,
schedule choice, device), and ref.py the dense torch oracles.  All
kernels take their tile order from an int32 schedule table built by
:mod:`repro_torch.core.schedule`, one row per CTA.
"""
from . import ops, ref
from ._build import LAUNCHES
from .kmeans import kmeans_init, kmeans_lloyd_fused, kmeans_lloyd_program
from .launch import launch
from .matmul import matmul_swizzled
from .simjoin import (
    simjoin_counts_swizzled,
    simjoin_emit_program,
    simjoin_emit_swizzled,
    simjoin_hits_program,
    simjoin_pairs_scheduled,
    simjoin_tile_hits_swizzled,
)

__all__ = [
    "LAUNCHES",
    "kmeans_init",
    "kmeans_lloyd_fused",
    "kmeans_lloyd_program",
    "launch",
    "matmul_swizzled",
    "ops",
    "ref",
    "simjoin_counts_swizzled",
    "simjoin_emit_program",
    "simjoin_emit_swizzled",
    "simjoin_hits_program",
    "simjoin_pairs_scheduled",
    "simjoin_tile_hits_swizzled",
]
