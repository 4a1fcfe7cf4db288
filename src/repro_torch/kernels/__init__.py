"""repro_torch.kernels — hand-written Hopper kernels for the paper's
applications.

Each kernel module (<name>.py) holds the tile math's plain PyTorch
version plus a :class:`repro_torch.core.GpuProgram` declaration whose
launcher calls the CUDA kernel in ``csrc/<name>.cu``; launch.py is the
single dispatcher every program goes through, _build.py compiles and
binds the CUDA sources, ops.py holds the public entry points (padding,
schedule choice, device), sharded.py the curve-range-sharded k-means and
ε-join behind their ``mesh=``, and ref.py the dense torch oracles.  All
kernels take their tile order from an int32 schedule table built by
:mod:`repro_torch.core.schedule`, one row per CTA.
"""
from . import ops, ref, sharded
from ._build import LAUNCHES
from .attention import (
    flash_attention_decode,
    flash_attention_prefill,
    flash_attention_swizzled,
)
from .cholesky import (
    cholesky_blocked,
    cholesky_blocked_reference,
    cholesky_program,
    cholesky_reference_program,
)
from .floyd_warshall import (
    floyd_warshall_blocked,
    floyd_warshall_blocked_reference,
    fw_program,
    fw_reference_program,
)
from .kmeans import (
    kmeans_assign_swizzled,
    kmeans_fold_program,
    kmeans_init,
    kmeans_lloyd_fused,
    kmeans_lloyd_program,
    kmeans_lloyd_reference,
    kmeans_shard_program,
)
from .launch import launch
from .matmul import matmul_swizzled, tile_update_program, tile_update_swizzled
from .simjoin import (
    simjoin_counts_swizzled,
    simjoin_emit_halo_program,
    simjoin_emit_program,
    simjoin_emit_swizzled,
    simjoin_hits_program,
    simjoin_hits_rows_program,
    simjoin_pairs_scheduled,
    simjoin_tile_hits_swizzled,
)

__all__ = [
    "LAUNCHES",
    "cholesky_blocked",
    "cholesky_blocked_reference",
    "cholesky_program",
    "cholesky_reference_program",
    "flash_attention_decode",
    "flash_attention_prefill",
    "flash_attention_swizzled",
    "floyd_warshall_blocked",
    "floyd_warshall_blocked_reference",
    "fw_program",
    "fw_reference_program",
    "kmeans_assign_swizzled",
    "kmeans_fold_program",
    "kmeans_init",
    "kmeans_lloyd_fused",
    "kmeans_lloyd_program",
    "kmeans_lloyd_reference",
    "kmeans_shard_program",
    "launch",
    "matmul_swizzled",
    "ops",
    "ref",
    "sharded",
    "simjoin_counts_swizzled",
    "simjoin_emit_halo_program",
    "simjoin_emit_program",
    "simjoin_emit_swizzled",
    "simjoin_hits_program",
    "simjoin_hits_rows_program",
    "simjoin_pairs_scheduled",
    "simjoin_tile_hits_swizzled",
    "tile_update_program",
    "tile_update_swizzled",
]
