"""repro_torch.core — the paper's space-filling-curve machinery, for the
PyTorch/CUDA port.

The numpy curve layer is a copy of the JAX package's (the port never
imports that package); only the device-facing parts differ:

  hilbert       Mealy-automaton H(i,j) / H^-1(h)            (paper §3)
  lindenmayer   CFG + non-recursive Fig.5 generators        (paper §4-5)
  zorder        Z-order / Gray-code baselines               (paper §2)
  peano         3-adic Peano curve baseline                 (paper §2.1)
  fur           overlay-grid curves for arbitrary n×m       (paper §6.1)
  fgf           jump-over walker for general regions        (paper §6.2)
  hilbert_nd    d-dimensional Hilbert/Z-order/Gray codecs   (beyond-paper)
  fgf_nd        d-dimensional jump-over walker              (beyond-paper)
  curve         SpaceFillingCurve abstraction + registry    (beyond-paper)
  curves_nd     table-driven curve algebras (harmonious,
                cyclic) + verification oracles              (beyond-paper)
  schedule      tile-schedule factory + traffic models,
                device tables as torch tensors per device   (GPU adaptation)
  program       GpuProgram declarations + curve-range
                partitioning                                (execution layer)
  torch_hilbert device-side vectorised codec                (GPU adaptation)
"""
from .curve import (
    SpaceFillingCurve,
    available_curves,
    curve_supports,
    get_curve,
    register,
)
from .curves_nd import (
    CurveAlgebra,
    TableCurveAlgebra,
    algebra_names,
    get_algebra,
    register_algebra,
    verify_table_curve,
)
from .fgf import fgf_path, fgf_rect, fgf_triangle
from .fgf_nd import curve_jump_path_nd, fgf_box_nd, fgf_path_nd, fgf_triangle_nd
from .fur import fur_is_unit_step, fur_path
from .hilbert import hilbert_decode, hilbert_encode, hilbert_path
from .hilbert_nd import hilbert_decode_nd, hilbert_encode_nd, hilbert_path_nd
from .peano import peano_decode, peano_encode, peano_path
from .program import GpuProgram, curve_partition
from .schedule import (
    CURVES,
    KMEANS_PHASES,
    SCHEDULE_KINDS,
    ScheduleChoice,
    as_choice,
    kmeans_schedule,
    kmeans_schedule_device,
    mark_first_visits,
    min_revisit_gap,
    miss_curve,
    phased_schedule,
    phased_schedule_device,
    register_schedule_cache,
    schedule_cache_clear,
    tile_schedule,
    tile_schedule_device,
    tile_schedule_nd,
    triangle_schedule,
    triangle_schedule_device,
    triangle_schedule_nd,
)
from .torch_hilbert import (
    hilbert_encode_nd_torch,
    hilbert_encode_torch,
    hilbert_sort_key,
)
from .zorder import zorder_decode, zorder_encode, zorder_path

__all__ = [k for k in dir() if not k.startswith("_")]
