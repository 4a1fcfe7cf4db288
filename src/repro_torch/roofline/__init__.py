"""repro_torch.roofline — the dry run's roofline terms on H100 constants
(the JAX package's ``repro.roofline``)."""
from .analysis import (
    analyze_cell,
    collective_bytes,
    cost_record,
    extrapolate_depth,
    roofline_report,
)

__all__ = [
    "analyze_cell",
    "collective_bytes",
    "cost_record",
    "extrapolate_depth",
    "roofline_report",
]
