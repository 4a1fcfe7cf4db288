"""repro_torch.configs — the 10 assigned architectures + shape registry (the
JAX package's configuration data, verbatim)."""
from .registry import ARCHS, get_config, get_reduced
from .shapes import SHAPES, ShapeSpec, applicable_shapes, cell_list, skip_reason

__all__ = [
    "ARCHS",
    "get_config",
    "get_reduced",
    "SHAPES",
    "ShapeSpec",
    "applicable_shapes",
    "cell_list",
    "skip_reason",
]
