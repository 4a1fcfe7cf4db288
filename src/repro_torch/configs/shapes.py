"""Assigned input shapes and the arch×shape applicability matrix.

Shapes (assignment): per LM arch —
  train_4k     seq 4,096   global_batch 256   (training step)
  prefill_32k  seq 32,768  global_batch 32    (inference prefill)
  decode_32k   seq 32,768  global_batch 128   (one token vs 32k KV cache)
  long_500k    seq 524,288 global_batch 1     (long-context decode)

Skip rules (assignment text, recorded in DESIGN.md §Arch-applicability):
  * ``long_500k`` needs sub-quadratic attention → runs only for ssm/hybrid
    (mamba2, zamba2); skipped for the 8 pure full-attention archs.
  * encoder-only archs (hubert) have no decode step → decode_32k and
    long_500k skipped.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

Mode = Literal["train", "prefill", "decode"]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    mode: Mode


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

_SUBQUADRATIC = {"zamba2-2.7b", "mamba2-2.7b"}
_ENCODER_ONLY = {"hubert-xlarge"}


def skip_reason(arch: str, shape: str) -> str | None:
    """None if the cell runs; otherwise the documented reason."""
    if arch in _ENCODER_ONLY and SHAPES[shape].mode == "decode":
        return "encoder-only arch has no decode step"
    if shape == "long_500k" and arch not in _SUBQUADRATIC:
        return "long_500k needs sub-quadratic attention (ssm/hybrid only)"
    return None


def applicable_shapes(arch: str) -> list[str]:
    return [s for s in SHAPES if skip_reason(arch, s) is None]


def cell_list(archs: list[str]) -> list[tuple[str, str]]:
    """All runnable (arch, shape) dry-run cells."""
    return [(a, s) for a in archs for s in applicable_shapes(a)]
