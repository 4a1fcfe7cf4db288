"""launch() — the single dispatch point for every GpuProgram.

The operands' device decides the path, and nothing else does:

* CUDA tensors → the program's hand-written kernel (``program.launcher``),
  which launches it or raises.  There is no fallback.
* CPU tensors → the program's plain PyTorch version (``program.plain``),
  the tile-walk twin that the CPU tests hold against the JAX reference.

Every kernel launch is counted per kernel name, where the launcher calls
the kernel, in :data:`repro_torch.kernels._build.LAUNCHES` (the port's
counterpart of the JAX package's ``PallasCallCounter``), so a run can
show that its main path went through the kernels.
"""
from __future__ import annotations

import torch

from repro_torch.core.program import GpuProgram

__all__ = ["cta_chunks", "launch", "require", "shuffled_ctas"]


def launch(program: GpuProgram, *tensors: torch.Tensor):
    """Run ``program`` over ``tensors`` on their device.

    All tensors, and the program's schedule, must be on one device.
    """
    devices = {t.device for t in tensors} | {program.schedule.device}
    if len(devices) != 1:
        raise ValueError(
            f"{program.name}: operands and schedule span devices "
            f"{sorted(str(d) for d in devices)}"
        )
    (device,) = devices
    if device.type == "cuda":
        return program.launcher(program, *tensors)
    if device.type == "cpu":
        return program.plain(program, *tensors)
    raise ValueError(f"{program.name}: no kernel for device {device}")


def require(program: GpuProgram, t: torch.Tensor, what: str, *, dtypes, shape=None):
    """A CUDA wrapper's operand check: raise on what its kernel does not
    take (wrong device, dtype, shape or a non-contiguous layout)."""
    if t.device.type != "cuda":
        raise ValueError(f"{program.name}: {what} is on {t.device}, not CUDA")
    if t.dtype not in dtypes:
        raise TypeError(f"{program.name}: {what} has dtype {t.dtype}, kernel takes {dtypes}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{program.name}: {what} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{program.name}: {what} must be contiguous")


def shuffled_ctas(n: int, device, seed: int = 0) -> torch.Tensor:
    """CTA ids ``0..n-1`` in a seeded random order: the order in which a
    plain version visits its CTAs, so that a hidden dependency between
    CTAs (which a GPU runs concurrently, in no order) fails on the CPU
    too."""
    g = torch.Generator().manual_seed(seed)
    return torch.randperm(n, generator=g).to(device)


def cta_chunks(order: torch.Tensor, per_cta: int, budget: int = 1 << 26):
    """Split a CTA order into chunks whose batched working set stays near
    ``budget`` elements (``per_cta`` elements each): the plain versions
    run a chunk of CTAs as one batched tensor op."""
    return order.split(max(1, budget // max(1, per_cta)))
