"""Dry run: trace every (arch × shape × mesh) cell's step on ``meta``
tensors and expose its roofline terms on the H100's constants.

Usage:
  python -m repro_torch.launch.dryrun --arch tinyllama-1.1b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod | --one-card] [--out results.json]

The JAX package's dry run compiles each cell on a 512-device XLA host
and reads the compiled program.  The port has no XLA: it runs the cell's
real step (``launch.steps.jit_for_cell``) once, at full width and depth,
on ``meta`` tensors (shapes and dtypes, nothing allocated) under
:class:`StepTrace`, a dispatch mode that sees every aten op and records

* the FLOPs of the products by operand dtype (``torch.utils.flop_counter``'s
  formulas), which the roofline prices on the tensor cores (bf16, fp16)
  or on the FP32 pipes (f32: TF32 stays off in the port);
* the bytes accessed: every op's inputs read and outputs written, views
  excepted (the counterpart of XLA's "bytes accessed", reported verbatim);
* the peak of the live bytes on the device: the arguments (state, batch,
  cache), the temporaries and the outputs, tracked by storage (each
  rounded up to the CUDA caching allocator's 512-byte granule) from its
  making to its freeing, autograd's saved tensors included while they live.

The step runs as the port runs it: ``remat`` is data only in the port
(``models/config.py``), so a train cell's memory is what the port holds,
with the flash's recompute backward and without JAX's remat; the record
says so.  No depth extrapolation is needed (no scan hides a layer).

On the one-card mesh (``--one-card``: ("data", "model") shaped (1, 1))
every number is the trace's and the collective term is 0.  On the
production meshes (16 x 16, 2 x 16 x 16 of H100s, described, not opened)
the state's per-device bytes are exact, from the shard shapes of
``shard_tree``; the step is traced at the local batch (the global batch
over the dp axes that ``resolve_spec`` keeps); the compute term divides
its FLOPs by the "model" axis where the policy shards matrices over it,
and its temporaries are not split over "model" (an upper bound); the
collective term is ``None``: the trace on ``meta`` runs one device's step
and records no collective (pricing the mesh step's collectives is
ROADMAP.md's Queue A item 10).  Nothing here imports JAX or sets
``XLA_FLAGS``.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import ARCHS, SHAPES, ShapeSpec, get_config, skip_reason
from repro_torch.launch.mesh import make_one_card_mesh, make_production_mesh
from repro_torch.launch.steps import (
    _axis_sizes,
    _tensors,
    batch_specs,
    input_specs,
    jit_for_cell,
    resolve_spec,
    shard_leaves,
)
from repro_torch.roofline.analysis import HBM_BW, analyze_cell, cost_record, roofline_report

__all__ = ["StepTrace", "main", "run_cell"]

ALLOC_GRANULE = 512  # bytes: the CUDA caching allocator rounds each block up to this
_NO_WRITE = frozenset({"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided"})

_NO_COLLECTIVES = ("the trace records no collective; the mesh step's collectives are not priced here yet "
                   "(ROADMAP.md's Queue A item 10)")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


class StepTrace(TorchDispatchMode):
    """Every aten op run on ``device`` inside the block: FLOPs of the
    products by operand dtype, bytes accessed, and live bytes by storage
    with their peak.  :meth:`hold` counts tensors made before the block
    (the step's arguments) as live."""

    def __init__(self, device="meta"):
        super().__init__()
        self.device = torch.device(device)
        self.flops_by_dtype: dict[str, int] = {}
        self.bytes = 0
        self.ops = 0
        self.live = 0
        self.peak = 0
        self._storages: dict[int, weakref.ref] = {}

    def hold(self, tree) -> int:
        """Count the tensors of ``tree`` (dicts, lists, tuples, modules)
        as live; returns their bytes."""
        before = self.live
        for t in _tensors(tree):
            self._track(t)
        self.peak = max(self.peak, self.live)
        return self.live - before

    def _track(self, t: torch.Tensor) -> None:
        if t.device != self.device:
            return
        st = t.untyped_storage()
        key = st._cdata
        if key in self._storages:
            return
        n = -(-st.nbytes() // ALLOC_GRANULE) * ALLOC_GRANULE
        self.live += n
        self._storages[key] = weakref.ref(st, functools.partial(self._free, key, n))

    def _free(self, key: int, n: int, _ref) -> None:
        self.live -= n
        self._storages.pop(key, None)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if not any(t.device == self.device for t in ins + outs):
            return out
        self.ops += 1
        packet = func._overloadpacket
        if packet in flop_registry:
            dt = _dtype_name(next(t for t in ins if t.is_floating_point()).dtype)
            self.flops_by_dtype[dt] = self.flops_by_dtype.get(dt, 0) + int(
                flop_registry[packet](*args, **kwargs, out_val=out))
        if not func.is_view:
            here = [t for t in ins if t.device == self.device]
            written = 0 if packet.__name__ in _NO_WRITE else sum(_nbytes(t) for t in outs if t.device == self.device)
            self.bytes += sum(map(_nbytes, here)) + written
        for t in outs:
            self._track(t)
        self.peak = max(self.peak, self.live)
        return out


def _trace_cell(cfg, shape: ShapeSpec, mesh) -> dict:
    """Run the cell's step once on ``meta`` inputs of ``shape`` under
    :class:`StepTrace` (the counterpart of the JAX package's
    ``_compile_cell``): FLOPs (total and by dtype), bytes accessed, the
    arguments' bytes and the peak of the live bytes, aten ops, seconds.
    ``collectives``: ``[]`` on one card (a step there has none)."""
    step = jit_for_cell(cfg, shape, mesh)
    args = input_specs(cfg, shape)
    tr = StepTrace("meta")
    arg_bytes = tr.hold(args)
    t0 = time.perf_counter()
    with tr:
        out = step(*args)
    seconds = time.perf_counter() - t0
    del out
    return {
        "flops": sum(tr.flops_by_dtype.values()),
        "flops_by_dtype": dict(tr.flops_by_dtype),
        "bytes": tr.bytes,
        "argument_bytes": arg_bytes,
        "peak_bytes": tr.peak,
        "ops": tr.ops,
        "trace_s": seconds,
        "collectives": [] if mesh.size == 1 else None,
    }


def _local_batch(cfg, shape: ShapeSpec, mesh) -> int:
    """The global batch over the dp axes that ``resolve_spec`` keeps for
    the batch's leading dim."""
    key = "tokens" if cfg.embed_inputs else "embeds"
    spec = resolve_spec(batch_specs(cfg, shape.mode == "train")[key], (shape.global_batch, shape.seq_len), mesh)
    entry = spec[0] if len(spec) else None
    sizes = _axis_sizes(mesh)
    split = 1
    for a in (entry if isinstance(entry, tuple) else (entry,) if entry else ()):
        split *= sizes[a]
    return shape.global_batch // split


def _production_trace(cfg, shape: ShapeSpec, mesh, policy: str) -> tuple[dict, list[str]]:
    """One device's record on a production mesh: the state's shard bytes
    exact, the step traced at the local batch, its FLOPs over the "model"
    axis where the policy shards matrices over it."""
    shard_bytes = sum(s.nbytes for s in shard_leaves(jit_for_cell(cfg, shape, mesh).in_shardings))
    local = dataclasses.replace(shape, global_batch=_local_batch(cfg, shape, mesh))
    tr = _trace_cell(cfg, local, mesh)
    split = _axis_sizes(mesh)["model"] if policy in ("2d", "tp_only") else 1
    flops = {dt: f / split for dt, f in tr["flops_by_dtype"].items()}
    temporaries = tr["peak_bytes"] - tr["argument_bytes"]
    notes = [
        f"state, batch and cache bytes exact from the shard shapes ({shard_bytes / 2**30:.2f} GiB a device)",
        f"step traced at the local batch {local.global_batch} of {shape.global_batch}; its FLOPs over "
        f"the model axis ({split})",
        f"temporaries ({temporaries / 2**30:.2f} GiB) not split over 'model': an upper bound",
        f"collective term None: {_NO_COLLECTIVES}",
    ]
    return {**tr, "flops": sum(flops.values()), "flops_by_dtype": flops,
            "peak_bytes": shard_bytes + temporaries, "argument_bytes": shard_bytes,
            "local_batch": local.global_batch}, notes


def run_cell(arch: str, shape_name, *, multi_pod: bool = False,
             verbose: bool = True, skip_cost: bool = False,
             policy: str = "2d", overrides: dict | None = None,
             label: str = "", mesh=None) -> dict:
    """Trace one cell; returns the roofline record.

    ``shape_name``: a name of ``configs.SHAPES`` (or a ``ShapeSpec``).
    ``mesh``: the production mesh by default (``multi_pod`` picks which);
    ``launch.mesh.make_one_card_mesh()`` for the card.
    ``policy``/``overrides``/``label`` are the JAX package's hillclimb
    knobs: sharding policy (2d/fsdp/tp_only/arch-default) and ModelConfig
    field overrides."""
    if isinstance(shape_name, ShapeSpec):
        shape, shape_name = shape_name, shape_name.name
    else:
        reason = skip_reason(arch, shape_name)
        if reason is not None:
            return {"arch": arch, "shape": shape_name, "skipped": reason}
        shape = SHAPES[shape_name]
    from repro_torch.models.layers import set_sharding_policy

    cfg = get_config(arch)
    if policy == "arch-default":
        policy = cfg.sharding_policy if shape.mode == "train" else "2d"
    set_sharding_policy(policy)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    mesh = mesh if mesh is not None else make_production_mesh(multi_pod=multi_pod)
    mesh_name = "x".join(map(str, mesh.devices.shape))
    notes = []
    if shape.mode == "train":
        notes.append(f"remat={cfg.remat} is data only in the port (not emulated): the memory is "
                     "what the port's step holds, the flash's recompute backward included")
    if mesh.size == 1:
        trace = _trace_cell(cfg, shape, mesh)
    else:
        trace, more = _production_trace(cfg, shape, mesh, policy)
        notes += more

    if skip_cost:
        return {
            "arch": arch, "shape": shape_name, "multi_pod": multi_pod, "mesh": mesh_name,
            "trace_s": round(trace["trace_s"], 1),
            "memory_per_device_bytes": int(trace["peak_bytes"]),
        }

    if shape.mode == "decode" and cfg.hybrid_attn_every:
        notes.append("analytic_bytes (the JAX package's, verbatim) counts a hybrid's SSM state but not "
                     "its shared-attention KV cache, which a decode step reads whole: the memory term is an "
                     "underestimate; the arguments read once take "
                     f"{1e3 * trace['argument_bytes'] / HBM_BW:.2f} ms")
    record = analyze_cell(trace, cost_record(trace), cfg, shape, mesh)
    record.update(
        arch=arch,
        shape=shape_name,
        multi_pod=multi_pod,
        mesh=mesh_name,
        trace_s=round(trace["trace_s"], 1),
        policy=policy,
        label=label,
        flops_by_dtype=trace["flops_by_dtype"],
        argument_bytes=int(trace["argument_bytes"]),
        aten_ops=trace["ops"],
        notes=notes,
    )
    if verbose:
        print(f"== {arch} × {shape_name} ({mesh_name}) ==")
        print(f"   trace: {trace['ops']} aten ops in {trace['trace_s']:.1f} s, peak "
              f"{trace['peak_bytes'] / 2**30:.2f} GiB (arguments {trace['argument_bytes'] / 2**30:.2f} GiB), "
              f"TFLOP by dtype {json.dumps({k: round(v / 1e12, 3) for k, v in trace['flops_by_dtype'].items()})}")
        print(roofline_report(record))
        for n in notes:
            print(f"   note: {n}")
    return record


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default=None)
    ap.add_argument("--shape", choices=sorted(SHAPES), default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--one-card", action="store_true",
                    help="the one-card mesh, ('data', 'model') shaped (1, 1): every number the trace's")
    ap.add_argument("--all", action="store_true", help="every runnable cell")
    ap.add_argument("--out", default=None, help="append JSON records here")
    ap.add_argument("--skip-cost", action="store_true", help="memory only")
    ap.add_argument("--policy",
                    choices=["2d", "fsdp", "tp_only", "arch-default"],
                    default="2d",
                    help="sharding policy; 'arch-default' uses each arch's optimized policy")
    ap.add_argument("--no-remat", action="store_true",
                    help="recorded in the config (remat is data only in the port: no effect)")
    ap.add_argument("--label", default="", help="tag for iteration logs")
    args = ap.parse_args(argv)
    if args.one_card and args.multi_pod:
        ap.error("--one-card and --multi-pod exclude each other")

    cells: list[tuple[str, str]] = []
    if args.all:
        from repro_torch.models import param_count_analytic

        # cheap archs first: most of the table lands early
        order = sorted(ARCHS, key=lambda a: param_count_analytic(get_config(a)))
        for a in order:
            for s in SHAPES:
                if skip_reason(a, s) is None:
                    cells.append((a, s))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        cells = [(args.arch, args.shape)]

    def append_out(rec: dict) -> None:
        if not args.out:
            return
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        existing = []
        if os.path.exists(args.out):
            with open(args.out) as f:
                existing = json.load(f)
        with open(args.out, "w") as f:
            json.dump(existing + [rec], f, indent=1)

    mesh = make_one_card_mesh() if args.one_card else None
    records, failures = [], []
    for arch, shape in cells:
        try:
            rec = run_cell(arch, shape, multi_pod=args.multi_pod,
                           skip_cost=args.skip_cost, policy=args.policy,
                           overrides={"remat": False} if args.no_remat else None,
                           label=args.label, mesh=mesh)
            records.append(rec)
            append_out(rec)
        except Exception as e:  # a failure here is a tracing or sharding bug
            traceback.print_exc()
            failures.append({"arch": arch, "shape": shape, "error": repr(e)})
            append_out(failures[-1])
    print(f"\n{len(records)}/{len(cells)} cells OK; {len(failures)} failed")
    if failures:
        for f_ in failures:
            print("FAILED:", f_["arch"], f_["shape"], f_["error"][:200])
        raise SystemExit(1)


if __name__ == "__main__":
    main()
