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
the record prices the port's one mesh program (``launch/spmd.py``): the
cell's step runs through ``spmd.run_cell`` on a ``DeviceMesh`` of
``meta`` devices of the production shape (:func:`mesh_trace`), where
``DeviceMesh.run`` runs program 0 alone for all of them.  Each program
is one data shard's rows at model index 0, on the parameters gathered
whole onto its device; a train step reduce-scatters the grads onto the
shards.  The compute term is a program's FLOPs (nothing of a matrix is
split over "model"; the MoE's EP branch splits the experts where the
programs run along "model"), the peak is the position's shards, the
program's rows, the gathered parameters and the program's temporaries,
and the collective term is the mesh's ``VolumeLedger`` (``records``: each
call as the HLO collective the JAX package parses, at NVLink's 450 GB/s).
AdamW moves nothing between positions and is left out of the traced
step.  Nothing here imports JAX or sets ``XLA_FLAGS``.
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
from torch.utils._pytree import tree_leaves, tree_map
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import ARCHS, SHAPES, ShapeSpec, get_config, skip_reason
from repro_torch.launch import spmd
from repro_torch.launch.mesh import make_mesh, make_one_card_mesh, make_production_mesh
from repro_torch.launch.steps import (
    _axis_sizes,
    _dp_axes,
    _tensors,
    batch_specs,
    input_specs,
    jit_for_cell,
    resolve_spec,
    shard_leaves,
)
from repro_torch.models import named_params
from repro_torch.models.moe import expert_parallel
from repro_torch.models.sharding import current_program
from repro_torch.roofline.analysis import (
    HBM_BW,
    LINK_BW,
    analyze_cell,
    collective_bytes,
    cost_record,
    roofline_report,
)

__all__ = ["StepTrace", "main", "mesh_trace", "run_cell"]

ALLOC_GRANULE = 512  # bytes: the CUDA caching allocator rounds each block up to this
_NO_WRITE = frozenset({"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided"})


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


class _Made(tuple):
    """(shape, stride, dtype) of a ``meta`` output, to make it again."""


def _meta_key(x):
    """The part of an op's argument that a ``meta`` kernel's result
    depends on: a tensor's dtype, shape, strides, offset and whether it is
    on ``meta``; any other value with its type (1 and 1.0 differ)."""
    if isinstance(x, torch.Tensor):
        return (x.dtype, x.shape, x.stride(), x.storage_offset(), x.is_meta)
    if isinstance(x, (list, tuple)):
        return (type(x), tuple(_meta_key(v) for v in x))
    if isinstance(x, dict):
        return (dict, tuple((k, _meta_key(v)) for k, v in x.items()))
    return (type(x), x)


def _remake(x):
    return torch.empty_strided(x[0], x[1], dtype=x[2], device="meta") if isinstance(x, _Made) else x


class StepTrace(TorchDispatchMode):
    """Every aten op run on ``device`` inside the block: FLOPs of the
    products by operand dtype, bytes accessed, and live bytes by storage
    with their peak.  :meth:`hold` counts tensors made before the block
    (the step's arguments) as live.

    The ops of a mesh program (run inside one: ``models.sharding.
    current_program``) and of the backward are also counted apart, in
    ``program_flops_by_dtype``, ``program_bytes``, ``program_live`` and
    ``program_peak`` (the storages such an op makes, until they are
    freed): on ``meta`` a mesh runs its program 0 alone
    (``DeviceMesh.run``), so these are one program's device's.

    On ``meta`` the result of an op that neither writes nor aliases its
    inputs is made from the metadata that the same op gave for inputs of
    the same metadata before: torch's ``meta`` kernels are Python, and a
    mesh step's controller runs its ops on every position's parts."""

    def __init__(self, device="meta"):
        super().__init__()
        self.device = torch.device(device)
        self.flops_by_dtype: dict[str, int] = {}
        self.bytes = 0
        self.ops = 0
        self.live = 0
        self.peak = 0
        self.program_flops_by_dtype: dict[str, int] = {}
        self.program_bytes = 0
        self.program_live = 0
        self.program_peak = 0
        self._storages: dict[int, weakref.ref] = {}
        self._memo: dict = {}
        self._functional: dict = {}

    def hold(self, tree) -> int:
        """Count the tensors of ``tree`` (dicts, lists, tuples, modules)
        as live; returns their bytes."""
        before = self.live
        for t in _tensors(tree):
            self._track(t, False)
        self.peak = max(self.peak, self.live)
        return self.live - before

    def _track(self, t: torch.Tensor, program: bool) -> None:
        if t.device != self.device:
            return
        st = t.untyped_storage()
        key = st._cdata
        if key in self._storages:
            return
        n = -(-st.nbytes() // ALLOC_GRANULE) * ALLOC_GRANULE
        self.live += n
        if program:
            self.program_live += n
        self._storages[key] = weakref.ref(st, functools.partial(self._free, key, n, program))

    def _free(self, key: int, n: int, program: bool, _ref) -> None:
        self.live -= n
        if program:
            self.program_live -= n
        self._storages.pop(key, None)

    def _run(self, func, args, kwargs):
        """``func(*args, **kwargs)``, or on ``meta`` its remembered result."""
        functional = self._functional.get(func)
        if functional is None:
            schema = func._schema
            functional = self._functional[func] = not schema.is_mutable and all(
                r.alias_info is None for r in schema.returns)
        if not functional or self.device.type != "meta":
            return func(*args, **kwargs)
        try:
            key = (func, _meta_key(args), _meta_key(kwargs))
            made = self._memo.get(key)
        except TypeError:  # an unhashable argument
            return func(*args, **kwargs)
        if made is not None:
            return tree_map(_remake, made)
        out = func(*args, **kwargs)
        outs = tree_leaves(out)
        ins = {t.untyped_storage()._cdata for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)}
        if any(isinstance(t, torch.Tensor) and t.untyped_storage()._cdata in ins for t in outs):
            self._functional[func] = False  # an alias its schema does not declare (``_unsafe_view``)
        elif all(t is None or isinstance(t, torch.Tensor) and t.is_meta for t in outs):
            self._memo[key] = tree_map(
                lambda t: _Made((t.shape, t.stride(), t.dtype)) if isinstance(t, torch.Tensor) else t, out)
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = self._run(func, args, kwargs)
        ins = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if not any(t.device == self.device for t in ins + outs):
            return out
        program = current_program() is not None or torch._C._current_graph_task_id() != -1
        self.ops += 1
        packet = func._overloadpacket
        if packet in flop_registry:
            dt = _dtype_name(next(t for t in ins if t.is_floating_point()).dtype)
            flops = int(flop_registry[packet](*args, **kwargs, out_val=out))
            self.flops_by_dtype[dt] = self.flops_by_dtype.get(dt, 0) + flops
            if program:
                self.program_flops_by_dtype[dt] = self.program_flops_by_dtype.get(dt, 0) + flops
        if not func.is_view:
            here = [t for t in ins if t.device == self.device]
            written = 0 if packet.__name__ in _NO_WRITE else sum(_nbytes(t) for t in outs if t.device == self.device)
            nbytes = sum(map(_nbytes, here)) + written
            self.bytes += nbytes
            if program:
                self.program_bytes += nbytes
        for t in outs:
            self._track(t, program)
        self.peak = max(self.peak, self.live)
        self.program_peak = max(self.program_peak, self.program_live)
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


def _work_split(cfg, mesh, axes: tuple) -> str:
    """What of the step the port's programs along ``axes`` split, beyond
    the batch's rows: nothing of a matrix over "model"; MoE experts by the
    EP branch's rule (``models/moe.py``)."""
    if cfg.block_kind != "moe":
        return "no matrix is split over 'model': each program runs whole parameters"
    if expert_parallel(cfg, mesh) is None:
        return ("no matrix is split over 'model'; without expert parallelism each program dispatches every "
                "program's tokens (the global capacity): the MoE's work repeated in each")
    m = mesh.axis_size("model")
    if "model" in axes:
        return (f"no dense matrix is split over 'model'; the EP branch splits the experts: a program computes "
                f"{cfg.num_experts // m} of {cfg.num_experts} on its data shard's tokens gathered over 'model'")
    return (f"no matrix is split over 'model'; the EP branch's {m} ranks' experts all run in each program, "
            "each rank's partial on its rows")


def mesh_trace(cfg, shape: ShapeSpec, logical) -> tuple[dict, list[str]]:
    """The record of the port's mesh program on a production mesh: the
    cell's step (``spmd.run_cell``, under the active sharding policy) on a
    ``DeviceMesh`` of ``meta`` devices of the shape and axes of
    ``logical`` (any mesh: a ``LogicalMesh`` of ranks, or a ``DeviceMesh``
    whose step is to be predicted), under :class:`StepTrace`, AdamW left
    out (part by part: no collective, no product).  Program 0 runs for all
    (``DeviceMesh.run``), so the trace's program ops are one program's
    device's: its FLOPs are the compute term and its bytes accessed the
    bytes; the mesh's ledger gives the collectives.  The peak is the
    position's shards, the program's rows of the batch and cache, the
    parameters gathered whole (one copy a device) and the program's
    temporaries (its live bytes' peak: activations, saved tensors, its
    grads).  ``mesh_trace_s``: placing the state on the mesh and the step;
    ``trace_s``: the step."""
    t0 = time.perf_counter()
    train = shape.mode == "train"
    mesh = make_mesh(logical.shape, logical.axis_names, devices=["meta"])
    step = jit_for_cell(cfg, shape, mesh)
    args = input_specs(cfg, shape)
    params = args[0]["params"] if train else args[0]
    shard_bytes = sum(s.nbytes for s in shard_leaves(step.in_shardings[0]))
    gathered = sum(map(_nbytes, named_params(params).values()))
    local = _local_batch(cfg, shape, logical)
    programs = shape.global_batch // local
    axes = spmd.batch_axes(mesh, _dp_axes(mesh), shape.global_batch)
    row_bytes = sum(map(_nbytes, _tensors(args[1:]))) // programs
    placed = spmd.place_state(cfg, args[0], mesh) if train else spmd.place_params(cfg, params, mesh)
    tr = StepTrace("meta")
    t1 = time.perf_counter()
    with tr, mesh.recording() as ledger:
        out = spmd.run_cell(step, placed, *args[1:], update=False)
    step_s = time.perf_counter() - t1
    del out, placed
    flops = dict(tr.program_flops_by_dtype)
    arguments = shard_bytes + row_bytes
    ring = sum(ledger.bytes.values())
    hlo = collective_bytes(ledger.records)
    notes = [
        f"the port's mesh program priced: {programs} program(s), one a data shard along {axes}, each on "
        f"{local} of the {shape.global_batch} rows at model index 0, the parameters gathered whole onto each"
        f"{', its grads reduce-scattered onto the shards' if train else ''}; traced on a "
        f"{'x'.join(map(str, logical.shape))} mesh of meta devices, program 0 standing for the others",
        f"compute term: a program's FLOPs (its {'forward and backward' if train else 'step'}); "
        f"{_work_split(cfg, mesh, axes)}",
        f"memory term: the JAX package's analytic lower bound over the mesh's {mesh.size} cards, verbatim; a "
        "program's own bytes accessed are hlo_bytes_per_device",
        f"collective term: the mesh step's ledger as HLO records ({hlo['count']} calls, {hlo['total']:.0f} B "
        f"a device); ring-priced {ring} B ({json.dumps(ledger.counts)} calls), {1e3 * ring / LINK_BW:.3f} ms at "
        f"{LINK_BW / 1e9:.0f} GB/s",
        f"peak: the position's shards ({shard_bytes / 2**30:.2f} GiB), the program's rows of the batch and cache "
        f"({row_bytes / 2**30:.2f} GiB), the parameters gathered whole ({gathered / 2**30:.2f} GiB) and the "
        f"program's temporaries ({tr.program_peak / 2**30:.2f} GiB)",
    ]
    if train:
        notes.append("AdamW (part by part: no collective, no product) left out of the trace: the bytes accessed "
                     "are a program's forward and backward")
    return {
        "flops": sum(flops.values()),
        "flops_by_dtype": flops,
        "bytes": tr.program_bytes,
        "argument_bytes": arguments,
        "peak_bytes": arguments + gathered + tr.program_peak,
        "ops": tr.ops,
        "trace_s": step_s,
        "mesh_trace_s": time.perf_counter() - t0,
        "collectives": list(ledger.records),
        "ledger": ledger.as_dict(),
        "local_batch": local,
        "programs": programs,
        "gathered_bytes": gathered,
    }, notes


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
        trace, more = mesh_trace(cfg, shape, mesh)
        notes += more

    on_mesh = {k: trace[k] for k in ("ledger", "programs", "local_batch", "gathered_bytes") if k in trace}
    if "mesh_trace_s" in trace:
        on_mesh["mesh_trace_s"] = round(trace["mesh_trace_s"], 1)
    if skip_cost:
        return {
            "arch": arch, "shape": shape_name, "multi_pod": multi_pod, "mesh": mesh_name,
            "trace_s": round(trace["trace_s"], 1),
            "memory_per_device_bytes": int(trace["peak_bytes"]), **on_mesh,
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
        **on_mesh,
    )
    if verbose:
        print(f"== {arch} × {shape_name} ({mesh_name}) ==")
        mesh_s = f" (the mesh trace {trace['mesh_trace_s']:.1f} s)" if "mesh_trace_s" in trace else ""
        print(f"   trace: {trace['ops']} aten ops in {trace['trace_s']:.1f} s{mesh_s}, peak "
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
