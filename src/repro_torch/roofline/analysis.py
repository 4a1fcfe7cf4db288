"""Roofline terms of a dry-run cell from its traced step (no card needed).

Per (arch, shape, mesh), the JAX package's three terms on the H100's
constants:
    compute term    = Σ over operand dtypes  FLOPs(dtype) / peak(dtype)
    memory term     = analytic bytes / 3.35 TB/s HBM3
    collective term = collective bytes / 450 GB/s NVLink 4

The constants are NVIDIA's data sheet for the H100 SXM5 80GB (dense
rates, no sparsity, at the full 700 W power limit): 989 TFLOP/s bf16 and
fp16 on the tensor cores, 67 TFLOP/s float32 on the FP32 pipes (TF32
stays off in the port, so an f32 product runs there), 3.35 TB/s of HBM3,
NVLink 4 at 900 GB/s a card in both directions (450 GB/s a direction),
and the capacity the H100 80GB HBM3 reports (``HBM_BYTES``:
``torch.cuda.get_device_properties(0).total_memory``).  A product of any
other dtype is priced on the FP32 pipes.

Methodology (the JAX package's notes, as they carry over):

* The port traces the step once, at full depth, on ``meta`` tensors
  (``repro_torch.launch.dryrun``): torch runs every layer in a Python
  loop, so no scan hides a layer.  ``extrapolate_depth`` is kept for the
  JAX package's shallow-twin method and is exact for homogeneous stacks.
* FLOPs are the products of the step (``torch.utils.flop_counter``'s
  formulas: mm, bmm, addmm, baddbmm, convolutions, attention), split by
  operand dtype.  Bytes accessed are every aten op's inputs read and
  outputs written (views excepted): the counterpart of XLA's "bytes
  accessed", reported verbatim (``hlo_bytes_per_device``); like the JAX
  package the bottleneck call uses the analytic lower bound instead.
* There is no HLO in the port: collectives come as ``(kind, per-device
  result bytes)`` records, priced by the JAX package's rules
  (:func:`collective_bytes`, all-reduce doubled for the ring): the
  ``VolumeLedger.records`` of the mesh step's run on a mesh of ``meta``
  devices of the production shape, none on one card.
"""
from __future__ import annotations

from typing import Any, Iterable

import numpy as np

# H100 SXM5 80GB, NVIDIA's data sheet (dense, 700 W)
PEAK_FLOPS = 989e12  # bf16 / fp16 tensor cores, FLOP/s a card
PEAK_FLOPS_FP32 = 67e12  # float32 on the FP32 pipes (TF32 off), FLOP/s a card
HBM_BW = 3.35e12  # HBM3, bytes/s a card
LINK_BW = 450e9  # NVLink 4, bytes/s a card and direction
HBM_BYTES = 85_017_493_504  # total_memory of an H100 80GB HBM3 (torch 2.11, cudaDeviceProp)

_COLLECTIVES = (
    "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
    "collective-permute",
)


def collective_bytes(records: Iterable[tuple[str, float]]) -> dict[str, float]:
    """Per-collective-kind byte totals from ``(kind, per-device result
    bytes)`` records: the JAX package's rules (a kind or its ``-start`` /
    ``-done`` form; all-reduce doubled for the ring) on records instead of
    HLO text."""
    out: dict[str, float] = {k: 0.0 for k in _COLLECTIVES}
    out["count"] = 0
    for kind, nbytes in records:
        base = None
        for c in _COLLECTIVES:
            if kind == c or kind.startswith(c + "-"):
                base = c
                break
        if base is None:
            continue
        if base == "all-reduce":
            nbytes *= 2  # ring: each element leaves and re-enters the chip
        out[base] += nbytes
        out["count"] += 1
    out["total"] = float(sum(out[c] for c in _COLLECTIVES))
    return out


def cost_record(trace: dict) -> dict[str, float]:
    """Raw per-device cost numbers of one traced step (the JAX package's
    keys).  ``trace``: a record of :mod:`repro_torch.launch.dryrun`'s; its
    ``collectives`` records give the ``coll_*`` keys."""
    coll = collective_bytes(trace["collectives"])
    return {
        "flops": float(trace["flops"]),
        "bytes": float(trace["bytes"]),
        "coll_total": coll["total"],
        "coll_detail": {k: coll[k] for k in _COLLECTIVES},
        "coll_count": coll["count"],
    }


def extrapolate_depth(c1: dict, c2: dict, d1: int, d2: int, L: int) -> dict:
    """Linear-in-depth extrapolation of cost records to L layers.

    Per-layer slopes are clamped at 0: CSE across unrolled layers can make
    the shallow-module difference slightly negative for terms dominated by
    the fixed (embed/logits) part."""
    out: dict[str, Any] = {}

    def extr(a, b):
        per = max((b - a) / (d2 - d1), 0.0)
        return max(a + (L - d1) * per, a), per

    for k in ("flops", "bytes", "coll_total"):
        out[k], out[k + "_per_layer"] = extr(c1[k], c2[k])
    out["coll_detail"] = {
        k: extr(c1["coll_detail"][k], c2["coll_detail"][k])[0]
        for k in _COLLECTIVES
    }
    out["coll_count_shallow"] = c2["coll_count"]
    return out


def model_flops(cfg, shape) -> float:
    """Analytic MODEL_FLOPS: 6·N_active·D train, 2·N_active·D inference."""
    from repro_torch.models import active_param_count

    n_active = active_param_count(cfg)
    if shape.mode == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.mode == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch  # decode: 1 token/sequence


def analytic_bytes(cfg, shape, chips: int) -> float:
    """Per-device HBM-traffic lower bound (what a fused program moves):
    params/optimizer traffic + activation stream + cache traffic.  As the
    JAX package's, a hybrid's decode counts the SSM state and not the
    shared attention's KV cache (``run_cell`` notes it)."""
    from repro_torch.models import param_count_analytic

    n = param_count_analytic(cfg)
    L, d = cfg.num_layers, cfg.d_model
    tokens = shape.global_batch * (shape.seq_len if shape.mode != "decode" else 1)
    if shape.mode == "train":
        # params bf16 read + grad f32 write+read + m/v f32 read+write ×2
        # + param write  ≈ 2 + 4·2 + 16 + 2
        param_traffic = 28.0 * n
        act_traffic = 16.0 * tokens * d * L  # fwd save + bwd read, bf16-ish
    elif shape.mode == "prefill":
        param_traffic = 2.0 * n
        act_traffic = 8.0 * tokens * d * L
    else:  # decode
        param_traffic = 2.0 * n
        act_traffic = 8.0 * tokens * d * L
        # KV/state cache read per token
        if cfg.block_kind == "mamba2":
            cache = 4.0 * shape.global_batch * cfg.ssm_heads * cfg.ssm_head_dim \
                * cfg.ssm_state * L
        elif cfg.is_mla:
            cache = 2.0 * shape.global_batch * shape.seq_len \
                * (cfg.kv_lora_rank + cfg.qk_rope_head_dim) * L
        else:
            cache = 2.0 * shape.global_batch * shape.seq_len * 2 \
                * cfg.num_kv_heads * cfg.attn_head_dim * L
        act_traffic += cache
    return (param_traffic + act_traffic) / chips


def peak_flops(dtype: str) -> float:
    """FLOP/s a card for products of ``dtype`` (a torch dtype's name):
    bf16 and fp16 on the tensor cores, anything else on the FP32 pipes."""
    return PEAK_FLOPS if dtype in ("bfloat16", "float16") else PEAK_FLOPS_FP32


def compute_seconds(flops_by_dtype: dict[str, float]) -> float:
    """Σ FLOPs(dtype) / peak(dtype)."""
    return sum(f / peak_flops(dt) for dt, f in flops_by_dtype.items())


def analyze_cell(trace: dict, cost: dict, cfg, shape, mesh) -> dict[str, Any]:
    """The JAX package's record of one cell, from the port's per-device
    trace (``flops_by_dtype``, ``peak_bytes``) and its cost record;
    ``fits_hbm_80g`` in place of ``fits_hbm_16g``."""
    chips = int(np.prod(mesh.devices.shape))
    flops_dev = cost["flops"]
    bytes_dev_hlo = cost["bytes"]
    coll_dev = cost["coll_total"]
    mf = model_flops(cfg, shape)
    bytes_dev_analytic = analytic_bytes(cfg, shape, chips)

    t_compute = compute_seconds(trace["flops_by_dtype"])
    t_mem_hlo = bytes_dev_hlo / HBM_BW
    t_mem = bytes_dev_analytic / HBM_BW
    t_coll = coll_dev / LINK_BW
    terms = {"compute": t_compute, "memory": t_mem, "collective": t_coll}
    bottleneck = max(terms, key=terms.get)
    step_time = max(terms.values())
    mfu = (mf / chips / PEAK_FLOPS) / step_time if step_time > 0 else 0.0
    mem_per_dev = int(trace["peak_bytes"])

    return {
        "chips": chips,
        "flops_per_device": flops_dev,
        "hlo_bytes_per_device": bytes_dev_hlo,
        "analytic_bytes_per_device": bytes_dev_analytic,
        "collective_bytes_per_device": coll_dev,
        "collectives": cost["coll_detail"],
        "t_compute_s": t_compute,
        "t_memory_s": t_mem,
        "t_memory_hlo_s": t_mem_hlo,
        "t_collective_s": t_coll,
        "bottleneck": bottleneck,
        "model_flops": mf,
        "useful_flops_ratio": mf / chips / max(flops_dev, 1.0),
        "roofline_fraction_mfu": mfu,
        "memory_per_device_bytes": mem_per_dev,
        "fits_hbm_80g": bool(mem_per_dev <= HBM_BYTES),
    }


def _ms(t) -> str:
    return f"{t*1e3:.2f}ms"


def roofline_report(rec: dict[str, Any]) -> str:
    if rec.get("skipped"):
        return f"   SKIPPED: {rec['skipped']}"
    return (
        f"   roofline: compute={_ms(rec['t_compute_s'])} "
        f"memory={_ms(rec['t_memory_s'])} "
        f"(hlo {_ms(rec['t_memory_hlo_s'])}) "
        f"collective={_ms(rec['t_collective_s'])} "
        f"-> {rec['bottleneck']}-bound "
        f"mfu~{rec['roofline_fraction_mfu']*100:.1f}% "
        f"useful-flops={min(rec['useful_flops_ratio'],9.99)*100:.0f}% "
        f"hbm/dev={rec['memory_per_device_bytes']/2**30:.2f}GiB "
        f"fits80G={rec['fits_hbm_80g']}"
    )
