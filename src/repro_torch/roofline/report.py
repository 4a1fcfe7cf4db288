"""Render dry-run JSON records as a markdown table.

Usage: PYTHONPATH=src python -m repro_torch.roofline.report results.json
"""
from __future__ import annotations

import json
import sys

from .analysis import HBM_BYTES


def _ms(t) -> str:
    return "—" if t is None else f"{t*1e3:.2f}"


def fmt_table(records: list[dict]) -> str:
    rows = []
    header = (
        "| arch | shape | compute (ms) | memory (ms) | collective (ms) | "
        "bottleneck | MFU roofline | useful FLOPs | HBM/dev (GiB) | fits 80G |"
    )
    rows.append(header)
    rows.append("|" + "---|" * 10)
    for r in records:
        if r.get("skipped"):
            rows.append(
                f"| {r['arch']} | {r['shape']} | — | — | — | skipped | — | — | — | "
                f"{r['skipped']} |"
            )
            continue
        if "t_compute_s" not in r:
            rows.append(
                f"| {r['arch']} | {r['shape']} | — | — | — | compile-proof | — | — | "
                f"{r.get('memory_per_device_bytes', 0)/2**30:.2f} | "
                f"{'yes' if r.get('memory_per_device_bytes', 1 << 60) <= HBM_BYTES else 'NO'} |"
            )
            continue
        rows.append(
            f"| {r['arch']} | {r['shape']} "
            f"| {_ms(r['t_compute_s'])} "
            f"| {_ms(r['t_memory_s'])} "
            f"| {_ms(r['t_collective_s'])} "
            f"| {r['bottleneck']} "
            f"| {r['roofline_fraction_mfu']*100:.1f}% "
            f"| {min(r['useful_flops_ratio'], 9.99)*100:.0f}% "
            f"| {r['memory_per_device_bytes']/2**30:.2f} "
            f"| {'yes' if r.get('fits_hbm_80g') else 'NO'} |"
        )
    return "\n".join(rows)


def main() -> None:
    with open(sys.argv[1]) as f:
        records = json.load(f)
    print(fmt_table(records))


if __name__ == "__main__":
    main()
