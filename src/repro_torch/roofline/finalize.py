"""Write the dry run's table between the DRYRUN markers of a document.

Usage: PYTHONPATH=src python -m repro_torch.roofline.finalize DOC.md RECORDS.json [MORE.json ...]

Reads the dry-run JSON records (``python -m repro_torch.launch.dryrun
--all --out RECORDS.json``; a later file's record of a cell replaces an
earlier one's), orders them by arch and shape, and writes
:func:`~repro_torch.roofline.report.fmt_table` between the
``<!-- DRYRUN:BEGIN -->`` and ``<!-- DRYRUN:END -->`` lines of DOC.md.
"""
from __future__ import annotations

import json
import sys

from .report import fmt_table

ORDER = [
    "hubert-xlarge", "tinyllama-1.1b", "stablelm-1.6b", "zamba2-2.7b",
    "mamba2-2.7b", "olmoe-1b-7b", "minitron-8b", "qwen2.5-14b",
    "chameleon-34b", "deepseek-v2-236b",
]
SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def _key(r):
    return (ORDER.index(r["arch"]), SHAPE_ORDER.index(r["shape"]))


def _load(path):
    with open(path) as f:
        return json.load(f)


def _dedupe_last(records):
    out = {}
    for r in records:
        if "arch" in r and "shape" in r:
            out[(r["arch"], r["shape"])] = r
    return out


def write_block(doc_path: str, block: str) -> None:
    """Replace what lies between the DRYRUN markers of ``doc_path``."""
    with open(doc_path) as f:
        doc = f.read()
    pre, rest = doc.split("<!-- DRYRUN:BEGIN -->")
    _, post = rest.split("<!-- DRYRUN:END -->")
    doc = pre + "<!-- DRYRUN:BEGIN -->\n" + block + "\n<!-- DRYRUN:END -->" + post
    with open(doc_path, "w") as f:
        f.write(doc)


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 2:
        raise SystemExit("usage: python -m repro_torch.roofline.finalize DOC.md RECORDS.json [...]")
    doc, paths = argv[0], argv[1:]
    records = {}
    for path in paths:
        records.update(_dedupe_last(_load(path)))
    failed = [r for r in records.values() if "error" in r]
    ok = sorted((r for r in records.values() if "error" not in r), key=_key)
    block = fmt_table(ok)
    if failed:
        block += "\n\nFailed: " + ", ".join(f"{r['arch']} × {r['shape']}" for r in sorted(failed, key=_key))
    write_block(doc, block)
    print(f"{doc}: dry-run table updated ({len(ok)} cells, {len(failed)} failed)")


if __name__ == "__main__":
    main()
