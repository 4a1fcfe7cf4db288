"""Step-atomic, content-hashed, async-capable checkpoints in the JAX
package's on-disk format.

Layout:  <dir>/step_<N>/
            manifest.json   (step, tree structure, key paths, and a
                             shape, dtype and sha256 a leaf)
            arr_<i>.npy     (one file a leaf, C-contiguous)
         <dir>/LATEST       (the pointer, replaced atomically, written last)

Guarantees (the JAX package's):
  * atomicity — a step is staged under a temporary name and renamed into
    place; LATEST moves only after the rename;
  * integrity — every leaf carries the sha256 of its file; a load checks
    it and falls back to an older step when a file does not match;
  * async — ``save_async`` copies the leaves to the host at once and
    writes them on a background thread;
  * retention — ``keep_last_n``, never deleting the step LATEST names.

A tree is nested dicts, tuples, lists and NamedTuples (``AdamWState``)
over tensors, numpy arrays and numbers.  Leaves are written in the JAX
package's flatten order (dict keys sorted, a NamedTuple's fields in
order), so a checkpoint crosses between the packages both ways: the JAX
loader reads leaves by position against its example tree.  bf16 (and
fp8) leaves are stored as same-width integer views with the dtype's name
in the manifest, read and written through torch, so no ``ml_dtypes`` is
needed.  Loads return CPU tensors; the caller moves them.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
import threading
import time
from typing import Any

import numpy as np
import torch

__all__ = ["CheckpointManager", "available_steps", "load_checkpoint", "save_checkpoint"]

# dtypes numpy cannot hold without ml_dtypes: stored as the JAX package
# stores them, as same-width integer views; (torch dtype, torch integer view,
# stored numpy dtype, the numpy view torch reads back)
_EXOTIC = {
    "bfloat16": (torch.bfloat16, torch.int16, np.uint16, np.int16),
    "float8_e4m3fn": (torch.float8_e4m3fn, torch.uint8, np.uint8, np.uint8),
    "float8_e5m2": (torch.float8_e5m2, torch.uint8, np.uint8, np.uint8),
}
_TORCH_NAME = {v[0]: k for k, v in _EXOTIC.items()}


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------

def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree, path: str = ""):
    """[(key path, leaf)] in the JAX package's order, with its key strings
    (``['state']['opt'].m['blocks']``)."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _flatten(tree[k], f"{path}[{k!r}]")]
    if _is_namedtuple(tree):
        return [kv for f in tree._fields for kv in _flatten(getattr(tree, f), f"{path}.{f}")]
    if isinstance(tree, (tuple, list)):
        return [kv for i, v in enumerate(tree) for kv in _flatten(v, f"{path}[{i}]")]
    return [(path, tree)]


def _unflatten(example, leaves):
    """``example``'s structure with its leaves replaced, in flatten order."""
    if isinstance(example, dict):
        return {k: _unflatten(example[k], leaves) for k in sorted(example)}
    if _is_namedtuple(example):
        return type(example)(*(_unflatten(getattr(example, f), leaves) for f in example._fields))
    if isinstance(example, (tuple, list)):
        return type(example)(_unflatten(v, leaves) for v in example)
    return next(leaves)


def _treedef(tree) -> str:
    """The structure in the JAX package's ``PyTreeDef`` notation."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_treedef(tree[k])}" for k in sorted(tree)) + "}"
    if _is_namedtuple(tree):
        inner = ", ".join(_treedef(getattr(tree, f)) for f in tree._fields)
        return f"CustomNode(namedtuple[{type(tree).__name__}], [{inner}])"
    if isinstance(tree, tuple):
        return "(" + ", ".join(_treedef(v) for v in tree) + ("," if len(tree) == 1 else "") + ")"
    if isinstance(tree, list):
        return "[" + ", ".join(_treedef(v) for v in tree) + "]"
    return "*"


def _host(x, copy: bool) -> tuple[np.ndarray, str]:
    """A leaf as (storable C-contiguous numpy array, dtype name); with
    ``copy`` an array of its own even where the leaf is on the host
    already (a snapshot that later in-place updates do not reach)."""
    if isinstance(x, torch.Tensor):
        t = x.detach().to("cpu", copy=copy).contiguous()
        if t.dtype in _TORCH_NAME:
            name = _TORCH_NAME[t.dtype]
            _, int_torch, stored, _ = _EXOTIC[name]
            return t.view(int_torch).numpy().view(stored), name
        arr = t.numpy()
    else:
        arr = np.array(x) if copy else np.asarray(x)
    return _contiguous(arr), str(arr.dtype)


def _contiguous(arr: np.ndarray) -> np.ndarray:
    # ascontiguousarray promotes 0-d to (1,): restore the shape
    return np.ascontiguousarray(arr).reshape(arr.shape)


def _tensor(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name in _EXOTIC:
        dtype, _, _, readable = _EXOTIC[dtype_name]
        return torch.from_numpy(_contiguous(arr.view(readable))).view(dtype)
    return torch.from_numpy(_contiguous(arr))


# ---------------------------------------------------------------------------
# save and load
# ---------------------------------------------------------------------------

def _snapshot(tree, copy: bool = False):
    flat = _flatten(tree)
    return [p for p, _ in flat], [_host(x, copy) for _, x in flat], _treedef(tree)


def save_checkpoint(directory: str, step: int, tree: Any) -> str:
    """Synchronous atomic save.  Returns the step directory."""
    os.makedirs(directory, exist_ok=True)
    return _write(directory, step, *_snapshot(tree))


def _write(directory, step, paths, host_leaves, treedef) -> str:
    final = os.path.join(directory, f"step_{step:010d}")
    tmp = tempfile.mkdtemp(dir=directory, prefix=".staging_")
    try:
        manifest = {"step": int(step), "treedef": f"PyTreeDef({treedef})", "paths": paths,
                    "leaves": []}
        for i, (arr, dtype_name) in enumerate(host_leaves):
            fn = f"arr_{i}.npy"
            np.save(os.path.join(tmp, fn), arr)
            with open(os.path.join(tmp, fn), "rb") as f:
                digest = hashlib.sha256(f.read()).hexdigest()
            manifest["leaves"].append(
                {"file": fn, "shape": list(arr.shape), "dtype": dtype_name, "sha256": digest})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    ptr_tmp = os.path.join(directory, ".LATEST.tmp")
    with open(ptr_tmp, "w") as f:
        f.write(str(step))
    os.replace(ptr_tmp, os.path.join(directory, "LATEST"))
    return final


def available_steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        if name.startswith("step_"):
            try:
                out.append(int(name.split("_")[1]))
            except ValueError:
                pass
    return sorted(out)


def load_checkpoint(directory: str, step: int | None = None, example: Any = None):
    """(step, tree): the step LATEST names (or ``step``), checked leaf by
    leaf; an unreadable or corrupted step falls back to the one before.
    With ``example`` the leaves take its structure, else a list.  Leaves
    are CPU tensors."""
    steps = available_steps(directory)
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    if step is None:
        latest = os.path.join(directory, "LATEST")
        if os.path.exists(latest):
            with open(latest) as f:
                step = int(f.read().strip())
        else:
            step = steps[-1]
    for s in reversed([s for s in steps if s <= step]):
        try:
            return s, _read(os.path.join(directory, f"step_{s:010d}"), example)
        except (OSError, ValueError, json.JSONDecodeError) as e:  # corrupted
            print(f"[ckpt] step {s} unreadable ({e}); trying previous")
    raise FileNotFoundError(f"no readable checkpoint <= {step} under {directory}")


def _read(stepdir: str, example: Any):
    with open(os.path.join(stepdir, "manifest.json")) as f:
        manifest = json.load(f)
    leaves = []
    for meta in manifest["leaves"]:
        path = os.path.join(stepdir, meta["file"])
        with open(path, "rb") as f:
            raw = f.read()
        if hashlib.sha256(raw).hexdigest() != meta["sha256"]:
            raise ValueError(f"hash mismatch in {path}")
        arr = np.load(path).reshape(meta["shape"])
        leaves.append(_tensor(arr, meta["dtype"]))
    if example is None:
        return leaves
    if len(_flatten(example)) != len(leaves):
        raise ValueError("checkpoint/model structure mismatch")
    return _unflatten(example, iter(leaves))


def _nbytes(host_leaves) -> int:
    return sum(arr.nbytes for arr, _ in host_leaves)


class CheckpointManager:
    """Async save, retention and resume, off the step path.  ``last_save``
    and ``last_restore`` record the step, seconds and bytes of the latest
    of each (host copy, write and hashing included)."""

    def __init__(self, directory: str, keep_last_n: int = 3):
        self.directory = directory
        self.keep_last_n = keep_last_n
        self._thread: threading.Thread | None = None
        self.last_save: dict | None = None
        self.last_restore: dict | None = None
        os.makedirs(directory, exist_ok=True)

    def save_async(self, step: int, tree: Any) -> None:
        self.wait()  # one save in flight at a time
        t0 = time.perf_counter()
        snap = _snapshot(tree, copy=True)  # the host copy, taken now

        def work():
            _write(self.directory, step, *snap)
            self._gc()
            self.last_save = {"step": step, "seconds": time.perf_counter() - t0,
                              "bytes": _nbytes(snap[1])}

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def save(self, step: int, tree: Any) -> None:
        self.wait()
        t0 = time.perf_counter()
        os.makedirs(self.directory, exist_ok=True)
        snap = _snapshot(tree)
        _write(self.directory, step, *snap)
        self._gc()
        self.last_save = {"step": step, "seconds": time.perf_counter() - t0, "bytes": _nbytes(snap[1])}

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def restore(self, example: Any = None, step: int | None = None):
        self.wait()
        t0 = time.perf_counter()
        out = load_checkpoint(self.directory, step, example)
        leaves = _flatten(out[1])
        self.last_restore = {"step": out[0], "seconds": time.perf_counter() - t0,
                             "bytes": sum(x.numel() * x.element_size() for _, x in leaves)}
        return out

    def latest_step(self) -> int | None:
        steps = available_steps(self.directory)
        return steps[-1] if steps else None

    def _gc(self) -> None:
        steps = available_steps(self.directory)
        keep = set(steps[-self.keep_last_n:])
        latest = os.path.join(self.directory, "LATEST")
        if os.path.exists(latest):
            with open(latest) as f:
                keep.add(int(f.read().strip()))
        for s in steps:
            if s not in keep:
                shutil.rmtree(os.path.join(self.directory, f"step_{s:010d}"), ignore_errors=True)
