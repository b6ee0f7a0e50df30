"""Atomic checkpoints in the reference's on-disk format (PyTorch port of
the part of ``repro.train.checkpoint`` the coloring service uses).

Layout::

    <dir>/step_00000123/arrays.npz     flat {encoded-path: array}
    <dir>/step_00000123/manifest.json  step, keys, shapes, dtypes, sha256
                                       checksum, optional ``meta``
    <dir>/LATEST                       text file, written last (commit point)

The format is the reference's byte for byte, so a checkpoint written by
either package restores in the other. Guarantees:

* atomicity — tmp-dir write + rename; ``LATEST`` advances only after the
  step directory is in place, so a preempted writer never corrupts the
  previous checkpoint;
* retention — keep-last-k pruning;
* integrity — :func:`load` verifies the checksum.

Any nested dict/list tree of arrays checkpoints through :func:`save`,
synchronously; torch tensors are moved to the host first. Dict keys must avoid ``/`` and
``__`` (the path separator and its npz encoding). Restoring onto a
different device layout (the reference's ``restore(shardings=)``) comes
with the distributed slice.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
from typing import Optional

import numpy as np
import torch

_SEP = "/"


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}{_SEP}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}{_SEP}"))
    else:
        out[prefix[:-1]] = tree
    return out


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _digest(flat: dict) -> str:
    digest = hashlib.sha256()
    for k in sorted(flat):
        digest.update(k.encode())
        digest.update(flat[k].tobytes())
    return digest.hexdigest()


def step_dir(root: str, step: int) -> str:
    return os.path.join(root, f"step_{step:08d}")


def save(root: str, step: int, tree, *, keep: int = 3,
         meta: Optional[dict] = None) -> None:
    """Checkpoint ``tree`` (any nested dict/list of arrays or tensors) at
    ``step``. ``meta`` is an optional JSON-able dict stored in the manifest
    and returned by :func:`load` (serialized specs, schema versions)."""
    os.makedirs(root, exist_ok=True)
    flat = _flatten(tree)
    bad = [k for k in flat if "__" in k]
    if bad:
        raise ValueError(f"checkpoint keys must not contain '__' (the npz "
                         f"path encoding): {bad[:3]}")
    host = {k: _host(v) for k, v in flat.items()}
    tmp = step_dir(root, step) + ".tmp"
    final = step_dir(root, step)
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "arrays.npz"),
             **{k.replace("/", "__"): v for k, v in host.items()})
    manifest = {
        "step": step,
        "keys": sorted(host.keys()),
        "shapes": {k: list(v.shape) for k, v in host.items()},
        "dtypes": {k: str(v.dtype) for k, v in host.items()},
        "checksum": _digest(host),
    }
    if meta is not None:
        manifest["meta"] = meta
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    latest = os.path.join(root, "LATEST")
    with open(latest + ".tmp", "w") as f:
        f.write(str(step))
        f.flush()
        os.fsync(f.fileno())
    os.rename(latest + ".tmp", latest)
    _prune(root, keep)


def _prune(root: str, keep: int):
    steps = all_steps(root)
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(step_dir(root, s), ignore_errors=True)


def all_steps(root: str):
    if not os.path.isdir(root):
        return []
    out = []
    for name in os.listdir(root):
        if name.startswith("step_") and not name.endswith(".tmp"):
            try:
                out.append(int(name[5:]))
            except ValueError:
                pass
    return sorted(out)


def latest_step(root: str) -> Optional[int]:
    latest = os.path.join(root, "LATEST")
    if os.path.exists(latest):
        with open(latest) as f:
            s = int(f.read().strip())
        if os.path.isdir(step_dir(root, s)):
            return s
    steps = all_steps(root)
    return steps[-1] if steps else None


def load(root: str, *, step: Optional[int] = None, verify: bool = True):
    """Rebuild a nested **dict** tree from the flat paths alone (list and
    tuple nodes come back as dicts keyed by their stringified index) and
    return ``(tree, manifest, step)``; ``manifest["meta"]`` carries what the
    writer attached. ``step=None`` takes ``LATEST``."""
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {root}")
    d = step_dir(root, step)
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(d, "arrays.npz")) as npz:
        flat = {k.replace("__", "/"): npz[k] for k in npz.files}
    if verify and _digest(flat) != manifest["checksum"]:
        raise IOError(f"checkpoint {d} failed checksum verification")
    for k, dt in manifest.get("dtypes", {}).items():
        if k in flat and str(flat[k].dtype) != dt:
            raise ValueError(
                f"checkpoint {d}: {k} is stored as {flat[k].dtype} for "
                f"dtype {dt}, which this package does not restore")
    tree: dict = {}
    for path, arr in flat.items():
        node = tree
        parts = path.split(_SEP)
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    return tree, manifest, step
