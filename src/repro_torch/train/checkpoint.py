"""Atomic, async-capable checkpoints in the reference's on-disk format (the
PyTorch port of ``repro.train.checkpoint``).

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
* integrity — :func:`load` and :func:`restore` verify the checksum;
* async — :func:`save` takes the host snapshot synchronously (every leaf
  copied off the live tensors before it returns) and, with
  ``async_write=True``, writes the files in a daemon thread, so a trainer
  may update its params in place at once.

Any nested dict/list tree of arrays or tensors checkpoints through
:func:`save`. A ``torch.bfloat16`` leaf, which numpy cannot hold, is stored
as the reference stores its bf16 leaves: the ``uint16`` view of its bytes,
with ``"bfloat16"`` in the manifest. Dict keys must avoid ``/`` and ``__``
(the path separator and its npz encoding).

Two readers: :func:`restore` fills the structure of a prototype tree (a
trainer's params and optimizer state) with tensors on each prototype
leaf's device; :func:`load` rebuilds a nested dict from the paths alone
(the coloring service; a checkpoint of the reference's trainer, whose
layout ``repro_torch.convert`` maps onto the port's). Restoring onto
another device layout (the reference's ``restore(shardings=)``) comes with
the sharded trainer.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
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


def _host(x, copy: bool):
    """``(array, dtype name)`` of a leaf on the host; a bf16 tensor is the
    ``uint16`` view of its bytes. With ``copy`` the array shares no memory
    with ``x``."""
    if isinstance(x, torch.Tensor):
        t = x.detach().to("cpu", copy=copy)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        a = t.numpy()
    else:
        a = np.array(x) if copy else np.asarray(x)
    return a, str(a.dtype)


def _stored_as(arr: np.ndarray, dtype: str):
    """A stored leaf in its manifest dtype: numpy, except bf16, which comes
    back as a ``torch.bfloat16`` tensor."""
    if str(arr.dtype) == dtype:
        return arr
    if dtype == "bfloat16" and arr.dtype == np.uint16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    raise ValueError(f"a leaf stored as {arr.dtype} for dtype {dtype}, "
                     f"which this package does not restore")


def _digest(flat: dict) -> str:
    digest = hashlib.sha256()
    for k in sorted(flat):
        digest.update(k.encode())
        digest.update(flat[k].tobytes())
    return digest.hexdigest()


def step_dir(root: str, step: int) -> str:
    return os.path.join(root, f"step_{step:08d}")


def save(root: str, step: int, tree, *, keep: int = 3,
         async_write: bool = False,
         meta: Optional[dict] = None) -> Optional[threading.Thread]:
    """Checkpoint ``tree`` (any nested dict/list of arrays or tensors) at
    ``step``. ``meta`` is an optional JSON-able dict stored in the manifest
    and returned by :func:`load` (serialized specs, schema versions).

    With ``async_write`` the leaves are copied to the host before this
    returns, the files are written by a daemon thread, and the thread is
    returned (join it before relying on the files); otherwise the write is
    done on return and the result is ``None``."""
    os.makedirs(root, exist_ok=True)
    flat = _flatten(tree)
    bad = [k for k in flat if "__" in k]
    if bad:
        raise ValueError(f"checkpoint keys must not contain '__' (the npz "
                         f"path encoding): {bad[:3]}")
    host, dtypes = {}, {}
    for k, v in flat.items():
        host[k], dtypes[k] = _host(v, copy=async_write)

    def write():
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
            "dtypes": dtypes,
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

    if async_write:
        t = threading.Thread(target=write, daemon=True)
        t.start()
        return t
    write()
    return None


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


def _load_flat(root: str, step: Optional[int], verify: bool):
    """The flat ``{path: leaf}`` of a checkpoint (``step=None`` takes
    ``LATEST``), checksum-verified, each leaf in its manifest dtype;
    returns ``(flat, manifest, step)``."""
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
        if k in flat:
            try:
                flat[k] = _stored_as(flat[k], dt)
            except ValueError as e:
                raise ValueError(f"checkpoint {d}: {k}: {e}") from None
    return flat, manifest, step


def _as_proto(path: str, leaf, proto):
    if not isinstance(proto, torch.Tensor):
        return leaf
    t = leaf if isinstance(leaf, torch.Tensor) else torch.from_numpy(leaf)
    if tuple(t.shape) != tuple(proto.shape):
        raise ValueError(f"checkpoint leaf {path} has shape "
                         f"{tuple(t.shape)}, the prototype {tuple(proto.shape)}")
    return t.to(device=proto.device, dtype=proto.dtype)


def restore(root: str, proto, *, step: Optional[int] = None,
            verify: bool = True):
    """Load a checkpoint into the structure of ``proto`` (nested dicts and
    lists) and return ``(tree, step)``; ``step=None`` takes ``LATEST``.
    Where the prototype leaf is a tensor, the restored leaf is a new tensor
    on its device and in its dtype (its shape must match); other leaves
    come back as :func:`load` gives them. The reference's ``shardings=``
    (re-sharding onto the current mesh) comes with the sharded trainer."""
    flat, _, step = _load_flat(root, step, verify)

    def build(sub, prefix=""):
        if isinstance(sub, dict):
            return {k: build(v, f"{prefix}{k}{_SEP}") for k, v in sub.items()}
        if isinstance(sub, (list, tuple)):
            return type(sub)(build(v, f"{prefix}{i}{_SEP}")
                             for i, v in enumerate(sub))
        path = prefix[:-1]
        if path not in flat:
            raise KeyError(f"checkpoint under {root} has no leaf {path}")
        return _as_proto(path, flat[path], sub)

    return build(proto), step


def load(root: str, *, step: Optional[int] = None, verify: bool = True):
    """Rebuild a nested **dict** tree from the flat paths alone (list and
    tuple nodes come back as dicts keyed by their stringified index) and
    return ``(tree, manifest, step)``; ``manifest["meta"]`` carries what the
    writer attached. ``step=None`` takes ``LATEST``. Leaves are numpy
    arrays, except bf16 ones, which are ``torch.bfloat16`` tensors."""
    flat, manifest, step = _load_flat(root, step, verify)
    tree: dict = {}
    for path, arr in flat.items():
        node = tree
        parts = path.split(_SEP)
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    return tree, manifest, step
