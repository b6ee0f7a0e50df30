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
layout ``repro_torch.convert`` maps onto the port's).

On a mesh (a tree with ``DTensor`` leaves) :func:`save` is a collective:
every rank calls it, each leaf's shards are gathered to rank 0 alone, and
rank 0 alone writes, so the files equal a one-device save of the same
values byte for byte. ``restore(shardings=, mesh=)`` puts each restored leaf onto
the given placements of ``mesh`` (the reference's elastic restart onto
another mesh shape); without them the leaves come back whole on the
prototype's device, which restarts a sharded run on one device.
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

from ..parallel.sharding import on_mesh

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


def _block(shape, mesh_shape, placements, coord) -> tuple:
    """The slices of a global tensor of ``shape`` that the rank at mesh
    coordinate ``coord`` holds under ``placements`` (``Shard`` splits as
    ``torch.chunk`` does, nested in mesh-dim order; ``Replicate`` keeps the
    whole dim)."""
    lo, hi = [0] * len(shape), list(shape)
    for mdim, p in enumerate(placements):
        if p.is_shard():
            d, k = p.dim, mesh_shape[mdim]
            step = -(-(hi[d] - lo[d]) // k)
            lo[d], hi[d] = (min(lo[d] + coord[mdim] * step, hi[d]),
                            min(lo[d] + (coord[mdim] + 1) * step, hi[d]))
        elif not p.is_replicate():
            raise ValueError(f"a checkpoint leaf placed {placements}: only "
                             f"Shard and Replicate are held at rest")
    return tuple(slice(a, b) for a, b in zip(lo, hi))


def _gathered_to_rank0(x):
    """A ``DTensor``'s global value as a plain tensor on rank 0, ``None`` on
    the other ranks (every rank of its mesh calls it; the mesh spans the
    process group): each rank's shard goes to rank 0 alone, padded to the
    largest shard's size, and rank 0 puts each at its place."""
    import torch.distributed as dist
    mesh = x.device_mesh
    ranks = mesh.mesh.flatten().tolist()
    if sorted(ranks) != list(range(dist.get_world_size())):
        raise ValueError("a checkpoint of DTensor leaves needs a mesh over "
                         "the whole process group")
    mshape = tuple(mesh.shape)
    blocks = {r: _block(x.shape, mshape, x.placements,
                        np.unravel_index(i, mshape))
              for i, r in enumerate(ranks)}
    sizes = {r: int(np.prod([b.stop - b.start for b in blk]))
             for r, blk in blocks.items()}
    n = max(sizes.values())
    mine = x.to_local().reshape(-1)
    sent = torch.zeros(n, dtype=x.dtype, device=mine.device)
    sent[:mine.numel()] = mine
    if dist.get_rank() != 0:
        dist.gather(sent, None, dst=0)
        return None
    got = [torch.empty_like(sent) for _ in range(dist.get_world_size())]
    dist.gather(sent, got, dst=0)
    out = torch.empty(x.shape, dtype=x.dtype, device=mine.device)
    for r, blk in blocks.items():
        out[blk] = got[r][:sizes[r]].view(out[blk].shape)
    return out


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
        _hash_leaf(digest, k, flat[k])
    return digest.hexdigest()


def _hash_leaf(digest, path: str, arr: np.ndarray):
    """The checksum's bytes of one leaf: its path, then its C-order bytes
    (hashed in place, not copied)."""
    digest.update(path.encode())
    digest.update(np.ascontiguousarray(arr).reshape(-1).view(np.uint8))


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
    done on return and the result is ``None``. With DTensor leaves every
    rank calls this, and only rank 0 writes (the others return ``None``)."""
    os.makedirs(root, exist_ok=True)
    flat = _flatten(tree)
    bad = [k for k in flat if "__" in k]
    if bad:
        raise ValueError(f"checkpoint keys must not contain '__' (the npz "
                         f"path encoding): {bad[:3]}")
    writer = True
    if any(on_mesh(x) for x in flat.values()):
        import torch.distributed as dist
        writer = dist.get_rank() == 0
    host, dtypes = {}, {}
    for k, v in flat.items():
        gathered = on_mesh(v)
        if gathered:
            v = _gathered_to_rank0(v.detach())      # a collective
        if writer:     # a gathered leaf is a fresh tensor: no second copy
            host[k], dtypes[k] = _host(v, copy=async_write and not gathered)
    if not writer:
        return None

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


def _open(root: str, step: Optional[int]):
    """``(step dir, manifest, step)`` of a checkpoint (``step=None`` takes
    ``LATEST``)."""
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {root}")
    d = step_dir(root, step)
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    return d, manifest, step


def _leaves(d: str, manifest: dict, verify: bool):
    """``(path, leaf)`` of a checkpoint, one leaf in memory at a time, in
    path order, each leaf in its manifest dtype. With ``verify`` it raises
    after the last leaf if the checksum differs, so a caller that consumes
    every leaf never returns a corrupted one."""
    digest = hashlib.sha256()
    dtypes = manifest.get("dtypes", {})
    with np.load(os.path.join(d, "arrays.npz")) as npz:
        for name in sorted(npz.files, key=lambda k: k.replace("__", "/")):
            path = name.replace("__", "/")
            arr = npz[name]
            if verify:
                _hash_leaf(digest, path, arr)
            if path in dtypes:
                try:
                    arr = _stored_as(arr, dtypes[path])
                except ValueError as e:
                    raise ValueError(f"checkpoint {d}: {path}: {e}") from None
            yield path, arr
    if verify and digest.hexdigest() != manifest["checksum"]:
        raise IOError(f"checkpoint {d} failed checksum verification")


def _load_flat(root: str, step: Optional[int], verify: bool):
    """The flat ``{path: leaf}`` of a checkpoint (``step=None`` takes
    ``LATEST``), checksum-verified, each leaf in its manifest dtype;
    returns ``(flat, manifest, step)``."""
    d, manifest, step = _open(root, step)
    return dict(_leaves(d, manifest, verify)), manifest, step


def _as_proto(path: str, leaf, proto, where, mesh):
    if not isinstance(proto, torch.Tensor):
        return leaf
    t = leaf if isinstance(leaf, torch.Tensor) else torch.from_numpy(leaf)
    if tuple(t.shape) != tuple(proto.shape):
        raise ValueError(f"checkpoint leaf {path} has shape "
                         f"{tuple(t.shape)}, the prototype {tuple(proto.shape)}")
    t = t.to(device=proto.device, dtype=proto.dtype)
    if where is None:
        return t
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t, mesh, list(where), src_data_rank=None)


def restore(root: str, proto, *, step: Optional[int] = None,
            shardings=None, mesh=None, verify: bool = True):
    """Load a checkpoint into the structure of ``proto`` (nested dicts and
    lists) and return ``(tree, step)``; ``step=None`` takes ``LATEST``.
    Where the prototype leaf is a tensor, the restored leaf is a new tensor
    on its device and in its dtype (its shape must match); other leaves
    come back as :func:`load` gives them.

    ``shardings`` (with ``mesh``, a ``DeviceMesh``): a tree matching
    ``proto`` whose leaves are DTensor placements on ``mesh``
    (``launch.specs.tree_shardings``), or ``None`` for a leaf kept whole;
    each placed leaf comes back as a DTensor holding this rank's shard (the
    reference's elastic restart onto the current mesh). Every rank reads
    the whole file, one leaf at a time, and keeps its shards; nothing
    crosses the wire."""
    if shardings is not None and mesh is None:
        raise ValueError("restore(shardings=) needs the mesh they are on")
    d, manifest, step = _open(root, step)
    wanted = {}

    def walk(sub, where, prefix=""):
        if isinstance(sub, dict):
            for k, v in sub.items():
                walk(v, None if where is None else where[k],
                     f"{prefix}{k}{_SEP}")
        elif isinstance(sub, (list, tuple)):
            for i, v in enumerate(sub):
                walk(v, None if where is None else where[i],
                     f"{prefix}{i}{_SEP}")
        else:
            wanted[prefix[:-1]] = (sub, where)

    walk(proto, shardings)
    placed = {}
    for path, leaf in _leaves(d, manifest, verify):
        if path in wanted:
            placed[path] = _as_proto(path, leaf, *wanted[path], mesh)
    missing = sorted(set(wanted) - set(placed))
    if missing:
        raise KeyError(f"checkpoint under {root} has no leaf {missing[0]}")

    def build(sub, prefix=""):
        if isinstance(sub, dict):
            return {k: build(v, f"{prefix}{k}{_SEP}") for k, v in sub.items()}
        if isinstance(sub, (list, tuple)):
            return type(sub)(build(v, f"{prefix}{i}{_SEP}")
                             for i, v in enumerate(sub))
        return placed[prefix[:-1]]

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
