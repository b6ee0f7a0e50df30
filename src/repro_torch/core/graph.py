"""Graph containers for the coloring engine (PyTorch port).

Three representations:

* :class:`Graph` — host-side (numpy) CSR + directed edge list. Construction,
  dedup, symmetrization, stats and streaming edge deltas live here.
  Bit-identical to the reference ``repro.core.graph.Graph``: the same edges
  give the same ``row_ptr`` and ``col_idx``.
* :class:`BipartiteGraph` — host-side two-sided CSR (left->right and
  right->left), the input of partial distance-2 coloring (``model="pd2"``),
  lowered into the engine's one-sided constraint graph by
  ``repro_torch.core.distance2``.
* :class:`DeviceGraph` — fixed-shape int32 torch tensors on ONE device,
  consumed by the coloring algorithms. Layout-aware like the reference:
  always the directed edge list plus ``inc_ptr``, and via
  ``Graph.to_device(layout=...)`` optionally the CSR arrays and/or the ELL
  geometry (per-edge slot map + static width) the ``ell_pallas`` and
  ``fused_pallas`` engines scatter through.

Conventions
-----------
* Vertices are ``int32`` ids in ``[0, V)``; ``V`` is the phantom vertex that
  padding edges point at.
* The *directed* edge list contains both ``(u, v)`` and ``(v, u)`` for every
  undirected edge, so per-vertex reductions over ``src`` see every neighbor.
* Colors are positive ints; ``0`` means "uncolored".
* ``device=None`` means ``"cuda"``: entry points run on the card unless the
  caller asks for the CPU, and raise when there is no card
  (:func:`resolve_device`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

_LAYOUTS = ("edges", "csr", "ell")

DeviceSpec = Union[None, str, torch.device]


def resolve_device(device: DeviceSpec = None) -> torch.device:
    """The device an entry point runs on: ``None`` means ``"cuda"``. A CUDA
    device without a card raises — there is no silent CPU fallback; only an
    explicit ``device="cpu"`` runs on the host."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on an NVIDIA card by default, and "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch path on the host")
    return dev


def pad_bucket(n: int, *, min_bucket: int = 256) -> int:
    """Round ``n`` up to the shape-bucket grid: multiples of ``2^(k-3)``
    within ``(2^(k-1), 2^k]`` (eighth-of-an-octave steps), floored at
    ``min_bucket`` for positive ``n``. ``n <= 0`` returns 0 — a degenerate
    (vertexless/edgeless) graph must not allocate a phantom slab.

    Padding waste stays at most 25% while the number of distinct shapes per
    size decade stays in the tens — what lets a
    :class:`repro_torch.core.api.ColoringPlan` serve a graph family with one
    program build."""
    n = int(n)
    if n <= 0:
        return 0
    if n <= min_bucket:
        return int(min_bucket)
    k = (n - 1).bit_length()
    step = 1 << max(k - 3, 0)
    return -(-n // step) * step


@dataclasses.dataclass(frozen=True)
class Graph:
    """Host-side undirected graph in CSR form (numpy)."""

    num_vertices: int
    row_ptr: np.ndarray  # [V+1] int64
    col_idx: np.ndarray  # [2E]  int32, neighbors sorted per row

    # ---------------------------------------------------------- construction
    @staticmethod
    def from_edges(num_vertices: int, edges: np.ndarray) -> "Graph":
        """Build from an [M, 2] array of (possibly duplicated, possibly
        self-looped, possibly one-directional) edges — the paper's
        post-processing of R-MAT output (dup/self-loop removal).

        Dedup sorts one int64 key ``src * V + dst`` of the symmetrized
        list, then keeps the first of each run: the same (src, dst) order
        as a two-key lexsort, with one sort pass."""
        edges = np.asarray(edges)
        if edges.size == 0:
            return Graph(num_vertices,
                         np.zeros(num_vertices + 1, np.int64),
                         np.zeros(0, np.int32))
        u = edges[:, 0].astype(np.int64)
        v = edges[:, 1].astype(np.int64)
        keep = u != v  # drop self loops
        u, v = u[keep], v[keep]
        n = np.int64(max(1, num_vertices))
        key = np.concatenate([u * n + v, v * n + u])
        del u, v
        key.sort()
        if key.size:
            first = np.empty(key.shape, np.bool_)
            first[0] = True
            np.not_equal(key[1:], key[:-1], out=first[1:])
            key = key[first]
        src = (key // n).astype(np.int32)
        dst = (key % n).astype(np.int32)
        counts = np.bincount(src, minlength=num_vertices).astype(np.int64)
        row_ptr = np.zeros(num_vertices + 1, np.int64)
        np.cumsum(counts, out=row_ptr[1:])
        return Graph(num_vertices, row_ptr, dst)

    # ---------------------------------------------------------------- stats
    @property
    def num_directed_edges(self) -> int:
        return int(self.col_idx.shape[0])

    @property
    def num_edges(self) -> int:
        return self.num_directed_edges // 2

    def degrees(self) -> np.ndarray:
        return np.diff(self.row_ptr).astype(np.int64)

    def max_degree(self) -> int:
        d = self.degrees()
        return int(d.max()) if d.size else 0

    def degree_variance(self) -> float:
        d = self.degrees()
        return float(d.var()) if d.size else 0.0

    def isolated_fraction(self) -> float:
        d = self.degrees()
        return float((d == 0).mean()) if d.size else 0.0

    def stats(self) -> dict:
        """The columns of the paper's Table 2 / Table 4."""
        return {
            "num_vertices": self.num_vertices,
            "num_edges": self.num_edges,
            "avg_degree": (2.0 * self.num_edges / max(1, self.num_vertices)),
            "max_degree": self.max_degree(),
            "degree_variance": self.degree_variance(),
            "pct_isolated": 100.0 * self.isolated_fraction(),
        }

    # ------------------------------------------------------------ transforms
    def directed_edges(self) -> Tuple[np.ndarray, np.ndarray]:
        """(src, dst) with both directions present; src is sorted."""
        src = np.repeat(
            np.arange(self.num_vertices, dtype=np.int32),
            np.diff(self.row_ptr).astype(np.int64),
        )
        return src, self.col_idx.astype(np.int32)

    def undirected_edges(self) -> np.ndarray:
        """The canonical undirected edge set: [E, 2] int32 with u < v, in
        lexicographic order (CSR order restricted to the lower direction)."""
        src, dst = self.directed_edges()
        half = src < dst
        return np.stack([src[half], dst[half]], 1)

    def _edge_keys(self, u: np.ndarray, v: np.ndarray) -> np.ndarray:
        """Dense int64 key of canonical (u < v) pairs — u*V+v stays below
        2^63 for any int32 vertex count, so no overflow."""
        return u.astype(np.int64) * np.int64(self.num_vertices) \
            + v.astype(np.int64)

    @staticmethod
    def _member_mask(sorted_keys: np.ndarray, keys: np.ndarray) -> np.ndarray:
        """[M] bool: which ``keys`` occur in ``sorted_keys`` (one
        searchsorted probe, shared by :meth:`has_edges` and
        :meth:`delta_info`)."""
        pos = np.searchsorted(sorted_keys, keys)
        hit = np.zeros(keys.shape[0], np.bool_)
        ok = pos < sorted_keys.shape[0]
        hit[ok] = sorted_keys[pos[ok]] == keys[ok]
        return hit

    @staticmethod
    def _canonical_pairs(edges, num_vertices: int) -> Tuple[np.ndarray, np.ndarray]:
        """Normalize an [M, 2] endpoint array: orient u < v, drop self
        loops, reject out-of-range ids. Duplicates are kept."""
        edges = np.asarray(edges)
        if edges.size == 0:
            z = np.zeros(0, np.int32)
            return z, z.copy()
        edges = edges.reshape(-1, 2)
        a = edges[:, 0].astype(np.int64)
        b = edges[:, 1].astype(np.int64)
        if a.size and (min(a.min(), b.min()) < 0
                       or max(a.max(), b.max()) >= num_vertices):
            raise ValueError("delta edge endpoint out of range "
                             f"[0, {num_vertices})")
        u = np.minimum(a, b)
        v = np.maximum(a, b)
        keep = u != v
        return u[keep].astype(np.int32), v[keep].astype(np.int32)

    def has_edges(self, edges) -> np.ndarray:
        """[M] bool membership mask for candidate undirected edges ([M, 2]
        endpoints, either orientation; self loops are never present)."""
        u, v = self._canonical_pairs(edges, self.num_vertices)
        base = self.undirected_edges()
        base_keys = self._edge_keys(base[:, 0], base[:, 1])  # sorted (CSR)
        hit = self._member_mask(base_keys, self._edge_keys(u, v))
        edges = np.asarray(edges)
        if edges.size == 0:
            return np.zeros(0, np.bool_)
        edges = edges.reshape(-1, 2)
        out = np.zeros(edges.shape[0], np.bool_)
        out[edges[:, 0] != edges[:, 1]] = hit
        return out

    def delta_info(self, inserts=None, deletes=None
                   ) -> Tuple["Graph", np.ndarray, int]:
        """Apply an undirected edge delta and report what changed:
        ``(new_graph, added_pairs, num_deleted)`` where ``added_pairs`` is
        the [M, 2] canonical (u < v) set of genuinely new edges and
        ``num_deleted`` the count of genuinely removed ones.

        Set semantics: duplicate rows, self loops, inserts of present edges
        and deletes of absent edges are no-ops; an edge in both lists ends
        PRESENT (deletes apply first, then inserts). The vertex set is
        fixed."""
        V = self.num_vertices
        base = self.undirected_edges()
        base_keys = self._edge_keys(base[:, 0], base[:, 1])  # sorted (CSR)

        ins_pairs = np.zeros((0, 2), np.int32)
        ins_keys = np.zeros(0, np.int64)
        if inserts is not None:
            iu, iv = self._canonical_pairs(inserts, V)
            if iu.size:
                ins_pairs = np.unique(np.stack([iu, iv], 1), axis=0)
                ins_keys = self._edge_keys(ins_pairs[:, 0], ins_pairs[:, 1])

        keep = np.ones(base_keys.shape[0], np.bool_)
        if deletes is not None:
            du, dv = self._canonical_pairs(deletes, V)
            if du.size:
                del_keys = self._edge_keys(du, dv)
                if ins_keys.size:
                    del_keys = del_keys[~np.isin(del_keys, ins_keys)]
                keep &= ~np.isin(base_keys, del_keys)

        new_pairs = ins_pairs
        if ins_keys.size:
            new_pairs = ins_pairs[~self._member_mask(base_keys, ins_keys)]
        new_graph = Graph.from_edges(
            V, np.concatenate([base[keep], new_pairs]))
        return new_graph, new_pairs, int((~keep).sum())

    def apply_delta(self, inserts=None, deletes=None) -> "Graph":
        """:meth:`delta_info`'s new graph, when the change report is not
        needed (same set semantics)."""
        return self.delta_info(inserts, deletes)[0]

    def relabel(self, perm: np.ndarray) -> "Graph":
        """Relabel vertices: new id of old vertex i is ``perm[i]``."""
        src, dst = self.directed_edges()
        new_src = perm[src].astype(np.int64)
        new_dst = perm[dst].astype(np.int64)
        half = new_src < new_dst
        return Graph.from_edges(
            self.num_vertices, np.stack([new_src[half], new_dst[half]], 1)
        )

    def to_device(self, *, layout: Union[str, Sequence[str]] = "edges",
                  pad_edges_to: Optional[int] = None,
                  ell_width: Optional[int] = None,
                  device: DeviceSpec = None) -> "DeviceGraph":
        """Move the graph onto ``device`` (``None`` = the card) in the
        requested layout(s).

        layout: ``"edges"`` (directed edge list — always present),
            ``"csr"`` (adds ``row_ptr``/``col_idx``), ``"ell"`` (adds the
            ELL geometry — the per-edge slot map + static slab width — that
            the ``ell_pallas``/``fused_pallas`` engines scatter through), or
            any sequence of these.
        ell_width: optional ELL width override (default: max degree; a
            smaller width truncates rows, which those engines reject).
        """
        dev = resolve_device(device)
        layouts = (layout,) if isinstance(layout, str) else tuple(layout)
        unknown = set(layouts) - set(_LAYOUTS)
        if unknown:
            raise ValueError(f"unknown layout(s) {sorted(unknown)}; "
                             f"choose from {_LAYOUTS}")
        src, dst = self.directed_edges()
        e = src.shape[0]
        pad = (pad_edges_to or e) - e
        if pad < 0:
            raise ValueError(f"pad_edges_to={pad_edges_to} < num edges {e}")

        def put(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

        # incident-edge auxiliary (every layout): [V+1] int32 row pointers
        # into the row-contiguous directed edge list — what the frontier
        # layer compacts an active vertex set through
        fits32 = self.num_directed_edges <= np.iinfo(np.int32).max
        inc_ptr_dev = put(self.row_ptr) if fits32 else None

        row_ptr_dev = col_idx_dev = slot_dev = None
        width = 0
        if "csr" in layouts:
            if not fits32:
                raise ValueError("csr device layout needs 2E < 2^31; "
                                 f"got {self.num_directed_edges} edges")
            row_ptr_dev = put(self.row_ptr)
            col_idx_dev = put(self.col_idx)
        if "ell" in layouts:
            width = max(1, int(ell_width if ell_width is not None
                               else self.max_degree()))
            # slot of each edge within its row; out-of-width and padding
            # edges get ``width``: the engines' ELL scatters write them
            # into a sink column that the kernel never reads
            pos = np.arange(e, dtype=np.int64) - self.row_ptr[src]
            slot = np.minimum(pos, width).astype(np.int32)
            if pad:
                slot = np.concatenate([slot, np.full(pad, width, np.int32)])
            slot_dev = put(slot)

        if pad:
            # padding edges point at the phantom vertex V with src=V, so
            # they are inert in segment reductions over [0, V)
            src = np.concatenate([src, np.full(pad, self.num_vertices, np.int32)])
            dst = np.concatenate([dst, np.full(pad, self.num_vertices, np.int32)])
        return DeviceGraph(
            num_vertices=self.num_vertices,
            num_directed_edges=e,
            src=put(src),
            dst=put(dst),
            max_degree=self.max_degree(),
            row_ptr=row_ptr_dev,
            col_idx=col_idx_dev,
            ell_slot=slot_dev,
            ell_width=width,
            inc_ptr=inc_ptr_dev,
        )

    def to_ell(self, max_degree: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
        """Padded ELL adjacency: ([V, D] int32 neighbor ids, [V] degrees).
        Pad slots hold ``V`` (phantom vertex)."""
        deg = self.degrees()
        d_max = int(max_degree if max_degree is not None else (deg.max() if deg.size else 0))
        ell = np.full((self.num_vertices, max(1, d_max)), self.num_vertices, np.int32)
        src, dst = self.directed_edges()
        pos = np.arange(src.shape[0], dtype=np.int64) - self.row_ptr[src]
        ok = pos < d_max
        ell[src[ok], pos[ok]] = dst[ok]
        return ell, deg.astype(np.int32)


@dataclasses.dataclass(frozen=True)
class BipartiteGraph:
    """Host-side bipartite graph: ``num_left`` x ``num_right`` vertices with
    edges only across the classes, stored as CSR in both directions.

    Partial distance-2 coloring colors one class so that no two vertices of
    it sharing a neighbor get the same color (distance-1 coloring of that
    class's one-mode projection). ``repro_torch.core.distance2`` lowers it
    into the engine's edge space; :func:`repro_torch.core.greedy_ref.
    greedy_color_pd2` is the serial oracle.
    """

    num_left: int
    num_right: int
    l2r_ptr: np.ndarray  # [L+1] int64
    l2r_idx: np.ndarray  # [E]   int32 right ids, sorted per row
    r2l_ptr: np.ndarray  # [R+1] int64
    r2l_idx: np.ndarray  # [E]   int32 left ids, sorted per row

    @staticmethod
    def from_edges(num_left: int, num_right: int,
                   edges: np.ndarray) -> "BipartiteGraph":
        """Build from an [M, 2] array of (left, right) pairs; duplicates are
        dropped. Each side's CSR is the two-key lexsort order of the
        reference."""
        edges = np.asarray(edges)
        if edges.size == 0:
            lv = np.zeros(0, np.int32)
            rv = np.zeros(0, np.int32)
        else:
            lv = edges[:, 0].astype(np.int32)
            rv = edges[:, 1].astype(np.int32)
        if lv.size and (lv.min() < 0 or lv.max() >= num_left
                        or rv.min() < 0 or rv.max() >= num_right):
            raise ValueError("bipartite edge endpoint out of range")

        def _csr(src, dst, n_src):
            order = np.lexsort((dst, src))
            s, d = src[order], dst[order]
            if s.size:
                first = np.empty(s.shape, np.bool_)
                first[0] = True
                np.logical_or(s[1:] != s[:-1], d[1:] != d[:-1], out=first[1:])
                s, d = s[first], d[first]
            ptr = np.zeros(n_src + 1, np.int64)
            np.cumsum(np.bincount(s, minlength=n_src), out=ptr[1:])
            return ptr, d.astype(np.int32)

        l2r_ptr, l2r_idx = _csr(lv, rv, num_left)
        r2l_ptr, r2l_idx = _csr(rv, lv, num_right)
        return BipartiteGraph(num_left, num_right,
                              l2r_ptr, l2r_idx, r2l_ptr, r2l_idx)

    @property
    def num_edges(self) -> int:
        return int(self.l2r_idx.shape[0])

    def left_degrees(self) -> np.ndarray:
        return np.diff(self.l2r_ptr).astype(np.int64)

    def right_degrees(self) -> np.ndarray:
        return np.diff(self.r2l_ptr).astype(np.int64)

    def stats(self) -> dict:
        ld, rd = self.left_degrees(), self.right_degrees()
        return {
            "num_left": self.num_left,
            "num_right": self.num_right,
            "num_edges": self.num_edges,
            "max_left_degree": int(ld.max()) if ld.size else 0,
            "max_right_degree": int(rd.max()) if rd.size else 0,
        }


@dataclasses.dataclass(frozen=True)
class DeviceGraph:
    """Fixed-shape int32 tensors on one device, in one or more layouts.

    The directed edge list (``src``/``dst``) is always present; CSR and ELL
    layouts are optional and requested via ``Graph.to_device(layout=...)``.
    ``max_degree`` is the color bound the table engines size themselves
    from; ``-1`` means unknown (hand-built graphs), which those engines
    reject rather than silently under-sizing their tables.
    """

    num_vertices: int
    num_directed_edges: int
    src: torch.Tensor  # [E2p] int32 in [0, V]; V = padding
    dst: torch.Tensor  # [E2p] int32 in [0, V]
    max_degree: int = -1
    row_ptr: Optional[torch.Tensor] = None   # [V+1] int32 (layout="csr")
    col_idx: Optional[torch.Tensor] = None   # [2E]  int32 (layout="csr")
    ell_slot: Optional[torch.Tensor] = None  # [E2p] int32 (layout="ell")
    ell_width: int = 0                       # static slab width (layout="ell")
    inc_ptr: Optional[torch.Tensor] = None   # [V+1] int32 incident-edge row
    # pointers into src/dst (attached by to_device under EVERY layout; its
    # presence asserts the edge list is row-contiguous — the frontier
    # layer's compaction invariant). Hand-built edge lists leave it None,
    # which disables the frontier path.

    @property
    def device(self) -> torch.device:
        return self.src.device

    @property
    def padded_edges(self) -> int:
        return int(self.src.shape[0])

    @property
    def has_csr(self) -> bool:
        return self.row_ptr is not None

    @property
    def has_ell(self) -> bool:
        return self.ell_slot is not None

    @property
    def has_frontier(self) -> bool:
        """True when the incident-edge auxiliary is present, i.e. the
        frontier execution layer can compact active sets on this graph."""
        return self.inc_ptr is not None
