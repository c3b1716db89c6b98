"""HNSW tensor index (paper §2.3, §4.1) — vectorized hot path.

Faithful multi-layer HNSW (Malkov & Yashunin) specialised the way NeurStore
uses it:

* each vertex stores an **8-bit quantized base tensor** plus its scale /
  zero-point (paper §4.1 "to reduce the index size, each base tensor is
  quantized to 8-bit ... prior to insertion");
* distance between a float32 query and a vertex de-quantizes the vertex on
  the fly — the paper's ``QuantizedL2Space`` (AVX2). Here the hot loop is the
  vectorized :func:`quantized_l2_batch`; an index on a CUDA device computes
  its distance blocks with the CUDA kernel of
  ``repro_torch.kernels.quantized_l2``;
* one index per flattened tensor length — the engine keeps a pool keyed by
  ``dim`` (paper §4.2 flattens tensors so (10,10) and (5,20) share an index).

Graph traversal is host-side control flow (as in the paper's CPU extension);
only the distance computation is a dense batched op. The index's ``device``
(not serialized) says where :meth:`HNSWIndex._distance_block` runs: on a
CUDA device every block goes through the kernel, which reads the vertex
payload from a device mirror of the host arrays (:class:`CodeMirror`: each
row is uploaded once, when it enters the index, or once per index when it
is read from bytes); on the CPU it is the numpy decomposed form and there
is no mirror. The per-candidate ``_distances`` of the graph walk stay in
numpy on the host either way, as in the reference.

Hot-path design (vs the seed implementation, frozen in
``repro.core.hnsw_ref`` of the reference package as the parity oracle):

* **Amortized vertex storage** — codes/scales/zero-points/mids/norms live in
  capacity-doubling preallocated arrays; insert is O(1) amortized instead of
  the seed's per-insert ``np.concatenate`` (O(n·D) copy per insert).
* **Decomposed quantized L2** — with ``deq_i = (c_i − z_i)·s_i`` the squared
  distance to query ``q`` expands to

      ‖q − deq_i‖² = ‖q‖² − 2·s_i·(q·c_i) + 2·s_i·z_i·Σq + ‖deq_i‖²

  where ``‖deq_i‖² = s_i²·(Σc_i² − 2·z_i·Σc_i + D·z_i²)`` is cached per
  vertex at insert (computed from exact integer sums of the uint8 codes).
  Constant rows (``s_i == 0``) use ``‖q‖² − 2·mid_i·Σq + D·mid_i²``; both
  cases collapse into one branch-free form via the per-vertex cache
  ``cross_i = s_i·z_i`` (normal) / ``−mid_i`` (constant):

      dist_i = ‖q‖² + ‖deq_i‖² + 2·(Σq·cross_i − s_i·(q·c_i))

  A search therefore costs one gemv over the candidate codes plus O(B)
  scalar work — no per-call (B, D) dequantize/subtract/square temporaries.
  The in-index gemv runs in float32 (codes are ≤ 255, exactly
  representable; measured max relative deviation from the float64 oracle
  is ~8e-8 at D=4096, an order of magnitude inside the 1e-6 parity
  budget) with the O(B) combination kept in float64.
* **Epoch visited tracking** — layer search stamps visited vertices into a
  reused int64 epoch array (hnswlib's VisitedListPool pattern: bump the
  epoch instead of re-zeroing) and filters neighbor expansions vectorized,
  replacing the seed's per-int Python ``set`` hashing without O(N) memset
  per layer call.

Precision note: the decomposed form has *absolute* error ~``s·‖q‖·ε₃₂·√D``
from the float32 gemv. For queries far from every vertex (the parity
workloads) that is ≤1e-6 relative; for a query next to a stored vertex the
distance itself approaches zero so the *relative* error can reach ~1e-2 —
but the absolute error stays ~1e-3 while competing candidates sit orders
of magnitude away, so nearest-base ranking (the engine's only use) is
unaffected, and the engine recomputes the delta exactly in float64 against
whichever base wins.
* Adjacency lists are int64 numpy arrays so the visited filter and the
  shrink step stay in numpy.

The traversal order and neighbor-selection logic are unchanged from the
seed, so on fixed-seed workloads the rebuilt index returns the same
neighbor ids (distances agree to fp rounding; see
``tests/test_hotpath.py``).

Lifecycle support (model delete/replace → vertex GC):

* **Tombstones** — :meth:`HNSWIndex.mark_deleted` excludes a vertex from
  search *results* while keeping it as a graph waypoint (hnswlib's
  deleted-markers): layer search still traverses dead vertices, it just
  never admits them to the result heap. With no deletions the filtered
  loop is behaviorally identical to the seed loop (the ``len(best) >= ef``
  stop condition cannot bind earlier than the seed's non-empty check while
  nothing is filtered), preserving oracle parity.
* **Compaction** — :meth:`HNSWIndex.compact` drops dead vertices from the
  vertex arrays and adjacency, first reconnecting each dead vertex's live
  neighbors to each other (bounded edge contraction, shrink-by-distance)
  so the graph stays navigable, and returns the old→new vertex-id remap
  the engine applies to surviving page records. Vertex codes are copied
  verbatim, so ``dequantize_vertex`` output for every surviving vertex is
  bit-identical across compaction.
"""

from __future__ import annotations

import heapq
import math
import pickle

import numpy as np
import torch

from .quantize import QuantMeta, quantize_linear, quantize_linear_batch
from ..kernels import ops
from ..obs.metrics import default_registry

__all__ = ["CodeMirror", "HNSWIndex", "mirror_uploads", "quantized_l2_batch"]

# Process-wide HNSW counters (docs/observability.md), summed over every
# index in the process. Increments are batched (one .inc(n) per distance
# call / per search) so the hot loops pay one counter bump, not one per
# vertex.
_REG = default_registry()
_M_DIST_EVALS = _REG.counter(
    "neurstore_hnsw_distance_evals_total",
    "Vertex distance evaluations (rows of decomposed quantized-L2).",
)
_M_VISITED = _REG.counter(
    "neurstore_hnsw_visited_total",
    "Vertices visited during layer searches.",
)
_M_SEARCHES = _REG.counter(
    "neurstore_hnsw_searches_total", "Graph k-NN searches."
)
_M_INSERTS = _REG.counter(
    "neurstore_hnsw_inserts_total", "Vertices inserted."
)

_EMPTY_IDS = np.empty(0, dtype=np.int64)

#: Code bytes uploaded by every :class:`CodeMirror` of the process: rows
#: that entered an index (``"rows"``) and whole indexes read from bytes
#: (``"index"``).
mirror_uploads = {"rows": 0, "index": 0}


class CodeMirror:
    """Device copy of the vertex payload that the distance kernel reads.

    ``codes`` (cap, dim) uint8 and ``scales``, ``zps``, ``mids`` (cap,)
    float64, row for row the index's host arrays, on ``device`` (any torch
    device). Rows are uploaded once: :meth:`write` when they enter the
    index, :meth:`load` when a whole index is read from bytes; growth and
    compaction move rows on the device. The code bytes of each kind of
    upload are counted in :data:`mirror_uploads`.
    """

    FIELDS = ("codes", "scales", "zps", "mids")

    def __init__(self, dim: int, device):
        self.device = torch.device(device)
        self.codes = torch.empty((0, dim), dtype=torch.uint8, device=self.device)
        self.scales, self.zps, self.mids = (
            torch.empty((0,), dtype=torch.float64, device=self.device) for _ in range(3))

    def grow(self, cap: int, n: int) -> None:
        """Capacity ``cap`` rows, keeping rows [0, n) (copied on the device)."""
        for name in self.FIELDS:
            old = getattr(self, name)
            new = torch.empty((cap, *old.shape[1:]), dtype=old.dtype, device=self.device)
            new[:n] = old[:n]
            setattr(self, name, new)

    def _upload(self, start: int, codes, scales, zps, mids, kind: str) -> None:
        rows = [np.asarray(v, dtype=np.float64).reshape(-1) for v in (scales, zps, mids)]
        stop = start + rows[0].size
        codes = np.asarray(codes, dtype=np.uint8).reshape(rows[0].size, self.codes.shape[1])
        self.codes[start:stop] = torch.from_numpy(codes)
        for name, row in zip(self.FIELDS[1:], rows):
            getattr(self, name)[start:stop] = torch.from_numpy(row)
        mirror_uploads[kind] += codes.nbytes

    def write(self, start: int, codes, scales, zps, mids) -> None:
        """Rows entering the index at ``start`` (uploaded here, once)."""
        self._upload(start, codes, scales, zps, mids, "rows")

    def load(self, codes, scales, zps, mids) -> None:
        """A whole index read from bytes, at rows [0, len(codes))."""
        self._upload(0, codes, scales, zps, mids, "index")

    def gather(self, keep: np.ndarray) -> None:
        """Keep rows ``keep`` in that order (compaction), on the device."""
        idx = torch.from_numpy(np.asarray(keep, dtype=np.int64)).to(self.device)
        for name in self.FIELDS:
            setattr(self, name, getattr(self, name).index_select(0, idx))

    def view(self, n: int) -> tuple[torch.Tensor, ...]:
        """(codes, scales, zps, mids) of rows [0, n), contiguous views."""
        return tuple(getattr(self, name)[:n] for name in self.FIELDS)


def _offload_distances(queries, codes, scales, zps, mids, device):
    """One (B, D)-vs-(N, D) distance block through the CUDA kernel on
    ``device``: host queries against the index's device-resident codes and
    quantization rows (tensors); returns the (B, N) float64 distances. Kept
    as a module-level hook so tests can stub it to verify the seam is used."""
    return ops.quantized_l2_auto(queries, codes, scales, zps, mids,
                                 device=device)


def _code_norms(codes, scales, zero_points, mids, dim: int) -> np.ndarray:
    """Cached ``‖deq‖²`` per row: ``s²·(Σc² − 2·z·Σc + D·z²)``, or
    ``D·mid²`` for constant rows — computed from exact integer code sums
    (uint8 codes: both sums fit int64 for any realistic D)."""
    c64 = np.atleast_2d(codes).astype(np.int64, copy=False)
    csum = c64.sum(axis=1)
    csq = np.einsum("nd,nd->n", c64, c64)
    s = np.atleast_1d(np.asarray(scales, dtype=np.float64))
    z = np.atleast_1d(np.asarray(zero_points, dtype=np.float64))
    norms = s * s * (csq - 2.0 * z * csum + dim * z * z)
    const = s == 0.0
    if const.any():
        m = np.atleast_1d(np.asarray(mids, dtype=np.float64))
        norms = np.where(const, dim * m * m, norms)
    return norms


def quantized_l2_batch(
    query: np.ndarray,
    codes: np.ndarray,
    scales: np.ndarray,
    zero_points: np.ndarray,
    mids: np.ndarray,
) -> np.ndarray:
    """Squared L2 between one f32 query (D,) and N quantized rows (N, D).

    Row i de-quantizes as ``(codes[i] - zp[i]) * scale[i]`` (or the constant
    ``mids[i]`` when ``scale[i] == 0``). Computed in the decomposed form
    documented in the module docstring; the dense dequantize-and-square
    version is ``repro_torch.kernels.ref.quantized_l2``, and the CUDA
    kernel ``csrc/quantized_l2.cu`` computes this decomposition on the card.
    """
    q = np.asarray(query, dtype=np.float64).ravel()
    qsq = float(np.dot(q, q))
    qsum = float(q.sum())
    dim = q.size
    s = np.asarray(scales, dtype=np.float64)
    z = np.asarray(zero_points, dtype=np.float64)
    norms = _code_norms(codes, s, z, mids, dim)
    dot = codes.astype(np.float64) @ q
    dist = (qsq - 2.0 * (s * dot - s * z * qsum)) + norms
    const = s == 0.0
    if const.any():
        m = np.asarray(mids, dtype=np.float64)[const]
        dist[const] = (qsq - 2.0 * m * qsum) + norms[const]
    return np.maximum(dist, 0.0, out=dist)


class HNSWIndex:
    """Hierarchical navigable small world graph over quantized base tensors."""

    def __init__(self, dim: int, m: int = 16, ef_construction: int = 64,
                 seed: int = 0, device="cuda"):
        self.dim = dim
        self.device = ops.resolve_device(device)
        self.m = m
        self.m0 = 2 * m
        self.ef_construction = ef_construction
        self.ml = 1.0 / math.log(m)
        self._rng = np.random.default_rng(seed)
        # On a CUDA index the kernel reads the payload from this mirror.
        self.mirror = CodeMirror(dim, self.device) if self.device.type == "cuda" else None
        # Vertex payloads in capacity-doubling arrays; rows [0, _n) are live.
        self._n = 0
        self._cap = 0
        self._codes = np.empty((0, dim), dtype=np.uint8)
        self._scales = np.empty((0,), dtype=np.float64)
        self._zps = np.empty((0,), dtype=np.int32)
        self._mids = np.empty((0,), dtype=np.float64)
        # Cached ‖deq_i‖² and cross_i per vertex (see module docstring).
        self._norms = np.empty((0,), dtype=np.float64)
        self._cross = np.empty((0,), dtype=np.float64)
        # Visited-epoch array reused across layer searches (no per-call
        # O(N) zeroing); a vertex is visited iff _vepoch[v] == _epoch.
        self._vepoch = np.zeros((0,), dtype=np.int64)
        self._epoch = 0
        # Tombstones: dead vertices stay as graph waypoints but are
        # excluded from search results until compact() drops them.
        self._deleted = np.zeros((0,), dtype=bool)
        self._levels: list[int] = []
        # neighbors[layer][node] -> int64 ndarray of neighbor ids
        self._neighbors: list[dict[int, np.ndarray]] = []
        self._entry: int | None = None
        self._max_level = -1

    # ------------------------------------------------------------------ size
    def __len__(self) -> int:
        return self._n

    @property
    def nbytes(self) -> int:
        """Approximate resident size: allocated vertex arrays + graph edges."""
        edge_bytes = sum(
            8 * sum(v.size for v in layer.values()) for layer in self._neighbors
        )
        return (
            self._codes.nbytes
            + self._scales.nbytes
            + self._zps.nbytes
            + self._mids.nbytes
            + self._norms.nbytes
            + self._cross.nbytes
            + self._deleted.nbytes
            + edge_bytes
        )

    def _grow(self, needed: int) -> None:
        """Double capacity until ``needed`` rows fit (O(1) amortized insert)."""
        if needed <= self._cap:
            return
        cap = max(self._cap, 8)
        while cap < needed:
            cap *= 2
        for name in ("_codes", "_scales", "_zps", "_mids", "_norms", "_cross",
                     "_vepoch", "_deleted"):
            old = getattr(self, name)
            shape = (cap, self.dim) if old.ndim == 2 else (cap,)
            # _vepoch must be zero-filled (epoch stamps start at 1) and
            # _deleted false-filled (new rows are live).
            alloc = np.zeros if name in ("_vepoch", "_deleted") else np.empty
            new = alloc(shape, dtype=old.dtype)
            new[: self._n] = old[: self._n]
            setattr(self, name, new)
        if self.mirror is not None:
            self.mirror.grow(cap, self._n)
        self._cap = cap

    # ------------------------------------------------------------ vertex I/O
    def vertex_codes(self, vid: int) -> tuple[np.ndarray, QuantMeta]:
        meta = QuantMeta(
            scale=float(self._scales[vid]),
            zero_point=int(self._zps[vid]),
            nbit=8,
            mid=float(self._mids[vid]),
        )
        return self._codes[vid], meta

    def dequantize_vertex(self, vid: int) -> np.ndarray:
        codes, meta = self.vertex_codes(vid)
        if meta.scale == 0.0:
            return np.full(self.dim, meta.mid, dtype=np.float64)
        return (codes.astype(np.float64) - meta.zero_point) * meta.scale

    # ------------------------------------------------------------- tombstones
    def mark_deleted(self, vid: int) -> None:
        """Tombstone a vertex: excluded from search results, kept as waypoint."""
        if not 0 <= vid < self._n:
            raise IndexError(f"vertex {vid} out of range [0, {self._n})")
        self._deleted[vid] = True

    def is_deleted(self, vid: int) -> bool:
        return bool(self._deleted[vid])

    @property
    def dead_count(self) -> int:
        return int(self._deleted[: self._n].sum())

    @property
    def live_count(self) -> int:
        return self._n - self.dead_count

    def dead_fraction(self) -> float:
        return self.dead_count / self._n if self._n else 0.0

    # ------------------------------------------------------------- distances
    def _distances(
        self, q32: np.ndarray, qsq: float, qsum: float, ids: np.ndarray
    ) -> np.ndarray:
        """Decomposed quantized L2 over a candidate batch (see module doc).

        ``q32`` is the float32 query; ``qsq``/``qsum`` are its float64
        squared norm and element sum.
        """
        idx = np.asarray(ids, dtype=np.int64)
        _M_DIST_EVALS.inc(idx.size)
        dot = self._codes[idx].astype(np.float32) @ q32
        s = self._scales[idx]
        dist = (qsq + self._norms[idx]) + 2.0 * (qsum * self._cross[idx] - s * dot)
        return np.maximum(dist, 0.0, out=dist)

    def _distance_block(self, queries: np.ndarray, n: int) -> np.ndarray:
        """(B, n) float64 distance matrix: query rows vs the first ``n`` codes.

        On a CUDA index every block goes through the ``quantized_l2``
        kernel via :func:`_offload_distances`, whatever its size, on the
        device mirror's first ``n`` rows (no code bytes are copied). On the
        CPU it is the decomposed form as one float32 gemm plus O(B·n)
        float64 combine against the cached per-vertex norms.
        """
        q2 = np.atleast_2d(np.asarray(queries, dtype=np.float64))
        if n == 0:
            return np.zeros((q2.shape[0], 0), dtype=np.float64)
        _M_DIST_EVALS.inc(q2.shape[0] * n)
        if self.device.type == "cuda":
            out = _offload_distances(q2, *self.mirror.view(n), self.device)
            return np.maximum(out, 0.0, out=out)
        qsq = np.einsum("bd,bd->b", q2, q2)
        qsum = q2.sum(axis=1)
        dot = q2.astype(np.float32) @ self._codes[:n].astype(np.float32).T
        s = self._scales[:n]
        dist = (qsq[:, None] + self._norms[None, :n]) + 2.0 * (
            qsum[:, None] * self._cross[None, :n] - s[None, :] * dot
        )
        return np.maximum(dist, 0.0, out=dist)

    def batch_distances(self, query: np.ndarray) -> np.ndarray:
        """Distances from one or many queries to every vertex — the hot loop.

        A 1-D ``query`` returns the (N,) distances exactly as before; a
        (B, D) block returns the (B, N) matrix computed as one gemm through
        the kernel dispatch seam (see :meth:`_distance_block`). This matrix
        is what :meth:`insert_batch` reuses for candidate-vs-resident
        lookups during batched ingestion.
        """
        q = np.asarray(query, dtype=np.float64)
        if q.ndim <= 1:
            return self._distance_block(q.ravel(), self._n)[0]
        return self._distance_block(q, self._n)

    def nearest_live_batch(
        self, queries: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray]:
        """Exact nearest *live* vertex per query row (brute-force scan).

        Returns ``(vids, dists)``; ``vid == -1`` where the index holds no
        live vertex. The batched save path uses this instead of per-tensor
        graph walks: one (B, N) distance block through the dispatch seam
        replaces B independent HNSW descents (tombstoned vertices are
        masked, matching ``search``'s ``exclude_deleted`` contract).
        """
        q2 = np.atleast_2d(np.asarray(queries, dtype=np.float64))
        b = q2.shape[0]
        n = self._n
        if n == 0 or self.live_count == 0:
            return (
                np.full(b, -1, dtype=np.int64),
                np.full(b, np.inf, dtype=np.float64),
            )
        dist = self._distance_block(q2, n)
        dead = self._deleted[:n]
        if dead.any():
            dist = np.where(dead[None, :], np.inf, dist)
        vids = np.argmin(dist, axis=1).astype(np.int64)
        return vids, dist[np.arange(b), vids]

    # ---------------------------------------------------------------- search
    def _search_layer(
        self,
        q32: np.ndarray,
        qsq: float,
        qsum: float,
        entry: list[int],
        ef: int,
        layer: int,
        exclude_deleted: bool = False,
        drow: np.ndarray | None = None,
    ) -> list[tuple[float, int]]:
        """Best-first search on one layer; returns ef closest (dist, id).

        With ``exclude_deleted`` tombstoned vertices are traversed as
        waypoints but never admitted to the result heap (hnswlib's
        deleted-marker search). With the flag off — and whenever nothing
        is filtered — the loop is behaviorally identical to the seed
        implementation: until ``best`` holds ``ef`` elements it contains
        every accepted candidate, so no remaining candidate can exceed its
        maximum and the stop test cannot fire earlier than the seed's
        ``best and d > -best[0][0]``.

        ``drow`` is a precomputed distance row indexed by vertex id (the
        batched-ingest matrix): when given, every candidate distance is a
        lookup instead of a gemv and ``q32``/``qsq``/``qsum`` are unused.
        """
        self._epoch += 1
        epoch = self._epoch
        visited = self._vepoch
        dead = self._deleted
        entry_ids = np.asarray(entry, dtype=np.int64)
        visited[entry_ids] = epoch
        n_visited = entry_ids.size
        dists = (
            drow[entry_ids] if drow is not None
            else self._distances(q32, qsq, qsum, entry_ids)
        )
        cand: list[tuple[float, int]] = [(d, v) for d, v in zip(dists, entry)]
        heapq.heapify(cand)
        best: list[tuple[float, int]] = [
            (-d, v) for d, v in zip(dists, entry)
            if not (exclude_deleted and dead[v])
        ]
        heapq.heapify(best)
        while len(best) > ef:
            heapq.heappop(best)
        adj = self._neighbors[layer]
        while cand:
            d, v = heapq.heappop(cand)
            if len(best) >= ef and d > -best[0][0]:
                break
            nbrs = adj.get(v)
            if nbrs is None or nbrs.size == 0:
                continue
            fresh = nbrs[visited[nbrs] != epoch]
            if fresh.size == 0:
                continue
            visited[fresh] = epoch
            n_visited += fresh.size
            if drow is not None:
                # Batched-ingest fast path: lookup + vectorized bound filter.
                # The filter uses the bound at expansion start, so it admits
                # a superset of the sequential loop's pushes — the final
                # ``best`` (ef smallest of everything pushed) is identical;
                # only the exploration frontier can be marginally larger.
                fd = drow[fresh]
                if len(best) >= ef:
                    keep = fd < -best[0][0]
                    if not keep.all():
                        fresh = fresh[keep]
                        fd = fd[keep]
                for du, u in zip(fd.tolist(), fresh.tolist()):
                    heapq.heappush(cand, (du, u))
                    if not (exclude_deleted and dead[u]):
                        heapq.heappush(best, (-du, u))
                while len(best) > ef:
                    heapq.heappop(best)
                continue
            fd = self._distances(q32, qsq, qsum, fresh)
            bound = -best[0][0] if best else math.inf
            for du, u in zip(fd, fresh):
                if len(best) < ef or du < bound:
                    heapq.heappush(cand, (du, u))
                    if not (exclude_deleted and dead[u]):
                        heapq.heappush(best, (-du, u))
                        if len(best) > ef:
                            heapq.heappop(best)
                        bound = -best[0][0]
        _M_VISITED.inc(n_visited)
        return sorted((-nd, int(v)) for nd, v in best)

    def search(
        self,
        query: np.ndarray,
        k: int = 1,
        ef: int | None = None,
        exclude_deleted: bool = True,
    ) -> list[tuple[float, int]]:
        """Approximate k-NN of a float query; returns [(sq_dist, vertex_id)].

        Tombstoned vertices are excluded from the results (but still guide
        the descent); pass ``exclude_deleted=False`` to search the raw
        graph. Returns ``[]`` when every reachable vertex is dead.
        """
        _M_SEARCHES.inc()
        if self._entry is None:
            return []
        ef = max(ef or self.ef_construction, k)
        q = np.asarray(query, dtype=np.float64).ravel()
        q32 = q.astype(np.float32)
        qsq = float(np.dot(q, q))
        qsum = float(q.sum())
        entry = [self._entry]
        for layer in range(self._max_level, 0, -1):
            # Upper-layer descent keeps dead vertices: they are waypoints.
            entry = [self._search_layer(q32, qsq, qsum, entry, 1, layer)[0][1]]
        return self._search_layer(
            q32, qsq, qsum, entry, ef, 0, exclude_deleted=exclude_deleted
        )[:k]

    # ---------------------------------------------------------------- insert
    def _select_neighbors(self, cands: list[tuple[float, int]], m: int) -> list[int]:
        return [v for _, v in sorted(cands)[:m]]

    def insert(self, tensor: np.ndarray) -> int:
        """Quantize ``tensor`` to 8 bits and insert as a new vertex.

        Returns the vertex id. The stored representation is the quantized
        code; callers needing the de-quantized base use
        :meth:`dequantize_vertex`.
        """
        q = np.asarray(tensor, dtype=np.float64).ravel()
        assert q.size == self.dim, (q.size, self.dim)
        codes, meta = quantize_linear(q, nbit=8)
        vid = self._n
        self._grow(vid + 1)
        self._codes[vid] = codes
        self._scales[vid] = meta.scale
        self._zps[vid] = meta.zero_point
        self._mids[vid] = meta.mid
        self._norms[vid] = _code_norms(
            codes, meta.scale, meta.zero_point, meta.mid, self.dim
        )[0]
        self._cross[vid] = (
            -meta.mid if meta.scale == 0.0 else meta.scale * meta.zero_point
        )
        if self.mirror is not None:
            self.mirror.write(vid, codes, meta.scale, meta.zero_point, meta.mid)
        self._n = vid + 1
        _M_INSERTS.inc()
        level = self._draw_level()
        self._register_level(vid, level)

        if self._entry is None:
            self._entry = vid
            self._max_level = level
            return vid
        self._link(vid, level, q)
        return vid

    def _draw_level(self) -> int:
        return int(-math.log(max(self._rng.random(), 1e-12)) * self.ml)

    def _register_level(self, vid: int, level: int) -> None:
        self._levels.append(level)
        while len(self._neighbors) <= level:
            self._neighbors.append({})
        for layer in range(level + 1):
            self._neighbors[layer].setdefault(vid, _EMPTY_IDS)

    def _shrink_query(self, u: int, shared: dict | None):
        """(q32, qsq, qsum) for vertex ``u``'s dequantized base, cached per
        batch: many batch members backlink into the same hub vertices, so
        the O(D) dequantize is paid once per hub per ``insert_batch``."""
        if shared is not None:
            hit = shared["deq"].get(u)
            if hit is not None:
                return hit
        base_u = self.dequantize_vertex(u)
        stats = (
            base_u.astype(np.float32),
            float(np.dot(base_u, base_u)),
            float(base_u.sum()),
        )
        if shared is not None:
            shared["deq"][u] = stats
        return stats

    @staticmethod
    def _append_id(cur: np.ndarray, vid: int) -> np.ndarray:
        lst = np.empty(cur.size + 1, dtype=np.int64)
        lst[:-1] = cur
        lst[-1] = vid
        return lst

    def _backlink_batch(
        self, layer: int, vid: int, nbrs, adj: dict, m: int, shared: dict
    ) -> None:
        """Backlink ``vid`` into its selected neighbors — batched shrink.

        Once a vertex has been shrunk its list sits exactly at the degree
        cap, so every later backlink appends one id; the cached post-shrink
        distances (``shared['nbr']``) are extended with a single new pair
        distance instead of recomputing the whole deq(u)-vs-list row — and
        those pair distances are computed for ALL cache-hit neighbors of
        this link in one (k, D) gemv against ``vid``'s codes. This was the
        dominant cost of naive batched linking (every backlink paid a full
        gather + gemv, ~half the insert_batch wall time).
        """
        nbr_cache = shared["nbr"]
        deq = shared["deq"]
        hits: list[tuple[int, np.ndarray, np.ndarray]] = []
        for u in nbrs:
            cur = adj.get(u, _EMPTY_IDS)
            if cur.size < m:  # under cap: plain append, no shrink
                adj[u] = self._append_id(cur, vid)
                continue
            hit = nbr_cache.get((layer, u))
            if hit is not None and hit[0] is cur:
                hits.append((u, cur, hit[1]))
                continue
            # First shrink of u this batch: full row, seeds both caches.
            lst = self._append_id(cur, vid)
            u32, usq, usum = self._shrink_query(u, shared)
            du = self._distances(u32, usq, usum, lst)
            order = np.argsort(du)[:m]
            lst = lst[order]
            nbr_cache[(layer, u)] = (lst, du[order])
            adj[u] = lst
        if not hits:
            return
        cv = self._codes[vid].astype(np.float32)
        u32s = np.stack([deq[u][0] for u, _, _ in hits])
        dots = u32s @ cv  # (k,) — one gemv for every cache-hit shrink
        nv = float(self._norms[vid])
        crv = float(self._cross[vid])
        sv = float(self._scales[vid])
        for (u, cur, cached), dot in zip(hits, dots.tolist()):
            _u32, usq, usum = deq[u]
            d = (usq + nv) + 2.0 * (usum * crv - sv * dot)
            du = np.empty(cached.size + 1)
            du[:-1] = cached
            du[-1] = d if d > 0.0 else 0.0
            lst = self._append_id(cur, vid)
            order = np.argsort(du)[:m]
            lst = lst[order]
            nbr_cache[(layer, u)] = (lst, du[order])
            adj[u] = lst

    def _link(
        self,
        vid: int,
        level: int,
        q: np.ndarray,
        drow: np.ndarray | None = None,
        shared: dict | None = None,
    ) -> None:
        """Wire ``vid`` into the graph (the second half of ``insert``).

        Sequential path (``shared is None``): per-item greedy descent from
        the global entry through the upper layers — behaviorally identical
        to the seed insert. Batched path: the upper-layer descent is shared
        across the batch (:meth:`_batch_chain`) and every candidate
        distance is a lookup into ``drow``, the batch-wide matrix from
        :meth:`_distance_block`.
        """
        q32 = q.astype(np.float32)
        qsq = float(np.dot(q, q))
        qsum = float(q.sum())
        if shared is None:
            entry = [self._entry]
            for layer in range(self._max_level, level, -1):
                entry = [
                    self._search_layer(q32, qsq, qsum, entry, 1, layer,
                                       drow=drow)[0][1]
                ]
        else:
            entry = [self._batch_chain(shared)[min(level, self._max_level)]]
        for layer in range(min(level, self._max_level), -1, -1):
            cands = self._search_layer(
                q32, qsq, qsum, entry, self.ef_construction, layer, drow=drow
            )
            m = self.m0 if layer == 0 else self.m
            nbrs = self._select_neighbors(cands, m)
            adj = self._neighbors[layer]
            adj[vid] = np.asarray(nbrs, dtype=np.int64)
            if shared is not None:
                self._backlink_batch(layer, vid, nbrs, adj, m, shared)
            else:
                for u in nbrs:
                    lst = np.append(adj.get(u, _EMPTY_IDS), vid)
                    if lst.size > m:
                        # Shrink: keep the m closest to u.
                        u32, usq, usum = self._shrink_query(u, None)
                        du = self._distances(u32, usq, usum, lst)
                        lst = lst[np.argsort(du)[:m]]
                    adj[u] = lst
            entry = [v for _, v in cands]
        if level > self._max_level:
            self._max_level = level
            self._entry = vid

    def _batch_chain(self, shared: dict) -> dict[int, int]:
        """Per-layer entry points from ONE shared descent over the batch
        centroid. ``chain[L]`` is the vertex a layer-``L`` search starts
        from: the greedy nearest to the centroid on layer ``L+1`` (the
        global entry at the top) — the batched stand-in for the per-item
        upper-layer descent. Recomputed only when the graph's entry point
        or max level moves mid-batch (a batch member drew a higher level).
        """
        key = (self._entry, self._max_level)
        if shared.get("key") != key:
            c32, csq, csum = shared["centroid"]
            chain = {self._max_level: self._entry}
            e = [self._entry]
            for layer in range(self._max_level, 0, -1):
                e = [self._search_layer(c32, csq, csum, e, 1, layer)[0][1]]
                chain[layer - 1] = e[0]
            shared["chain"] = chain
            shared["key"] = key
        return shared["chain"]

    def insert_batch(
        self,
        tensors,
        quantized: tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray] | None = None,
        max_matrix_elems: int = 1 << 24,
    ) -> list[int]:
        """Insert a batch of same-dim tensors; returns their vertex ids.

        The batched ingest path (ISSUE 3 tentpole):

        1. **one quantization sweep** — all candidates go through
           ``quantize_linear_batch`` (bit-exact with per-tensor
           ``quantize_linear``), or arrive pre-quantized via ``quantized``
           when the engine already swept the group;
        2. **bulk vertex append** — one ``_grow`` + vectorized norm/cross
           computation for the whole batch;
        3. **one shared entry-point descent** per batch at the upper layers
           (:meth:`_batch_chain`, recomputed only when the entry moves);
        4. **sequential layer-0 linking** that reuses a batch-wide
           ``batch_distances`` matrix of candidate-vs-resident codes: every
           per-candidate distance in the layer searches is an O(1) lookup
           into one (B, N) block computed through the kernel dispatch seam
           (CUDA ``quantized_l2`` on the card, decomposed numpy gemm on CPU).

        The graph that results is *not* edge-identical to sequential
        ``insert`` (the shared descent starts items from the centroid's
        entry chain), but recall parity is held within tolerance —
        ``tests/test_batch_ingest.py::test_insert_batch_recall_parity``.
        Level draws consume the RNG in the same per-item order as
        sequential inserts.

        ``max_matrix_elems`` bounds the resident distance matrix: batches
        are chunked so no (rows × cols) block exceeds it (~128 MB float64
        at the default), keeping memory flat for large ingests.
        """
        if isinstance(tensors, np.ndarray) and tensors.ndim == 2:
            q_all = np.asarray(tensors, dtype=np.float64)
        else:
            rows = [np.asarray(t, dtype=np.float64).ravel() for t in tensors]
            if not rows:
                return []
            q_all = np.stack(rows)
        b = q_all.shape[0]
        if b == 0:
            return []
        assert q_all.shape[1] == self.dim, (q_all.shape, self.dim)

        if quantized is None:
            codes, scales, zps, mids = quantize_linear_batch(q_all, nbit=8)
        else:
            codes, scales, zps, mids = quantized
        n0 = self._n
        _M_INSERTS.inc(b)
        self._grow(n0 + b)
        self._codes[n0:n0 + b] = codes
        self._scales[n0:n0 + b] = scales
        self._zps[n0:n0 + b] = zps
        self._mids[n0:n0 + b] = mids
        self._norms[n0:n0 + b] = _code_norms(codes, scales, zps, mids, self.dim)
        cross = scales * np.asarray(zps, dtype=np.float64)
        const = scales == 0.0
        if const.any():
            cross = np.where(const, -np.asarray(mids, dtype=np.float64), cross)
        self._cross[n0:n0 + b] = cross
        if self.mirror is not None:
            # Before the distance blocks below: their columns reach n0 + end.
            self.mirror.write(n0, codes, scales, zps, mids)
        self._n = n0 + b

        levels = [self._draw_level() for _ in range(b)]
        for i, level in enumerate(levels):
            self._register_level(n0 + i, level)

        centroid = q_all.mean(axis=0)
        shared = {
            "deq": {},
            "nbr": {},
            "centroid": (
                centroid.astype(np.float32),
                float(np.dot(centroid, centroid)),
                float(centroid.sum()),
            ),
        }
        # Chunked batch-wide distance matrix: chunk rows are sized so the
        # (rows, n0 + chunk_end) block stays under max_matrix_elems. During
        # item i's linking every candidate id is < n0 + i (links to a batch
        # member only exist once it has been linked), so a chunk's columns
        # only need to reach its own end.
        start = 0
        while start < b:
            # Chunk rows sized against the chunk's OWN column count
            # (n0 + start + rows): rows² + (n0+start)·rows ≤ budget.
            base_cols = n0 + start
            rows_per_chunk = int(
                (math.sqrt(base_cols * base_cols + 4.0 * max_matrix_elems)
                 - base_cols) / 2.0
            )
            end = min(b, start + max(1, rows_per_chunk))
            ncols = n0 + end
            dmat = self._distance_block(q_all[start:end], ncols)
            for i in range(start, end):
                vid = n0 + i
                if self._entry is None:
                    self._entry = vid
                    self._max_level = levels[i]
                    continue
                self._link(vid, levels[i], q_all[i],
                           drow=dmat[i - start], shared=shared)
            start = end
        return list(range(n0, n0 + b))

    # ------------------------------------------------------------ compaction
    def clone(self) -> "HNSWIndex":
        """Deep copy for copy-on-write compaction.

        Vacuum compacts the clone and installs it as the resident index;
        the original object — shared with snapshot readers that captured
        it at load time — is never restructured, so their
        :meth:`vertex_codes` reads stay valid without any lock. (Like
        eviction+reload, the clone restarts the level RNG; graph shape
        after later inserts may differ, data never does.)
        """
        return HNSWIndex.from_bytes(self.to_bytes(), device=self.device)

    def compact(self) -> dict[int, int]:
        """Drop tombstoned vertices; returns the old→new vertex-id remap.

        Before any vertex is removed, the live neighbors of each dead
        vertex are cross-linked (edge contraction, shrunk back to the
        layer's degree cap by distance-to-endpoint) so that deleting a
        waypoint does not disconnect the survivors. Vertex codes and
        quantization metadata rows are copied verbatim, so
        :meth:`dequantize_vertex` output for every surviving vertex is
        bit-identical across compaction — the engine relies on this for
        its vacuum parity bar.
        """
        n = self._n
        dead = self._deleted[:n]
        live_old = np.flatnonzero(~dead)
        remap = {int(o): i for i, o in enumerate(live_old.tolist())}
        if live_old.size == n:
            return remap  # no tombstones — identity remap, nothing rebuilt

        # 1) Edge contraction: connected components of dead vertices are
        #    collapsed at once, so live regions bridged only by a *chain*
        #    of dead waypoints stay connected (single-hop contraction
        #    would strand them). Each component's full live boundary is
        #    cross-linked, shrunk back to the degree cap by distance.
        for layer, adj in enumerate(self._neighbors):
            cap = self.m0 if layer == 0 else self.m
            parent: dict[int, int] = {}

            def _find(x: int) -> int:
                while parent[x] != x:
                    parent[x] = parent[parent[x]]
                    x = parent[x]
                return x

            boundary: dict[int, set[int]] = {}
            for v, nbrs in adj.items():
                if not dead[v]:
                    continue
                parent.setdefault(v, v)
                if not nbrs.size:
                    continue
                for u in nbrs[dead[nbrs]].tolist():
                    parent.setdefault(u, u)
                    ru, rv = _find(u), _find(v)
                    if ru != rv:
                        parent[ru] = rv
            for v, nbrs in adj.items():
                if not dead[v] or not nbrs.size:
                    continue
                live = nbrs[~dead[nbrs]]
                if live.size:
                    boundary.setdefault(_find(v), set()).update(live.tolist())
            for live_set in boundary.values():
                if len(live_set) < 2:
                    continue
                live_arr = np.fromiter(live_set, dtype=np.int64)
                for u in live_set:
                    extra = live_arr[live_arr != u]
                    cur = adj.get(u, _EMPTY_IDS)
                    if cur.size:
                        cur = cur[~dead[cur]]
                    merged = np.unique(np.concatenate([cur, extra]))
                    merged = merged[merged != u]
                    if merged.size > cap:
                        base_u = self.dequantize_vertex(u)
                        du = self._distances(
                            base_u.astype(np.float32),
                            float(np.dot(base_u, base_u)),
                            float(base_u.sum()),
                            merged,
                        )
                        merged = merged[np.argsort(du)[:cap]]
                    adj[u] = merged.astype(np.int64)

        # 2) Rebuild vertex arrays: copy surviving rows (codes verbatim).
        nlive = int(live_old.size)
        self._codes = self._codes[live_old]
        self._scales = self._scales[live_old]
        self._zps = self._zps[live_old]
        self._mids = self._mids[live_old]
        self._norms = self._norms[live_old]
        self._cross = self._cross[live_old]
        if self.mirror is not None:
            self.mirror.gather(live_old)
        self._vepoch = np.zeros(nlive, dtype=np.int64)
        self._epoch = 0
        self._deleted = np.zeros(nlive, dtype=bool)
        self._levels = [self._levels[int(o)] for o in live_old]
        self._n = nlive
        self._cap = nlive

        # 3) Rebuild adjacency in the new id space, dropping dead vertices.
        lut = np.full(n, -1, dtype=np.int64)
        lut[live_old] = np.arange(nlive, dtype=np.int64)
        new_layers: list[dict[int, np.ndarray]] = []
        for adj in self._neighbors:
            nl: dict[int, np.ndarray] = {}
            for v, nbrs in adj.items():
                if dead[v]:
                    continue
                if nbrs.size:
                    mapped = lut[nbrs[~dead[nbrs]]].astype(np.int64)
                else:
                    mapped = _EMPTY_IDS
                nl[int(lut[v])] = mapped
            new_layers.append(nl)
        while new_layers and not new_layers[-1]:
            new_layers.pop()
        self._neighbors = new_layers

        # 4) New entry point: lowest-id survivor on the highest level.
        if nlive == 0:
            self._entry = None
            self._max_level = -1
            self._neighbors = []
        else:
            self._max_level = max(self._levels)
            self._entry = self._levels.index(self._max_level)
        return remap

    # ------------------------------------------------------------- serialize
    def to_bytes(self) -> bytes:
        n = self._n
        state = {
            "dim": self.dim,
            "m": self.m,
            "ef_construction": self.ef_construction,
            "codes": self._codes[:n].copy(),
            "scales": self._scales[:n].copy(),
            "zps": self._zps[:n].copy(),
            "mids": self._mids[:n].copy(),
            "norms": self._norms[:n].copy(),
            "deleted": self._deleted[:n].copy(),
            "levels": self._levels,
            "neighbors": [
                {int(k): v.tolist() for k, v in layer.items()}
                for layer in self._neighbors
            ],
            "entry": self._entry,
            "max_level": self._max_level,
        }
        return pickle.dumps(state, protocol=pickle.HIGHEST_PROTOCOL)

    @classmethod
    def from_bytes(cls, data: bytes, device="cuda") -> "HNSWIndex":
        state = pickle.loads(data)
        idx = cls(state["dim"], state["m"], state["ef_construction"],
                  device=device)
        n = len(state["levels"])
        idx._grow(n)
        idx._codes[:n] = state["codes"]
        idx._scales[:n] = state["scales"]
        idx._zps[:n] = state["zps"]
        idx._mids[:n] = state["mids"]
        if idx.mirror is not None:
            idx.mirror.load(idx._codes[:n], idx._scales[:n], idx._zps[:n], idx._mids[:n])
        idx._n = n
        norms = state.get("norms")
        if norms is not None:
            idx._norms[:n] = norms
        elif n:
            # Seed-format pickle: rebuild the cached norms from the codes.
            idx._norms[:n] = _code_norms(
                state["codes"], idx._scales[:n], idx._zps[:n],
                idx._mids[:n], idx.dim,
            )
        deleted = state.get("deleted")
        if deleted is not None:
            # Pre-tombstone pickles carry no flags: every vertex is live.
            idx._deleted[:n] = deleted
        # cross_i is derived (never serialized): s·z, or −mid on const rows.
        s = idx._scales[:n]
        cross = s * idx._zps[:n].astype(np.float64)
        const = s == 0.0
        cross[const] = -idx._mids[:n][const]
        idx._cross[:n] = cross
        idx._levels = state["levels"]
        idx._neighbors = [
            {int(k): np.asarray(v, dtype=np.int64) for k, v in layer.items()}
            for layer in state["neighbors"]
        ]
        idx._entry = state["entry"]
        idx._max_level = state["max_level"]
        return idx
