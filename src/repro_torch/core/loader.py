"""Compression-aware model loading (paper §4.3 / Algorithm 2).

Three paper mechanisms, adapted from ONNX-graph surgery to PyTorch:

* **Augmented computation graph** — instead of inserting ``DequantizeLinear``
  + ``Add`` ONNX nodes, :meth:`LoadedModel.compressed_params` exposes each
  tensor as its quantized base + quantized delta with quant metadata, and
  :func:`reconstruct_torch` is the dequant+add subgraph on tensors.
  Downstream, ``repro_torch.kernels.dequant_matmul`` fuses that subgraph
  *into* the consuming matmul so the full-precision weight never
  materializes in device memory (the card's form of on-demand
  decompression).
* **Flexible loading** (§4.3.1) — ``bits=b`` reads only the top ``b``
  bit-planes of each delta payload from the page (true partial I/O) and
  widens the scale by ``2^(nbit-b)`` (Alg. 2 lines 6-8).
* **Share-counted de-quantization** (§4.3.2) — base tensors referenced by
  multiple records are de-quantized once per materialization pass; a
  per-pass countdown (reset when it drains, so repeated ``tensor()`` calls
  or a second ``materialize()`` never go negative) frees the de-quantized
  copy once every sharing record has consumed it.
* **Pipelining** (§4.3.3) — :class:`PipelineLoader` overlaps page I/O,
  de-quantization and consumption in a 3-stage thread pipeline.
  :meth:`LoadedModel.iter_tensors` can reconstruct several tensors at
  once, each on a thread of its own (numpy releases the GIL in the
  reconstruction's array operations), and hand them out in order; a
  checkpoint restore takes ``RECONSTRUCT_WORKERS`` of them.

Concurrency model (the snapshot-isolation PR; see ``docs/concurrency.md``):

Every handle is backed by a :class:`ModelSnapshot` — an epoch-stamped
immutable view (catalog entry, pinned buffer-pool page frame, per-dim
HNSW index references) captured under the engine lock at ``load_model``
time. After capture, **no read path takes the engine lock**: page bytes
are pinned and immutable, decoded payloads live in the frame's shared
cache, and base codes come from the snapshot's index objects, whose
existing rows are never restructured (vacuum compacts copy-on-write
clones; saves only append). A handle opened before a concurrent
``replace_model``/``delete_model``/``vacuum`` therefore keeps
materializing its weights bit-identically from the snapshot; a handle
opened after the writer's commit sees the new state.
"""

from __future__ import annotations

import os
import queue
import threading
import weakref
from collections import Counter, deque
from collections.abc import Mapping
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .integrity import CorruptPageError
from .pages import TensorPage, TensorRecord, decode_payload, read_record, read_record_partial
from .quantize import dequantize_delta, dequantize_linear

__all__ = [
    "CompressedParams", "KernelNotReady", "LoadedModel", "ModelSnapshot",
    "PipelineLoader", "materialize_many", "reconstruct_torch",
]


# The tensors a checkpoint restore reconstructs at once, a thread each
# (numpy's float64 dequantize, add and cast release the GIL). The server's
# download stream keeps one: it shares the host with the wire's encoding
# and its readers, and a reader's decoded payloads fill the buffer pool,
# whose fill the write admission reads.
RECONSTRUCT_WORKERS = min(4, os.cpu_count() or 1)


class KernelNotReady(RuntimeError):
    """A tensor's delta codes exceed the fused kernels' 8-bit operand width.

    Full-precision loads keep ~17-bit deltas; the int8/int4 compute-on-
    compressed kernels need ``nbit <= 8``. Reload the model with flexible
    loading (``load_model(name, bits=8)`` or ``bits=4``) for kernel-ready
    parameters (paper §4.3.1).
    """


def reconstruct_torch(base_codes, base_scale, base_zp, qdelta, delta_scale, delta_zp):
    """The augmented-graph subgraph: Dequant(base) + Dequant(delta) → Add.

    Float32 tensor ops on the codes' device; bin-centre delta dequant
    matches ``quantize.dequantize_delta``. Shapes: any; dtypes: integer
    code tensors.
    """
    base = (base_codes.to(torch.float32) - base_zp) * base_scale
    delta = (qdelta.to(torch.float32) - delta_zp + 0.5) * delta_scale
    return base + delta


class ModelSnapshot:
    """Epoch-stamped immutable view of one model, captured at load time.

    Holds everything a reader needs so that no later access touches shared
    mutable engine state: the committed catalog entry, the pinned page
    frame (``None`` for ``shared_cache=False`` loads, whose bytes are
    private), and strong references to the HNSW index objects for every
    dim the model's records use. Released explicitly via :meth:`close` or
    automatically when the handle is garbage collected (a ``weakref``
    finalizer enqueues the release; the engine drains the queue at its
    next operation boundary — never from inside GC, where lock state is
    unknowable).
    """

    __slots__ = ("epoch", "entry", "frame", "indexes", "_finalizer", "__weakref__")

    def __init__(self, epoch, entry, frame, indexes, release):
        self.epoch = epoch
        self.entry = entry
        self.frame = frame
        self.indexes = indexes
        # release() must not reference self (it would keep the snapshot
        # alive); it enqueues (token, frame) on the engine's release queue.
        self._finalizer = weakref.finalize(self, release)

    def close(self) -> None:
        """Release the snapshot's pins (idempotent)."""
        self._finalizer()


class LoadedModel:
    """Handle over one stored model, loaded without full decompression."""

    def __init__(self, engine, page: TensorPage, info: dict,
                 bits: int | None = None,
                 snapshot: ModelSnapshot | None = None):
        self.engine = engine
        self.page = page
        self.info = info
        self.bits = bits
        self.snapshot = snapshot
        self._records: dict[str, TensorRecord] = {}
        self._order: list[str] = []
        self._index_of: dict[str, int] = {}
        # Records are read with packed payloads only (decode=False): the
        # vectorized planar bit-unpack runs lazily on first tensor access,
        # so open-time cost is header parsing + payload slicing and the
        # pipeline's dequant stage does the unpack work (paper §4.3.3).
        for i in range(page.n_records):
            rec = (
                read_record_partial(page, i, bits, decode=False)
                if bits is not None
                else read_record(page, i, decode=False)
            )
            self._records[rec.name] = rec
            self._index_of[rec.name] = i
            self._order.append(rec.name)
        # Share counts: how many records reference each base vertex. The
        # immutable counts stay in _share; _remaining is the per-pass
        # countdown that controls the cached de-quantized copy's lifetime.
        self._share = Counter((r.dim_key, r.vertex_id) for r in self._records.values())
        self._remaining: dict[tuple[int, int], int] = dict(self._share)
        self._deq_base: dict[tuple[int, int], np.ndarray] = {}
        # Guards the handle-local caches above when one handle is shared
        # across threads. Never held around O(dim) work.
        self._cache_lock = threading.Lock()

    # ------------------------------------------------------------- metadata
    @property
    def architecture(self) -> dict:
        return self.info["architecture"]  # ModelEntry supports item access

    def tensor_names(self) -> list[str]:
        return list(self._order)

    def close(self) -> None:
        """Release the underlying snapshot (pins drop immediately)."""
        if self.snapshot is not None:
            self.snapshot.close()
            self.engine._drain_released()

    def _ensure_decoded(self, rec: TensorRecord) -> TensorRecord:
        """Unpack a record's payload, sharing the decoded codes across every
        handle over the same page version through the frame cache."""
        if rec.qdelta is not None:
            return rec
        # Defense in depth for unverified paths (legacy v2 pages, engines
        # opened with checksums=False): a payload shorter than its metadata
        # claims must fail typed, never decode into silently wrong codes.
        if len(rec.payload) < rec.payload_nbytes:
            raise CorruptPageError(
                f"tensor {rec.name!r}: truncated payload "
                f"({len(rec.payload)} of {rec.payload_nbytes} bytes)"
            )
        frame = self.snapshot.frame if self.snapshot is not None else None
        if frame is None:
            rec.qdelta = decode_payload(rec)
            return rec
        key = (self._index_of[rec.name], self.bits)
        arr = frame.decoded.get(key)  # lock-free read (GIL-atomic dict get)
        if arr is None:
            fresh = decode_payload(rec)
            fresh.setflags(write=False)  # shared across handles: never mutated
            inserted = False
            with frame.lock:
                arr = frame.decoded.get(key)
                if arr is None:
                    frame.decoded[key] = arr = fresh
                    inserted = True
            self.engine.page_pool.count_decoded(hit=False)
            if inserted:
                self.engine.page_pool.note_extra(frame, arr.nbytes)
        else:
            self.engine.page_pool.count_decoded(hit=True)
        rec.qdelta = arr
        return rec

    def record(self, name: str) -> TensorRecord:
        return self._ensure_decoded(self._records[name])

    # ------------------------------------------------- on-demand decompress
    def _index_for(self, rec: TensorRecord):
        if self.snapshot is not None:
            return self.snapshot.indexes[rec.dim_key]
        # Legacy path (no snapshot): consult the live cache under the lock.
        with self.engine._lock:
            self.engine._check_quarantine(rec.dim_key)
            return self.engine.index_cache.get(rec.dim_key)

    def _base(self, rec: TensorRecord) -> np.ndarray:
        """De-quantize a base once per pass; free when every sharer has read it.

        Lock-free against the engine: base codes come from the snapshot's
        index object, whose rows [0, n) are never moved or renumbered
        (saves append; vacuum compacts a copy-on-write clone and installs
        it for *future* snapshots). The countdown resets to the full share
        count when it drains, so the cache is correct across repeated
        ``tensor(name)`` calls and multiple ``materialize()`` passes.
        """
        key = (rec.dim_key, rec.vertex_id)
        with self._cache_lock:
            base = self._deq_base.get(key)
        if base is None:
            index = self._index_for(rec)
            codes, meta = index.vertex_codes(rec.vertex_id)
            base = dequantize_linear(codes, meta)  # O(dim), outside all locks
        with self._cache_lock:
            if key not in self._deq_base and self._share.get(key, 0) > 1:
                self._deq_base[key] = base
            left = self._remaining.get(key, 1) - 1
            if left <= 0:
                self._deq_base.pop(key, None)
                self._remaining[key] = self._share.get(key, 1)  # rearm
            else:
                self._remaining[key] = left
        return base

    def tensor(self, name: str) -> np.ndarray:
        """Reconstruct one tensor to float32 (base + delta, on demand)."""
        rec = self._ensure_decoded(self._records[name])
        base = self._base(rec)
        delta = dequantize_delta(rec.qdelta, rec.meta)
        return (base + delta).reshape(rec.shape).astype(np.float32)

    def materialize(self) -> dict[str, np.ndarray]:
        """Full reconstruction of every tensor (the non-compression-aware path)."""
        return {name: self.tensor(name) for name in list(self._order)}

    def iter_tensors(self, names=None, workers: int = 1):
        """Stream ``(name, tensor)`` record-by-record, in page order (or in
        the order of ``names``, a subset of :meth:`tensor_names`).

        The bounded-memory reconstruction path: one tensor is resident at
        a time, plus the ``workers - 1`` being reconstructed ahead of it,
        each on a thread of its own (and the shared de-quantized base
        cache), so a consumer that forwards each tensor — the serving
        layer's chunked download — never holds the whole model as one
        buffer. Entirely lock-free off the snapshot, like
        :meth:`materialize`.
        """
        todo = iter(list(self._order) if names is None else list(names))
        if workers <= 1:
            for name in todo:
                yield name, self.tensor(name)
            return
        with ThreadPoolExecutor(max_workers=workers) as pool:
            ahead: deque = deque()
            for name in todo:
                ahead.append((name, pool.submit(self.tensor, name)))
                if len(ahead) == workers:
                    break
            while ahead:
                name, job = ahead.popleft()
                nxt = next(todo, None)
                if nxt is not None:
                    ahead.append((nxt, pool.submit(self.tensor, nxt)))
                yield name, job.result()

    # ------------------------------------------ compressed (augmented graph)
    def _compressed_entry(self, name: str) -> dict:
        """Build one tensor's quantized-component entry (Alg. 2 lines 4-5)."""
        rec = self._ensure_decoded(self._records[name])
        index = self._index_for(rec)
        codes, bmeta = index.vertex_codes(rec.vertex_id)
        # int8-safe recentring for the CUDA kernels: uint8 codes c with
        # zero-point z dequantize identically as (c-128) with (z-128),
        # and (c-128) fits int8 exactly. Only valid when nbit <= 8 —
        # use flexible loading (bits=8) for kernel-ready params.
        entry = {
            "shape": rec.shape,
            "base_codes": (codes.astype(np.int16) - 128)
            .astype(np.int8).reshape(rec.shape),
            "base_scale": np.float32(bmeta.scale),
            "base_zp": np.float32(bmeta.zero_point - 128),
            "base_mid": np.float32(bmeta.mid),
            "qdelta": rec.qdelta.reshape(rec.shape),
            "delta_scale": np.float32(rec.meta.scale),
            "delta_zp": np.float32(rec.meta.zero_point),
            "delta_mid": np.float32(rec.meta.mid),
            "nbit": rec.meta.nbit,
        }
        if rec.meta.nbit <= 8:
            entry["qdelta_i8"] = ((rec.qdelta - 128).astype(np.int8)
                                  .reshape(rec.shape))
            entry["delta_zp_i8"] = np.float32(rec.meta.zero_point - 128)
        return entry

    def compressed_params(self) -> "CompressedParams":
        """Lazy per-tensor quantized components for compute-on-compressed.

        Returns a mapping whose entries are built on first access — a
        caller serving a subset of tensors (the common case: a decoder's
        matmul weights, not its norm vectors) pays payload decode and
        reshape cost only for what it touches, with the same laziness
        contract as ``tensor(name)``. Each entry carries exactly what
        Alg. 2 retrieves (lines 4-5): the int8 base codes + (scale, zp),
        the quantized delta codes + (scale, zp, nbit). Feed entries to
        ``reconstruct_torch``, or :meth:`CompressedParams.kernel_operands`
        for the fused ``dequant_matmul`` kernels.
        """
        return CompressedParams(self)


class CompressedParams(Mapping):
    """Lazy name → quantized-components view over a :class:`LoadedModel`.

    Dict-compatible (iteration, ``len``, ``in``, ``.values()``...), but
    entries decode on first ``[name]`` access and are cached. Kernel-ready
    int8 recentrings (``qdelta_i8``/``delta_zp_i8``) are present only when
    the record's delta fits 8 bits; :meth:`kernel_operands` converts their
    absence into a typed :class:`KernelNotReady` instead of a KeyError.
    """

    def __init__(self, lm: "LoadedModel"):
        self._lm = lm
        self._entries: dict[str, dict] = {}

    def __iter__(self):
        return iter(self._lm._order)

    def __len__(self) -> int:
        return len(self._lm._order)

    def __contains__(self, name) -> bool:
        return name in self._lm._records

    def __getitem__(self, name: str) -> dict:
        entry = self._entries.get(name)  # GIL-atomic; duplicate builds benign
        if entry is None:
            entry = self._entries.setdefault(name, self._lm._compressed_entry(name))
        return entry

    def kernel_operands(self, name: str) -> dict:
        """The entry, guaranteed kernel-ready — or :class:`KernelNotReady`."""
        entry = self[name]
        if entry["nbit"] > 8:
            raise KernelNotReady(
                f"tensor {name!r}: delta quantized at {entry['nbit']} bits "
                "> 8; reload with load_model(..., bits=8) for the fused "
                "kernels")
        return entry


def materialize_many(models: list["LoadedModel"]) -> list[dict[str, np.ndarray]]:
    """Materialize several handles, de-quantizing each base once per batch.

    The load-side counterpart of ``StorageEngine.save_models``: a base
    vertex referenced by records in *different* handles (a checkpoint sweep
    loading a family of fine-tunes) is de-quantized once and seeded into
    every holder's per-pass cache, instead of once per handle. Per-handle
    share accounting is untouched — the seeded copy drains through the
    normal countdown, so repeated materialize passes behave exactly as
    before. Returns one ``{name: tensor}`` dict per handle, in order.

    Entirely lock-free against the engine: each handle's snapshot pins its
    index objects, so two handles share a base iff they reference the same
    vertex id in the *same index object* (handles that straddle a vacuum
    hold different index versions and correctly do not share).
    """
    groups: dict[tuple, list[tuple[LoadedModel, TensorRecord]]] = {}
    for lm in models:
        seen: set[tuple] = set()
        for rec in lm._records.values():
            if rec.vertex_id < 0:
                continue
            idx = (lm.snapshot.indexes.get(rec.dim_key)
                   if lm.snapshot is not None else None)
            if idx is None:
                continue
            key = (id(idx), rec.vertex_id)
            if key not in seen:
                seen.add(key)
                groups.setdefault(key, []).append((lm, rec))
    for holders in groups.values():
        if len(holders) < 2:
            continue  # shared within one handle only: _base caches it
        lm0, rec0 = holders[0]
        index = lm0.snapshot.indexes[rec0.dim_key]
        codes, meta = index.vertex_codes(rec0.vertex_id)
        base = dequantize_linear(codes, meta)
        for lm, rec in holders:
            with lm._cache_lock:
                lm._deq_base.setdefault((rec.dim_key, rec.vertex_id), base)
    return [lm.materialize() for lm in models]


class PipelineLoader:
    """3-stage pipeline: page I/O → de-quantization → consumer (paper §4.3.3).

    Stage i loads tensor i while stage i-1's tensor de-quantizes and the
    consumer computes on tensor i-2. ``run`` returns per-stage busy seconds
    so benchmarks can show the overlap win.
    """

    def __init__(self, model: LoadedModel, depth: int = 4):
        self.model = model
        self.depth = depth

    def run(self, consume) -> dict:
        import time

        names = self.model.tensor_names()
        q_io: "queue.Queue" = queue.Queue(maxsize=self.depth)
        q_deq: "queue.Queue" = queue.Queue(maxsize=self.depth)
        busy = {"io": 0.0, "dequant": 0.0, "compute": 0.0}

        def stage_io():
            for name in names:
                t0 = time.perf_counter()
                # record() triggers the lazy planar bit-unpack, so this
                # stage does the real payload-decode work while the dequant
                # stage reconstructs the previous tensor.
                rec = self.model.record(name)
                busy["io"] += time.perf_counter() - t0
                q_io.put((name, rec))
            q_io.put(None)

        def stage_dequant():
            while True:
                item = q_io.get()
                if item is None:
                    q_deq.put(None)
                    return
                name, rec = item
                t0 = time.perf_counter()
                tensor = self.model.tensor(name)
                busy["dequant"] += time.perf_counter() - t0
                q_deq.put((name, tensor))

        t_start = time.perf_counter()
        threads = [threading.Thread(target=stage_io), threading.Thread(target=stage_dequant)]
        for t in threads:
            t.start()
        while True:
            item = q_deq.get()
            if item is None:
                break
            name, tensor = item
            t0 = time.perf_counter()
            consume(name, tensor)
            busy["compute"] += time.perf_counter() - t0
        for t in threads:
            t.join()
        busy["wall"] = time.perf_counter() - t_start
        return busy
