"""Space accounting: where every stored byte went, attributably.

The paper's headline number is a compression ratio (§4, Fig. 9), so the
store must be able to answer "logical vs physical, per what?" without a
full rescan. :class:`SpaceAccountant` is the incremental answer: the
engine pushes one :class:`ModelSpace` fact at every commit point
(save / replace / delete / vacuum) and the accountant can at any moment
produce a report broken down per model, per dim-group, per tenant and
store-wide.

This module is pure bookkeeping on purpose. ``repro_torch.obs`` is imported
by every layer and must never import back into them, so nothing here
knows about engines, catalogs or pages — the engine computes the byte
splits (it has the records in hand at save time) and passes plain data
in; refcounts arrive as a ``ref_count(dim_key, vertex_id)`` callable at
report time so shared-base amortization always reflects the *current*
catalog, not the one at save time.

Byte taxonomy (all integers, all bytes):

* **logical**: the uncompressed float32 footprint a naive store would
  hold (``numel * 4`` per tensor) — the denominator of the paper's
  compression ratio.
* **delta**: bit-packed quantized-delta payloads inside the model's
  page (``nbit`` planes of ``ceil(numel/8)`` bytes each).
* **metadata**: everything else in the page file — record headers,
  tensor names, shapes, the offset table and framing. Derived as
  ``page_bytes - delta_bytes`` so ``delta + metadata == page_bytes``
  holds by construction and the *real* conservation check is
  ``page_bytes == os.path.getsize(page)`` (tests/fsck do exactly that).
* **shared base**: 8-bit base codes live in the HNSW index and are
  shared by every model whose tensors reference the vertex. A vertex
  costs ~``numel`` bytes (one byte per element); a model is charged
  ``numel / refcount`` per reference — the same amortization rule as
  ``StorageEngine.per_model_bytes``.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field

__all__ = [
    "TensorSpace",
    "ModelSpace",
    "SpaceAccountant",
]

# Key used in the per-tenant breakdown for models that do not belong to
# any tenant namespace (embedded saves without a "t/name" prefix).
UNTENANTED = "_embedded"


@dataclass(frozen=True)
class TensorSpace:
    """Space facts for one stored tensor record."""

    dim_key: int  # dim-group (flattened element count class)
    vertex_id: int  # base vertex this tensor's delta references
    numel: int  # elements (logical bytes = numel * 4)
    delta_bytes: int  # bit-packed delta payload bytes in the page


@dataclass(frozen=True)
class ModelSpace:
    """Space facts for one committed model version (one page file)."""

    name: str
    page: str  # page file name (e.g. "model_7.page")
    page_bytes: int  # on-disk page file size at commit
    logical_bytes: int  # uncompressed f32 footprint
    tensors: tuple[TensorSpace, ...] = field(default_factory=tuple)

    @property
    def delta_bytes(self) -> int:
        return sum(t.delta_bytes for t in self.tensors)

    @property
    def metadata_bytes(self) -> int:
        return self.page_bytes - self.delta_bytes

    def ref_counter(self) -> dict:
        """This model's reference multiset: ``(dim, vid) -> count``."""
        refs: dict = {}
        for t in self.tensors:
            key = (t.dim_key, t.vertex_id)
            refs[key] = refs.get(key, 0) + 1
        return refs


def _ratio(physical: int, logical: int) -> float | None:
    return (physical / logical) if logical > 0 else None


class SpaceAccountant:
    """Incremental logical/physical byte ledger over committed models.

    Mutations (``record_save`` / ``record_delete`` / ``reset``) are
    called by the engine *after* its commit point — the accountant only
    ever describes durable state. All methods are thread-safe; the
    report is computed from an atomic snapshot of the ledger.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._models: dict[str, ModelSpace] = {}

    # --------------------------------------------------------- mutation
    def record_save(self, space: ModelSpace) -> None:
        """Install (or replace, by name) one committed model's facts."""
        with self._lock:
            self._models[space.name] = space

    def record_delete(self, name: str) -> None:
        with self._lock:
            self._models.pop(name, None)

    def reset(self, spaces) -> None:
        """Replace the whole ledger (open-time / post-vacuum rescan)."""
        with self._lock:
            self._models = {s.name: s for s in spaces}

    # ---------------------------------------------------------- queries
    def models(self) -> dict[str, ModelSpace]:
        with self._lock:
            return dict(self._models)

    def totals(self, ref_count) -> tuple[int, int]:
        """``(logical_bytes, physical_bytes)`` store-wide.

        Cheap enough for a gauge callback: physical is page bytes plus
        one byte per element of every *unique* live-referenced vertex.
        """
        models = self.models()
        logical = sum(m.logical_bytes for m in models.values())
        physical = sum(m.page_bytes for m in models.values())
        seen: set = set()
        for m in models.values():
            for t in m.tensors:
                key = (t.dim_key, t.vertex_id)
                if key not in seen and t.vertex_id >= 0:
                    seen.add(key)
                    physical += t.numel
        return logical, physical

    def report(self, ref_count, tenant_of=None) -> dict:
        """Full attribution report (JSON-safe).

        ``ref_count(dim_key, vertex_id)`` must return the store-wide
        live reference count for a base vertex; ``tenant_of(name)``
        optionally maps a model name to its tenant (``None`` = not a
        tenant model). Shape::

            {"store": {...}, "per_model": {...},
             "per_dim": {...}, "per_tenant": {...}}
        """
        models = self.models()
        per_model: dict[str, dict] = {}
        per_dim: dict[int, dict] = {}
        seen_vertices: set = set()
        store_base_bytes = 0

        for name in sorted(models):
            m = models[name]
            own_refs = m.ref_counter()
            shared_base = 0.0
            reclaimable_base = 0
            for t in m.tensors:
                if t.vertex_id < 0:
                    continue
                rc = max(int(ref_count(t.dim_key, t.vertex_id)), 1)
                shared_base += t.numel / rc
                d = per_dim.setdefault(t.dim_key, {
                    "tensors": 0, "logical_bytes": 0, "delta_bytes": 0,
                    "base_vertices": 0, "base_bytes": 0,
                })
                d["tensors"] += 1
                d["logical_bytes"] += t.numel * 4
                d["delta_bytes"] += t.delta_bytes
                key = (t.dim_key, t.vertex_id)
                if key not in seen_vertices:
                    seen_vertices.add(key)
                    store_base_bytes += t.numel
                    d["base_vertices"] += 1
                    d["base_bytes"] += t.numel
            # Reclaimable-on-delete: the page itself, plus every base
            # vertex whose only live references come from this model
            # (its refcount equals this model's contribution).
            for (dim, vid), count in own_refs.items():
                if vid < 0:
                    continue
                if int(ref_count(dim, vid)) <= count:
                    numel = next(
                        t.numel for t in m.tensors
                        if t.dim_key == dim and t.vertex_id == vid)
                    reclaimable_base += numel
            physical = m.page_bytes + int(round(shared_base))
            per_model[name] = {
                "page": m.page,
                "n_tensors": len(m.tensors),
                "logical_bytes": m.logical_bytes,
                "page_bytes": m.page_bytes,
                "delta_bytes": m.delta_bytes,
                "metadata_bytes": m.metadata_bytes,
                "shared_base_bytes": int(round(shared_base)),
                "physical_bytes": physical,
                "reclaimable_bytes": m.page_bytes + reclaimable_base,
                "compression_ratio": _ratio(physical, m.logical_bytes),
            }

        store_logical = sum(m.logical_bytes for m in models.values())
        store_page = sum(m.page_bytes for m in models.values())
        store_delta = sum(m.delta_bytes for m in models.values())
        store_physical = store_page + store_base_bytes
        store = {
            "models": len(models),
            "logical_bytes": store_logical,
            "physical_bytes": store_physical,
            "page_bytes": store_page,
            "delta_bytes": store_delta,
            "metadata_bytes": store_page - store_delta,
            "base_bytes": store_base_bytes,
            "compression_ratio": _ratio(store_physical, store_logical),
        }

        per_tenant: dict[str, dict] = {}
        for name, pm in per_model.items():
            tenant = tenant_of(name) if tenant_of is not None else None
            if tenant is None:
                head, sep, _ = name.partition("/")
                tenant = head if sep else UNTENANTED
            t = per_tenant.setdefault(tenant, {
                "models": 0, "logical_bytes": 0, "physical_bytes": 0,
                "page_bytes": 0, "delta_bytes": 0,
            })
            t["models"] += 1
            t["logical_bytes"] += pm["logical_bytes"]
            t["physical_bytes"] += pm["physical_bytes"]
            t["page_bytes"] += pm["page_bytes"]
            t["delta_bytes"] += pm["delta_bytes"]
        for t in per_tenant.values():
            t["compression_ratio"] = _ratio(
                t["physical_bytes"], t["logical_bytes"])

        return {
            "store": store,
            "per_model": per_model,
            "per_dim": {str(k): v for k, v in sorted(per_dim.items())},
            "per_tenant": per_tenant,
        }

    # ------------------------------------------------------------ drift
    def diff(self, other: "SpaceAccountant") -> list[str]:
        """Compare two ledgers; each discrepancy is one human-readable
        line. Empty list = no drift. ``self`` is the incremental ledger,
        ``other`` the rescan ground truth (fsck ``--accounting``)."""
        mine = self.models()
        theirs = other.models()
        out: list[str] = []
        for name in sorted(set(mine) - set(theirs)):
            out.append(f"accounting: {name!r} tracked but not on disk")
        for name in sorted(set(theirs) - set(mine)):
            out.append(f"accounting: {name!r} on disk but not tracked")
        for name in sorted(set(mine) & set(theirs)):
            a, b = mine[name], theirs[name]
            for attr in ("page", "page_bytes", "logical_bytes",
                         "delta_bytes"):
                av, bv = getattr(a, attr), getattr(b, attr)
                if av != bv:
                    out.append(
                        f"accounting: {name!r} {attr} drift "
                        f"(tracked {av!r} != rescan {bv!r})")
            if a.ref_counter() != b.ref_counter():
                out.append(
                    f"accounting: {name!r} base-reference drift "
                    "(tracked refs != rescan refs)")
        return out
