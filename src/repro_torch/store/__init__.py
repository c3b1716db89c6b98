"""The supported public facade over the NeurStore engine.

``repro_torch.store`` is the import path applications should use::

    from repro_torch.store import NeurStore, SaveRequest

    store = NeurStore.open("/path/to/store")        # on the card
    store.save(SaveRequest("base", tensors, architecture={"family": "demo"}))
    with store.load("base", bits=8) as handle:
        params = handle.materialize()

Everything here is a thin, *typed* veneer over
:class:`repro_torch.core.engine.StorageEngine` — the same
:class:`~repro_torch.store.api.SaveRequest` / :class:`~repro_torch.store.api.SaveReport`
/ :class:`~repro_torch.store.api.LoadHandle` / :class:`~repro_torch.store.api.StoreStats`
dataclasses are used verbatim by the HTTP server handlers
(``repro_torch.server.app``) and the network client
(``repro_torch.server.client.StoreClient``), so code written against this
facade runs unchanged against a remote store. The canonical knob set
(``tolerance``/``tau`` defaults + per-save overrides, ``bits`` /
``shared_cache`` per load) is documented in :mod:`repro_torch.store.api` and
``docs/serving.md``.

``repro_torch.core.engine`` remains importable for existing code (its
``StorageEngine``/``SaveReport`` are exactly what this facade wraps),
but new surface lands here first.

The engine runs its HNSW probes on the card: ``open`` defaults to
``device="cuda"`` and raises without CUDA, as ``StorageEngine`` does.
Only an explicit ``device="cpu"`` runs the plain path.
"""

from __future__ import annotations

from ..core.engine import DEFAULT_TAU, DEFAULT_TOLERANCE, StorageEngine
from .api import LoadHandle, SaveReport, SaveRequest, StoreStats
from .errors import (
    AdmissionRejectedError,
    QuotaExceededError,
    RemoteStoreError,
)

__all__ = [
    "AdmissionRejectedError",
    "DEFAULT_TAU",
    "DEFAULT_TOLERANCE",
    "LoadHandle",
    "NeurStore",
    "QuotaExceededError",
    "RemoteStoreError",
    "SaveReport",
    "SaveRequest",
    "StoreStats",
]


class NeurStore:
    """Typed single-process front door over one on-disk store."""

    def __init__(self, engine: StorageEngine):
        self.engine = engine

    @classmethod
    def open(
        cls,
        path: str,
        *,
        tolerance: float = DEFAULT_TOLERANCE,
        tau: float = DEFAULT_TAU,
        cache_bytes: int = 32 << 30,
        pool_bytes: int = 1 << 30,
        checksums: bool = True,
        auto_maintenance: bool = False,
        device="cuda",
    ) -> "NeurStore":
        """Open (or create) a store at ``path`` with the documented knobs.

        ``tolerance``/``tau`` become the store-level defaults that
        per-save overrides fall back to; ``cache_bytes`` bounds the HNSW
        index cache, ``pool_bytes`` the tensor-page buffer pool,
        ``device`` where the index mirrors and their kernel run.
        """
        return cls(StorageEngine(
            path, tolerance=tolerance, tau=tau, cache_bytes=cache_bytes,
            pool_bytes=pool_bytes, checksums=checksums,
            auto_maintenance=auto_maintenance, device=device,
        ))

    # --------------------------------------------------------------- writes
    def save(self, request: SaveRequest) -> SaveReport:
        return self.engine.save_model(
            request.name, request.architecture, request.tensors,
            tolerance=request.tolerance, tau=request.tau,
        )

    def save_many(self, requests: list[SaveRequest]) -> list[SaveReport]:
        """Commit several models in ONE catalog transaction (batch ingest).

        Per-save knob overrides are not supported on the batch path (the
        batch shares one probe/quantize sweep); all requests must leave
        ``tolerance``/``tau`` unset.
        """
        for r in requests:
            if r.tolerance is not None or r.tau is not None:
                raise ValueError(
                    f"save_many: request {r.name!r} carries per-save knob "
                    "overrides; batch saves use the store defaults")
        return self.engine.save_models(
            [(r.name, r.architecture, r.tensors) for r in requests]
        )

    def replace(self, request: SaveRequest) -> SaveReport:
        """Replace an existing model (KeyError if absent) atomically."""
        return self.engine.replace_model(
            request.name, request.architecture, request.tensors,
            tolerance=request.tolerance, tau=request.tau,
        )

    def delete(self, name: str) -> None:
        self.engine.delete_model(name)

    def vacuum(self, min_dead_fraction: float = 0.0) -> dict:
        return self.engine.vacuum(min_dead_fraction=min_dead_fraction)

    # ---------------------------------------------------------------- reads
    def load(self, name: str, *, bits: int | None = None,
             shared_cache: bool = True) -> LoadHandle:
        lm = self.engine.load_model(name, bits=bits, shared_cache=shared_cache)
        return LoadHandle.from_loaded(name, lm, bits=bits)

    def load_many(self, names: list[str],
                  bits: int | None = None) -> list[LoadHandle]:
        """Open several handles under ONE snapshot epoch (consistent set)."""
        return [
            LoadHandle.from_loaded(name, lm, bits=bits)
            for name, lm in zip(names, self.engine.load_models(names, bits=bits))
        ]

    def models(self) -> list[str]:
        return self.engine.list_models()

    def stats(self) -> StoreStats:
        return StoreStats.from_engine(self.engine.stats())

    # --------------------------------------------------------- observability
    def accounting(self) -> dict:
        """Space accounting: ``{"store", "per_model", "per_dim",
        "per_tenant"}`` byte attribution (``docs/observability.md``)."""
        return self.engine.accounting_report()

    def explain(self, name: str) -> dict:
        """Persisted save EXPLAIN (per-tensor dedup decisions) + the
        model's current space attribution."""
        return self.engine.model_explain(name)

    def metrics(self) -> dict:
        """Parsed snapshot of the process-wide metrics registry.

        Returns ``{family_name: {"type": ..., "help": ..., "samples":
        [{"name", "labels", "value"}, ...]}}`` — the same structure
        :func:`repro_torch.obs.metrics.parse_prometheus_text` produces, so
        embedded callers and scrape consumers see one schema.
        """
        from ..obs.metrics import default_registry, parse_prometheus_text
        return parse_prometheus_text(default_registry().render())

    def metrics_text(self) -> str:
        """Prometheus text exposition (what ``GET /v1/metrics`` serves)."""
        from ..obs.metrics import default_registry
        return default_registry().render()

    # ------------------------------------------------------------ lifecycle
    def close(self) -> None:
        self.engine.close()

    def __enter__(self) -> "NeurStore":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
