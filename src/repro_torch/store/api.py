"""Typed request/response surface shared by every front door.

One set of dataclasses is the whole contract: the embedded facade
(:class:`repro_torch.store.NeurStore`), the HTTP handlers
(``repro_torch.server.app``) and the network client
(``repro_torch.server.client.StoreClient``) all construct and consume exactly
these types, so the wire schema and the Python API cannot drift apart.

Canonical knob set (the one documented parameter vocabulary — see
``docs/serving.md`` for the full table):

* **store-level defaults**, set once at ``NeurStore.open`` /
  ``StorageEngine(...)``: ``tolerance`` (quantization error bound *p*,
  paper §4.2) and ``tau`` (delta-range similarity threshold, §6.1.3);
* **per-save overrides**: :attr:`SaveRequest.tolerance` /
  :attr:`SaveRequest.tau` — ``None`` means "use the store default";
* **per-load knobs**: ``bits`` (flexible loading — read only the top
  *b* delta bit-planes, §4.3.1; ``None`` = full precision) and
  ``shared_cache`` (route page bytes through the buffer pool; ``False``
  is the private-bytes baseline used by benchmarks).

There are no other spellings: anything that used to be passed ad hoc
(``tolerance=``/``tau=`` kwargs vs engine attributes, ``bits=`` vs
``shared_cache=``) is one of the three tiers above.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Iterator, Mapping

import numpy as np

# Re-exported verbatim: the engine's save statistics ARE the wire-level
# save response (SaveReport.to_dict/from_dict is the JSON body).
from ..core.engine import DEFAULT_TAU, DEFAULT_TOLERANCE, SaveReport

__all__ = [
    "DEFAULT_TAU",
    "DEFAULT_TOLERANCE",
    "LoadHandle",
    "SaveReport",
    "SaveRequest",
    "StoreStats",
]


@dataclasses.dataclass
class SaveRequest:
    """One model to persist — the typed argument of every save surface.

    ``tensors`` maps tensor name → float array, iterated in architecture
    order (records land in page order). ``tolerance``/``tau`` override
    the store defaults for this save only (``None`` = store default).
    """

    name: str
    tensors: Mapping[str, np.ndarray]
    architecture: dict = dataclasses.field(default_factory=dict)
    tolerance: float | None = None
    tau: float | None = None

    def total_bytes(self) -> int:
        """Uncompressed float32 footprint (what quota admission sees).

        The store casts every input to float32 before quantizing, so the
        footprint is ``size * itemsize(f32)`` regardless of the input
        dtype — an f16 upload is *not* half price, and an f64 upload is
        not double. This keeps quota admission and the space accountant
        (``repro_torch.obs.accounting``) charging the same logical bytes.
        """
        itemsize = np.dtype(np.float32).itemsize
        return sum(
            int(np.asarray(t).size) * itemsize for t in self.tensors.values()
        )

    def wire_header(self) -> dict:
        """The JSON header frame of a streamed upload (tensors excluded)."""
        return {
            "name": self.name,
            "architecture": self.architecture,
            "tolerance": self.tolerance,
            "tau": self.tau,
            "n_tensors": len(self.tensors),
        }

    @classmethod
    def from_wire(cls, header: dict,
                  tensors: Mapping[str, np.ndarray]) -> "SaveRequest":
        return cls(
            name=str(header.get("name", "")),
            tensors=tensors,
            architecture=header.get("architecture") or {},
            tolerance=header.get("tolerance"),
            tau=header.get("tau"),
        )


class LoadHandle:
    """Unified typed read handle over one model — embedded or remote.

    Both backends expose the same three access patterns:

    * :meth:`tensors` — stream ``(name, array)`` record-by-record, the
      bounded-memory path (one tensor resident at a time). A remote
      handle decodes frames straight off the socket; an embedded handle
      reconstructs lazily off its pinned snapshot.
    * :meth:`materialize` — the full ``{name: array}`` dict (cached).
    * :meth:`tensor` — one tensor by name.

    Remote streams are one-shot: ``tensors()`` can be consumed once,
    after which only the materialized cache (if built) serves access.
    ``close()`` releases the snapshot (embedded) or drains/abandons the
    response (remote); the handle is a context manager.
    """

    def __init__(self, name: str, architecture: dict, bits: int | None,
                 *, loaded=None, stream=None, close=None):
        self.name = name
        self.architecture = architecture
        self.bits = bits
        self._loaded = loaded        # LoadedModel (embedded backend)
        self._stream = stream        # iterator[(name, array)] (remote)
        self._close = close
        self._cache: dict[str, np.ndarray] | None = None

    # ------------------------------------------------------------ builders
    @classmethod
    def from_loaded(cls, name: str, loaded, bits: int | None = None):
        return cls(name, loaded.info["architecture"], bits, loaded=loaded)

    @classmethod
    def from_stream(cls, header: dict, stream: Iterator, close=None):
        return cls(str(header.get("name", "")),
                   header.get("architecture") or {},
                   header.get("bits"), stream=stream, close=close)

    # -------------------------------------------------------------- access
    def tensors(self) -> Iterator[tuple[str, np.ndarray]]:
        """Stream records one at a time (bounded memory)."""
        if self._cache is not None:
            yield from self._cache.items()
        elif self._loaded is not None:
            yield from self._loaded.iter_tensors()
        elif self._stream is not None:
            stream, self._stream = self._stream, None
            yield from stream
        else:
            raise RuntimeError("load handle already consumed (one-shot "
                               "remote stream); use materialize() up front")

    def materialize(self) -> dict[str, np.ndarray]:
        """Every tensor, reconstructed to float32 (cached after first call)."""
        if self._cache is None:
            self._cache = dict(self.tensors())
        return self._cache

    def tensor(self, name: str) -> np.ndarray:
        if self._loaded is not None and self._cache is None:
            return self._loaded.tensor(name)
        return self.materialize()[name]

    def tensor_names(self) -> list[str]:
        if self._loaded is not None:
            return self._loaded.tensor_names()
        return list(self.materialize())

    # ----------------------------------------------------------- lifecycle
    def close(self) -> None:
        if self._loaded is not None:
            self._loaded.close()
        if self._close is not None:
            close, self._close = self._close, None
            close()

    def __enter__(self) -> "LoadHandle":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


@dataclasses.dataclass
class StoreStats:
    """The *documented* slice of ``StorageEngine.stats()`` — stats-as-API.

    Every field here is stable contract (``docs/serving.md`` documents
    each counter); the admission policy consumes **only** these fields.
    ``raw`` carries the full engine dump for humans and dashboards, with
    no stability promise.
    """

    schema_version: int
    epoch: int
    models: int
    snapshots_live: int
    oldest_epoch: int | None
    pool_resident_bytes: int
    pool_budget_bytes: int
    pool_pinned_bytes: int
    read_only: bool
    corrupt_models: int
    # Space accounting (repro_torch.obs.accounting): logical = uncompressed
    # f32 footprint of all committed models; physical = page bytes plus
    # shared 8-bit base codes; ratio = physical / logical (None when the
    # store is empty).
    logical_bytes: int = 0
    physical_bytes: int = 0
    compression_ratio: float | None = None
    raw: dict = dataclasses.field(default_factory=dict, repr=False)

    @classmethod
    def from_engine(cls, stats: dict) -> "StoreStats":
        """Project an ``StorageEngine.stats()`` dump onto the stable schema."""
        pool = stats.get("buffer_pool", {})
        snaps = stats.get("snapshots", {})
        integ = stats.get("integrity", {})
        acct = stats.get("accounting", {})
        return cls(
            schema_version=int(stats.get("schema_version", 0)),
            epoch=int(stats.get("epoch", 0)),
            models=int(stats.get("models", 0)),
            snapshots_live=int(snaps.get("live", 0)),
            oldest_epoch=snaps.get("oldest_epoch"),
            pool_resident_bytes=int(pool.get("resident_bytes", 0)),
            pool_budget_bytes=int(pool.get("budget_bytes", 0)),
            pool_pinned_bytes=int(pool.get("pinned_bytes", 0)),
            read_only=bool(integ.get("read_only", False)),
            corrupt_models=len(integ.get("corrupt_models", ())),
            logical_bytes=int(acct.get("logical_bytes", 0)),
            physical_bytes=int(acct.get("physical_bytes", 0)),
            compression_ratio=acct.get("compression_ratio"),
            raw=stats,
        )

    # Derived signals the admission policy keys on.
    @property
    def pool_utilization(self) -> float:
        if self.pool_budget_bytes <= 0:
            return 0.0
        return self.pool_resident_bytes / self.pool_budget_bytes

    @property
    def epoch_lag(self) -> int:
        """How many commits behind the oldest live snapshot is (0 if none)."""
        if self.oldest_epoch is None:
            return 0
        return max(0, self.epoch - self.oldest_epoch)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "StoreStats":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})
