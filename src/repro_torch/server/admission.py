"""Write admission / backpressure policy fed by ``StorageEngine.stats()``.

Reads are never gated: the snapshot read path is lock-free after capture
and pins its own resources, so a read costs the writers nothing. Writes
are the amplifying operations — each save commits a catalog snapshot
(bumping the epoch every live reader's lag is measured against) and
pushes bytes through the index cache and buffer pool — so writes are
what admission sheds when the store is under pressure.

The policy consumes **only the documented stats fields** (the
:class:`repro_torch.store.api.StoreStats` projection of
``StorageEngine.stats()`` — stats-as-API, ``docs/serving.md``):

* ``pool_utilization`` — ``pool_resident_bytes / pool_budget_bytes``.
  Above the watermark, new page writes would start evicting frames that
  live readers are actively sharing; shedding writes lets the
  maintenance daemon's trims catch up.
* ``epoch_lag`` — ``epoch - oldest_epoch`` over live snapshots. Every
  write commit widens the gap between the catalog head and the oldest
  pinned snapshot; unbounded lag means unbounded retained page versions
  (copy-on-write vacuum keeps every pinned generation alive). Shedding
  writes bounds version retention while long reads drain.

Rejection raises :class:`~repro_torch.store.errors.AdmissionRejectedError`,
which the server surfaces as HTTP 429 + ``{"code": "backpressure"}``
with a ``Retry-After`` hint — the request is safe to retry verbatim.
"""

from __future__ import annotations

import dataclasses

from ..obs.metrics import default_registry
from ..store.api import StoreStats
from ..store.errors import AdmissionRejectedError

__all__ = ["AdmissionPolicy"]

_M_REJECTED = default_registry().counter(
    "neurstore_server_admission_rejects_total",
    "Writes shed by the admission policy, by trigger.",
    ("reason",),
)


@dataclasses.dataclass
class AdmissionPolicy:
    """Threshold policy over the documented stats fields.

    ``max_pool_utilization`` — reject writes while the buffer pool holds
    more than this fraction of its byte budget (> 1.0 disables; pinned
    frames can push utilization past 1.0).
    ``max_epoch_lag`` — reject writes while the oldest live snapshot is
    more than this many commits behind the catalog head (negative
    disables).
    ``retry_after_s`` — the backoff hint returned with a rejection.
    """

    max_pool_utilization: float = 0.95
    max_epoch_lag: int = 256
    retry_after_s: float = 0.05

    # Telemetry (exposed via /v1/stats so load tests can see shed counts).
    rejected: int = 0

    def check_write(self, stats: StoreStats) -> None:
        """Raise :class:`AdmissionRejectedError` if a write must shed."""
        util = stats.pool_utilization
        if 0 <= self.max_pool_utilization < util:
            self.rejected += 1
            _M_REJECTED.labels("pool_utilization").inc()
            raise AdmissionRejectedError(
                f"buffer pool at {util:.0%} of budget "
                f"(> {self.max_pool_utilization:.0%}); retry after "
                f"{self.retry_after_s}s")
        lag = stats.epoch_lag
        if 0 <= self.max_epoch_lag < lag:
            self.rejected += 1
            _M_REJECTED.labels("epoch_lag").inc()
            raise AdmissionRejectedError(
                f"oldest live snapshot is {lag} commits behind "
                f"(> {self.max_epoch_lag}); retry after "
                f"{self.retry_after_s}s")

    def stats(self) -> dict:
        return {
            "max_pool_utilization": self.max_pool_utilization,
            "max_epoch_lag": self.max_epoch_lag,
            "rejected": self.rejected,
        }
