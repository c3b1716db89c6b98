"""Per-tenant namespaces and byte quotas (enforced at save-commit time).

Tenancy is a *naming* convention the server owns: a model saved by
tenant ``t`` under name ``n`` lives in the engine catalog as ``t/n``.
Tenant ids are validated (``[A-Za-z0-9_-]+``, no ``/``) so namespaces
cannot collide or escape; model names may themselves contain ``/``.

Quotas bound the **on-disk page bytes** a tenant's committed models
occupy — post-dedup, post-quantization — so a tenant whose fine-tunes
dedup well against existing bases is charged only for its delta pages
(shared base vertices in the HNSW index are charged to nobody, matching
the engine's own storage accounting).

Enforcement happens inside the engine's save transaction via
``StorageEngine.commit_gate``: the gate runs under the engine lock
immediately before the journal intent, sees the exact encoded page
bytes about to commit (plus the bytes of any page the save replaces),
and raises :class:`~repro_torch.store.errors.QuotaExceededError` to abort the
save before any durable side effect. A racing pair of saves for the
same tenant cannot both slip under the limit — the gate and the commit
are one critical section.
"""

from __future__ import annotations

import re
import threading

from ..store.errors import QuotaExceededError

__all__ = ["QuotaManager", "split_tenant", "tenant_model_name",
           "validate_tenant"]

_TENANT_RE = re.compile(r"^[A-Za-z0-9_-]{1,64}$")


def validate_tenant(tenant: str) -> str:
    """Return ``tenant`` or raise ``ValueError`` (``invalid_request``)."""
    if not _TENANT_RE.match(tenant):
        raise ValueError(f"invalid tenant id {tenant!r} "
                         "(allowed: [A-Za-z0-9_-], max 64 chars)")
    return tenant


def tenant_model_name(tenant: str, name: str) -> str:
    """The engine-catalog name for ``name`` in ``tenant``'s namespace."""
    validate_tenant(tenant)
    if not name:
        raise ValueError("empty model name")
    return f"{tenant}/{name}"


def split_tenant(full_name: str) -> tuple[str, str] | None:
    """Inverse of :func:`tenant_model_name`; None for non-namespaced rows."""
    tenant, sep, name = full_name.partition("/")
    if not sep or not _TENANT_RE.match(tenant):
        return None
    return tenant, name


class QuotaManager:
    """Byte quotas per tenant namespace.

    ``default_limit`` applies to tenants without an explicit entry;
    ``None`` means unlimited. Usage is derived from the engine catalog
    (sum of committed page sizes per namespace), so it needs no separate
    persistence and survives restarts, vacuums (which shrink pages) and
    out-of-band deletes for free.
    """

    def __init__(self, default_limit: int | None = None,
                 limits: dict[str, int] | None = None):
        self.default_limit = default_limit
        self.limits = dict(limits or {})
        self._lock = threading.Lock()

    def limit(self, tenant: str) -> int | None:
        with self._lock:
            return self.limits.get(tenant, self.default_limit)

    def set_limit(self, tenant: str, limit: int | None) -> None:
        with self._lock:
            if limit is None:
                self.limits.pop(tenant, None)
            else:
                self.limits[tenant] = int(limit)

    def usage(self, engine, tenant: str) -> int:
        """Committed on-disk page bytes in ``tenant``'s namespace."""
        prefix = f"{tenant}/"
        total = 0
        for name in engine.list_models():
            if name.startswith(prefix):
                total += engine._page_size(engine.model_info(name))
        return total

    def report(self, engine, tenant: str) -> dict:
        limit = self.limit(tenant)
        used = self.usage(engine, tenant)
        return {
            "tenant": tenant,
            "limit_bytes": limit,
            "used_bytes": used,
            "remaining_bytes": None if limit is None else max(0, limit - used),
        }

    def gate(self, engine):
        """Build the ``StorageEngine.commit_gate`` callable.

        The engine calls it under its lock with one entry per model in
        the committing transaction: ``{"name", "page_bytes",
        "old_page_bytes"}``. Charges are grouped per tenant so a batch
        save is admitted or rejected atomically, matching the engine's
        all-or-nothing batch commit.
        """

        def check(entries: list[dict]) -> None:
            deltas: dict[str, int] = {}
            for e in entries:
                split = split_tenant(str(e["name"]))
                if split is None:
                    continue  # non-namespaced (embedded) saves are ungated
                tenant = split[0]
                deltas[tenant] = (
                    deltas.get(tenant, 0)
                    + int(e["page_bytes"]) - int(e["old_page_bytes"])
                )
            for tenant, delta in deltas.items():
                limit = self.limit(tenant)
                if limit is None:
                    continue
                used = self.usage(engine, tenant)
                if used + delta > limit:
                    raise QuotaExceededError(
                        f"tenant {tenant!r}: save would use "
                        f"{used + delta} bytes of a {limit}-byte quota "
                        f"({used} already committed)")

        return check
