"""Unified error surface: one machine-readable code per failure class.

The same registry backs all three surfaces (the error contract asserted
by ``tests/test_server.py::test_error_contract``):

* the **embedded API** raises the typed exceptions directly;
* the **server** maps an exception to ``{"error": {"code", "message"}}``
  plus the code's canonical HTTP status (:func:`error_payload`);
* **StoreClient** maps the code back to the *same* typed exception class
  (:func:`raise_for_code`), so ``except CorruptPageError`` works
  identically against a local engine and a remote store.

Codes are part of the wire contract (``docs/serving.md``): they are
append-only and never renamed.

=================  ======  ==========================================
code               status  raised as
=================  ======  ==========================================
``not_found``      404     ``KeyError``
``corrupt``        409     ``CorruptPageError``
``read_only``      503     ``ReadOnlyStoreError``
``quota_exceeded`` 413     :class:`QuotaExceededError`
``backpressure``   429     :class:`AdmissionRejectedError`
``kernel_not_ready`` 422   ``KernelNotReady``
``invalid_request`` 400    ``ValueError``
``internal``       500     :class:`RemoteStoreError`
=================  ======  ==========================================
"""

from __future__ import annotations

from ..core.integrity import (
    CorruptIndexError,
    CorruptPageError,
    IntegrityError,
    ReadOnlyStoreError,
)
from ..core.loader import KernelNotReady

__all__ = [
    "AdmissionRejectedError",
    "QuotaExceededError",
    "RemoteStoreError",
    "ERROR_CODES",
    "error_code_for",
    "error_payload",
    "http_status_for",
    "raise_for_code",
]


class QuotaExceededError(RuntimeError):
    """A save would push a tenant past its byte quota (checked at commit)."""


class AdmissionRejectedError(RuntimeError):
    """A write was rejected by the admission policy (pool pressure or
    snapshot-epoch lag). The request is safe to retry after backoff."""


class RemoteStoreError(RuntimeError):
    """The server failed in a way no specific code covers (HTTP 5xx)."""


# code → canonical HTTP status. Append-only: codes are wire contract.
ERROR_CODES: dict[str, int] = {
    "not_found": 404,
    "corrupt": 409,
    "read_only": 503,
    "quota_exceeded": 413,
    "backpressure": 429,
    "kernel_not_ready": 422,
    "invalid_request": 400,
    "internal": 500,
}

# code → exception type the client raises. One entry per code; the
# reverse mapping in error_code_for handles subclass fan-in (every
# IntegrityError subclass → "corrupt" except the two specialized ones).
_RAISERS: dict[str, type] = {
    "not_found": KeyError,
    "corrupt": CorruptPageError,
    "read_only": ReadOnlyStoreError,
    "quota_exceeded": QuotaExceededError,
    "backpressure": AdmissionRejectedError,
    "kernel_not_ready": KernelNotReady,
    "invalid_request": ValueError,
    "internal": RemoteStoreError,
}


def error_code_for(exc: BaseException) -> str:
    """Map an exception to its stable wire code (most-specific first)."""
    if isinstance(exc, ReadOnlyStoreError):
        return "read_only"
    if isinstance(exc, (CorruptPageError, CorruptIndexError, IntegrityError)):
        return "corrupt"
    if isinstance(exc, QuotaExceededError):
        return "quota_exceeded"
    if isinstance(exc, AdmissionRejectedError):
        return "backpressure"
    if isinstance(exc, KernelNotReady):
        return "kernel_not_ready"
    if isinstance(exc, KeyError):
        return "not_found"
    if isinstance(exc, ValueError):
        return "invalid_request"
    return "internal"


def http_status_for(code: str) -> int:
    return ERROR_CODES.get(code, 500)


def error_payload(exc: BaseException) -> tuple[int, dict]:
    """(HTTP status, JSON body) for an exception — the server's error path."""
    code = error_code_for(exc)
    message = str(exc) or type(exc).__name__
    if isinstance(exc, KeyError) and exc.args:
        message = str(exc.args[0])  # KeyError str() wraps in quotes
    return http_status_for(code), {"error": {"code": code, "message": message}}


def raise_for_code(code: str, message: str) -> None:
    """Raise the typed exception registered for ``code`` (client side).

    Unknown codes (a newer server) degrade to :class:`RemoteStoreError`
    with the code embedded, so old clients fail loudly but typed.
    """
    exc_type = _RAISERS.get(code)
    if exc_type is None:
        raise RemoteStoreError(f"[{code}] {message}")
    raise exc_type(message)
