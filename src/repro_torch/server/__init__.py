"""Networked front door for the model store.

``ModelStoreServer`` serves one :class:`~repro_torch.core.engine.StorageEngine`
over HTTP (stdlib ``ThreadingHTTPServer`` — no framework dependency);
``StoreClient`` is the matching typed client. Both speak the shared
dataclasses from :mod:`repro_torch.store.api` and the error-code registry from
:mod:`repro_torch.store.errors`, so embedded and served access are the same
API with a socket in between. See ``docs/serving.md``.

Run a server from the command line::

    python -m repro_torch.server --store /path/to/store --port 8750
"""

from .admission import AdmissionPolicy
from .app import ModelStoreServer
from .client import StoreClient
from .quota import QuotaManager, split_tenant, tenant_model_name
from .wire import STREAM_VERSION, WireError

__all__ = [
    "AdmissionPolicy",
    "ModelStoreServer",
    "QuotaManager",
    "STREAM_VERSION",
    "StoreClient",
    "WireError",
    "split_tenant",
    "tenant_model_name",
]
