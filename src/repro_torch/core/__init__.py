"""NeurStore core: tensor-based storage engine, delta quantization, loader."""

from .bufferpool import BufferPool, PageFrame
from .catalog import Catalog, CatalogState, ModelEntry
from .compressed import CompressedModel, CompressedTensor
from .engine import DEFAULT_TAU, DEFAULT_TOLERANCE, SaveReport, StorageEngine
from .faultfs import FaultCrash, FaultFS, FaultInjected, FaultPlan
from .hnsw import HNSWIndex, quantized_l2_batch
from .integrity import (
    CorruptIndexError,
    CorruptJournalError,
    CorruptMetaError,
    CorruptPageError,
    IntegrityError,
    ReadOnlyStoreError,
)
from .loader import (
    CompressedParams,
    KernelNotReady,
    LoadedModel,
    ModelSnapshot,
    PipelineLoader,
    materialize_many,
    reconstruct_torch,
)
from .maintenance import MaintenanceDaemon
from .quantize import (
    QuantMeta,
    delta_nbit,
    dequantize_delta,
    dequantize_linear,
    dequantize_linear_batch,
    extract_msb,
    quantize_delta,
    quantize_linear,
    quantize_linear_batch,
)

__all__ = [
    "BufferPool",
    "Catalog",
    "CatalogState",
    "CompressedModel",
    "CompressedParams",
    "CompressedTensor",
    "CorruptIndexError",
    "CorruptJournalError",
    "CorruptMetaError",
    "CorruptPageError",
    "DEFAULT_TAU",
    "DEFAULT_TOLERANCE",
    "FaultCrash",
    "FaultFS",
    "FaultInjected",
    "FaultPlan",
    "HNSWIndex",
    "IntegrityError",
    "KernelNotReady",
    "ReadOnlyStoreError",
    "MaintenanceDaemon",
    "ModelEntry",
    "ModelSnapshot",
    "LoadedModel",
    "PageFrame",
    "PipelineLoader",
    "QuantMeta",
    "SaveReport",
    "StorageEngine",
    "delta_nbit",
    "dequantize_delta",
    "dequantize_linear",
    "dequantize_linear_batch",
    "extract_msb",
    "materialize_many",
    "quantize_delta",
    "quantize_linear",
    "quantize_linear_batch",
    "quantized_l2_batch",
    "reconstruct_torch",
]
