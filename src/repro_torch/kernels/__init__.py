"""CUDA kernels for NeurStore's compute hot-spots, with plain versions.

* ``dequant_matmul`` / ``dequant_matmul_int4`` — fused compute-on-compressed
  matmul (paper §4.3): the weight is dequantized in registers inside the
  product, so the full-precision weight never exists in device memory.
* ``quantized_l2`` — batched quantized-L2 distance (the paper's AVX2
  ``QuantizedL2Space``, §5), the HNSW distance block.
* ``flash_attention`` — forward softmax attention, grouped GQA with causal,
  local-window and key-length masks: the model stack's attention.

The sources live in ``repro_torch/csrc/`` and are built by ``_build`` at
first use; ``ops.py`` holds the dispatch seams and ``ref.py`` the plain
PyTorch versions the wrappers use for CPU tensors. The kernel wrappers
themselves are ``ops.dequant_matmul``, ``ops.dequant_matmul_int4``,
``ops.quantized_l2`` and ``ops.flash_attention``; the package names
``dequant_matmul``, ``quantized_l2`` and ``flash_attention`` stay the
submodules.
"""

from . import ops, ref
from .ops import dequant_matmul_auto, dequant_matmul_int4, pack_int4, quantized_l2_auto

__all__ = [
    "dequant_matmul_auto",
    "dequant_matmul_int4",
    "ops",
    "pack_int4",
    "quantized_l2_auto",
    "ref",
]
