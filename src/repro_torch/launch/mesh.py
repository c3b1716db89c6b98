"""Device mesh builders over the live process group, and the card's rates.

The port of the reference's ``repro/launch/mesh.py``. Functions, never
module-level constants, so importing this module touches no process group.
Every builder makes a ``torch.distributed.device_mesh.DeviceMesh`` with
``mesh_dim_names`` over the default process group, which the caller has
initialized (``dist.init_process_group``: NCCL on the cards, gloo on the
CPU, the fake group of ``launch/dryrun.py`` for the production shapes).
The mesh's size must be the group's world size.

The production meshes keep the reference's shapes, 16 × 16 and 2 × 16 × 16,
so that their spec trees can be held against the reference's. On H100s a
``model`` axis of 16 spans two 8-GPU NVLink domains, so the collective
term of a roofline over these rates is a lower bound.
"""

from __future__ import annotations

__all__ = ["BF16_PEAK_FLOPS", "HBM_BW", "NVLINK_BW", "make_host_mesh", "make_mesh",
           "make_production_mesh"]

# One NVIDIA H100 80GB HBM3 (SXM) at its 700.00 W power limit, the card
# chip_smoke.py runs on: the published dense bf16 tensor-core rate and the
# HBM3 rate (chip_smoke.py's BF16_TC_PEAK and HBM_SXM), and NVLink 4's
# 900 GB/s a card, 450 GB/s each way, in place of the TPU's ICI link.
BF16_PEAK_FLOPS = 989e12       # per card
HBM_BW = 3.35e12               # bytes/s per card
NVLINK_BW = 450e9              # bytes/s per card, one direction


def _device_type(device: str) -> str:
    import torch

    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a mesh on 'cuda' needs a CUDA card; pass device='cpu' "
                           "(gloo) to build one on the CPU")
    return device


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], device: str = "cuda"):
    """A mesh of ``shape`` with axis names ``axes`` (tests, small pipelines)."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(_device_type(device), tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda"):
    """16×16 single-pod (256 ranks) or 2×16×16 multi-pod (512 ranks)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def make_host_mesh(model_parallel: int = 1, device: str = "cuda"):
    """Every rank of the process group as ("data", "model")."""
    import torch.distributed as dist

    n = dist.get_world_size()
    if n % model_parallel:
        raise ValueError(f"{n} ranks do not split into model-parallel groups of "
                         f"{model_parallel}")
    return make_mesh((n // model_parallel, model_parallel), ("data", "model"), device)
