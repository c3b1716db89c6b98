"""Error-feedback quantized gradient sync for the slow cross-pod hop.

The port of the reference's ``repro/distributed/compression.py``. Within a
pod, gradients reduce over the fast interconnect in bf16 / f32; across
pods (a data-center link, about 10x slower) they sync as int8 with a
per-tensor scale and error feedback. For two pods the quantized all-gather
moves size/4 bytes against 2 x size/2 for a float32 all-reduce, and the
quantization residual is carried to the next step (error feedback keeps
SGD unbiased in the long run; Seide et al. 2014, 1-bit SGD).

* :func:`quantize_grad` / :func:`dequantize_grad`: the pair, for custom
  schedules;
* :func:`cross_pod_sync`: the collective over the ``pod`` dimension of a
  ``torch.distributed.device_mesh.DeviceMesh``, where the reference runs a
  ``shard_map`` over its mesh's ``pod`` axis.

Nothing here creates a process group: the caller builds the mesh.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..tree import tree_map

__all__ = ["cross_pod_sync", "dequantize_grad", "init_error_state", "quantize_grad"]


def quantize_grad(g: torch.Tensor, err, nbit: int = 8):
    """Error-feedback int quantization of one gradient tensor.

    Returns (codes int8, scale float32 0-d, new_err float32);
    dequant = codes * scale. The scale is symmetric and per tensor
    (gradients are zero-centred deltas), ``max(amax / levels, 1e-20)``,
    and codes round half to even, as the reference's ``jnp.round``.
    """
    g32 = g.to(torch.float32) + err
    amax = g32.abs().amax()
    levels = 2 ** (nbit - 1) - 1
    scale = torch.clamp_min(amax / levels, 1e-20)
    codes = torch.clamp(torch.round(g32 / scale), -levels, levels).to(torch.int8)
    deq = codes.to(torch.float32) * scale
    new_err = g32 - deq
    return codes, scale, new_err


def dequantize_grad(codes: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return codes.to(torch.float32) * scale


def init_error_state(grads):
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device), grads)


def cross_pod_sync(grads, err_state, mesh, *, axis: str = "pod", nbit: int = 8):
    """Average gradients across the ``axis`` dimension of ``mesh`` with
    int8 error feedback. Returns (synced grads, new error state).

    Every rank passes its own pod's (already pod-reduced) gradients and
    its error state, trees of the same structure on every rank. Each leaf
    is quantized with its own scale; the codes and the scales are gathered
    over ``mesh.get_group(axis)``, and the leaf's result is the mean of
    the dequantized codes, cast to the gradient's dtype. The collectives
    run on the group's backend (NCCL for tensors on the card).
    """
    group = mesh.get_group(axis)
    n_pods = dist.get_world_size(group)

    def sync_leaf(g, err):
        codes, scale, new_err = quantize_grad(g, err, nbit)
        all_codes = [torch.empty_like(codes) for _ in range(n_pods)]
        dist.all_gather(all_codes, codes, group=group)
        all_scales = [torch.empty(1, dtype=scale.dtype, device=scale.device)
                      for _ in range(n_pods)]
        dist.all_gather(all_scales, scale.reshape(1), group=group)
        deq = torch.stack(all_codes).to(torch.float32) * torch.cat(all_scales).reshape(
            (-1,) + (1,) * codes.ndim)
        return deq.mean(dim=0).to(g.dtype), new_err

    pairs = tree_map(sync_leaf, grads, err_state)
    return (tree_map(lambda _, pair: pair[0], grads, pairs),
            tree_map(lambda _, pair: pair[1], grads, pairs))
