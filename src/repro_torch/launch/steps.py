"""Train, prefill, serve and evaluation steps over the model stack.

The port of the reference's ``repro/launch/steps.py``: ``make_train_step``
is the microbatched step (gradient sums over microbatches, the
remat-per-period forward, AdamW), ``make_prefill_step`` a full forward
returning last-position logits, ``make_serve_step`` one greedy decode token
against the cache and ``make_eval_step`` the loss. ``jax.jit`` and
``lax.scan`` have no counterpart: each step runs eagerly, the microbatches
in a Python loop, and the prefill, serve and eval steps under
``torch.inference_mode()`` (``torch.no_grad()`` in a tensor-parallel
step: a view of a DTensor made outside inference mode cannot be taken
inside it).
"""

from __future__ import annotations

import functools

import torch

from ..distributed import sharding as sh
from ..models import decode_step, forward, loss_fn
from ..models.config import ModelConfig
from ..optim import adamw_update
from ..tree import tree_leaves, tree_map

__all__ = ["make_eval_step", "make_prefill_step", "make_serve_step", "make_train_step",
           "pick_microbatches"]


def pick_microbatches(cfg: ModelConfig, global_batch: int) -> int:
    """Microbatch count heuristic: keep per-microbatch tokens ≲ 128k for
    big-d models (activation + logits memory), ≲ 256k otherwise."""
    micro = 16 if cfg.d_model > 4096 or cfg.n_experts >= 64 else 32
    micro = min(micro, global_batch)
    while global_batch % micro:
        micro //= 2
    return max(global_batch // micro, 1)


def make_train_step(cfg: ModelConfig, n_microbatches: int = 1, *,
                    lr: float = 1e-4, grad_dtype=None):
    """Returns train_step(params, opt_state, batch) → (params, opt, metrics).

    The batch is split on dim 0 into ``n_microbatches`` equal parts; each
    part's loss is differentiated with respect to every parameter, the
    gradients summed in ``grad_dtype`` (float32 by default) and divided by
    the count, and ``metrics["loss"]`` is the mean of the parts' losses.
    With one microbatch the gradients stay in the parameters' dtypes, as in
    the reference. Inside ``launch.shardings.sharded`` each data-parallel
    rank runs this on its own rows, and the losses and gradients are summed
    over the ranks before the division (by microbatches × ranks); the
    gradients of a rank's own experts (``sh.expert_parallel``) only over
    the ranks that hold the same experts. Then one ``adamw_update``; the
    inputs are left as they were.
    """
    acc_dtype = grad_dtype or torch.float32

    def value_and_grad(params, batch):
        # Differentiable views of the parameters (storage shared, no copy).
        diff = tree_map(lambda p: p.detach().requires_grad_(True), params)
        with torch.enable_grad():
            loss = loss_fn(diff, batch, cfg)[0]
            leaves = tree_leaves(diff)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else _placed_like(g, p)
                 for p, g in zip(leaves, grads)]
        it = iter(grads)
        return loss.detach(), tree_map(lambda _: next(it), params)

    def train_step(params, opt_state, batch):
        if n_microbatches == 1:
            loss, grads = value_and_grad(params, batch)
        else:
            size = next(iter(batch.values())).shape[0]
            if size % n_microbatches:
                raise ValueError(f"a batch of {size} does not split into {n_microbatches} "
                                 "equal microbatches")
            parts = {k: v.reshape((n_microbatches, size // n_microbatches) + v.shape[1:])
                     for k, v in batch.items()}
            grads = tree_map(lambda p: torch.zeros_like(p, dtype=acc_dtype), params)
            loss = 0.0
            for i in range(n_microbatches):
                part_loss, part = value_and_grad(params, {k: v[i] for k, v in parts.items()})
                grads = tree_map(lambda a, g: a + g.to(acc_dtype), grads, part)
                loss = loss + part_loss
        # Inside a sharded step (launch.shardings.sharded) the sums over the
        # data-parallel ranks, each of which computed on its own rows, as
        # GSPMD reduces the reference's gradients; outside one, unchanged.
        # A rank's own experts' gradients already hold every rank's rows
        # (the exchange's backward): they are not summed over the ranks
        # that hold other experts, but divided by n as the rest are.
        n = n_microbatches * sh.data_parallel_size()
        loss, grads = sh.data_parallel_sum(loss), sh.data_parallel_sum(grads, like=params)
        if n > 1:
            loss, grads = loss / n, tree_map(lambda g: g / n, grads)
        params, opt_state = adamw_update(params, grads, opt_state, lr=lr)
        return params, opt_state, {"loss": loss}

    return train_step


def _placed_like(grad, param):
    """A parameter's gradient laid out as the parameter is. In a
    tensor-parallel step a replicated weight met by split activations (a
    norm's scale on the sequence-split residual) has a partial gradient
    over ``model``: it is summed here, once a microbatch. A sharded
    weight's gradient keeps its shard."""
    if not hasattr(param, "placements") or tuple(grad.placements) == tuple(param.placements):
        return grad
    return grad.redistribute(param.device_mesh, param.placements)


def _inference(fn):
    """``fn`` under ``torch.inference_mode()``, or ``torch.no_grad()``
    inside a tensor-parallel step."""
    @functools.wraps(fn)
    def run(*args):
        with torch.inference_mode() if sh.compute_mesh() is None else torch.no_grad():
            return fn(*args)
    return run


def make_eval_step(cfg: ModelConfig):
    @_inference
    def eval_step(params, batch):
        return loss_fn(params, batch, cfg)[0]
    return eval_step


def make_prefill_step(cfg: ModelConfig):
    @_inference
    def prefill_step(params, batch):
        logits = forward(params, batch, cfg)
        return logits[:, -1, :].to(torch.float32)  # (B, V)
    return prefill_step


def make_serve_step(cfg: ModelConfig):
    """One greedy decode token for the whole batch."""

    @_inference
    def serve_step(params, cache, batch, pos):
        logits, new_cache = decode_step(params, cache, batch, pos, cfg)
        # Vocabulary-split logits gathered (B × V) for the argmax.
        next_tok = torch.argmax(sh.unsplit(logits[:, -1, :], 1), dim=-1).to(torch.int32)
        return next_tok, new_cache

    return serve_step
