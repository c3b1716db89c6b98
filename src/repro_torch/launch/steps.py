"""Prefill, serve and evaluation steps over the model stack.

The port of the reference's ``repro/launch/steps.py`` (its serving half):
``make_prefill_step`` is a full forward returning last-position logits,
``make_serve_step`` one greedy decode token against the cache and
``make_eval_step`` the loss. ``jax.jit`` has no counterpart: each step runs
eagerly under ``torch.inference_mode()``. ``make_train_step`` and
``pick_microbatches`` wait for the training slice (ROADMAP queue A8).
"""

from __future__ import annotations

import torch

from ..models import decode_step, forward, loss_fn
from ..models.config import ModelConfig

__all__ = ["make_eval_step", "make_prefill_step", "make_serve_step"]


def make_eval_step(cfg: ModelConfig):
    @torch.inference_mode()
    def eval_step(params, batch):
        return loss_fn(params, batch, cfg)[0]
    return eval_step


def make_prefill_step(cfg: ModelConfig):
    @torch.inference_mode()
    def prefill_step(params, batch):
        logits = forward(params, batch, cfg)
        return logits[:, -1, :].to(torch.float32)  # (B, V)
    return prefill_step


def make_serve_step(cfg: ModelConfig):
    """One greedy decode token for the whole batch."""

    @torch.inference_mode()
    def serve_step(params, cache, batch, pos):
        logits, new_cache = decode_step(params, cache, batch, pos, cfg)
        next_tok = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        return next_tok, new_cache

    return serve_step
