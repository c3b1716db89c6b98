"""Serving loop: batched greedy decoding over NeurStore-resident models.

The port of the reference's ``repro/launch/serve.py``. A request names a
checkpoint step; the server restores it from the NeurStore engine
(flexible bits), decodes a batch of prompts lock-step through
``decode_step``, and keeps loaded models LRU-style. Runs on the card unless
``device="cpu"``; every step runs under ``torch.inference_mode()``.
"""

from __future__ import annotations

import time
from collections import OrderedDict

import numpy as np
import torch

from ..checkpoint import CheckpointManager
from ..kernels.ops import resolve_device
from ..models import decode_step, init_cache
from ..models.config import ModelConfig

__all__ = ["ModelServer"]


class ModelServer:
    def __init__(self, cfg: ModelConfig, ckpt_dir: str, *,
                 max_models: int = 2, bits: int | None = 8, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mgr = CheckpointManager(ckpt_dir, device=self.device)
        self.bits = bits
        self.max_models = max_models
        self._models: OrderedDict[int, dict] = OrderedDict()

    # ------------------------------------------------------------ model mgmt
    def load(self, step: int | None = None) -> int:
        """Load a checkpointed model (flexible-bit) into the server cache."""
        if step is None:
            step = self.mgr.latest_step()
            if step is None:
                raise ValueError("no checkpoints available")
        if step in self._models:
            self._models.move_to_end(step)
            return step
        step, state = self.mgr.restore(step, bits=self.bits)
        self._models[step] = state["params"]
        while len(self._models) > self.max_models:  # LRU eviction
            self._models.popitem(last=False)
        return step

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # --------------------------------------------------------------- serving
    @torch.inference_mode()
    def generate(self, model_step: int, prompts: np.ndarray,
                 max_new_tokens: int = 16) -> tuple[np.ndarray, dict]:
        """Greedy decode a batch. prompts: (B, S0) int. Returns the (B,
        max_new_tokens) int32 tokens and latency stats (prompt teacher-forced
        through decode steps; batched lock-step)."""
        params = self._models[model_step]
        cfg = self.cfg
        b, s0 = prompts.shape
        toks = torch.as_tensor(np.asarray(prompts), dtype=torch.int64, device=self.device)
        cache = init_cache(cfg, b, s0 + max_new_tokens, device=self.device)
        t0 = time.perf_counter()
        for t in range(s0):
            logits, cache = decode_step(params, cache, {"tokens": toks[:, t:t + 1]}, t, cfg)
        self._sync()
        t_prefill = time.perf_counter() - t0
        out = []
        tok = torch.argmax(logits[:, -1:], dim=-1)
        t0 = time.perf_counter()
        for i in range(max_new_tokens):
            out.append(tok)
            logits, cache = decode_step(params, cache, {"tokens": tok}, s0 + i, cfg)
            tok = torch.argmax(logits[:, -1:], dim=-1)
        self._sync()
        t_decode = time.perf_counter() - t0
        stats = {
            "prefill_s": t_prefill,
            "decode_s": t_decode,
            "tokens_per_s": b * max_new_tokens / max(t_decode, 1e-9),
        }
        return torch.cat(out, dim=1).to(torch.int32).cpu().numpy(), stats
