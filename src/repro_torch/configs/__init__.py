"""Assigned-architecture registry: --arch <id> → (CONFIG, SMOKE).

Copies of the reference's ``repro/configs``, on the port's ``ModelConfig``.
"""

import importlib

ARCHS = [
    "recurrentgemma-9b",
    "deepseek-67b",
    "internlm2-1.8b",
    "glm4-9b",
    "qwen3-8b",
    "granite-moe-3b-a800m",
    "arctic-480b",
    "rwkv6-7b",
    "hubert-xlarge",
    "llava-next-34b",
]


def _module(arch_id: str):
    mod = arch_id.replace("-", "_").replace(".", "_")
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(arch_id: str, smoke: bool = False):
    m = _module(arch_id)
    return m.SMOKE if smoke else m.CONFIG


def list_archs() -> list[str]:
    return list(ARCHS)
