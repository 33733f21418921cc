"""Architecture configs (one module per architecture, as in
``repro/configs``): all ten of the reference's.

``get_config(name)`` returns the full ModelConfig; ``get_reduced(name)`` a
same-family small config for CPU tests.
"""
from __future__ import annotations

import importlib

ARCHS = ["chatglm3-6b", "deepseek-v2-lite-16b", "gemma3-4b",
         "h2o-danube-1.8b", "llava-next-34b", "qwen3-moe-235b-a22b",
         "stablelm-3b", "whisper-large-v3", "xlstm-1.3b", "zamba2-7b"]


def _mod(name: str):
    if name not in ARCHS:
        raise KeyError(f"{name!r} is no architecture; known: {ARCHS}")
    key = name.replace("-", "_").replace(".", "_")
    return importlib.import_module(f"{__name__}.{key}")


def get_config(name: str):
    return _mod(name).config()


def get_reduced(name: str):
    return _mod(name).reduced()


def list_archs():
    return list(ARCHS)
