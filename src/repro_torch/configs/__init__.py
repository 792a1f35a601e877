"""Architecture registry of the port: the configs ported so far.

``get_config(arch)`` / ``get_smoke_config(arch)`` mirror the reference's
``repro/configs`` entry points for the architectures listed here.
"""
from __future__ import annotations

from ..models.config import ModelConfig
from . import jamba_1_5_large_398b, stablelm_1_6b

_MODULES = {
    "jamba-1.5-large-398b": jamba_1_5_large_398b,
    "stablelm-1.6b": stablelm_1_6b,
}


def get_config(arch: str) -> ModelConfig:
    return _MODULES[arch].config()


def get_smoke_config(arch: str) -> ModelConfig:
    return _MODULES[arch].smoke_config()
