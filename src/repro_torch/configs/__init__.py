"""Architecture registry of the port: the reference's ten archs
(``repro.configs``), each config equal to the reference's field for
field, and the shape cells (``configs.shapes``).

``NOT_PORTED`` names archs the registry knows but the port cannot build
yet, so that asking for one says why it is missing; every arch is
ported, so it is empty.
"""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig
from .shapes import SHAPES, ShapeCell, applicable, input_specs

_MODULES = {
    "grok-1-314b": "grok_1_314b",
    "phi3.5-moe-42b": "phi35_moe_42b",
    "jamba-v0.1-52b": "jamba_v01_52b",
    "xlstm-1.3b": "xlstm_1_3b",
    "internvl2-2b": "internvl2_2b",
    "internlm2-20b": "internlm2_20b",
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "deepseek-7b": "deepseek_7b",
    "qwen2.5-3b": "qwen25_3b",
    "whisper-tiny": "whisper_tiny",
}

NOT_PORTED: tuple[str, ...] = ()

ARCH_NAMES = tuple(_MODULES)


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"arch {name!r} is not ported to repro_torch yet; ROADMAP.md "
            f"lists the slices still to come (ported: {ARCH_NAMES})")
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; have {ARCH_NAMES}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.SMOKE if smoke else mod.CONFIG


def list_configs() -> dict[str, ModelConfig]:
    return {n: get_config(n) for n in ARCH_NAMES}


__all__ = ["ARCH_NAMES", "NOT_PORTED", "SHAPES", "ShapeCell", "applicable",
           "get_config", "input_specs", "list_configs"]
