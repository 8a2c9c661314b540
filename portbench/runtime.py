"""What every driver shares: the device's description, the check that no
JAX module was loaded, the comparison of readings with their limits, and
freeing the program's memory before the reference runs."""

from __future__ import annotations

import gc
import math
import subprocess
import sys

import torch

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def model_config(model: dict):
    """The program's ``ModelConfig`` of a configuration file's ``model``
    (its lists as tuples)."""
    from repro_torch.models.config import ModelConfig
    return ModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                          for k, v in model.items()})


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is
    ``jax``, ``jaxlib``, ``flax`` or the JAX package ``repro``, compared
    whole: ``repro_torch`` is not ``repro``."""
    mods = sys.modules if modules is None else modules
    return sorted(m for m in mods if m.split(".", 1)[0] in FORBIDDEN)


def power_limit_w():
    """The card's power limit (W) as ``nvidia-smi`` reads it, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=20)
        return float(out.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def device_info(device: torch.device, chips: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": chips}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": chips, "power_limit_w": power_limit_w()}


def synchronizer(device: torch.device):
    return torch.cuda.synchronize if device.type == "cuda" else None


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def free_memory(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def judge(readings: dict, limits: dict) -> tuple[bool, dict]:
    """``(correct, checks)``: every number that the limits file names
    against its limit; a reading that is missing or not finite fails."""
    checks, ok = {}, True
    for name, spec in limits["numbers"].items():
        v = readings.get(name)
        good = v is not None and math.isfinite(v) and v <= spec["limit"]
        ok = ok and good
        checks[name] = {"value": v, "limit": spec["limit"]}
    return ok, checks


def p95(values) -> float:
    """The 95th percentile by nearest rank (the value at rank
    ``ceil(0.95 n)``)."""
    v = sorted(values)
    return v[max(0, math.ceil(0.95 * len(v)) - 1)]
