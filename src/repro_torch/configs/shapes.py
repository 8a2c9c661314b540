"""Input-shape cells and per-arch applicability (port of
``repro.configs.shapes``).

Four shapes per LM arch (40 cells total):
  train_4k    seq=4096   global_batch=256   (training:  train_step)
  prefill_32k seq=32768  global_batch=32    (inference: prefill last-logit)
  decode_32k  seq=32768  global_batch=128   (serve_step, KV cache = seq)
  long_500k   seq=524288 global_batch=1     (serve_step, sub-quadratic only)

``long_500k`` runs only for architectures whose decode state is
sub-quadratic in context: SSM/hybrid state (jamba, xlstm) or sliding-
window KV (h2o-danube).  Pure full-attention archs skip it.

:func:`input_specs` gives tensors on the ``meta`` device where the
reference gives ``jax.ShapeDtypeStruct``: shapes and dtypes, no storage.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.models.config import ModelConfig


@dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str        # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}

# archs with sub-quadratic long-context decode
_SUBQUADRATIC = {"jamba-v0.1-52b", "xlstm-1.3b", "h2o-danube-1.8b"}


def applicable(cfg: ModelConfig, shape: ShapeCell) -> tuple[bool, str]:
    """(runs?, reason-if-skipped)."""
    if shape.name == "long_500k" and cfg.name not in _SUBQUADRATIC:
        return False, ("full-attention KV cache at 524288 tokens is "
                       "quadratic-state; skipped per assignment rules")
    return True, ""


def _meta(*shape, dtype=torch.int32):
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeCell, *, reduced: bool = False):
    """Meta-tensor stand-ins for every model input of this cell; a decode
    cell gives ``tokens_t`` and the ints ``cache_len`` and ``batch``.

    ``reduced`` scales batch/seq down for smoke testing the same code path.
    """
    S = shape.seq_len if not reduced else 32
    B = shape.global_batch if not reduced else 4
    frontend = cfg.frontend is not None or cfg.encoder_layers
    nf = cfg.n_frontend_tokens if not reduced else 8

    if shape.kind == "train":
        batch = {"tokens": _meta(B, S), "labels": _meta(B, S),
                 "mask": _meta(B, S, dtype=torch.float32)}
        if frontend:
            batch["frontend_embeds"] = _meta(B, nf, cfg.d_model,
                                             dtype=torch.float32)
        return batch
    if shape.kind == "prefill":
        out = {"tokens": _meta(B, S)}
        if frontend:
            out["frontend_embeds"] = _meta(B, nf, cfg.d_model,
                                           dtype=torch.float32)
        return out
    if shape.kind == "decode":
        # one new token; the cache covers `seq_len` context
        return {"tokens_t": _meta(B, 1), "cache_len": S, "batch": B}
    raise ValueError(shape.kind)
