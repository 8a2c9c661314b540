"""Model configuration: the fields of ``repro.models.config.ModelConfig``,
with torch dtypes.

Every field of the reference is kept, so a config reads the same in both
packages.  ``attention_impl`` is kept
for parity only: the port's ops choose the kernel by the tensor's device
(``kernels.ops``), not by this string.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}

# Copy of ``repro.core.plan.BACKENDS``: importing ``repro`` pulls in jax.
A2A_BACKENDS = ("tuned", "autotune", "direct", "factorized", "pipelined",
                "overlap")


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense|moe|hybrid|ssm|vlm|audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int                         # 0 => no separate FFN (xLSTM)
    vocab: int
    head_dim: int | None = None       # default d_model // n_heads

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 2
    capacity_factor: float | None = 1.25   # None = dropless
    router_aux_weight: float = 0.01
    moe_every: int = 1

    # --- attention ---
    window: int | None = None         # sliding-window size (SWA)
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    attention_impl: str = "xla"       # parity only; see module docstring

    # --- layer mixer pattern (repeating) ---
    block_pattern: tuple[str, ...] = ("attn",)

    # --- ssm / xlstm / spectral ---
    ssm_state: int = 16
    ssm_conv: int = 4
    ssm_expand: int = 2
    spectral_long_conv: bool = False
    xlstm_chunk: int = 0
    recurrent_step_remat: bool = False

    # --- frontends / enc-dec ---
    frontend: str | None = None
    n_frontend_tokens: int = 0
    encoder_layers: int = 0

    # --- numerics ---
    norm: str = "rmsnorm"             # rmsnorm | layernorm
    act: str = "swiglu"               # swiglu | gelu
    tie_embeddings: bool = True
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    remat: bool = True
    remat_policy: str = "nothing"
    z_loss: float = 1e-4

    # --- parallelism hints (the collective slice) ---
    use_ulysses: bool = False
    expert_axes: tuple[str, ...] = ("data",)
    a2a_variant: str = "natural"
    a2a_backend: str = "tuned"
    a2a_chunks: int = 0

    def __post_init__(self):
        if self.n_heads % self.n_kv_heads:
            raise ValueError("n_heads must be divisible by n_kv_heads")
        if self.n_layers % len(self.block_pattern):
            raise ValueError("n_layers must divide into block_pattern")
        if self.a2a_backend not in A2A_BACKENDS:
            raise ValueError(f"unknown a2a_backend {self.a2a_backend!r}; "
                             f"expected one of {A2A_BACKENDS}")

    @property
    def dropless(self) -> bool:
        return self.capacity_factor is None

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def pdtype(self) -> torch.dtype:
        return DTYPES[self.param_dtype]

    @property
    def cdtype(self) -> torch.dtype:
        return DTYPES[self.compute_dtype]

    @property
    def superblock(self) -> tuple[tuple[str, str], ...]:
        """Repeating (mixer, ffn) plan; the stack loops over superblocks."""
        period = len(self.block_pattern)
        if self.moe_every > 1:
            period = math.lcm(period, self.moe_every)
        plan = []
        for i in range(period):
            mixer = self.block_pattern[i % len(self.block_pattern)]
            if self.spectral_long_conv and mixer in ("mamba", "mlstm",
                                                     "slstm"):
                mixer = "spectral"
            if self.d_ff == 0:
                ffn = "none"
            elif self.n_experts and (self.moe_every <= 1
                                     or i % self.moe_every == 1):
                ffn = "moe"
            else:
                ffn = "dense"
            plan.append((mixer, ffn))
        return tuple(plan)

    @property
    def n_superblocks(self) -> int:
        return self.n_layers // len(self.superblock)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
