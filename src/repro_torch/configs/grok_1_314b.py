"""grok-1-314b [moe] — 8 experts top-2 [hf:xai-org/grok-1; unverified].
The same values as ``repro.configs.grok_1_314b``."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b", family="moe",
    n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=32768, vocab=131072,
    n_experts=8, top_k=2,
)

# Reduced same-family config for CPU smoke tests.
SMOKE = CONFIG.replace(
    name="grok-1-314b-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab=256, n_experts=4,
    param_dtype="float32", compute_dtype="float32", remat=False)
