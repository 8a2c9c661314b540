"""internvl2-2b [vlm] — InternViT + InternLM2 [arXiv:2404.16821; hf].
The ViT frontend is a stub: ``configs.shapes.input_specs`` gives
precomputed patch embeddings (256 tokens after pixel-shuffle).  The same
values as ``repro.configs.internvl2_2b``."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b", family="vlm",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8,
    d_ff=8192, vocab=92553,
    frontend="vit_stub", n_frontend_tokens=256,
)

SMOKE = CONFIG.replace(
    name="internvl2-2b-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab=256, n_frontend_tokens=8,
    param_dtype="float32", compute_dtype="float32", remat=False)
