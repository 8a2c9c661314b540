"""qwen2.5-3b [dense] — GQA kv=2, QKV bias [hf:Qwen/Qwen2.5-3B; hf].
The same values as ``repro.configs.qwen25_3b``."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-3b", family="dense",
    n_layers=36, d_model=2048, n_heads=16, n_kv_heads=2,
    d_ff=11008, vocab=151936,
    qkv_bias=True,
)

SMOKE = CONFIG.replace(
    name="qwen2.5-3b-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab=256,
    param_dtype="float32", compute_dtype="float32", remat=False)
