"""deepseek-7b [dense] — llama-arch, MHA (kv=32) [arXiv:2401.02954; hf].
The same values as ``repro.configs.deepseek_7b``."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b", family="dense",
    n_layers=30, d_model=4096, n_heads=32, n_kv_heads=32,
    d_ff=11008, vocab=102400,
)

SMOKE = CONFIG.replace(
    name="deepseek-7b-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, d_ff=128, vocab=256,
    param_dtype="float32", compute_dtype="float32", remat=False)
