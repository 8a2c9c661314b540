"""internlm2-20b [dense] — GQA [arXiv:2403.17297; hf].
The same values as ``repro.configs.internlm2_20b``."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-20b", family="dense",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=16384, vocab=92544,
)

SMOKE = CONFIG.replace(
    name="internlm2-20b-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab=256,
    param_dtype="float32", compute_dtype="float32", remat=False)
