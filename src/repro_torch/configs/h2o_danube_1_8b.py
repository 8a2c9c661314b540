"""h2o-danube-1.8b [dense] — llama+mistral mix with sliding-window
attention [arXiv:2401.16818; hf].  SWA makes long_500k decode O(window).
The same values as ``repro.configs.h2o_danube_1_8b``."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b", family="dense",
    n_layers=24, d_model=2560, n_heads=32, n_kv_heads=8,
    d_ff=6912, vocab=32000,
    window=4096,
)

SMOKE = CONFIG.replace(
    name="h2o-danube-1.8b-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab=256, window=8,
    param_dtype="float32", compute_dtype="float32", remat=False)
