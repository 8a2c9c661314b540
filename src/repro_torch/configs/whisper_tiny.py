"""whisper-tiny [audio] — enc-dec, conv frontend (stub)
[arXiv:2212.04356; unverified].  ``configs.shapes.input_specs`` gives
precomputed frame embeddings (1500 frames).  The same values as
``repro.configs.whisper_tiny``."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny", family="audio",
    n_layers=4, d_model=384, n_heads=6, n_kv_heads=6,
    d_ff=1536, vocab=51865,
    encoder_layers=4, frontend="audio_stub", n_frontend_tokens=1500,
    norm="layernorm", act="gelu", rope_theta=0.0,
)

SMOKE = CONFIG.replace(
    name="whisper-tiny-smoke", n_layers=2, encoder_layers=2, d_model=64,
    n_heads=4, n_kv_heads=4, d_ff=128, vocab=256, n_frontend_tokens=16,
    param_dtype="float32", compute_dtype="float32", remat=False)
