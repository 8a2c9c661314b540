"""jamba-v0.1-52b [hybrid] — Mamba + attention 7:1 interleave, MoE 16
experts top-2 every other layer [arXiv:2403.19887; hf]; the same values
as ``repro.configs.jamba_v01_52b``."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=65536,
    n_experts=16, top_k=2, moe_every=2,
    # one attention layer per 8 (position 4), mamba elsewhere
    block_pattern=("mamba", "mamba", "mamba", "mamba",
                   "attn", "mamba", "mamba", "mamba"),
    ssm_state=16, ssm_conv=4, ssm_expand=2,
    # checkpoint the selective scan so that backpropagation through time
    # keeps only the carried state
    recurrent_step_remat=True,
)

SMOKE = CONFIG.replace(
    name="jamba-v0.1-52b-smoke", n_layers=8, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab=256, n_experts=4, ssm_state=4,
    param_dtype="float32", compute_dtype="float32", remat=False)
