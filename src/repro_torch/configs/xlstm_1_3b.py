"""xlstm-1.3b [ssm] — mLSTM and sLSTM blocks (7:1) [arXiv:2405.04517;
unverified]; the same values as ``repro.configs.xlstm_1_3b``.  d_ff=0:
the xLSTM blocks carry their own projections."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab=50304,
    block_pattern=("mlstm", "mlstm", "mlstm", "mlstm",
                   "mlstm", "mlstm", "mlstm", "slstm"),
    # the chunkwise mLSTM (128 tokens a chunk) and the per-step remat
    xlstm_chunk=128,
    recurrent_step_remat=True,
)

SMOKE = CONFIG.replace(
    name="xlstm-1.3b-smoke", n_layers=8, d_model=64,
    param_dtype="float32", compute_dtype="float32", remat=False)
