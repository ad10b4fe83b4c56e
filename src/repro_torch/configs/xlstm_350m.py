"""xLSTM-350M: sLSTM + mLSTM blocks, 4 heads, no separate FFN (gated
in-block projection; d_ff=0 per the assignment).  [arXiv:2405.04517]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m", family="ssm",
    n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4, d_ff=0,
    vocab=50304, source="arXiv:2405.04517")
