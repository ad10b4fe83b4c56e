"""StarCoder2-3B: dense, GQA, RoPE.  [arXiv:2402.19173]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b", family="dense",
    n_layers=30, d_model=3072, n_heads=24, n_kv_heads=2, d_ff=12288,
    vocab=49152, source="arXiv:2402.19173")
