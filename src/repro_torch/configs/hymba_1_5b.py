"""Hymba-1.5B: hybrid-head model — parallel attention + mamba heads per
layer, ssm_state=16.  [arXiv:2411.13676]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, d_ff=5504,
    vocab=32001, ssm_state=16, source="arXiv:2411.13676")
