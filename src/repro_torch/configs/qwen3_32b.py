"""Qwen3-32B: dense, qk_norm, GQA kv=8, head_dim=128 (Qwen3 family uses
explicit head_dim 128 independent of d_model/n_heads).  [hf:Qwen/Qwen3-8B]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=64, n_kv_heads=8, d_ff=25600,
    vocab=151936, head_dim=128, qk_norm=True, source="hf:Qwen/Qwen3-8B")
