"""OLMoE-1B-7B: 64 experts, top-8, d_ff=1024 per expert.  [arXiv:2409.02060]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b", family="moe",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=1024,
    vocab=50304, n_experts=64, top_k=8, source="arXiv:2409.02060")
