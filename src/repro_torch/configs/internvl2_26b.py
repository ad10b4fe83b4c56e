"""InternVL2-26B language backbone (InternLM2-20B-style decoder).  The
InternViT vision encoder is the allowed stub: input_specs provides 256
precomputed patch embeddings (d=1024) per image, projected into d_model.
[arXiv:2404.16821]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b", family="vlm",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=16384,
    vocab=92553, frontend="vlm", n_frontend_tokens=256, d_frontend=1024,
    source="arXiv:2404.16821")
