"""MusicGen-medium: decoder-only over EnCodec tokens (audio backbone only;
the mel/conv codec frontend is the allowed stub — tokens are the input).
[arXiv:2306.05284]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium", family="audio",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24, d_ff=6144,
    vocab=2048, source="arXiv:2306.05284")
