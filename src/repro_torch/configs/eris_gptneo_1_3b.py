"""GPT-Neo-1.3B-scale decoder — the paper's own largest model
(CNN/DailyMail experiments, Table 1).  [arXiv: Black et al. 2021]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="eris-gptneo-1.3b", family="dense",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=8192,
    vocab=50257, source="paper Sec. 4.1 / zenodo.5297715")
