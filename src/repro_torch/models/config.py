"""Model configuration system.

One ``ModelConfig`` describes any architecture in the assigned pool
(dense / moe / hybrid / ssm / audio / vlm).  Configs are registered by id
in ``repro_torch.configs`` and selectable via ``--arch <id>`` in the launchers.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None  # default d_model // n_heads
    # attention options
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    sliding_window: Optional[int] = None   # decode-time window (long_500k)
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_group_size: int = 256      # tokens per dispatch group
    # SSM / hybrid
    ssm_state: int = 0             # mamba N (hymba) / used as chunk hint
    # frontend stubs ([audio]/[vlm] carve-out)
    frontend: str = "none"         # none | vlm
    n_frontend_tokens: int = 0     # e.g. 256 ViT patches
    d_frontend: int = 0            # frontend embedding width
    # performance knobs (§Perf hillclimbing; defaults = paper-faithful
    # baseline, flips recorded in EXPERIMENTS.md)
    tp_head_aligned: bool = False   # shard attn projections only on whole
                                    # heads (replicate if heads % tp != 0)
    megatron_ffn: bool = False      # column-parallel w_gate/w_up +
                                    # row-parallel w_down
    loss_fp32_logits: bool = True   # False: CE with f16 logits + f32 accum
    ssm_scan_f32: bool = True       # False: associative-scan elems in f16
    attn_scores_f32: bool = True    # False: keep score chunks in f16
    seq_parallel: bool = False      # sequence-parallel activations between
                                    # TP regions (psum_scatter/all_gather
                                    # conjugates; needs ffn+vocab to shard)
    attn_batch_shard: bool = False  # context-parallel attention: shard the
                                    # (local) batch over 'model' instead of
                                    # splitting heads (for heads % tp != 0)
    flash_attention: bool = True    # blocked online-softmax train/prefill
                                    # attention (custom-VJP Pallas kernel;
                                    # falls back to chunked when the shape
                                    # doesn't tile — ``supports()``)
    remat_policy: str = "full"      # full | none | dots | dots_batch |
                                    # offload_dots — what jax.checkpoint
                                    # saves across the layer-scan body
    bf16_residency: bool = False    # keep scores/logits resident in the
                                    # compute dtype; f32 only inside matmul
                                    # accumulation epilogues
    overlap_collectives: bool = True  # decompose model-axis psums into
                                    # double-buffered ppermute chunk rings
                                    # (overlappable with compute)
    dense_embed_grad: bool = True   # one-hot matmul backward for the
                                    # embedding table (no serial
                                    # scatter-add loop on CPU/XLA)
    # numerics / structure
    dtype: str = "bfloat16"
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    attn_chunk: int = 512          # query-chunked attention block
    scan_chunk: int = 128          # ssm/linear-attn time chunk
    # citation for the config (source paper / model card)
    source: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.hd

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.hd

    # ------------------------------------------------------------- params
    def param_count(self) -> int:
        """Total parameter count (all experts)."""
        return _count(self, active_only=False)

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k experts only) — the N in
        MODEL_FLOPS = 6·N_active·D."""
        return _count(self, active_only=True)

    # -------------------------------------------------------------- smoke
    def smoke(self) -> "ModelConfig":
        """Reduced same-family variant for CPU smoke tests
        (<=2 layers, d_model<=512, <=4 experts)."""
        d = 256
        heads = 4
        kv = max(1, min(self.n_kv_heads, 2))
        return dataclasses.replace(
            self, name=self.name + "-smoke", n_layers=2, d_model=d,
            n_heads=heads, n_kv_heads=kv, head_dim=d // heads,
            d_ff=(2 * d if self.d_ff else 0), vocab=512,
            n_experts=(4 if self.n_experts else 0),
            top_k=(min(2, self.top_k) if self.top_k else 0),
            moe_group_size=32,
            n_frontend_tokens=(8 if self.n_frontend_tokens else 0),
            d_frontend=(64 if self.d_frontend else 0),
            attn_chunk=32, scan_chunk=16, dtype="float32")


def _count(cfg: ModelConfig, active_only: bool) -> int:
    D, L, V = cfg.d_model, cfg.n_layers, cfg.vocab
    n = V * D                      # embed
    if not cfg.tie_embeddings:
        n += D * V                 # lm_head
    n += D                         # final norm
    if cfg.frontend == "vlm":
        n += cfg.d_frontend * D
    per_layer = 2 * D              # two norms
    if cfg.family != "ssm":
        per_layer += D * cfg.q_dim + 2 * D * cfg.kv_dim + cfg.q_dim * D
        if cfg.qkv_bias:
            per_layer += cfg.q_dim + 2 * cfg.kv_dim
        if cfg.qk_norm:
            per_layer += 2 * cfg.hd
    if cfg.family == "moe":
        e = cfg.top_k if active_only else cfg.n_experts
        per_layer += D * cfg.n_experts            # router
        per_layer += e * 3 * D * cfg.d_ff
    elif cfg.family == "ssm":
        # mLSTM mixer + gated projection block
        per_layer += 3 * D * cfg.q_dim + cfg.q_dim * D   # q,k,v,o
        per_layer += 2 * D * cfg.n_heads                 # i,f gates
        per_layer += 2 * D * 2 * D + 2 * D * D           # gated proj (up2x, gate, down)
    elif cfg.family == "hybrid":
        Di = D
        per_layer += D * 2 * Di + Di * D                 # mamba in/out
        per_layer += Di * (1 + 2 * cfg.ssm_state)        # dt, B, C proj (per ch)
        per_layer += Di * cfg.ssm_state + Di             # A, skip D
        per_layer += 3 * D * cfg.d_ff
    else:                          # dense / audio / vlm
        per_layer += 3 * D * cfg.d_ff
    return n + L * per_layer
