"""The yardstick: one H100's published peaks, and the operations and
bytes of the work the per-layer metrics hold against them, computed from
a configuration's shapes and never read from the program.

Peaks (NVIDIA's H100 SXM data sheet, dense, at the 700 W limit): 989
TFLOP/s bf16 on the tensor cores, 3.35 TB/s of HBM3.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
QBLOCK = 256                    # the int8 wire's block


def head_dim(m: dict) -> int:
    return m.get("head_dim") or m["d_model"] // m["n_heads"]


def matmul_weights_per_token(m: dict) -> int:
    """Weights a token multiplies by on its way through the model: the
    projections, the FFN (for moe the router and its top_k experts) and
    the unembedding; the embedding lookup and norms are no products."""
    D, hd = m["d_model"], head_dim(m)
    Q, KV = m["n_heads"] * hd, m["n_kv_heads"] * hd
    layer = D * Q + 2 * D * KV + Q * D
    if m["family"] == "moe":
        layer += D * m["n_experts"] + m["top_k"] * 3 * D * m["d_ff"]
    else:
        layer += 3 * D * m["d_ff"]
    return m["n_layers"] * layer + D * m["vocab"]


def causal_pairs(S: int) -> int:
    return S * (S + 1) // 2


def gradient_flops(m: dict, batch: int, seq: int) -> float:
    """Model FLOPs of one client's gradient on (batch, seq) tokens: 6 x
    the weights a token multiplies by x the tokens, and the causal
    attention's two products (2 flops a multiply-add, forward once and
    backward twice).  Recomputation and the experts' capacity padding
    are not counted: they are the program's choice, not the model's."""
    tokens = batch * seq
    attn = (3 * 2 * 2 * head_dim(m) * m["n_heads"] * batch
            * causal_pairs(seq) * m["n_layers"])
    return 6.0 * matmul_weights_per_token(m) * tokens + attn


def flash_bound_s(kernel: str, m: dict, batch: int, seq: int,
                  elem_bytes: int = 2) -> float:
    """The least time of one causal flash-attention launch on a client's
    (batch, heads, seq, head_dim) tensors: each input read once and each
    output written once at the HBM rate, against 4, 6 and 8 flops a
    visible (query, key) pair per head dim (forward; dq; dk and dv) at
    the bf16 tensor-core peak.  The larger of the two bounds it."""
    hd, H, KV = head_dim(m), m["n_heads"], m["n_kv_heads"]
    qb = elem_bytes * batch * H * seq * hd
    kvb = elem_bytes * batch * KV * seq * hd
    rows = 4 * batch * H * seq                       # f32 lse / delta
    nbytes = {"flash_fwd": 2 * qb + 2 * kvb + rows,
              "flash_dq": 3 * qb + 2 * kvb + 2 * rows,
              "flash_dkv": 2 * qb + 4 * kvb + 2 * rows}[kernel]
    per_pair = {"flash_fwd": 4, "flash_dq": 6, "flash_dkv": 8}[kernel]
    flops = per_pair * hd * batch * H * causal_pairs(seq)
    return max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS)


def padded(n: int) -> int:
    return -(-n // QBLOCK) * QBLOCK


def wire_bound_s(kernel: str, n: int, g_bytes: int = 4) -> float:
    """The least time of one wire-kernel launch on a client's n
    coordinates, bound by bytes (their few flops a coordinate take a
    fifth of that time or less at the f32 rate): dsc_quantize reads g and
    s and writes s', the int8 codes and a scale a block; dequantize reads
    the codes and scales and writes f32 values."""
    n_pad, blocks = padded(n), padded(n) // QBLOCK
    nbytes = {"dsc_quantize": n * (g_bytes + 4 + 4) + n_pad + 4 * blocks,
              "dequantize": n_pad + 4 * blocks + 4 * n_pad}[kernel]
    return nbytes / HBM_BYTES_PER_S

