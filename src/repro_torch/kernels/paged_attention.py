"""Paged decode attention through a block table
(``repro/kernels/paged_attention.py``).

:func:`paged_attention` launches the hand-written CUDA kernel
``csrc/paged_attention.cu`` on CUDA tensors; its design (split over chunks
of the context, merged by the last chunk to finish) and its bound are set
out in that file.  On CPU tensors it computes :func:`paged_attention_ref`,
the plain torch version, and only there: on a CUDA tensor it launches the
kernel or raises, whatever the shape.  On meta tensors (the dry run) it
checks what the card checks but the addresses, allocates its output and
launches nothing.  On the card and on meta it declares its work to an
active ``launch.accounting.Account``, counted by shapes
(:func:`declared_work`).  ``paged_attention.launches`` counts the
kernel's launches.

The kernel's f32 workspace for the chunks' partials and its counters
belong to this module, one of each per device, grown as a call needs and
never shrunk; a grown-out buffer is kept alive, since a captured CUDA
graph may still point at it.  Calls on one device therefore run on one
stream at a time, as the serving engine's do.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.launch import accounting

NEG_INF = -1e30
MAX_HEAD_DIM = 256
THREADS = 256                 # threads per block, as kThreads in the kernel
CHUNK = 64                    # positions a block takes, rounded to pages
SMEM_LIMIT = 232448           # dynamic shared memory per block on sm_90


def chunk_positions(block_size: int) -> int:
    """C, the positions of one chunk (one thread block): whole pages, 64
    positions where the block size divides 64.  It depends on the block
    size alone, so a row's chunks do not depend on the batch."""
    return block_size * max(1, CHUNK // block_size)


def smem_bytes(group: int, head_dim: int, block_size: int = 16,
               kv_itemsize: int = 4) -> int:
    """Dynamic shared memory a block takes (``smem_bytes`` in the kernel):
    the chunk's K and V rows, the G scaled queries, the slices of the PV
    sum, the scores, m and l, and a flag."""
    C = chunk_positions(block_size)
    items = group * (head_dim * kv_itemsize // 16)
    slices = 1 if items >= THREADS else THREADS // items
    return (2 * C * head_dim * kv_itemsize
            + 4 * (group * head_dim * (1 + slices) + group * C + 2 * group
                   + 1))


def supports(n_heads: int, n_kv_heads: int, head_dim: int,
             block_size: int = 16, kv_itemsize: int = 4) -> bool:
    """Shapes the CUDA kernel takes: whole GQA groups, a head dim from 8
    to 256 in 16-byte rows (a multiple of 8), and a block within one
    block's shared memory."""
    return (n_heads % n_kv_heads == 0 and head_dim % 8 == 0
            and 8 <= head_dim <= MAX_HEAD_DIM
            and smem_bytes(n_heads // n_kv_heads, head_dim, block_size,
                           kv_itemsize) <= SMEM_LIMIT)


def paged_attention_ref(q: torch.Tensor, k_pool: torch.Tensor,
                        v_pool: torch.Tensor, block_tables: torch.Tensor,
                        context_lens: torch.Tensor, *,
                        window: Optional[int] = None) -> torch.Tensor:
    """Plain torch version: gather each request's pages from the pools,
    then masked softmax attention with the (B, P*bs) scores materialized.
    Same signature and semantics as :func:`paged_attention`."""
    B, H, hd = q.shape
    N, KV, bs, _ = k_pool.shape
    P = block_tables.shape[1]
    G = H // KV
    tbl = block_tables.long()
    # (B, P, KV, bs, hd) -> (B, KV, P*bs, hd)
    ks = k_pool[tbl].permute(0, 2, 1, 3, 4).reshape(B, KV, P * bs, hd)
    vs = v_pool[tbl].permute(0, 2, 1, 3, 4).reshape(B, KV, P * bs, hd)
    qg = q.reshape(B, KV, G, hd)
    s = torch.einsum("bkgh,bksh->bkgs", qg.float(), ks.float()) * hd ** -0.5
    pos = torch.arange(P * bs, device=q.device)
    ctx = context_lens.long()[:, None]
    valid = pos[None] < ctx
    if window is not None:
        valid &= pos[None] >= ctx - window
    valid = valid[:, None, None]
    s = torch.where(valid, s, NEG_INF)
    # a fully-masked row (inactive slot) must produce zeros, not mean(v):
    # with m == NEG_INF, exp(s - m) is 1 at masked lanes, so zero them
    m = s.amax(-1, keepdim=True)
    e = torch.exp(s - m) * valid
    denom = e.sum(-1, keepdim=True).clamp_min(1e-30)
    w = (e / denom).to(vs.dtype)
    out = torch.einsum("bkgs,bksh->bkgh", w, vs)
    return out.reshape(B, H, hd).to(q.dtype)


_DTYPES = (torch.float32, torch.bfloat16)
_P, _I = ctypes.c_void_p, ctypes.c_int
# q k v tables ctx out ws counters; B H KV hd N bs P window; scale; C
# q_bf16 kv_bf16; stream
_ARGS = [_P] * 8 + [_I] * 8 + [ctypes.c_float] + [_I] * 3 + [_P]
# device index -> (f32 workspace, int32 counters)
_workspaces: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
_retired: List[torch.Tensor] = []   # outgrown, maybe still in a CUDA graph


def _workspace(device: torch.device, floats: int,
               rows: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The device's workspace of at least ``floats`` f32 and its counters
    of at least ``rows``, grown by doubling.  The counters are zeroed only
    when they are allocated: the kernel returns each to zero."""
    ws, counters = _workspaces.get(device.index, (None, None))
    if ws is None or ws.numel() < floats:
        if ws is not None:
            _retired.append(ws)
        ws = torch.empty(max(floats, 2 * (0 if ws is None else ws.numel())),
                         dtype=torch.float32, device=device)
    if counters is None or counters.numel() < rows:
        if counters is not None:
            _retired.append(counters)
        counters = torch.zeros(
            max(rows, 2 * (0 if counters is None else counters.numel())),
            dtype=torch.int32, device=device)
    _workspaces[device.index] = (ws, counters)
    return ws, counters


def _workspace_sizes(B: int, H: int, KV: int, hd: int, P: int,
                     block_size: int) -> Tuple[int, int]:
    """(f32 floats, int32 counters) of the workspace a call at these
    shapes needs: the chunks' partials (acc, m, l) of every (row, head,
    chunk), chunks cut from the table's capacity P * bs, and a counter a
    (row, kv head)."""
    chunks = max(1, -(-P * block_size // chunk_positions(block_size)))
    return B * H * chunks * (hd + 2), B * KV


def workspace_bytes(B: int, H: int, KV: int, hd: int, P: int,
                    block_size: int) -> int:
    """Bytes of the per-device workspace and counters a call at these
    shapes needs (:func:`_workspace_sizes`).  It persists between calls
    (a warm card already holds it), so the dry run reports it apart from
    a step's peak."""
    return 4 * sum(_workspace_sizes(B, H, KV, hd, P, block_size))


def declared_work(q, k_pool, block_tables, window) -> Tuple[float, int]:
    """(flops, bytes) the wrapper declares for one call, counted by
    shapes: the context lengths live on the device (meta has none, and
    reading them on the card would sync every step), so each row counts
    its table's capacity P * bs, cut at the window.  With full tables, as
    the dry run builds them, that is the work done; in the engine it is an
    upper bound.  4 H hd flops a key (q k and p v); the bytes are the
    kernel's own bound (``csrc/paged_attention.cu``): those keys' K and V
    rows, q, out, the tables and the lengths."""
    B, H, hd = q.shape
    _, KV, bs, _ = k_pool.shape
    keys = block_tables.shape[1] * bs
    if window is not None:
        keys = min(keys, window)
    flops = 4 * B * H * hd * keys
    nbytes = (B * keys * KV * hd * 2 * k_pool.element_size()
              + 2 * q.numel() * q.element_size()
              + block_tables.numel() * 4 + B * 4)
    return float(flops), nbytes


def _check(q, k_pool, v_pool, block_tables, context_lens, window):
    tensors = dict(q=q, k_pool=k_pool, v_pool=v_pool,
                   block_tables=block_tables, context_lens=context_lens)
    for name, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"paged_attention: {name} is on {t.device}, "
                             f"q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"paged_attention: {name} must be contiguous")
    if q.dtype not in _DTYPES or k_pool.dtype not in _DTYPES:
        raise TypeError(f"paged_attention: q and pools must be float32 or "
                        f"bfloat16, got {q.dtype} and {k_pool.dtype}")
    if v_pool.dtype != k_pool.dtype:
        raise TypeError("paged_attention: k_pool and v_pool differ in dtype")
    if block_tables.dtype != torch.int32 or context_lens.dtype != torch.int32:
        raise TypeError("paged_attention: block_tables and context_lens "
                        "must be int32")
    if q.dim() != 3 or k_pool.dim() != 4 or block_tables.dim() != 2:
        raise ValueError("paged_attention: want q (B, H, hd), pools "
                         "(N, KV, bs, hd), block_tables (B, P)")
    B, H, hd = q.shape
    _, KV, _, hd_k = k_pool.shape
    if (v_pool.shape != k_pool.shape or hd_k != hd
            or block_tables.shape[0] != B or context_lens.shape != (B,)):
        raise ValueError(
            f"paged_attention: shapes disagree: q {tuple(q.shape)}, pools "
            f"{tuple(k_pool.shape)}/{tuple(v_pool.shape)}, block_tables "
            f"{tuple(block_tables.shape)}, context_lens "
            f"{tuple(context_lens.shape)}")
    bs = k_pool.shape[2]
    if not supports(H, KV, hd, bs, k_pool.element_size()):
        raise ValueError(f"paged_attention: the CUDA kernel does not take "
                         f"n_heads={H}, n_kv_heads={KV}, head_dim={hd}, "
                         f"block_size={bs}, {k_pool.dtype} pools")
    if B > 65535:
        raise ValueError(f"paged_attention: batch {B} beyond the kernel's "
                         f"grid (65535)")
    for name in ("q", "k_pool", "v_pool"):
        if q.device.type != "meta" and tensors[name].data_ptr() % 16:
            raise ValueError(f"paged_attention: {name} does not start on "
                             f"16 bytes (the kernel's 16-byte copies)")
    if window is not None and window < 0:
        raise ValueError(f"paged_attention: window must be >= 0, got {window}")


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, block_tables: torch.Tensor,
                    context_lens: torch.Tensor, *,
                    window: Optional[int] = None) -> torch.Tensor:
    """One decode step of paged GQA attention.

    q:             (B, H, hd) -- the new tokens' query heads
    k_pool/v_pool: (N, KV, bs, hd) -- the global block pools
    block_tables:  (B, P) int32 -- pool block of each request's page p
                   (entries past the request's pages must still be valid
                   pool indices, e.g. 0)
    context_lens:  (B,) int32 -- valid positions per request INCLUDING
                   the token being decoded (its K/V already written)
    window:        sliding window -- keys at ctx-window <= j < ctx attend

    Returns (B, H, hd) in q's dtype.  Rows with ctx == 0 are exact zeros.
    """
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pool, v_pool, block_tables,
                                   context_lens, window=window)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"paged_attention: no kernel for {q.device}")
    _check(q, k_pool, v_pool, block_tables, context_lens, window)
    B, H, hd = q.shape
    N, KV, bs, _ = k_pool.shape
    P = block_tables.shape[1]
    out = torch.empty_like(q)
    if B == 0:
        return out
    if accounting.active() is not None:
        flops, nbytes = declared_work(q, k_pool, block_tables, window)
        accounting.declare("paged_attention", (), (), flops, nbytes=nbytes)
    if q.device.type == "meta":
        return out
    C = chunk_positions(bs)
    ws, counters = _workspace(q.device,
                              *_workspace_sizes(B, H, KV, hd, P, bs))
    with torch.cuda.device(q.device):
        err = _build.bind("paged_attention", "paged_attention_launch",
                          _ARGS)(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            block_tables.data_ptr(), context_lens.data_ptr(), out.data_ptr(),
            ws.data_ptr(), counters.data_ptr(), B, H, KV, hd, N, bs, P,
            -1 if window is None else int(window), hd ** -0.5, C,
            int(q.dtype == torch.bfloat16),
            int(k_pool.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    _build.raise_on_error("paged_attention", err)
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
