"""The paged decode path against the reference, on the CPU: the layers it
runs (RMS norm, rotary embedding, chunked causal attention), the paged
attention plain version against the Pallas kernel in interpret mode, the
block allocator and the prefill scatter, and ``paged_decode_step`` end to
end with the params carried across by ``params_from_jax``.  Inputs are
numpy arrays from fixed seeds, fed to both packages.

The CUDA kernel itself runs only on the card: tests/test_torch_cuda.py."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")

from torch_threads import one_thread  # noqa: E402,F401
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.kernels import paged_attention as ref_pa  # noqa: E402
from repro.models import layers as ref_L  # noqa: E402
from repro.models import transformer as ref_tr  # noqa: E402
from repro.serve import cache as ref_cache  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as tr  # noqa: E402
from repro_torch.serve.cache import (SCRATCH_BLOCK, BlockAllocator,  # noqa: E402
                                     BlockBudgetExceeded, pages_for,
                                     write_prefill)

# f32 on both sides; the two frameworks sum in other orders, so results
# agree to a few ulps of the largest term, not bit for bit
TOL = dict(atol=2e-4, rtol=2e-4)


def _t(a):
    return torch.from_numpy(np.array(a))


# ----------------------------------------------------------------- layers
@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_rms_norm_matches_reference(dtype):
    """Variance in f32, rsqrt cast to x's dtype BEFORE the multiply, then
    * scale: with bf16 inputs that order decides the rounding."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32) * 3
    s = rng.standard_normal(64).astype(np.float32)
    jx, js = jnp.asarray(x, dtype), jnp.asarray(s, dtype)
    ref = np.asarray(ref_L.rms_norm(jx, js, 1e-6).astype(jnp.float32))
    tdt = torch.float32 if dtype is np.float32 else torch.bfloat16
    got = L.rms_norm(_t(x).to(tdt), _t(s).to(tdt), 1e-6).float().numpy()
    if dtype is np.float32:
        np.testing.assert_allclose(got, ref, atol=1e-6, rtol=1e-6)
    else:
        np.testing.assert_array_equal(got, ref)


def test_rope_rotates_halves_as_reference():
    """Rotary embedding rotates the two concatenated HALVES of the head
    dim against each other, not interleaved pairs."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 300, size=(2, 7))
    ref = np.asarray(ref_L.rope(jnp.asarray(x), jnp.asarray(pos), 10000.0))
    got = L.rope(_t(x), _t(pos), 10000.0).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=1e-5)
    # the same rotation on interleaved (even, odd) pairs gives other numbers
    perm = np.concatenate([np.arange(0, 16, 2), np.arange(1, 16, 2)])
    inter = np.empty_like(x)
    inter[..., perm] = L.rope(_t(x[..., perm]), _t(pos), 10000.0).numpy()
    assert not np.allclose(inter, ref, atol=1e-3)


@pytest.mark.parametrize("Sq,H,KV,window,chunk", [
    (12, 4, 2, None, 512),       # GQA, one chunk
    (20, 4, 1, 6, 8),            # MQA, window, three chunks (ragged tail)
    (9, 4, 4, None, 4),          # MHA, chunked
])
def test_causal_attention_matches_reference(Sq, H, KV, window, chunk):
    rng = np.random.default_rng(Sq + H)
    q = rng.standard_normal((2, Sq, H, 16)).astype(np.float32)
    k = rng.standard_normal((2, Sq, KV, 16)).astype(np.float32)
    v = rng.standard_normal((2, Sq, KV, 16)).astype(np.float32)
    ref = ref_L.causal_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), window=window, chunk=chunk)
    got = L.causal_attention(_t(q), _t(k), _t(v), window=window, chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)


# ------------------------------------------------- paged attention (plain)
def _paged_inputs(B, H, KV, bs, P, hd, seed):
    rng = np.random.default_rng(seed)
    N = P * B + 1
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    kp = rng.standard_normal((N, KV, bs, hd)).astype(np.float32)
    vp = rng.standard_normal((N, KV, bs, hd)).astype(np.float32)
    tbl = np.arange(1, N, dtype=np.int32).reshape(B, P)
    ctx = rng.integers(1, P * bs + 1, size=B).astype(np.int32)
    ctx[0] = 0                                  # inactive slot
    return q, kp, vp, tbl, ctx


@pytest.mark.parametrize("B,H,KV,bs,P,hd,window", [
    (2, 4, 2, 8, 3, 16, None),     # GQA
    (3, 8, 8, 16, 4, 32, None),    # MHA
    (4, 6, 2, 8, 5, 16, 7),        # GQA + sliding window
    (3, 4, 1, 16, 3, 32, None),    # MQA
])
def test_paged_ref_matches_pallas_interpret(B, H, KV, bs, P, hd, window):
    """The plain torch version against the reference's Pallas kernel run
    in interpret mode (tests/test_serve.py's four shapes), with an
    inactive (ctx 0) row that must come out as exact zeros, not mean(v)."""
    q, kp, vp, tbl, ctx = _paged_inputs(B, H, KV, bs, P, hd, B * 100 + H)
    ref = ref_pa.paged_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tbl),
        jnp.asarray(ctx), window=window, interpret=True)
    got = pa.paged_attention_ref(_t(q), _t(kp), _t(vp), _t(tbl), _t(ctx),
                                 window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)
    assert not got[0].any()
    # on a CPU tensor the wrapper computes the plain version, uncounted
    before = pa.paged_attention.launches
    via = pa.paged_attention(_t(q), _t(kp), _t(vp), _t(tbl), _t(ctx),
                             window=window)
    assert torch.equal(via, got) and pa.paged_attention.launches == before


def test_supports_bounds():
    assert pa.supports(16, 16, 128) and pa.supports(14, 2, 64)
    assert pa.supports(4, 2, 8) and pa.supports(4, 4, 256)
    assert not pa.supports(6, 4, 64)        # partial GQA group
    assert not pa.supports(4, 4, 63)        # odd head dim
    assert not pa.supports(4, 4, 6)         # below 8
    assert not pa.supports(4, 4, 258)       # above 256
    assert not pa.supports(4, 4, 12)        # rows off 16 bytes in bf16
    assert not pa.supports(4, 4, 256, block_size=256)   # K, V too large


def _good():
    return (torch.zeros(2, 4, 16), torch.zeros(5, 2, 8, 16),
            torch.zeros(5, 2, 8, 16), torch.zeros(2, 2, dtype=torch.int32),
            torch.zeros(2, dtype=torch.int32))


@pytest.mark.parametrize("bad,exc,match", [
    (dict(q=torch.zeros(2, 4, 16, dtype=torch.float16)), TypeError,
     "float32 or bfloat16"),
    (dict(v_pool=torch.zeros(5, 2, 8, 16, dtype=torch.bfloat16)), TypeError,
     "differ in dtype"),
    (dict(block_tables=torch.zeros(2, 2, dtype=torch.int64)), TypeError,
     "int32"),
    (dict(q=torch.zeros(2, 16, 4).transpose(1, 2)), ValueError,
     "contiguous"),
    (dict(context_lens=torch.zeros(3, dtype=torch.int32)), ValueError,
     "shapes disagree"),
    (dict(q=torch.zeros(2, 3, 16)), ValueError, "does not take"),
    (dict(window=-1), ValueError, "window"),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad, exc, match):
    names = ("q", "k_pool", "v_pool", "block_tables", "context_lens")
    pa._check(*_good(), None)                    # the good inputs pass
    args = dict(zip(names, _good()), window=None)
    args.update(bad)
    with pytest.raises(exc, match=match):
        pa._check(*(args[n] for n in names), args["window"])


# ------------------------------------- the CUDA kernel's split over chunks
def _split_k(q, k_pool, v_pool, tables, ctx, window=None):
    """The arithmetic of the CUDA kernel (``csrc/paged_attention.cu``): each
    row's range [max(ctx - window, 0), ctx) cut at multiples of
    C = ``chunk_positions(bs)``; per chunk, in f32, m = max s, p = e^(s - m),
    l = sum p, acc = p V with q pre-scaled by f32(hd**-0.5); a row of one
    chunk writes acc / max(l, 1e-30), a longer one merges its chunks in
    order, sum e^(m_c - M) acc_c / max(sum e^(m_c - M) l_c, 1e-30); an
    empty range writes zeros.  Nothing but the row's own ctx and window
    decides its chunks."""
    B, H, hd = q.shape
    N, KV, bs, _ = k_pool.shape
    P = tables.shape[1]
    G = H // KV
    C = pa.chunk_positions(bs)
    scale = float(np.float32(hd ** -0.5))
    out = torch.zeros(B, H, hd)
    for b in range(B):
        ctx_in = max(int(ctx[b]), 0)
        hi = min(ctx_in, P * bs)
        lo = max(ctx_in - window, 0) if window is not None else 0
        if hi <= lo:
            continue
        for h in range(KV):
            qg = q[b, h * G:(h + 1) * G].float() * scale
            parts = []
            for c in range(lo // C, -(-hi // C)):
                pos = torch.arange(max(c * C, lo), min(c * C + C, hi))
                blk = tables[b, pos // bs].long().clamp(0, N - 1)
                s = qg @ k_pool[blk, h, pos % bs].float().T
                m = s.amax(-1)
                p = torch.exp(s - m[:, None])
                parts.append((m, p.sum(-1), p @ v_pool[blk, h, pos % bs].float()))
            if len(parts) == 1:
                m, l, acc = parts[0]
                o = acc / l.clamp_min(1e-30)[:, None]
            else:
                M = torch.stack([m for m, _, _ in parts]).amax(0)
                w = [torch.exp(m - M) for m, _, _ in parts]
                l_sum = sum(wc * l for wc, (_, l, _) in zip(w, parts))
                acc = sum(wc[:, None] * a for wc, (_, _, a) in zip(w, parts))
                o = acc / l_sum.clamp_min(1e-30)[:, None]
            out[b, h * G:(h + 1) * G] = o
    return out.to(q.dtype)


# contexts: an inactive row, one token, page edges (16, 17), chunk edges
# (64, 65, 128, 129) and the table's reach (12 pages of 16: three chunks)
SPLIT_CTX = [0, 1, 16, 17, 64, 65, 128, 129, 191, 192]


@pytest.mark.parametrize("H,KV,hd,window", [
    (4, 4, 32, None),              # MHA
    (14, 2, 16, None),             # qwen2-0.5b's group of 7
    (4, 2, 32, 70),                # a window across a chunk edge
    (4, 1, 16, 64),                # a window of exactly one chunk
])
def test_split_k_matches_pallas_interpret(H, KV, hd, window):
    """The kernel's split over chunks and its merge, emulated, against the
    reference's Pallas kernel in interpret mode, with rows of one, two and
    three chunks and rows whose range starts inside a chunk; the ctx-0 row
    is exact zeros."""
    B, bs, P = len(SPLIT_CTX), 16, 12
    q, kp, vp, tbl, _ = _paged_inputs(B, H, KV, bs, P, hd, 11 + H)
    ctx = np.array(SPLIT_CTX, np.int32)
    want = ref_pa.paged_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tbl),
        jnp.asarray(ctx), window=window, interpret=True)
    got = _split_k(_t(q), _t(kp), _t(vp), _t(tbl), _t(ctx), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    assert not got[0].any()


@pytest.mark.parametrize("window", [None, 70])
def test_split_k_row_alone_equals_row_in_a_batch(window):
    """A row's chunks and merge order come from its own ctx and window:
    each row of the batch, computed alone with a table only as wide as its
    pages, is bit-identical."""
    B, H, KV, hd, bs, P = len(SPLIT_CTX), 4, 2, 32, 16, 12
    q, kp, vp, tbl, _ = (_t(a) for a in _paged_inputs(B, H, KV, bs, P, hd, 5))
    ctx = _t(np.array(SPLIT_CTX, np.int32))
    batch = _split_k(q, kp, vp, tbl, ctx, window=window)
    for b in range(B):
        pages = max(1, pages_for(int(ctx[b]), bs))
        alone = _split_k(q[b:b + 1], kp, vp, tbl[b:b + 1, :pages],
                         ctx[b:b + 1], window=window)
        assert torch.equal(alone[0], batch[b]), b


def test_chunks_are_whole_pages_and_do_not_depend_on_the_batch():
    assert pa.chunk_positions(16) == 64 and pa.chunk_positions(8) == 64
    assert pa.chunk_positions(5) == 60 and pa.chunk_positions(48) == 48
    assert pa.chunk_positions(128) == 128
    for bs in (1, 5, 16, 48, 128):
        assert pa.chunk_positions(bs) % bs == 0
    # bf16 pools of eris-gptneo-1.3b and qwen2-0.5b fit several blocks an SM
    assert pa.smem_bytes(1, 128, 16, 2) < 48 * 1024
    assert pa.smem_bytes(7, 64, 16, 2) < 48 * 1024


# ------------------------------------------------------------- allocator
@given(n_tokens=st.integers(0, 500), bs=st.integers(1, 64))
@settings(max_examples=40, deadline=None)
def test_pages_for_covers_exactly(n_tokens, bs):
    p = pages_for(n_tokens, bs)
    assert p == ref_cache.pages_for(n_tokens, bs)
    assert p * bs >= n_tokens
    assert (p - 1) * bs < n_tokens or p == 0


@given(num_blocks=st.integers(2, 64), seed=st.integers(0, 2**16))
@settings(max_examples=25, deadline=None)
def test_allocator_invariants_random_walk(num_blocks, seed):
    """tests/test_paged_cache.py's random walk, on the port's allocator
    and the reference's side by side: the same blocks come out."""
    rng = np.random.default_rng(seed)
    a = BlockAllocator(num_blocks, block_size=8)
    r = ref_cache.BlockAllocator(num_blocks, block_size=8)
    held = []
    peak_seen = 0
    for _ in range(60):
        if held and rng.random() < 0.4:
            grp = held.pop(int(rng.integers(len(held))))
            a.free(grp)
            r.free(grp)
            continue
        want = int(rng.integers(1, max(2, num_blocks // 2)))
        got = a.alloc(want)
        assert got == r.alloc(want)
        if got is None:
            assert want > a.available
            continue
        held.append(got)
        flat = [b for grp in held for b in grp]
        assert len(flat) == len(set(flat))
        assert all(0 < b < num_blocks for b in flat)
        peak_seen = max(peak_seen, len(flat))
        assert a.used + a.available == a.capacity == num_blocks - 1
    assert a.peak_used == peak_seen
    for grp in held:
        a.free(grp)
    assert a.available == a.capacity and a.used == 0


def test_allocator_all_or_nothing_strict_and_double_free():
    a = BlockAllocator(num_blocks=4, block_size=8)
    assert a.alloc(5) is None and a.available == 3
    with pytest.raises(BlockBudgetExceeded):
        a.alloc(5, strict=True)
    got = a.alloc(3)
    assert sorted(got) == [1, 2, 3] and a.alloc(1) is None
    a.free(got)
    with pytest.raises(ValueError):
        a.free(got)
    with pytest.raises(ValueError):
        a.free([SCRATCH_BLOCK])
    for bad in (dict(num_blocks=1, block_size=8),
                dict(num_blocks=8, block_size=0)):
        with pytest.raises(ValueError):
            BlockAllocator(**bad)


@given(S=st.integers(1, 40), bs=st.sampled_from([1, 4, 8, 16]),
       Lyr=st.integers(1, 3), KV=st.sampled_from([1, 2, 4]),
       seed=st.integers(0, 2**16))
@settings(max_examples=8, deadline=None)
def test_write_prefill_matches_reference(S, bs, Lyr, KV, seed):
    """The prefill scatter puts the advanced dims in front -- values go in
    as (S, L, KV, hd) -- and lands byte for byte where the reference's
    does, the padded tail in the scratch block."""
    hd = 8
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((Lyr, S, KV, hd)).astype(np.float32)
    v = rng.standard_normal((Lyr, S, KV, hd)).astype(np.float32)
    num_blocks = pages_for(S, bs) + 3
    pages = np.full((pages_for(S, bs) + 1,), SCRATCH_BLOCK, np.int32)
    pages[:-1] = np.arange(2, 2 + pages_for(S, bs))
    shape = (Lyr, num_blocks, KV, bs, hd)
    ref = ref_cache.write_prefill(
        {"k": jnp.zeros(shape), "v": jnp.zeros(shape)}, jnp.asarray(k),
        jnp.asarray(v), jnp.asarray(pages), bs)
    pools = {"k": torch.zeros(shape), "v": torch.zeros(shape)}
    out = write_prefill(pools, _t(k), _t(v), _t(pages), bs)
    assert out is pools                          # updated in place
    for n in ("k", "v"):
        np.testing.assert_array_equal(pools[n].numpy(), np.asarray(ref[n]))
    assert not pools["k"][:, 1].any()            # block 1 never referenced


# ------------------------------------------------------ paged decode step
def _cfg(arch):
    return dataclasses.replace(ref_get_config(arch).smoke(), n_layers=2,
                               dtype="float32")


@pytest.mark.parametrize("arch,window", [
    ("qwen2-0.5b", None), ("qwen2-0.5b", 8),
    ("eris-gptneo-1.3b", None), ("eris-gptneo-1.3b", 8),
    ("qwen3-32b", None), ("musicgen-medium", None),
    ("starcoder2-3b", 8), ("starcoder2-15b", None),
])
def test_paged_decode_step_matches_reference(arch, window):
    """Two batched decode steps through random pools: rows at ragged
    depths, one inactive slot (ctx 0, all-scratch table).  The reference
    runs its Pallas kernel in interpret mode (use_kernel=True); the port
    writes the new K/V through the table, then attends with ctx + 1."""
    cfg = _cfg(arch)
    ref_params = ref_tr.init_params(jax.random.PRNGKey(2), cfg)
    params = params_from_jax(jax.tree.map(np.asarray, ref_params), "cpu")
    pcfg = get_config(arch).smoke()
    pcfg = dataclasses.replace(pcfg, n_layers=2, dtype="float32")
    B, bs, P = 3, 4, 5
    N = B * P + 1
    rng = np.random.default_rng(11)
    shape = (cfg.n_layers, N, cfg.n_kv_heads, bs, cfg.hd)
    kp = rng.standard_normal(shape).astype(np.float32)
    vp = rng.standard_normal(shape).astype(np.float32)
    tbl = np.arange(1, N, dtype=np.int32).reshape(B, P)
    tbl[0] = SCRATCH_BLOCK
    ctx = np.array([0, 6, 13], np.int32)
    toks = rng.integers(0, cfg.vocab, size=(B, 1)).astype(np.int32)
    ref_pools = {"k": jnp.asarray(kp), "v": jnp.asarray(vp)}
    pools = {"k": _t(kp), "v": _t(vp)}
    for _ in range(2):
        ref_logits, ref_pools = ref_tr.paged_decode_step(
            ref_params, cfg, ref_pools, jnp.asarray(tbl), jnp.asarray(ctx),
            jnp.asarray(toks), window=window, use_kernel=True)
        logits, pools = tr.paged_decode_step(
            params, pcfg, pools, _t(tbl), _t(ctx), _t(toks).long(),
            window=window, use_kernel=True)
        np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                                   **TOL)
        for n in ("k", "v"):
            np.testing.assert_allclose(pools[n].numpy(),
                                       np.asarray(ref_pools[n]), **TOL)
        toks = np.asarray(ref_logits[:, 0].argmax(-1))[:, None]
        ctx = ctx + np.array([0, 1, 1], np.int32)


def test_forward_prefill_matches_reference_and_paged_decode_continues_it():
    """The full prefill forward (logits and per-layer K/V) against the
    reference, then prefill-then-decode through the pools equals the
    full forward at every later position."""
    cfg = _cfg("qwen2-0.5b")
    ref_params = ref_tr.init_params(jax.random.PRNGKey(4), cfg)
    params = params_from_jax(jax.tree.map(np.asarray, ref_params), "cpu")
    pcfg = dataclasses.replace(get_config("qwen2-0.5b").smoke(), n_layers=2,
                               dtype="float32")
    T, S0, bs = 12, 5, 4
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (1, T))
    ref_full, ref_caches, _ = ref_tr.forward(ref_params, cfg,
                                             jnp.asarray(toks),
                                             mode="prefill")
    full, caches, _ = tr.forward(params, pcfg, _t(toks), mode="prefill")
    np.testing.assert_allclose(full.numpy(), np.asarray(ref_full), **TOL)
    for n in ("k", "v"):
        np.testing.assert_allclose(caches["kv"][n].numpy(),
                                   np.asarray(ref_caches["kv"][n]), **TOL)

    pools = tr.init_paged_pools(pcfg, 8, bs, torch.float32, "cpu")
    pages = torch.arange(1, 1 + pages_for(T, bs))
    _, pre, _ = tr.forward(params, pcfg, _t(toks[:, :S0]), mode="prefill")
    write_prefill(pools, pre["kv"]["k"][:, 0], pre["kv"]["v"][:, 0], pages,
                  bs)
    tables = pages[None].to(torch.int32)
    for t in range(S0, T):
        logits, pools = tr.paged_decode_step(
            params, pcfg, pools, tables, torch.tensor([t], dtype=torch.int32),
            _t(toks[:, t:t + 1]))
        np.testing.assert_allclose(logits[0, 0].numpy(), full[0, t].numpy(),
                                   atol=2e-3, rtol=2e-3)
