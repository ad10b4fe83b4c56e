"""The serving programs that the dry run accounts (``launch/serve.py``:
``serve_program``, ``lower_step``) against the reference's
``_prefill_fn`` / ``_decode_fn`` on the CPU, and the paged kernel's meta
branch and declaration.

At ``.smoke()`` sizes in f32, params from the reference's init through
``convert.params_from_jax``, the reference jitted:

* prefill (qwen2-0.5b, olmoe-1b-7b): the last position's logits and the
  K/V caches within 1e-5 relative norm;
* the paged decode through full block tables at ``seq_len - 1`` cached
  positions against the reference's dense ``decode_step`` at ``pos =
  seq_len - 1`` on the same K/V (qwen2-0.5b, olmoe-1b-7b): logits within
  1e-5, the new token's K/V written where the dense cache writes it;
* the paged decode under a window of 16 at position 40, the pages before
  the window on the scratch block (filled with large values that must not
  be read), against the reference's ring of 16;
* hymba-1.5b (with and without a window) and xlstm-350m through the dense
  ``decode_step`` that writes the caller's K/V ring in place: logits and
  every cache leaf within 1e-5.

Then: the paged wrapper's declaration on meta equals the flops its plain
version counts on the CPU with a full table and no window, and the
formula under a window; the meta branch raises wherever the card's
``_check`` raises, with its words, and skips only the address check; a
dense decode on meta holds one cache, not two; loops run by ``trips``
(the mLSTM replay, the selective scan's chunks) count on meta what they
count on the CPU.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_thread  # noqa: E402,F401
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.launch import serve as ref_serve  # noqa: E402
from repro.models import transformer as ref_tr  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax, tree_leaves  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.launch import serve as sl  # noqa: E402
from repro_torch.launch.accounting import Account  # noqa: E402
from repro_torch.models import transformer as tr  # noqa: E402

RTOL = 1e-5
BS = 16


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


@functools.lru_cache(maxsize=None)
def _pair(arch):
    ref_cfg = ref_get_config(arch).smoke()
    p = ref_tr.init_params(jax.random.PRNGKey(0), ref_cfg)
    return ref_cfg, get_config(arch).smoke(), p, params_from_jax(
        jax.tree.map(np.asarray, p), "cpu")


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "olmoe-1b-7b"])
def test_prefill_equals_reference(arch):
    ref_cfg, cfg, ref_p, params = _pair(arch)
    B, S = 2, 48
    step, (p, batch) = sl.serve_program(cfg, None, "prefill", B, S,
                                        device="cpu", params=params)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (B, S),
                                             dtype=np.int32)
    batch["tokens"].copy_(torch.from_numpy(toks))
    last, caches = step(p, batch)
    ref_last, ref_caches = jax.jit(ref_serve._prefill_fn(ref_cfg))(
        ref_p, {"tokens": toks})
    assert last.shape == (B, 1, cfg.vocab)
    assert _rel(last, ref_last) < RTOL
    for n in ("k", "v"):
        assert _rel(caches["kv"][n], ref_caches["kv"][n]) < RTOL


def _dense_kv(ref_cfg, B, size, seed):
    rng = np.random.default_rng(seed)
    shape = (ref_cfg.n_layers, B, size, ref_cfg.n_kv_heads, ref_cfg.hd)
    return {n: rng.standard_normal(shape).astype(np.float32)
            for n in ("k", "v")}


def _fill_pools(pools, tables, kv, positions):
    """Write dense K/V ``kv[n][l, b, i]`` (position ``positions[i]``) into
    the pools through the block tables."""
    for n in ("k", "v"):
        for i, p in enumerate(positions):
            blocks = tables[:, p // BS].long()
            pools[n][:, blocks, :, p % BS] = torch.from_numpy(
                kv[n][:, :, i]).to(pools[n].dtype)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "olmoe-1b-7b"])
def test_paged_full_table_equals_dense_decode(arch):
    """Full tables at S - 1 = 39 cached positions over 3 pages against the
    reference's dense cache of 40 positions at pos 39."""
    ref_cfg, cfg, ref_p, params = _pair(arch)
    B, S = 2, 40
    step, (p, pools, tables, ctx, tokens) = sl.serve_program(
        cfg, None, "decode", B, S, device="cpu", params=params)
    assert tables.shape == (B, 3) and bool((ctx == S - 1).all())
    assert len(set(tables.flatten().tolist())) == B * 3     # no scratch
    kv = _dense_kv(ref_cfg, B, S, seed=1)
    _fill_pools(pools, tables, kv, range(S))
    tok = np.random.default_rng(2).integers(0, cfg.vocab, (B, 1),
                                            dtype=np.int32)
    tokens.copy_(torch.from_numpy(tok))
    logits, out = step(p, pools, tables, ctx, tokens)
    assert out is pools
    ref_logits, ref_cache = jax.jit(ref_serve._decode_fn(ref_cfg, None))(
        ref_p, {"kv": kv}, tok, np.int32(S - 1))
    assert _rel(logits, ref_logits) < RTOL
    last = S - 1
    for n in ("k", "v"):
        got = pools[n][:, tables[:, last // BS].long(), :, last % BS]
        assert _rel(got, np.asarray(ref_cache["kv"][n])[:, :, last]) < RTOL


def test_paged_window_equals_reference_ring():
    """Window 16 at position 40 (S = 41): the table's first page (0-15) on
    the scratch block, which holds values of 1e3 that no row may read;
    pages 1-2 hold positions 16-39.  The reference's ring of 16 holds
    positions 25-40 (40's slot written by the step)."""
    ref_cfg, cfg, ref_p, params = _pair("qwen2-0.5b")
    B, S, W = 2, 41, 16
    step, (p, pools, tables, ctx, tokens) = sl.serve_program(
        cfg, None, "decode", B, S, window=W, device="cpu", params=params)
    assert tables.shape == (B, 3) and bool((tables[:, 0] == 0).all())
    assert pools["k"].shape[1] == 1 + B * 2           # window pages only
    for n in ("k", "v"):
        pools[n][:, 0] = 1e3
    kv = _dense_kv(ref_cfg, B, S, seed=3)
    _fill_pools(pools, tables, {n: v[:, :, 16:40] for n, v in kv.items()},
                range(16, 40))
    ring = {n: np.zeros_like(v[:, :, :W]) for n, v in kv.items()}
    for pos in range(S - W, S - 1):
        for n in ("k", "v"):
            ring[n][:, :, pos % W] = kv[n][:, :, pos]
    tok = np.random.default_rng(4).integers(0, cfg.vocab, (B, 1),
                                            dtype=np.int32)
    tokens.copy_(torch.from_numpy(tok))
    logits, _ = step(p, pools, tables, ctx, tokens)
    ref_logits, _ = jax.jit(ref_serve._decode_fn(ref_cfg, W))(
        ref_p, {"kv": ring}, tok, np.int32(S - 1))
    assert _rel(logits, ref_logits) < RTOL


def _to_np(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


@pytest.mark.parametrize("arch,window", [("hymba-1.5b", None),
                                         ("hymba-1.5b", 8),
                                         ("xlstm-350m", None)])
def test_dense_decode_in_place_equals_reference(arch, window):
    ref_cfg, cfg, ref_p, params = _pair(arch)
    B, S = 2, 24
    step, (p, cache, token) = sl.serve_program(
        cfg, None, "decode", B, S, window=window, device="cpu",
        params=params)
    sl.fill_inputs((p, cache, token), cfg, seed=5)
    before = {id(t) for t in tree_leaves(cache)}
    ref_cache = jax.tree.map(lambda t: t.numpy().copy(), cache)
    ref_logits, ref_new = jax.jit(ref_serve._decode_fn(ref_cfg, window))(
        ref_p, ref_cache, token.numpy(), np.int32(S - 1))
    logits, new = step(p, cache, token)
    assert _rel(logits, ref_logits) < RTOL
    ref_new = _to_np(ref_new)
    for (path, got), want in zip(
            jax.tree_util.tree_flatten_with_path(
                jax.tree.map(lambda t: t.numpy(), new))[0],
            jax.tree_util.tree_leaves(ref_new)):
        assert _rel(got, want) < RTOL, path
    if "kv" in cache:                       # written in place, not copied
        assert new["kv"]["k"] is cache["kv"]["k"]
        assert {id(t) for t in tree_leaves(new["kv"])} <= before


# ----------------------------------------------------- the paged kernel
def _paged_inputs(B=3, H=4, KV=2, hd=16, P=4, dtype=torch.float32,
                  ctx=None, device="cpu"):
    g = torch.Generator().manual_seed(7)
    N = 1 + B * P
    q = torch.randn(B, H, hd, generator=g).to(dtype)
    kp = torch.randn(N, KV, BS, hd, generator=g).to(dtype)
    vp = torch.randn(N, KV, BS, hd, generator=g).to(dtype)
    tbl = (1 + torch.arange(B * P, dtype=torch.int32)).reshape(B, P)
    lens = torch.full((B,), P * BS if ctx is None else ctx,
                      dtype=torch.int32)
    return [t.to(device) for t in (q, kp, vp, tbl, lens)]


def _meta(ts):
    return [torch.empty_like(t, device="meta") for t in ts]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_paged_declaration_equals_plain_count(dtype):
    """Full tables, no window: the declaration on meta is the flops the
    plain version's two products count on the CPU; its bytes are each
    position's K and V once, q, out, the tables and the lengths."""
    ins = _paged_inputs(dtype=dtype)
    with Account(device="cpu") as cpu:
        pa.paged_attention(*ins)
    with Account(device="meta") as meta:
        out = pa.paged_attention(*_meta(ins))
    (decl,) = meta.kernels.values()
    q, kp, _, tbl, lens = ins
    B, H, hd = q.shape
    keys = tbl.shape[1] * BS
    assert decl["launches"] == 1 and not cpu.kernels
    assert decl["flops"] == cpu.flops == 4 * B * H * hd * keys
    size = q.element_size()
    assert decl["bytes"] == (B * keys * kp.shape[1] * hd * 2 * size
                             + 2 * q.numel() * size + tbl.numel() * 4 + B * 4)
    assert out.shape == q.shape and out.dtype == q.dtype
    assert out.device.type == "meta"


def test_paged_declaration_under_a_window():
    """With a window the count is cut there, row by row, from the table's
    capacity (the lengths are not read)."""
    ins = _paged_inputs(ctx=37)
    q, kp, _, tbl, _ = ins
    for window, keys in ((20, 20), (1000, 64)):
        with Account(device="meta") as meta:
            pa.paged_attention(*_meta(ins), window=window)
        (decl,) = meta.kernels.values()
        B, H, hd = q.shape
        assert decl["flops"] == 4 * B * H * hd * keys
        assert decl["bytes"] == (B * keys * kp.shape[1] * hd * 2 * 4
                                 + 2 * q.numel() * 4 + tbl.numel() * 4
                                 + B * 4)


def _bad_cases():
    ok = _paged_inputs()
    q, kp, vp, tbl, lens = ok
    return {
        "f16": ([q.half(), kp.half(), vp.half(), tbl, lens], None),
        "v_dtype": ([q, kp, vp.bfloat16(), tbl, lens], None),
        "int64_tables": ([q, kp, vp, tbl.long(), lens], None),
        "not_contiguous": ([q.transpose(0, 1).contiguous().transpose(0, 1),
                            kp, vp, tbl, lens], None),
        "shapes": ([q, kp, vp, tbl[:2], lens], None),
        "rank": ([q[0], kp, vp, tbl, lens], None),
        "head_dim": (_paged_inputs(hd=12), None),
        "gqa_group_too_large": (_paged_inputs(H=64, KV=1, hd=256), None),
        "window": (ok, -1),
    }


@pytest.mark.parametrize("case", sorted(_bad_cases()))
def test_meta_branch_raises_where_the_card_does(case):
    args, window = _bad_cases()[case]
    with pytest.raises((TypeError, ValueError)) as card:
        pa._check(*args, window)
    with pytest.raises(type(card.value)) as meta:
        pa.paged_attention(*_meta(args), window=window)
    assert str(meta.value) == str(card.value)


def test_meta_branch_skips_only_the_address_check():
    """A q that would start off 16 bytes on the card: the meta branch has
    no address to check and allocates the output as the card would."""
    q, kp, vp, tbl, lens = _meta(_paged_inputs())
    flat = torch.empty(q.numel() + 1, device="meta")
    q_off = flat[1:].view(q.shape)
    out = pa.paged_attention(q_off, kp, vp, tbl, lens)
    assert out.shape == q.shape and out.device.type == "meta"


def test_dense_decode_holds_one_cache():
    """hymba-1.5b's smoke config at decode_32k's length on meta: the
    in-place step's peak is its arguments and one layer's transients (the
    score product's copy of that layer's K ring), under half the K/V
    rings; the copying ``decode_step`` holds every ring a second time."""
    cfg = get_config("hymba-1.5b").smoke()
    step, inputs = sl.serve_program(cfg, None, "decode", 4, 32768,
                                    device="meta")
    kv_bytes = sum(t.numel() * t.element_size()
                   for t in tree_leaves(inputs[1]["kv"]))
    with Account(device="meta", inputs=inputs) as donated:
        step(*inputs)
    with Account(device="meta", inputs=inputs) as copied:
        tr.decode_step(inputs[0], cfg, inputs[1], inputs[2], 32767)
    extra = donated.peak_bytes - donated.argument_bytes
    assert extra < 0.5 * kv_bytes
    assert copied.peak_bytes - copied.argument_bytes - extra >= kv_bytes
    assert donated.flops == copied.flops


@pytest.mark.parametrize("arch", ["xlstm-350m", "hymba-1.5b"])
def test_trips_count_on_meta_what_the_cpu_counts(arch):
    """The prefill of a recurrent family (the mLSTM's replay over 64
    tokens, the scan's 4 chunks of 16) counted on the CPU, every trip run,
    and on meta, two trips, the second counted 63 (3) times: flops and
    traffic equal; the peak equal, but for the scan's outputs of the
    chunks before the last, which the CPU's last trip holds and meta's
    second does not (two of them)."""
    cfg = dataclasses.replace(get_config(arch).smoke(), n_layers=1)
    B, S = 2, 64
    step, (p, batch) = sl.serve_program(cfg, None, "prefill", B, S,
                                        device="cpu")
    sl.fill_inputs((p, batch), cfg, seed=8)
    for t in tree_leaves(p):
        t.normal_(0, 0.02)
    step(p, batch)              # makes the host constants that are cached
    with Account(device="cpu", inputs=(p, batch)) as cpu:
        step(p, batch)
    mp = jax.tree.map(lambda t: torch.empty_like(t, device="meta"),
                      (p, batch))
    with Account(device="meta", inputs=mp) as meta:
        step(*mp)
    assert cpu.flops == meta.flops > 0
    assert cpu.traffic_bytes == meta.traffic_bytes
    held = 0
    if cfg.family == "hybrid":
        chunks, d_inner = S // cfg.scan_chunk, p["blocks"]["m_in"].shape[-1]
        held = (chunks - 2) * B * cfg.scan_chunk * (d_inner // 2) * 4
    assert cpu.peak_bytes - meta.peak_bytes == held
