"""The port's CUDA kernels on the card.  This file imports torch and the
port only (the machine with the card has no jax), so it runs there as

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tests that need the card carry the ``cuda`` marker and skip without one,
naming what is missing; whether there is a card is decided inside the
fixture, never at import."""
import ctypes
import dataclasses
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.models import transformer as tr  # noqa: E402
from repro_torch.serve import ServeEngine, ServeSettings  # noqa: E402


@pytest.fixture
def cuda():
    """The card and the toolkit, or a skip naming what is missing."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    if shutil.which("nvcc") is None and \
            not os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("needs nvcc (the CUDA toolkit) to build the kernel")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(B, H, KV, bs, P, hd, seed):
    rng = np.random.default_rng(seed)
    N = P * B + 1
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    kp = rng.standard_normal((N, KV, bs, hd)).astype(np.float32)
    vp = rng.standard_normal((N, KV, bs, hd)).astype(np.float32)
    tbl = (rng.permutation(N - 1) + 1).astype(np.int32).reshape(B, P)
    ctx = rng.integers(1, P * bs + 1, size=B).astype(np.int32)
    ctx[0] = 0                                  # inactive slot
    return [torch.from_numpy(a) for a in (q, kp, vp, tbl, ctx)]


def test_no_kernel_for_other_devices():
    """Neither the CPU path nor the kernel nor the meta branch (the dry
    run's): a tensor on another device raises."""
    import types
    _, kp, vp, tbl, ctx = _inputs(2, 4, 2, 8, 2, 16, 0)
    q = types.SimpleNamespace(device=torch.device("xpu"))
    with pytest.raises(ValueError, match="no kernel for xpu"):
        pa.paged_attention(q, kp, vp, tbl, ctx)


@pytest.mark.cuda
@pytest.mark.parametrize("H,KV,hd,window,qdt,kvdt", [
    (16, 16, 128, None, torch.float32, torch.float32),
    (16, 16, 128, 40, torch.bfloat16, torch.bfloat16),
    (14, 2, 64, None, torch.bfloat16, torch.bfloat16),
    (14, 2, 64, 24, torch.float32, torch.bfloat16),
    (4, 4, 256, None, torch.float32, torch.float32),
    (8, 1, 8, 5, torch.float32, torch.float32),
    (24, 2, 128, None, torch.bfloat16, torch.bfloat16),  # > 48 KB smem
    # the local heads of a rank at model 2: eris-gptneo-1.3b, qwen2-0.5b
    (8, 8, 128, None, torch.float32, torch.float32),
    (8, 8, 128, None, torch.bfloat16, torch.bfloat16),
    (7, 1, 64, None, torch.float32, torch.float32),
    (7, 1, 64, None, torch.bfloat16, torch.bfloat16),
])
def test_cuda_kernel_matches_plain_version(cuda, H, KV, hd, window, qdt,
                                           kvdt):
    """The kernel against the plain version on the card (f32: 1e-4; bf16
    pools: 2e-2, the plain version rounds its weights to bf16), the ctx-0
    row exact zeros, and every row of batch 8 bit-identical alone."""
    B, bs, P = 8, 16, 6
    q, kp, vp, tbl, ctx = (t.to(cuda) for t in _inputs(B, H, KV, bs, P, hd,
                                                      7))
    q, kp, vp = q.to(qdt), kp.to(kvdt), vp.to(kvdt)
    before = pa.paged_attention.launches
    out = pa.paged_attention(q, kp, vp, tbl, ctx, window=window)
    torch.cuda.synchronize()
    assert pa.paged_attention.launches == before + 1
    ref = pa.paged_attention_ref(q, kp, vp, tbl, ctx, window=window)
    tol = 1e-4 if torch.bfloat16 not in (qdt, kvdt) else 2e-2
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    assert out.dtype == qdt and not out[0].any()
    for b in range(B):
        one = pa.paged_attention(q[b:b + 1], kp, vp, tbl[b:b + 1],
                                 ctx[b:b + 1], window=window)
        assert torch.equal(one[0], out[b])


@pytest.mark.cuda
def test_cuda_wrapper_raises_instead_of_falling_back(cuda):
    q = torch.zeros(2, 6, 64, device=cuda)             # 6 heads over 4 kv
    pool = torch.zeros(3, 4, 16, 64, device=cuda)
    tbl = torch.zeros(2, 1, dtype=torch.int32, device=cuda)
    ctx = torch.ones(2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="does not take"):
        pa.paged_attention(q, pool, pool, tbl, ctx)
    with pytest.raises(ValueError, match="is on cpu"):
        pa.paged_attention(q[:, :4].contiguous(), pool, pool, tbl.cpu(), ctx)


@pytest.mark.cuda
def test_engine_on_the_card_equals_the_host(cuda):
    """qwen2-0.5b's smoke variant in f32: greedy tokens through the kernel
    equal the host's plain path, and the kernel ran once per layer per
    decode step."""
    cfg = get_config("qwen2-0.5b").smoke()
    host = tr.init_params(cfg, seed=0, device="cpu")
    card = {k: (v.to(cuda) if not isinstance(v, dict) else
                {n: t.to(cuda) for n, t in v.items()})
            for k, v in host.items()}
    settings = ServeSettings(max_concurrency=4, block_size=8, num_blocks=32,
                             max_model_len=40, max_new_tokens=5,
                             cache_dtype="float32")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, size=n).tolist()
               for n in (3, 9, 17, 30)]
    eng = ServeEngine(cfg, card, settings, device=cuda)
    pa.paged_attention.launches = 0
    got = eng.run(prompts)
    assert pa.paged_attention.launches == \
        cfg.n_layers * eng.stats()["decode_steps"] > 0
    want = ServeEngine(cfg, host, settings, device="cpu").run(prompts)
    assert [o.tokens for o in got] == [o.tokens for o in want]


# ------------------------------------------------------- the wire kernels
from repro_torch.core import fl  # noqa: E402
from repro_torch.core.compressors import RandP  # noqa: E402
from repro_torch.kernels import dsc_quantize as dq  # noqa: E402
from repro_torch.kernels import dsc_update as du  # noqa: E402
from repro_torch.kernels import quantize as qz  # noqa: E402
from repro_torch.kernels import ref as wire_ref  # noqa: E402


def _wire_inputs(n, gdt, cuda, seed=3):
    rng = np.random.default_rng(seed)
    g = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    s = torch.from_numpy((0.3 * rng.standard_normal(n)).astype(np.float32))
    g[256:512] = 0.0                              # a zero block
    s[256:512] = 0.0
    return g.to(cuda).to(gdt), s.to(cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [3 * 2**16 + 77, 2**18])
@pytest.mark.parametrize("gdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p", [0.25, 1.0])
@pytest.mark.parametrize("base", [0, 2**32 - 4096])
def test_cuda_wire_kernels_match_plain_versions(cuda, n, gdt, p, base):
    """dsc_update, dsc_quantize, quantize and dequantize on the card equal
    their plain versions bit for bit (codes, scales, v, s'), across the
    2**32 index wrap; a zero block and the padded tail stay zero; each
    wrapper counts one launch."""
    g, s = _wire_inputs(n, gdt, cuda)
    before = dict(du=du.dsc_update.launches, dq=dq.dsc_quantize.launches,
                  q=qz.quantize.launches, d=qz.dequantize.launches)
    v, s1 = du.dsc_update(g, s, 7, p=p, gamma=0.37, index_base=base)
    rv, rs1 = wire_ref.dsc_update_ref(g, s, 7, p=p, gamma=0.37,
                                      index_base=base)
    assert torch.equal(v, rv) and torch.equal(s1, rs1)
    q, sc, s2 = dq.dsc_quantize(g, s, 8, 9, p=p, gamma=0.37,
                                index_base=base)
    rq, rsc, rs2 = wire_ref.dsc_quantize_ref(g, s, 8, 9, p=p, gamma=0.37,
                                             index_base=base)
    assert torch.equal(q, rq) and torch.equal(sc, rsc) and torch.equal(s2, rs2)
    assert float(sc[1]) == 0.0 and not q[256:512].any() and not q[n:].any()
    q, sc = qz.quantize(g, 10, index_base=base)
    rq, rsc = wire_ref.quantize_ref(g, 10, index_base=base)
    assert torch.equal(q, rq) and torch.equal(sc, rsc)
    assert torch.equal(qz.dequantize(q, sc), wire_ref.dequantize_ref(q, sc))
    torch.cuda.synchronize()
    assert (du.dsc_update.launches - before["du"],
            dq.dsc_quantize.launches - before["dq"],
            qz.quantize.launches - before["q"],
            qz.dequantize.launches - before["d"]) == (1, 1, 1, 1)


@pytest.mark.cuda
def test_cuda_wire_kernels_update_the_shift_in_place(cuda):
    g, s = _wire_inputs(4096 + 13, torch.float32, cuda)
    want = dq.dsc_quantize(g, s, 1, 2, p=0.25, gamma=0.5)[2]
    s_in = s.clone()
    assert dq.dsc_quantize(g, s_in, 1, 2, p=0.25, gamma=0.5,
                           out=s_in)[2] is s_in
    assert torch.equal(s_in, want)
    s_in = s.clone()
    du.dsc_update(g, s_in, 1, p=0.25, gamma=0.5, out=s_in)
    assert torch.equal(s_in, du.dsc_update(g, s, 1, p=0.25, gamma=0.5)[1])


@pytest.mark.cuda
def test_cuda_wire_wrappers_raise_instead_of_falling_back(cuda):
    g = torch.zeros(1024, device=cuda)
    with pytest.raises(ValueError, match="is on cpu"):
        du.dsc_update(g, g.cpu(), 1, p=0.5, gamma=0.1)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        qz.quantize(g.half(), 1)
    with pytest.raises(ValueError, match="aligned"):
        qz.dequantize(torch.zeros(513, dtype=torch.int8, device=cuda)[1:],
                      torch.zeros(2, device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("flash", [False, True])
def test_fl_round_on_the_card_equals_the_host(cuda, flash):
    """Two fused DSC-int8 rounds of eris-gptneo-1.3b's smoke variant in
    f32, on the card through the kernels and on the host through the
    plain versions, with the same seeds: x within 1e-4 relative norm (a
    code may flip where u falls within an ulp of its fraction, as the
    two devices' gradients differ in the last bits).  With flash on, each
    flash kernel ran once per layer per client gradient."""
    cfg = dataclasses.replace(get_config("eris-gptneo-1.3b").smoke(),
                              flash_attention=flash)
    fcfg = fl.FLConfig(method="eris", K=3, A=8, lr=0.1, use_dsc=True,
                       compressor=RandP(p=0.25), int8_wire=True,
                       compress_impl="fused")
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, size=(3, 2, 16)).astype(np.int32))

    def loss(p, b):
        return tr.loss_fn(p, cfg, {"tokens": b})

    host = fl.FLRun(fcfg, tr.init_params(cfg, seed=0, device="cpu"), loss,
                    device="cpu")
    card = fl.FLRun(fcfg, tr.init_params(cfg, seed=0, device="cpu"), loss,
                    device=cuda)
    dq.dsc_quantize.launches = 0
    _set_flash_launches(0)
    for _ in range(2):
        host.step(toks)
        card.step(toks.to(cuda))
    assert dq.dsc_quantize.launches == 2 * 3
    want = 2 * 3 * cfg.n_layers if flash else 0
    assert [fn.launches for fn in FLASH] == [want] * 3
    rel = float((card.x.cpu() - host.x).norm() / host.x.norm())
    assert rel < 1e-4


# ------------------------------------------------------ flash attention
from repro_torch.kernels import flash_attention as fa  # noqa: E402

FLASH = (fa.flash_fwd, fa.flash_dq, fa.flash_dkv)


def _set_flash_launches(value):
    for fn in FLASH:
        fn.launches = value


def _flash_inputs(B, H, KV, S, d, dtype, cuda, bshd=True, seed=5):
    """q, k, v, do as (B, H, S, d): transposed views of (B, S, H, d)
    tensors, as the model hands them over, or contiguous."""
    rng = np.random.default_rng(seed)
    out = []
    for heads in (H, KV, KV, H):
        shape = (B, S, heads, d) if bshd else (B, heads, S, d)
        t = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        t = t.to(cuda).to(dtype)
        out.append(t.transpose(1, 2) if bshd else t)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,KV,S,d,causal,window,dtype,bshd", [
    (2, 4, 2, 128, 64, True, None, torch.float32, True),
    (1, 4, 4, 100, 32, False, None, torch.float32, True),   # ragged S
    (1, 2, 1, 256, 16, True, 48, torch.float32, False),
    (2, 4, 2, 128, 128, True, None, torch.float32, True),   # most smem
    (4, 16, 16, 64, 128, True, None, torch.bfloat16, True),  # gptneo round
    (4, 14, 2, 64, 64, True, None, torch.bfloat16, True),   # qwen2 round
    (4, 4, 2, 64, 64, True, None, torch.float32, True),     # smoke round
    (8, 16, 16, 64, 128, True, None, torch.float32, True),  # f32 train step
    (1, 14, 2, 256, 64, True, 100, torch.bfloat16, True),   # qwen2 GQA 7
    # the tensor-core dq and dk/dv (bf16)
    (1, 4, 4, 100, 128, True, None, torch.bfloat16, True),   # ragged S
    (1, 4, 4, 256, 128, True, 200, torch.bfloat16, True),    # window, 4 tiles
    (1, 14, 2, 512, 64, True, None, torch.bfloat16, True),   # 7 heads a kv
    (2, 4, 4, 128, 128, True, None, torch.bfloat16, False),  # contiguous
    (1, 14, 2, 128, 64, False, None, torch.bfloat16, False),  # contiguous
    (1, 2, 1, 128, 32, True, 48, torch.bfloat16, True),      # d = 32, padded
    # the f32 forward, dq and dk/dv on the tensor cores (3xTF32)
    (1, 4, 4, 100, 128, True, None, torch.float32, True),    # ragged S
    (1, 14, 2, 512, 64, True, None, torch.float32, True),    # 7 heads a kv
    (1, 14, 2, 512, 64, True, 200, torch.float32, True),     # window
    (2, 4, 4, 128, 128, True, None, torch.float32, False),   # contiguous
    (1, 2, 1, 256, 16, True, None, torch.float32, True),     # d = 16
    (1, 2, 1, 128, 32, False, None, torch.float32, True),    # d = 32, full
    (1, 14, 2, 2048, 64, False, None, torch.float32, True),  # longest sums
    (1, 16, 16, 2048, 128, True, None, torch.float32, True),  # gptneo context
])
def test_cuda_flash_kernels_match_plain_versions(cuda, B, H, KV, S, d, causal,
                                                 window, dtype, bshd):
    """The forward, dq and dk/dv kernels against their plain versions on
    the same inputs (f32: 1e-4, the order of summation and the 3xTF32
    products; bf16 outputs: 2**-7 of the plain value plus 1e-4, one bf16
    step, since both sides compute in f32 and cast once, the tensor-core
    dq and dk/dv taking p and ds as two bf16 terms), each launched once,
    every bf16 kernel on the tensor cores and every f32 one on the f32
    tensor-core kernels (3xTF32); outputs keep their inputs' strides."""
    q, k, v, do = _flash_inputs(B, H, KV, S, d, dtype, cuda, bshd)
    mask = dict(causal=causal, window=window)
    before = [fn.launches for fn in FLASH]
    tc_before = [fn.tensor_core_launches for fn in FLASH]
    tc32_before = [fn.f32_tensor_core_launches for fn in FLASH]
    o, lse = fa.flash_fwd(q, k, v, **mask)
    delta = wire_ref.flash_delta(o, do)
    dq_ = fa.flash_dq(q, k, v, do, lse, delta, **mask)
    dk, dv = fa.flash_dkv(q, k, v, do, lse, delta, **mask)
    torch.cuda.synchronize()
    assert [fn.launches - b for fn, b in zip(FLASH, before)] == [1, 1, 1]
    tc = int(dtype == torch.bfloat16)
    assert [fn.tensor_core_launches - b
            for fn, b in zip(FLASH, tc_before)] == [tc] * 3
    assert [fn.f32_tensor_core_launches - b
            for fn, b in zip(FLASH, tc32_before)] == [1 - tc] * 3
    ro, rlse = wire_ref.flash_fwd_ref(q, k, v, **mask)
    rdq = wire_ref.flash_dq_ref(q, k, v, do, lse, delta, **mask)
    rdk, rdv = wire_ref.flash_dkv_ref(q, k, v, do, lse, delta, **mask)
    rtol = 1e-4 if dtype == torch.float32 else 2.0 ** -7
    for name, got, want in (("o", o, ro), ("dq", dq_, rdq), ("dk", dk, rdk),
                            ("dv", dv, rdv)):
        assert got.dtype == dtype and got.stride() == \
            (q if name in ("o", "dq") else k).stride(), name
        torch.testing.assert_close(got.float(), want.float(), atol=1e-4,
                                   rtol=rtol, msg=name)
    torch.testing.assert_close(lse, rlse, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_cuda_flash_function_matches_the_oracle(cuda):
    """The autograd Function on the card (forward kernel, delta, dq and
    dk/dv kernels) against autograd through the naive oracle, f32."""
    q, k, v, w = _flash_inputs(2, 6, 2, 128, 64, torch.float32, cuda)
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(
        (fa.flash_attention(*leaves, window=40) * w).sum(), leaves)
    want = torch.autograd.grad(
        (wire_ref.flash_attention_ref(*leaves, window=40) * w).sum(), leaves)
    for g, e in zip(got, want):
        torch.testing.assert_close(g, e, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_cuda_flash_wrappers_raise_instead_of_falling_back(cuda):
    q, k, v, do = _flash_inputs(1, 4, 2, 64, 64, torch.float32, cuda)
    with pytest.raises(ValueError, match="is on cpu"):
        fa.flash_fwd(q, k.cpu(), v)
    with pytest.raises(ValueError, match="is on cpu"):
        fa.flash_attention(q, k, v.cpu())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.flash_fwd(q.half(), k.half(), v.half())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.flash_fwd(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_fwd(q[..., :48], k[..., :48], v[..., :48])


@pytest.mark.cuda
def test_cuda_flash_backward_raises_on_rows_off_16_bytes(cuda):
    """The bf16 dq and dk/dv kernels copy rows in 16-byte chunks: a view
    whose base address or row stride is off 16 bytes raises; nothing
    falls back."""
    q, k, v, do = _flash_inputs(1, 4, 2, 64, 64, torch.bfloat16, cuda)
    o, lse = fa.flash_fwd(q, k, v)
    delta = wire_ref.flash_delta(o, do)
    flat = torch.zeros(q.numel() + 1, dtype=q.dtype, device=cuda)
    shifted = flat[1:].view(q.shape)                   # base 2 bytes off
    wide = torch.zeros(1, 64, 4, 68, dtype=q.dtype, device=cuda)
    ragged = wide[..., :64].transpose(1, 2)            # rows 136 bytes apart
    before = (fa.flash_dq.launches, fa.flash_dkv.launches)
    for bad in (shifted, ragged):
        with pytest.raises(ValueError, match="16 bytes"):
            fa.flash_dq(bad, k, v, do, lse, delta)
        with pytest.raises(ValueError, match="16 bytes"):
            fa.flash_dkv(q, k, v, bad, lse, delta)
    assert (fa.flash_dq.launches, fa.flash_dkv.launches) == before


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,KV,S,d,causal,window,bshd", [
    (2, 4, 4, 128, 16, True, None, True),       # d = 16, padded to 64
    (1, 2, 1, 100, 32, True, 48, True),         # d = 32, ragged S, window
    (1, 14, 2, 320, 64, True, None, True),      # GQA 7, five k-tiles
    (1, 14, 2, 256, 64, True, 100, False),      # GQA 7, window, contiguous
    (2, 4, 4, 200, 128, False, None, True),     # full, ragged S
    (1, 4, 4, 1024, 128, True, 300, True),      # window over many tiles
])
def test_cuda_tensor_core_forward_matches_flash_fwd_ref(cuda, B, H, KV, S, d,
                                                        causal, window, bshd):
    """The bf16 forward on the tensor cores (``csrc/flash_fwd_sm90.cu``)
    against ``flash_fwd_ref``: o within one bf16 step (2**-7 |ref| + 1e-4),
    lse within 1e-4 + 1e-4 |ref|; one launch, on the tensor cores, o in
    q's strides."""
    q, k, v, _ = _flash_inputs(B, H, KV, S, d, torch.bfloat16, cuda, bshd,
                               seed=9)
    mask = dict(causal=causal, window=window)
    before = (fa.flash_fwd.launches, fa.flash_fwd.tensor_core_launches)
    o, lse = fa.flash_fwd(q, k, v, **mask)
    torch.cuda.synchronize()
    assert (fa.flash_fwd.launches - before[0],
            fa.flash_fwd.tensor_core_launches - before[1]) == (1, 1)
    block = 64 if S % 64 == 0 else S            # blocks that tile S
    ro, rlse = wire_ref.flash_fwd_ref(q, k, v, **mask, block_q=block,
                                      block_k=block)
    assert o.dtype == torch.bfloat16 and o.stride() == q.stride()
    err = (o.float() - ro.float()).abs()
    assert bool((err <= 2.0 ** -7 * ro.float().abs() + 1e-4).all()), \
        float(err.max())
    torch.testing.assert_close(lse, rlse, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_cuda_flash_forward_raises_on_rows_off_16_bytes(cuda):
    """The bf16 forward copies rows in 16-byte chunks: a view off 16 bytes
    raises before any launch; its f32 copy (contiguous, so on 16 bytes)
    runs on the f32 tensor-core forward."""
    q, k, v, _ = _flash_inputs(1, 4, 2, 64, 64, torch.bfloat16, cuda)
    flat = torch.zeros(q.numel() + 1, dtype=q.dtype, device=cuda)
    shifted = flat[1:].view(q.shape)
    wide = torch.zeros(1, 64, 4, 68, dtype=q.dtype, device=cuda)
    ragged = wide[..., :64].transpose(1, 2)
    before = fa.flash_fwd.launches
    for bad in (shifted, ragged):
        with pytest.raises(ValueError, match="16 bytes"):
            fa.flash_fwd(bad, k, v)
        with pytest.raises(ValueError, match="16 bytes"):
            fa.flash_attention(q, bad[:, :2], v)
    assert fa.flash_fwd.launches == before
    tc = fa.flash_fwd.tensor_core_launches
    tc32 = fa.flash_fwd.f32_tensor_core_launches
    fa.flash_fwd(ragged.float(), k.float(), v.float())
    torch.cuda.synchronize()
    assert (fa.flash_fwd.launches, fa.flash_fwd.tensor_core_launches,
            fa.flash_fwd.f32_tensor_core_launches) == (before + 1, tc,
                                                       tc32 + 1)


@pytest.mark.cuda
def test_cuda_f32_flash_raises_on_rows_off_16_bytes(cuda):
    """The f32 forward, dq and dk/dv copy rows in 16-byte chunks (four
    floats) too: a view whose base address or row stride is off 16 bytes
    raises before any launch; nothing falls back."""
    q, k, v, do = _flash_inputs(1, 4, 2, 64, 64, torch.float32, cuda)
    o, lse = fa.flash_fwd(q, k, v)
    delta = wire_ref.flash_delta(o, do)
    flat = torch.zeros(q.numel() + 1, device=cuda)
    shifted = flat[1:].view(q.shape)                   # base 4 bytes off
    wide = torch.zeros(1, 64, 4, 66, device=cuda)
    ragged = wide[..., :64].transpose(1, 2)            # rows 264 bytes apart
    before = ([fn.launches for fn in FLASH],
              [fn.f32_tensor_core_launches for fn in FLASH])
    for bad in (shifted, ragged):
        with pytest.raises(ValueError, match="16 bytes"):
            fa.flash_fwd(bad, k, v)
        with pytest.raises(ValueError, match="16 bytes"):
            fa.flash_fwd(q, bad[:, :2], v)
        with pytest.raises(ValueError, match="16 bytes"):
            fa.flash_dkv(q, k, v, bad, lse, delta)
        with pytest.raises(ValueError, match="16 bytes"):
            fa.flash_dkv(bad, k, v, do, lse, delta)
        for args in ((bad, k, v, do), (q, bad[:, :2], v, do),
                     (q, k, bad[:, :2], do), (q, k, v, bad)):
            with pytest.raises(ValueError, match="16 bytes"):
                fa.flash_dq(*args, lse, delta)
    assert ([fn.launches for fn in FLASH],
            [fn.f32_tensor_core_launches for fn in FLASH]) == before


# ------------------------------------------------ the paged kernel, split-K
def _long_inputs(H, KV, hd, dtype, cuda, seed=13):
    """8 requests over 128 pages of 16 (2048 positions): contexts from one
    page to the table's reach, most over several 64-position chunks."""
    B, bs, P = 8, 16, 128
    q, kp, vp, tbl, _ = _inputs(B, H, KV, bs, P, hd, seed)
    ctx = torch.tensor([0, 63, 65, 700, 1024, 1500, 2047, 2048],
                       dtype=torch.int32)
    return [t.to(cuda) for t in (q.to(dtype), kp.to(dtype), vp.to(dtype),
                                 tbl, ctx)]


@pytest.mark.cuda
@pytest.mark.parametrize("H,KV,hd,window,dtype", [
    (16, 16, 128, None, torch.bfloat16),
    (14, 2, 64, None, torch.bfloat16),
    (14, 2, 64, 1000, torch.float32),
    (16, 16, 128, 130, torch.float32),
])
def test_cuda_paged_kernel_long_contexts_batch_invariant(cuda, H, KV, hd,
                                                         window, dtype):
    """Contexts up to 2048 over many chunks (the merge of the chunks'
    partials runs): the plain version's tolerance, the ctx-0 row exact
    zeros, and each row alone, with a table only as wide as its pages,
    bit-identical to the same row of the batch."""
    q, kp, vp, tbl, ctx = _long_inputs(H, KV, hd, dtype, cuda)
    out = pa.paged_attention(q, kp, vp, tbl, ctx, window=window)
    ref = pa.paged_attention_ref(q, kp, vp, tbl, ctx, window=window)
    torch.cuda.synchronize()
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    assert not out[0].any()
    for b in range(len(ctx)):
        pages = max(1, -(-int(ctx[b]) // 16))
        one = pa.paged_attention(q[b:b + 1], kp, vp, tbl[b:b + 1, :pages],
                                 ctx[b:b + 1], window=window)
        assert torch.equal(one[0], out[b]), b


@pytest.mark.cuda
@pytest.mark.parametrize("kvdt", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_cuda_paged_kernel_long_window_pre_window_scratch(cuda, kvdt):
    """The serving dry run's long_500k layout at a long context: 2 rows of
    9,000 and 12,345 positions over 772-page tables, a window of 8,192,
    every page before the window on scratch block 0 (filled with 1e4,
    which no row may read), the window's pages on blocks of their own;
    against the plain version within phase 3's bounds (1e-4 f32, 2e-2
    bf16) and, since the outputs are ~1/sqrt(8192) of V's scale, each
    (row, head) within a norm relative to the plain version's (1e-3 f32,
    1e-2 bf16).  The window's oldest 64 keys dropped (a lost chunk
    partial) must fail that check in every (row, head)."""
    from repro_torch.launch.serve import window_tables
    bs, W, ctx = 16, 8192, [9000, 12345]
    tables, blocks = window_tables(1, max(ctx), bs, W)
    P = tables.shape[1]
    tbl = np.zeros((2, P), np.int32)
    for b, c in enumerate(ctx):
        row, n = window_tables(1, c, bs, W)
        tbl[b, :row.shape[1]] = np.where(row[0] > 0, row[0] + b * n, 0)
    g = torch.Generator().manual_seed(11)
    N = int(tbl.max()) + 1
    q = torch.randn(2, 14, 64, generator=g).to(kvdt)
    kp = torch.randn(N, 2, bs, 64, generator=g)
    vp = torch.randn(N, 2, bs, 64, generator=g)
    kp[0], vp[0] = 1e4, 1e4
    args = [t.to(cuda) for t in (q, kp.to(kvdt), vp.to(kvdt),
                                 torch.from_numpy(tbl),
                                 torch.tensor(ctx, dtype=torch.int32))]
    out = pa.paged_attention(*args, window=W)
    ref = pa.paged_attention_ref(*args, window=W)
    tol = 1e-4 if kvdt == torch.float32 else 2e-2
    err = (out.float() - ref.float()).abs()
    assert bool((err <= tol + tol * ref.float().abs()).all()), \
        float(err.max())
    assert float(out.float().abs().max()) < 100     # scratch not read

    def rel(a):
        return ((a.float() - ref.float()).norm(dim=-1)
                / ref.float().norm(dim=-1))
    rel_tol = 1e-3 if kvdt == torch.float32 else 1e-2
    assert float(rel(out).max()) <= rel_tol, float(rel(out).max())
    dropped = pa.paged_attention_ref(*args, window=W - 64)
    assert float(rel(dropped).min()) > rel_tol, float(rel(dropped).min())


@pytest.mark.cuda
def test_cuda_paged_kernel_graph_replay_equals_eager(cuda):
    """A CUDA graph of the kernel, replayed twice, gives the eager call's
    bits: the merge's counters are zero again after every launch."""
    q, kp, vp, tbl, ctx = _long_inputs(14, 2, 64, torch.bfloat16, cuda)
    eager = pa.paged_attention(q, kp, vp, tbl, ctx)
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        pa.paged_attention(q, kp, vp, tbl, ctx)
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = pa.paged_attention(q, kp, vp, tbl, ctx)
    for _ in range(2):
        g.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)
    _, counters = pa._workspaces[cuda.index or 0]
    assert not counters.any()


@pytest.mark.cuda
def test_cuda_paged_smem_matches_the_kernel(cuda):
    """The wrapper's shared-memory count (``supports``) is the kernel's."""
    from repro_torch.kernels import _build
    fn = _build.bind("paged_attention", "paged_attention_smem",
                     [ctypes.c_int] * 4)
    for G, hd, bs, size in ((1, 128, 16, 2), (7, 64, 16, 2), (12, 128, 16, 2),
                            (1, 256, 16, 4), (8, 8, 5, 4)):
        assert fn(G, hd, pa.chunk_positions(bs), size) == \
            pa.smem_bytes(G, hd, bs, size)


@pytest.mark.cuda
def test_cuda_paged_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    pool = torch.zeros(3, 2, 16, 12, dtype=torch.bfloat16, device=cuda)
    q = torch.zeros(2, 4, 12, dtype=torch.bfloat16, device=cuda)
    tbl = torch.zeros(2, 1, dtype=torch.int32, device=cuda)
    ctx = torch.ones(2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="does not take"):   # rows of 24 B
        pa.paged_attention(q, pool, pool, tbl, ctx)
    flat = torch.zeros(3 * 2 * 16 * 16 + 1, dtype=torch.bfloat16,
                       device=cuda)
    shifted = flat[1:].view(3, 2, 16, 16)
    with pytest.raises(ValueError, match="16 bytes"):
        pa.paged_attention(q[..., :8].contiguous().repeat(1, 1, 2), shifted,
                           shifted, tbl, ctx)


# ------------------------------------------------- the threefry key stream
from repro_torch import random  # noqa: E402
from repro_torch.core import dsc as dsc_lib  # noqa: E402
from repro_torch.core import compressors as comp  # noqa: E402
from repro_torch.serve import sample  # noqa: E402


@pytest.fixture(params=[True, False], ids=["partitionable", "original"])
def layout(request, monkeypatch):
    monkeypatch.setattr(random, "partitionable", request.param)
    return request.param


@pytest.mark.cuda
def test_cuda_stream_equals_host(cuda, layout):
    """Keys split and folded on the card, and every integer draw and
    uniform made there, equal the host's bit for bit; Gumbel noise within
    8 ulps of max(|g|, 1) (the two devices' logs)."""
    key, ckey = random.PRNGKey(9), random.PRNGKey(9).to(cuda)
    assert torch.equal(random.split(ckey, 6).cpu(), random.split(key, 6))
    assert torch.equal(random.fold_in(ckey, 2**31 + 1).cpu(),
                       random.fold_in(key, 2**31 + 1))
    n = 300_007
    for draw in (lambda d: random.bits(key, (n,), device=d),
                 lambda d: random.uniform(key, (n,), device=d),
                 lambda d: random.uniform(key, (n,), -3.3, 7.1, device=d),
                 lambda d: random.bernoulli(key, 0.3, (n,), device=d),
                 lambda d: random.randint(key, (n,), -5, 100003, device=d),
                 lambda d: random.permutation(key, n, device=d)):
        assert torch.equal(draw(cuda).cpu(), draw("cpu"))
    g, hg = random.gumbel(key, (n,), device=cuda).cpu(), \
        random.gumbel(key, (n,))
    ulp = torch.from_numpy(np.spacing(hg.abs().clamp_min(1.0).numpy()))
    assert float(((g - hg).abs() / ulp).max()) <= 8


@pytest.mark.cuda
def test_cuda_chunked_draws_equal_one_piece(cuda, layout, monkeypatch):
    key = random.PRNGKey(4)
    whole = random.bernoulli(key, 0.25, (1_000_003,), device=cuda)
    bits = random.bits(key, (1_000_003,), device=cuda)
    monkeypatch.setattr(random, "CHUNK", 65536)
    assert torch.equal(random.bernoulli(key, 0.25, (1_000_003,),
                                        device=cuda), whole)
    assert torch.equal(random.bits(key, (1_000_003,), device=cuda), bits)
    lo = 123_456
    assert torch.equal(random.bits(key, (1_000_003,), device=cuda,
                                   window=(lo, lo + 5000)),
                       bits[lo:lo + 5000])


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
def test_cuda_jnp_dsc_equals_host(cuda, int8, monkeypatch):
    """The threefry DSC client step on the card (its int8 round trip on
    the quantize kernels) equals the host's, v and s' bit for bit, over
    several chunks."""
    monkeypatch.setattr(random, "CHUNK", 65536)
    c = comp.RandP(p=0.3)
    c = comp.Int8RoundTrip(inner=c) if int8 else c
    rng = np.random.default_rng(3)
    g = torch.from_numpy(rng.standard_normal(300_007).astype(np.float32))
    s = torch.from_numpy((0.2 * rng.standard_normal(300_007)).astype(
        np.float32))
    s_card = s.to(cuda)
    qz.quantize.launches = 0
    v_card = dsc_lib.compress_client(s_card, g.to(cuda), c, 0.37,
                                     random.PRNGKey(2))
    v = dsc_lib.compress_client(s, g, c, 0.37, random.PRNGKey(2))
    assert qz.quantize.launches == (5 if int8 else 0)
    assert torch.equal(v_card.cpu(), v) and torch.equal(s_card.cpu(), s)


@pytest.mark.cuda
def test_cuda_sampler_equals_host(cuda):
    """The sampler on the card, with the host's keys and logits, draws
    the host's tokens (the Gumbel noise a few ulps apart does not move an
    argmax on this set)."""
    rng = np.random.default_rng(9)
    n, V = 64, 50257
    logits = torch.from_numpy((2 * rng.standard_normal((n, V))).astype(
        np.float32))
    args = [torch.from_numpy(a) for a in (
        rng.choice([0.0, 0.7, 1.0, 1.5], n).astype(np.float32),
        rng.choice([0, 1, 20, 400], n).astype(np.int32),
        rng.choice([1.0, 0.9, 0.5], n).astype(np.float32))]
    keys = random.split(random.PRNGKey(3), n)
    got = sample(keys.to(cuda), logits.to(cuda), *(a.to(cuda) for a in args))
    assert torch.equal(got.cpu(), sample(keys, logits, *args))


# ------------------------------------------------- the distributed step
@pytest.fixture(scope="module")
def nccl_rank():
    """A one-rank ``cpu:gloo,cuda:nccl`` group on a loopback port (CUDA
    tensors through NCCL, CPU tensors through gloo), made only once a
    card is found, and its mesh."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    if shutil.which("nvcc") is None and \
            not os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("needs nvcc (the CUDA toolkit) to build the kernel")
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_lib
    device = mesh_lib.init_process_group("cuda")
    yield device, mesh_lib.make_host_mesh(device=device)
    dist.destroy_process_group()


def _train_run(cfg, mesh, fields, device, steps, opt):
    from repro_torch.convert import tree_map
    from repro_torch.launch import train
    settings = train.TrainSettings(**fields)
    step = train.make_train_step(cfg, mesh, opt, settings, device=device)
    params = tree_map(lambda t: t.to(device), train.store_params(
        tr.init_params(cfg, seed=0, device="cpu"), cfg, mesh, settings))
    state = opt.init(params)
    dsc_ref = train.init_dsc_state(cfg, mesh, settings, device=device)
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab, size=(8, 64)).astype(np.int32)).to(device)
    losses = []
    for i in range(steps):
        params, state, dsc_ref, m = step(params, state, dsc_ref,
                                         {"tokens": toks}, random.PRNGKey(i))
        losses.append(float(m["loss"]))
    return params, state, losses


@pytest.mark.cuda
@pytest.mark.parametrize("fields", [
    dict(grad_dtype="float32"),
    dict(grad_dtype="float32", use_dsc=True, int8_wire=True),
    dict(grad_dtype="float32", int8_wire=True),
    dict(grad_dtype="float32", use_dsc=True),
    dict(grad_dtype="float32", int8_wire=True, ldp_eps=8.0,
         agg_dropout=0.25, link_failure=0.1),
    dict(grad_dtype="float32", int8_wire=True, async_buffer=True,
         buffer_cadence=2, client_dropout=0.25, delay_max=2),
    dict(grad_dtype="float32", use_dsc=True, dsc_p=0.5, int8_wire=True,
         agg_dropout=0.25, link_failure=0.1),
    dict(grad_dtype="float32", secure_mask=True)],
    ids=["fsa", "dsc_int8_fused", "int8", "dsc", "ldp_int8+agg_fail",
         "async_int8", "dsc_int8+agg_fail", "secure_agg"])
def test_cuda_train_step_equals_the_host(cuda, nccl_rank, fields):
    """Two sgd steps of the distributed step on the one-rank NCCL group
    (kernels) and on the host (gloo, plain versions), eris-gptneo-1.3b's
    smoke variant in f32, same params and keys: params within 1e-4
    relative norm, losses within 1e-4 (the gradients differ in their last
    bits, and an int8 code flips where a draw falls within an ulp of its
    fraction).  With the fused wire, one dsc_quantize a leaf a step."""
    from repro_torch.convert import tree_leaves
    from repro_torch.optim import sgd
    device, mesh = nccl_rank
    cfg = get_config("eris-gptneo-1.3b").smoke()
    dq.dsc_quantize.launches = 0
    card, _, closs = _train_run(cfg, mesh, fields, device, 2, sgd(0.05))
    if fields.get("use_dsc") and fields.get("int8_wire"):
        assert dq.dsc_quantize.launches == 2 * len(tree_leaves(card))
    host, _, hloss = _train_run(cfg, mesh, fields, torch.device("cpu"), 2,
                                sgd(0.05))
    cx = torch.cat([t.reshape(-1).cpu() for t in tree_leaves(card)])
    hx = torch.cat([t.reshape(-1) for t in tree_leaves(host)])
    assert float((cx - hx).norm() / hx.norm()) <= 1e-4
    np.testing.assert_allclose(closs, hloss, rtol=1e-4)


@pytest.mark.cuda
def test_cuda_train_draws_equal_the_host(cuda):
    """The distributed step's per-leaf draws on the card: every rank's
    mask row at n_client 4 equal to the host's bit for bit, on a window
    past 2**24, the four summing to exactly zero; each rank's LDP noise
    within 8 ulps of the host's."""
    from repro_torch.launch import train
    key, n, window = random.PRNGKey(3), 2**25 + 77, (2**24 - 5, 2**24 + 4099)
    rows = []
    for aidx in range(4):
        card = train.mask_row(key, 5, aidx, 4, n, device=cuda, window=window)
        host = train.mask_row(key, 5, aidx, 4, n, window=window)
        assert torch.equal(card.cpu(), host)
        rows.append(card)
        z_card = train.ldp_noise(key, 5, aidx, (n,), device=cuda,
                                 window=window).cpu()
        z_host = train.ldp_noise(key, 5, aidx, (n,), window=window)
        ulps = (z_card.view(torch.int32).long()
                - z_host.view(torch.int32).long()).abs().max()
        assert torch.equal(z_card.sign(), z_host.sign()) and int(ulps) <= 8
    assert bool(((rows[0] + rows[1] + rows[2] + rows[3]) == 0).all())


@pytest.mark.cuda
def test_cuda_adam_update_equals_the_host(cuda):
    """Three adam updates (weight decay on) of host-made bf16 params and
    gradients, on the card and on the host: params, mu, nu and their
    dtypes bit for bit (separate IEEE-rounded ops, the square root
    correctly rounded on both)."""
    from repro_torch.convert import tree_leaves, tree_map
    from repro_torch.optim import adam
    rng = np.random.default_rng(6)
    p0 = {"w": torch.from_numpy(rng.standard_normal((257, 129)).astype(
        np.float32)).bfloat16(), "b": torch.zeros(129, dtype=torch.bfloat16)}
    grads = [tree_map(lambda t: torch.from_numpy(rng.standard_normal(
        tuple(t.shape)).astype(np.float32)), p0) for _ in range(3)]
    ends = []
    for d in (cuda, torch.device("cpu")):
        opt = adam(1e-2, weight_decay=0.1)
        p = tree_map(lambda t: t.to(d), p0)
        st = opt.init(p)
        for g in grads:
            delta, st = opt.update(
                tree_map(lambda x, q: x.to(d).to(q.dtype), g, p), st, p)
            p = tree_map(torch.add, p, delta)
        ends.append(tree_leaves(p) + tree_leaves(st.mu) + tree_leaves(st.nu))
    for a, b in zip(*ends):
        assert a.dtype == b.dtype and torch.equal(a.cpu(), b)


@pytest.mark.cuda
def test_cuda_adam_step_makes_bf16_params_f32(cuda, nccl_rank):
    """A bf16 model through one adam step on the card: every stored leaf
    is f32 (the reference's delta is f32: its bias correction is an f32
    array), the moments stay bf16 until the next step makes them f32."""
    from repro_torch.convert import tree_leaves
    from repro_torch.optim import adam
    device, mesh = nccl_rank
    cfg = dataclasses.replace(get_config("eris-gptneo-1.3b").smoke(),
                              dtype="bfloat16")
    params, state, _ = _train_run(cfg, mesh, dict(use_dsc=True,
                                                  int8_wire=True), device, 1,
                                  adam(1e-2))
    assert {t.dtype for t in tree_leaves(params)} == {torch.float32}
    assert {t.dtype for t in tree_leaves(state.mu)} == {torch.bfloat16}
    params, state, _ = _train_run(cfg, mesh, dict(), device, 2, adam(1e-2))
    assert {t.dtype for t in tree_leaves(state.mu)} == {torch.float32}


# ------------------------------------------------ the round matrix stages
def _stage_inputs(cuda, K=4, n=300_007, seed=21):
    """K client vectors on the host and the card, and a round's keys."""
    from repro_torch.core import pipeline as pl
    rng = np.random.default_rng(seed)
    v = torch.from_numpy((0.1 * rng.standard_normal((K, n))).astype(
        np.float32))
    return v, v.to(cuda), pl.split_round_keys(random.PRNGKey(seed))


@pytest.mark.cuda
@pytest.mark.parametrize("stage", ["ldp", "prune", "pairwise"])
def test_cuda_compress_stages_equal_host(cuda, stage, monkeypatch):
    """LDPNoise, PruneWithhold and PairwiseMask on the card, client by
    client over several chunks: the pairwise masks and the withheld
    update bit for bit with the host's, the LDP noise within 4 ulps of
    max(|out|, sigma) (the two devices' erfinv and log1p)."""
    from repro_torch.core import baselines as bl
    from repro_torch.core import pipeline as pl
    monkeypatch.setattr(random, "CHUNK", 65536)
    v, v_card, keys = _stage_inputs(cuda)
    K = v.shape[0]
    st = {"ldp": pl.LDPNoise(ldp=bl.LDPConfig(8.0, 1e-5, 1.0)),
          "prune": pl.PruneWithhold(rate=0.1),
          "pairwise": pl.PairwiseMask()}[stage]
    state = pl.RoundState(None, None, ())
    sigma = bl.gaussian_sigma(8.0, 1e-5, 1.0)
    for k in range(K):
        card = st.apply(keys, state, v_card[k], k, K).cpu()
        host = st.apply(keys, state, v[k], k, K)
        if stage == "ldp":
            ulp = torch.from_numpy(np.spacing(
                host.abs().clamp_min(sigma).numpy()))
            assert float(((card - host).abs() / ulp).max()) <= 4
        else:
            assert torch.equal(card, host)


@pytest.mark.cuda
@pytest.mark.parametrize("stage", ["secure_agg", "shatter", "failures",
                                   "buffered"])
def test_cuda_aggregate_stages_equal_host(cuda, stage, monkeypatch):
    """The streamed aggregate stages on the card against the host from
    the same vectors and keys: secure aggregation's masked mean bit for
    bit (fixed-point masks, rows added in order), shatter, failure
    injection and the buffer within 1e-6 relative norm."""
    from repro_torch.core import pipeline as pl
    monkeypatch.setattr(random, "CHUNK", 65536)
    v, v_card, keys = _stage_inputs(cuda)
    K, n = v.shape
    st = {"secure_agg": pl.SecureAggAggregate(),
          "shatter": pl.ShatterAggregate(chunks=8, r=2),
          "failures": pl.FailureInjectedFSA(A=8, agg_dropout=0.25,
                                            link_failure=0.3,
                                            mask_scheme="contiguous"),
          "buffered": pl.BufferedAggregate(
              arrival=pl.ArrivalModel(delay_max=2, dropout=0.25),
              cadence=1)}[stage]
    out = []
    for rows, d in ((v_card, cuda), (v, torch.device("cpu"))):
        state = pl.RoundState(None, None, (), buf=pl.init_buffer(n, d))
        out.append(st.apply(keys, state, iter(rows), K).update.cpu())
    if stage == "secure_agg":
        assert torch.equal(out[0], out[1])
    else:
        assert float((out[0] - out[1]).norm() / out[1].norm()) < 1e-6


@pytest.mark.cuda
def test_cuda_withhold_threshold_equals_topk(cuda):
    """The radix selection on the card: the k-th largest |g| as
    torch.topk finds it, f32 and bf16, with ties."""
    from repro_torch.core import baselines as bl
    rng = np.random.default_rng(5)
    g = torch.from_numpy(np.round(rng.standard_normal(1_000_003) * 64)
                         .astype(np.float32) / 64).to(cuda)
    for t in (g, g.bfloat16()):
        for k in (1, 1000, 100_000, t.numel()):
            want = torch.topk(t.float().abs(), k).values[-1]
            assert float(bl.withhold_threshold(t, k)) == float(want)


# ------------------------------------------------------ the privacy audit
@pytest.mark.cuda
def test_cuda_flash_function_refuses_a_create_graph_backward(cuda):
    """On the card the kernels' outputs carry no graph, so a second
    derivative through the Function would drop attention's share in
    silence: a ``create_graph=True`` backward raises instead, and the
    first-order backward runs the kernels."""
    torch.manual_seed(0)
    x = torch.randn(1, 128, 64, device=cuda, requires_grad=True)
    w = torch.randn(64, 256, device=cuda, requires_grad=True)

    def loss():
        q = (x @ w).view(1, 128, 4, 64).transpose(1, 2)
        return (fa.flash_attention(q, q, q) ** 2).sum()

    with pytest.raises(RuntimeError, match="once differentiable"):
        torch.autograd.grad(loss(), (w,), create_graph=True)
    before = fa.flash_dq.launches
    (gw,) = torch.autograd.grad(loss(), (w,))
    torch.cuda.synchronize()
    assert fa.flash_dq.launches == before + 1 and bool(gw.isfinite().all())


@pytest.mark.cuda
def test_cuda_tap_views_round_trip_the_int8_wire(cuda, nccl_rank):
    """One sgd step with ``capture_views`` on the int8 wire on the
    one-rank NCCL group: each leaf's view is the dequantized round trip
    the dequantize kernel received (one launch a leaf), the update
    applied bit for bit (n_client = 1: the mean of one row is the row),
    and the host's views within one quantization step everywhere and 1e-3
    relative norm: the two devices' gradients differ in their last bits,
    so a code flips where a draw falls within an ulp of its fraction
    (2.0e-4 of the norm measured on an NVIDIA H100 80GB HBM3)."""
    from repro_torch.convert import tree_leaves, tree_map
    from repro_torch.launch import train
    from repro_torch.optim import sgd
    from repro_torch.optim.optimizers import weak
    device, mesh = nccl_rank
    cfg = get_config("eris-gptneo-1.3b").smoke()
    views = []
    for d in (device, torch.device("cpu")):
        settings = train.TrainSettings(grad_dtype="float32", int8_wire=True,
                                       capture_views=True)
        step = train.make_train_step(cfg, mesh, sgd(0.05), settings,
                                     device=d)
        params = tree_map(lambda t: t.to(d), train.store_params(
            tr.init_params(cfg, seed=0, device="cpu"), cfg, mesh, settings))
        pre = [t.clone() for t in tree_leaves(params)]
        toks = torch.from_numpy(np.random.default_rng(4).integers(
            0, cfg.vocab, size=(8, 64)).astype(np.int32)).to(d)
        before = qz.dequantize.launches
        params, _, _, _, v = step(params, (), train.init_dsc_state(
            cfg, mesh, settings, device=d), {"tokens": toks},
            random.PRNGKey(0))
        if d.type == "cuda":
            torch.cuda.synchronize()
            assert qz.dequantize.launches - before == len(pre)
        for i, (p0, p1) in enumerate(zip(pre, tree_leaves(params))):
            g = v[str(i)][0, 0].view(p0.shape)
            assert torch.equal(p1, p0 + weak(-0.05, g) * g)
        views.append(torch.cat([v[str(i)].reshape(-1).cpu()
                                for i in range(len(pre))]))
    diff = (views[0] - views[1]).abs()
    assert float(diff.max()) <= float(views[1].abs().max()) / 127 * 1.001
    assert float((views[0] - views[1]).norm() / views[1].norm()) <= 1e-3


# ------------------------------------------------------ recurrent families
@pytest.mark.cuda
def test_hymba_smoke_gradient_on_the_card_equals_the_host(cuda):
    """hymba-1.5b's smoke variant in f32 (attention and the selective
    scan in parallel): the loss and every gradient leaf on the card,
    through the flash kernels (one launch of each a layer), within 1e-4
    relative norm of the host's plain path."""
    cfg = get_config("hymba-1.5b").smoke()
    host = tr.init_params(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, size=(4, 64)).astype(np.int32))
    out = []
    for device in (cuda, torch.device("cpu")):
        params = {k: ({n: t.to(device) for n, t in v.items()}
                      if isinstance(v, dict) else v.to(device))
                  for k, v in host.items()}
        leaves = [params["embed"]] + list(params["blocks"].values())
        for t in leaves:
            t.requires_grad_()
        _set_flash_launches(0)
        loss = tr.loss_fn(params, cfg, {"tokens": toks.to(device)})
        grads = torch.autograd.grad(loss, leaves)
        if device.type == "cuda":
            assert [fn.launches for fn in FLASH] == [cfg.n_layers] * 3
        out.append((float(loss), [g.cpu() for g in grads]))
    (lc, gc), (lh, gh) = out
    assert abs(lc - lh) <= 1e-4 * abs(lh)
    for a, b in zip(gc, gh):
        assert float((a - b).norm() / b.norm()) < 1e-4


@pytest.mark.cuda
def test_cuda_collectives_through_a_gloo_group_are_host_staged(cuda,
                                                               nccl_rank):
    """On a gloo group a CUDA tensor crosses through host buffers and
    comes back on the card: every collective of ``dist/collectives`` at
    one rank returns its operand, and the NCCL group does not stage.  The
    ring shift needs a peer (gloo sends to no rank's self; the model axis
    shifts only at two ranks or more): ``chip_smoke.py`` phase 16 runs
    it between processes on the card."""
    import torch.distributed as dist
    from repro_torch.dist import collectives as cl
    device, _ = nccl_rank
    gloo = dist.new_group([0], backend="gloo")
    x = torch.arange(24, dtype=torch.float32, device=device).view(2, 3, 4)
    assert cl.host_staged(x, gloo)
    assert not cl.host_staged(x, dist.group.WORLD)
    for y in (cl.all_reduce(x, gloo), cl.all_gather(x, gloo, 1),
              cl.reduce_scatter(x, gloo, 2), cl.all_to_all(x, gloo, 1, 2)):
        assert y.device == x.device
        assert torch.equal(y, x)
    assert torch.equal(cl.all_reduce(x, gloo, dist.ReduceOp.MAX), x)
    dist.destroy_process_group(gloo)
