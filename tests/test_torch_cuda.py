"""The port's CUDA kernel on the card.  This file imports torch and the
port only (the machine with the card has no jax), so it runs there as

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tests that need the card carry the ``cuda`` marker and skip without one,
naming what is missing; whether there is a card is decided inside the
fixture, never at import."""
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
    """Neither the CPU path nor the kernel: a meta tensor raises."""
    q, kp, vp, tbl, ctx = (t.to("meta") for t in _inputs(2, 4, 2, 8, 2, 16,
                                                         0))
    with pytest.raises(ValueError, match="no kernel for meta"):
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
