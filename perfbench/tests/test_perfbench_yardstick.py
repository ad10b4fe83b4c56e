"""The yardstick's counts against hand counts at both configurations'
shapes, and each per-layer reader's arithmetic on a made-up trace."""
from __future__ import annotations

import pytest

from _bench import ROOT, cell_files

from perfbench import run as bench
from perfbench import yardstick
from perfbench.reference import eris_round

GPTNEO = cell_files("gptneo-round-fused")[0]["model"]
OLMOE = cell_files("olmoe-round-fused")[0]["model"]


def test_reference_layout_counts_the_published_arithmetic():
    # 2 x 50257 x 2048 embed and head, 2048 ln_f, 24 layers of two norms,
    # four 2048^2 projections and three 2048 x 8192 matrices
    assert eris_round.layout(GPTNEO)[1] == 1_816_565_760 == \
        2 * 50257 * 2048 + 2048 + 24 * (2 * 2048 + 4 * 2048**2
                                         + 3 * 2048 * 8192)
    # 2 x 50304 x 2048 + 2048 + 4 x (2 x 2048 + 4 x 2048^2 + 2048 x 64 +
    # 64 x 3 x 2048 x 1024)
    assert eris_round.layout(OLMOE)[1] == 1_884_309_504 == \
        2 * 50304 * 2048 + 2048 + 4 * (2 * 2048 + 4 * 2048**2 + 2048 * 64
                                       + 64 * 3 * 2048 * 1024)


def test_gradient_flops_by_hand():
    # eris-gptneo-1.3b, 4 x 1024 tokens: weights a token multiplies by
    # 24 x (4 x 2048^2 + 3 x 2048 x 8192) + 2048 x 50257
    w = 24 * (4 * 2048**2 + 3 * 2048 * 8192) + 2048 * 50257
    assert w == 1_713_539_072
    attn = 3 * 2 * 2 * 128 * 16 * 4 * (1024 * 1025 // 2) * 24
    assert yardstick.gradient_flops(GPTNEO, 4, 1024) == 6 * w * 4096 + attn
    assert yardstick.gradient_flops(GPTNEO, 4, 1024) == 43_350_094_774_272
    # olmoe-1b-7b-l4, 2 x 4096 tokens: 4 x (4 x 2048^2 + 2048 x 64 + 8 x
    # 3 x 2048 x 1024) + 2048 x 50304
    w = 4 * (4 * 2048**2 + 2048 * 64 + 8 * 3 * 2048 * 1024) + 2048 * 50304
    assert w == 371_982_336
    attn = 12 * 128 * 16 * 2 * (4096 * 4097 // 2) * 4
    assert yardstick.gradient_flops(OLMOE, 2, 4096) == 6 * w * 8192 + attn


def test_flash_bounds_by_hand():
    # (4, 16, 1024, 128) bf16: q, k, v, o 16 MiB each, lse 256 KiB
    t = 4 * 2 * 4 * 16 * 1024 * 128
    fwd_bytes = t + 4 * 4 * 16 * 1024
    fwd_flops = 4 * 128 * 4 * 16 * (1024 * 1025 // 2)
    assert fwd_bytes / 3.35e12 > fwd_flops / 989e12     # bytes bound it
    assert yardstick.flash_bound_s("flash_fwd", GPTNEO, 4, 1024) == \
        pytest.approx(fwd_bytes / 3.35e12, rel=1e-12)
    # (2, 16, 4096, 128): the dk/dv products bound it
    dkv_flops = 8 * 128 * 2 * 16 * (4096 * 4097 // 2)
    assert yardstick.flash_bound_s("flash_dkv", OLMOE, 2, 4096) == \
        pytest.approx(dkv_flops / 989e12, rel=1e-12)


def test_wire_bounds_match_the_kernel_table():
    n = 1_816_565_760
    # 13.02 and 5.02 bytes a coordinate: PERF.md's 7.058 and 2.720 ms
    assert yardstick.wire_bound_s("dsc_quantize", n) * 1e3 == \
        pytest.approx(7.058, abs=1e-3)
    assert yardstick.wire_bound_s("dequantize", n) * 1e3 == \
        pytest.approx(2.720, abs=1e-3)


def _reader(name):
    return bench.load_module(ROOT / "perfbench" / "metrics" / f"{name}.py",
                             f"test_reader_{name}")


def test_readers_on_a_made_up_trace():
    config, traffic, _ = cell_files("gptneo-round-fused")
    n = 1_816_565_760
    B, S = traffic["batch"], traffic["seq"]
    fwd = yardstick.flash_bound_s("flash_fwd", config["model"], B, S)
    quant = yardstick.wire_bound_s("dsc_quantize", n)
    ns = 1_000_000_000
    prof = {"device_ops": [
        ("void flash_fwd_sm90_kernel<...>", 0, int(4 * fwd * ns)),
        ("void dsc_quantize_kernel<float>", 10 * ns, int(10 * ns + 2 * quant
                                                          * ns)),
        ("elementwise", 20 * ns, 30 * ns)], "host_ops": [],
        "window": (0, 40 * ns)}
    ctx = {"config": config, "traffic": traffic, "n": n, "profile": prof,
           "timed": {"round": [1000.0, 1200.0], "grad": [600.0, 700.0],
                     "compress": [200.0, 300.0]},
           "busy_s": 10.5, "window_s": 40.0, "rounds": 5, "wall_s": 6.0,
           "peak_bytes": 70e9, "setup_s": 12.0}
    assert _reader("flash_roofline").read(ctx) == pytest.approx(25.0, rel=1e-3)
    assert _reader("wire_roofline").read(ctx) == pytest.approx(50.0, rel=1e-3)
    assert _reader("grad_ms").read(ctx) == 650.0
    assert _reader("compress_ms").read(ctx) == 250.0
    assert _reader("aggregate_ms").read(ctx) == 200.0
    assert _reader("idle_pct").read(ctx) == pytest.approx(73.75)
    assert _reader("round_mfu").read(ctx) == pytest.approx(
        100 * 4 * yardstick.gradient_flops(config["model"], B, S)
        / (1.1 * 989e12))
    assert _reader("peak_mem_gb").read(ctx) == 70.0
    assert _reader("round_ms").read(dict(ctx, timed=None)) == 1200.0
    assert _reader("round_ms").read(ctx) is None       # a traced run's
    assert _reader("flash_roofline").read(dict(ctx, profile=None)) is None
