"""The port's serving engine on the CPU, against the reference engine and
its own contracts: greedy token streams equal to ``repro.serve``'s for the
same params, batched output identical to solo output (sampled requests
included), preemption replay, EOS, validation, and the sampler.

The port's sampler draws from its own counter-based stream (the murmur3
hash of ``kernels/common`` keyed on request seed and token index), not
from threefry: greedy requests match the reference exactly, sampled ones
in distribution, which the last tests check against the filtered
distribution both samplers draw from."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import transformer as ref_tr  # noqa: E402
from repro.serve import ServeEngine as RefServeEngine  # noqa: E402
from repro.serve import ServeSettings as RefServeSettings  # noqa: E402
from repro.serve import sample as ref_sample  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch import serve as serve_lib  # noqa: E402
from repro_torch.models import transformer as tr  # noqa: E402
from repro_torch.serve import (SamplingParams, ServeEngine,  # noqa: E402
                               ServeSettings, pages_for, sample)
from repro_torch.serve.sampling import token_uniforms  # noqa: E402


def tiny_cfg(arch="qwen2-0.5b"):
    return dataclasses.replace(get_config(arch).smoke(), n_layers=2,
                               dtype="float32")


SETTINGS = dict(max_concurrency=8, block_size=8, num_blocks=64,
                max_model_len=48, prefill_bucket=16, max_new_tokens=6,
                cache_dtype="float32")


def tiny_settings(**over):
    return ServeSettings(**dict(SETTINGS, **over))


def prompts_for(vocab, n, seed=0, lo=3, hi=11):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=int(rng.integers(lo, hi))).tolist()
            for _ in range(n)]


@pytest.fixture(scope="module")
def params():
    return tr.init_params(tiny_cfg(), seed=0, device="cpu")


# ------------------------------------------------- against the reference
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "eris-gptneo-1.3b"])
def test_greedy_streams_equal_reference_engine(arch):
    """Same params (carried by params_from_jax), same prompts: the port's
    engine emits the reference engine's greedy token streams, through
    prefill buckets, ragged admission and the paged decode."""
    cfg = dataclasses.replace(ref_get_config(arch).smoke(), n_layers=2,
                              dtype="float32")
    ref_params = ref_tr.init_params(jax.random.PRNGKey(0), cfg)
    params = params_from_jax(jax.tree.map(np.asarray, ref_params), "cpu")
    prompts = prompts_for(cfg.vocab, 3, seed=1, lo=5, hi=20)
    ref = RefServeEngine(cfg, ref_params,
                         RefServeSettings(**SETTINGS)).run(prompts)
    eng = ServeEngine(tiny_cfg(arch), params, tiny_settings(), device="cpu")
    outs = eng.run(prompts)
    assert [o.tokens for o in outs] == [o.tokens for o in ref]
    assert [o.finish_reason for o in outs] == ["length"] * 3


# ---------------------------------------------------- engine contracts
def test_batched_8way_token_identical_to_solo(params):
    """Ten requests share eight slots; every stream, sampled ones
    included, equals the same request served alone."""
    cfg = tiny_cfg()
    prompts = prompts_for(cfg.vocab, 10)
    samps = [SamplingParams() if i % 2 == 0 else
             SamplingParams(temperature=0.8, top_k=5)
             for i in range(len(prompts))]
    eng = ServeEngine(cfg, params, tiny_settings(), device="cpu")
    for i, p in enumerate(prompts):
        eng.submit(p, sampling=samps[i], seed=i)
    outs, max_active = [], 0
    while eng.waiting or eng._active():
        outs.extend(eng.step())
        max_active = max(max_active, len(eng._active()))
    outs = sorted(outs, key=lambda o: o.rid)
    assert max_active == 8
    st = eng.stats()
    assert pages_for(48, 8) < st["peak_blocks"] <= st["block_capacity"]
    assert st["tokens_out"] == 10 * 6
    for i, p in enumerate(prompts):
        solo = ServeEngine(cfg, params, tiny_settings(max_concurrency=1),
                           device="cpu")
        solo.submit(p, sampling=samps[i], seed=i)
        ref = solo.run()
        assert outs[i].tokens == ref[0].tokens, f"request {i} diverged"
        assert outs[i].finish_reason == "length"


def test_preemption_replays_identically(params):
    cfg = tiny_cfg()
    prompts = prompts_for(cfg.vocab, 4, seed=3, lo=8, hi=12)
    samps = [SamplingParams(), SamplingParams(temperature=1.0, top_p=0.9)] * 2
    big = ServeEngine(cfg, params, tiny_settings(max_concurrency=4,
                                                 max_new_tokens=10),
                      device="cpu")
    small = ServeEngine(cfg, params, tiny_settings(
        max_concurrency=4, num_blocks=10, max_model_len=24,
        max_new_tokens=10), device="cpu")
    for eng in (big, small):
        for i, p in enumerate(prompts):
            eng.submit(p, sampling=samps[i], seed=i)
    ref, outs = big.run(), small.run()
    assert sum(o.preemptions for o in outs) > 0
    assert [o.tokens for o in outs] == [o.tokens for o in ref]
    st = small.stats()
    assert st["peak_blocks"] <= st["block_capacity"] == 9


def test_eos_stops_early(params):
    cfg = tiny_cfg()
    prompt = prompts_for(cfg.vocab, 1)[0]
    tok0 = ServeEngine(cfg, params, tiny_settings(),
                       device="cpu").run([prompt])[0].tokens[0]
    out = ServeEngine(cfg, params, tiny_settings(eos_id=tok0),
                      device="cpu").run([prompt])[0]
    assert out.finish_reason == "stop"
    assert out.tokens == [tok0]


def test_naive_and_kernel_paths_agree_on_cpu(params):
    """On the CPU both decode paths compute the plain version: the
    ``decode_kernel`` switch changes nothing but the route."""
    cfg = tiny_cfg()
    prompts = prompts_for(cfg.vocab, 3, seed=4)
    a = ServeEngine(cfg, params, tiny_settings(decode_kernel="cuda"),
                    device="cpu").run(prompts)
    b = ServeEngine(cfg, params, tiny_settings(decode_kernel="naive"),
                    device="cpu").run(prompts)
    assert [o.tokens for o in a] == [o.tokens for o in b]


def test_submit_and_settings_validation(params):
    cfg = tiny_cfg()
    eng = ServeEngine(cfg, params, tiny_settings(), device="cpu")
    with pytest.raises(ValueError, match="empty prompt"):
        eng.submit([])
    with pytest.raises(ValueError, match="max_model_len"):
        eng.submit(list(range(40)), max_new_tokens=40)
    small = ServeEngine(cfg, params, tiny_settings(num_blocks=3),
                        device="cpu")
    with pytest.raises(ValueError, match="blocks"):
        small.submit(list(range(30)), max_new_tokens=10)
    for bad in (dict(max_concurrency=0), dict(num_blocks=1),
                dict(block_size=0), dict(max_model_len=0),
                dict(prefill_bucket=0), dict(decode_kernel="pallas"),
                dict(cache_dtype="int8")):
        with pytest.raises(ValueError, match="ServeSettings"):
            ServeSettings(**bad)
    assert ServeSettings(max_model_len=100, block_size=16).max_pages == 7
    with pytest.raises(ValueError, match="families"):
        ServeEngine(tiny_cfg("xlstm-350m"), params, tiny_settings(),
                    device="cpu")


def test_launch_serve_main_smoke(capsys):
    stats = serve_lib.main(["--arch", "qwen2-0.5b", "--smoke",
                            "--requests", "3", "--gen", "4",
                            "--prompt-min", "3", "--prompt-max", "12",
                            "--device", "cpu"])
    assert stats["requests"] == 3 and stats["finish_reasons"] == ["length"]
    assert stats["tokens_out"] == 12
    assert stats["peak_blocks"] <= stats["block_capacity"]
    assert '"tokens_out": 12' in capsys.readouterr().out


# ------------------------------------------------------------- sampling
def test_greedy_and_topk1_are_argmax():
    logits = torch.from_numpy(
        np.random.default_rng(0).standard_normal((5, 33)).astype(np.float32))
    am = logits.argmax(-1).to(torch.int32)
    u = torch.rand(5, generator=torch.Generator().manual_seed(0))
    zeros = torch.zeros(5, dtype=torch.int32)
    greedy = sample(u, logits, torch.zeros(5), zeros, torch.ones(5))
    assert torch.equal(greedy, am)
    topk1 = sample(u, logits, torch.full((5,), 1.3), zeros + 1,
                   torch.ones(5))
    assert torch.equal(topk1, am)
    tie = torch.tensor([[0.0, 2.0, 2.0, 1.0]])        # first maximum wins
    assert int(sample(u[:1], tie, torch.zeros(1), zeros[:1],
                      torch.ones(1))[0]) == 1


def test_topk_topp_keep_draws_in_support():
    logits = torch.from_numpy(
        np.random.default_rng(2).standard_normal((1, 64)).astype(np.float32))
    top5 = set(torch.argsort(-logits[0])[:5].tolist())
    u = token_uniforms(torch.full((200,), 7), torch.arange(200))
    rows = logits.expand(200, 64)
    k = sample(u, rows, torch.full((200,), 1.5),
               torch.full((200,), 5, dtype=torch.int32), torch.ones(200))
    assert set(k.tolist()) <= top5 and len(set(k.tolist())) > 1
    p = sample(u, rows, torch.full((200,), 2.0),
               torch.zeros(200, dtype=torch.int32), torch.full((200,), 1e-6))
    assert set(p.tolist()) == {int(logits.argmax())}


def test_token_stream_depends_only_on_seed_and_index():
    seeds = torch.tensor([5, 5, 2**40 + 5, 9])
    idx = torch.tensor([3, 3, 3, 0])
    u = token_uniforms(seeds, idx)
    assert u[0] == u[1] and u[0] != u[2]          # high seed bits count
    assert torch.equal(token_uniforms(seeds[2:3], idx[2:3]), u[2:3])
    assert bool(((u >= 0) & (u < 1)).all())


@pytest.mark.parametrize("temp,top_k,top_p", [(1.0, 0, 1.0), (0.7, 8, 1.0),
                                              (1.3, 0, 0.8)])
def test_sampled_distribution_matches_reference(temp, top_k, top_p):
    """Both samplers draw from one filtered distribution (temperature,
    then top-k, then top-p on the sorted probabilities with
    (cum - probs) < top_p).  The port's inverse-CDF draw over a uniform
    grid of 4096 points reproduces it to 1/4096 per token; the
    reference's threefry draws, 4000 of them, to five sigma."""
    V = 24
    logits = np.random.default_rng(3).standard_normal((1, V)).astype(
        np.float32) * 2
    s = logits[0] / temp
    order = np.argsort(-s, kind="stable")
    srt = s[order]
    keep = np.arange(V) < (top_k if top_k else V)
    pr = np.where(keep, np.exp(srt - srt.max()), 0)
    pr /= pr.sum()
    keep &= (np.cumsum(pr) - pr) < top_p
    want = np.zeros(V)
    want[order] = np.where(keep, np.exp(srt - srt.max()), 0)
    want /= want.sum()

    M = 4096
    u = (torch.arange(M, dtype=torch.float64) + 0.5) / M
    got = sample(u.float(), torch.from_numpy(logits).expand(M, V),
                 torch.full((M,), temp), torch.full((M,), top_k,
                                                    dtype=torch.int32),
                 torch.full((M,), top_p))
    freq = np.bincount(got.numpy(), minlength=V) / M
    np.testing.assert_allclose(freq, want, atol=1.5 / M)

    n = 4000
    keys = jax.random.split(jax.random.PRNGKey(0), n)
    drawn = ref_sample(keys, jnp.broadcast_to(jnp.asarray(logits), (n, V)),
                       jnp.full((n,), temp), jnp.full((n,), top_k,
                                                      jnp.int32),
                       jnp.full((n,), top_p))
    ref_freq = np.bincount(np.asarray(drawn), minlength=V) / n
    sigma = np.sqrt(want * (1 - want) / n)
    assert np.all(np.abs(ref_freq - want) <= 5 * sigma + 1e-12)
