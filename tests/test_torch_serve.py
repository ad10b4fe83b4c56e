"""The port's serving engine on the CPU, against the reference engine and
its own contracts: greedy and sampled token streams equal to
``repro.serve``'s for the same params and seeds, batched output identical
to solo output (sampled requests included), preemption replay, EOS,
validation, and the sampler.

Both samplers key token i of a request with ``fold_in(PRNGKey(seed), i)``
and draw with the Gumbel-max trick over the threefry stream; the last
tests also check the draws against the filtered distribution both
samplers draw from."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_thread  # noqa: E402,F401
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import transformer as ref_tr  # noqa: E402
from repro.serve import ServeEngine as RefServeEngine  # noqa: E402
from repro.serve import ServeSettings as RefServeSettings  # noqa: E402
from repro.serve import sample as ref_sample  # noqa: E402
from repro.serve import SamplingParams as RefSamplingParams  # noqa: E402
from repro_torch import random  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch import serve as serve_lib  # noqa: E402
from repro_torch.models import transformer as tr  # noqa: E402
from repro_torch.serve import (SamplingParams, ServeEngine,  # noqa: E402
                               ServeSettings, pages_for, sample)


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
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "eris-gptneo-1.3b",
                                  "olmoe-1b-7b"])
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


# (temperature, top_k, top_p) of the sampled requests, one a request
SAMPLED = ((1.0, 0, 1.0), (0.7, 8, 1.0), (1.3, 0, 0.8), (0.9, 20, 0.9),
           (0.0, 0, 1.0), (2.0, 0, 1.0))


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "eris-gptneo-1.3b",
                                  "olmoe-1b-7b"])
def test_sampled_streams_equal_reference_engine(arch):
    """Same params, same prompts and seeds: six requests sampled with
    temperature, top-k and top-p (and one greedy) through the continuous
    batch give the reference engine's tokens, token for token."""
    cfg = dataclasses.replace(ref_get_config(arch).smoke(), n_layers=2,
                              dtype="float32")
    ref_params = ref_tr.init_params(jax.random.PRNGKey(0), cfg)
    params = params_from_jax(jax.tree.map(np.asarray, ref_params), "cpu")
    prompts = prompts_for(cfg.vocab, len(SAMPLED), seed=1, lo=5, hi=20)
    ref = RefServeEngine(cfg, ref_params, RefServeSettings(**SETTINGS))
    eng = ServeEngine(tiny_cfg(arch), params, tiny_settings(), device="cpu")
    for i, (prompt, (t, k, p)) in enumerate(zip(prompts, SAMPLED)):
        ref.submit(prompt, sampling=RefSamplingParams(t, k, p), seed=100 + i)
        eng.submit(prompt, sampling=SamplingParams(t, k, p), seed=100 + i)
    want, got = ref.run(), eng.run()
    assert [o.tokens for o in got] == [o.tokens for o in want]
    assert len({tuple(o.tokens) for o in got}) == len(SAMPLED)


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
def _keys(n, seed=0):
    return random.split(random.PRNGKey(seed), n)


def test_greedy_and_topk1_are_argmax():
    logits = torch.from_numpy(
        np.random.default_rng(0).standard_normal((5, 33)).astype(np.float32))
    am = logits.argmax(-1).to(torch.int32)
    keys = _keys(5)
    zeros = torch.zeros(5, dtype=torch.int32)
    greedy = sample(keys, logits, torch.zeros(5), zeros, torch.ones(5))
    assert torch.equal(greedy, am)
    topk1 = sample(keys, logits, torch.full((5,), 1.3), zeros + 1,
                   torch.ones(5))
    assert torch.equal(topk1, am)
    tie = torch.tensor([[0.0, 2.0, 2.0, 1.0]])        # first maximum wins
    assert int(sample(keys[:1], tie, torch.zeros(1), zeros[:1],
                      torch.ones(1))[0]) == 1


def test_topk_topp_keep_draws_in_support():
    logits = torch.from_numpy(
        np.random.default_rng(2).standard_normal((1, 64)).astype(np.float32))
    top5 = set(torch.argsort(-logits[0])[:5].tolist())
    keys = _keys(200, seed=7)
    rows = logits.expand(200, 64)
    k = sample(keys, rows, torch.full((200,), 1.5),
               torch.full((200,), 5, dtype=torch.int32), torch.ones(200))
    assert set(k.tolist()) <= top5 and len(set(k.tolist())) > 1
    p = sample(keys, rows, torch.full((200,), 2.0),
               torch.zeros(200, dtype=torch.int32), torch.full((200,), 1e-6))
    assert set(p.tolist()) == {int(logits.argmax())}


def test_token_stream_depends_only_on_seed_and_index(params, monkeypatch):
    """A token's key is ``fold_in(PRNGKey(seed), index)``, the reference
    engine's: the same for the same (seed, index), different for another
    index or seed, and blind to seed bits above 32, as jax's PRNGKey is
    with 64-bit types off."""
    import repro_torch.serve.engine as engine_mod
    calls = []

    def spy(keys, logits, *settings):
        calls.append(keys.clone())
        return torch.zeros(len(keys), dtype=torch.int32)

    monkeypatch.setattr(engine_mod, "sample", spy)
    eng = ServeEngine(tiny_cfg(), params, tiny_settings(), device="cpu")
    pairs = ((5, 3), (5, 3), (2**40 + 5, 3), (9, 0))
    reqs = [engine_mod.Request(rid=i, prompt=[1], max_new_tokens=1,
                               sampling=SamplingParams(), seed=seed)
            for i, (seed, _) in enumerate(pairs)]
    eng._sample(torch.zeros(4, 8), reqs, [i for _, i in pairs])
    keys = calls[0]
    assert torch.equal(keys[0], keys[1]) and torch.equal(keys[0], keys[2])
    assert not torch.equal(keys[0], keys[3])
    for got, (seed, i) in zip(keys, pairs):
        want = jax.random.fold_in(jax.random.PRNGKey(seed), i)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sample_equals_reference_sampler():
    """The sampler alone, fed the reference's keys and logits: the same
    tokens as ``repro.serve.sample`` on 64 rows of mixed settings."""
    rng = np.random.default_rng(9)
    n, V = 64, 300
    logits = (2 * rng.standard_normal((n, V))).astype(np.float32)
    temp = rng.choice([0.0, 0.5, 1.0, 1.7], n).astype(np.float32)
    top_k = rng.choice([0, 1, 5, 40], n).astype(np.int32)
    top_p = rng.choice([1.0, 0.9, 0.5], n).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(4), n)
    want = ref_sample(keys, jnp.asarray(logits), jnp.asarray(temp),
                      jnp.asarray(top_k), jnp.asarray(top_p))
    got = sample(torch.from_numpy(np.asarray(keys).astype(np.int64)),
                 torch.from_numpy(logits), torch.from_numpy(temp),
                 torch.from_numpy(top_k), torch.from_numpy(top_p))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("temp,top_k,top_p", [(1.0, 0, 1.0), (0.7, 8, 1.0),
                                              (1.3, 0, 0.8)])
def test_sampled_distribution_matches_reference(temp, top_k, top_p):
    """Both samplers draw from one filtered distribution (temperature,
    then top-k, then top-p on the sorted probabilities with
    (cum - probs) < top_p): 4000 threefry draws of each, with other
    keys for the two, reproduce it to five sigma."""
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

    n = 4000
    keys = random.split(random.PRNGKey(1), n)
    got = sample(keys, torch.from_numpy(logits).expand(n, V),
                 torch.full((n,), temp), torch.full((n,), top_k,
                                                    dtype=torch.int32),
                 torch.full((n,), top_p))
    freq = np.bincount(got.numpy(), minlength=V) / n
    sigma = np.sqrt(want * (1 - want) / n)
    assert np.all(np.abs(freq - want) <= 5 * sigma + 1e-12)

    n = 4000
    keys = jax.random.split(jax.random.PRNGKey(0), n)
    drawn = ref_sample(keys, jnp.broadcast_to(jnp.asarray(logits), (n, V)),
                       jnp.full((n,), temp), jnp.full((n,), top_k,
                                                      jnp.int32),
                       jnp.full((n,), top_p))
    ref_freq = np.bincount(np.asarray(drawn), minlength=V) / n
    sigma = np.sqrt(want * (1 - want) / n)
    assert np.all(np.abs(ref_freq - want) <= 5 * sigma + 1e-12)
