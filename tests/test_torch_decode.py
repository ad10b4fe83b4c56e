"""The dense ring-cache decode (``init_cache``, ``decode_step``,
``layers.decode_attention``) and ``serve/sampling.beam_search`` against
the reference on the CPU, at ``.smoke()`` sizes in f32.

``init_cache`` gives the reference's shapes and dtypes for every family.
``decode_step`` from an empty cache, ten steps, for qwen2-0.5b with and
without a window of 8 (the ring wraps), xlstm-350m and hymba-1.5b (also
on a bf16 cache): logits and every f32 cache leaf within 1e-5 relative
norm at each step (the reference jitted), a bf16 cache's K and V within
one bf16 step.  A cache that would promote a bf16 residual stream to f32
raises, where the reference's layer scan fails.  Decode is consistent
with the port's own forward over 12 steps (the reference's
``test_decode_consistent_with_forward``, its 2e-3), dense, ssm, hybrid
and moe.  ``beam_search`` with 1 beam, and
with 4 beams and an EOS that a first beam draws (the frozen-EOS rule
and the length penalty), on dense, ssm and hybrid: tokens equal, scores
within 1e-5.  vlm serving fails at the reference's call: the engine's
first ``run`` and ``beam_search`` both stop in ``embed_inputs`` for want
of an image.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_thread  # noqa: E402,F401
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import transformer as ref_tr  # noqa: E402
from repro.serve import sampling as ref_sampling  # noqa: E402
from repro.serve.engine import ServeEngine as RefServeEngine  # noqa: E402
from repro.serve.engine import ServeSettings as RefServeSettings  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import transformer as tr  # noqa: E402
from repro_torch.serve import ServeEngine, ServeSettings  # noqa: E402
from repro_torch.serve.sampling import beam_search  # noqa: E402

STEP_RTOL, FORWARD_TOL, SCORE_TOL = 1e-5, 2e-3, 1e-5
BF16_STEP = 2.0 ** -7


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _flat(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _flat(tree[k], prefix + k + "/")
        else:
            yield prefix + k, tree[k]


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    return ref_tr.init_params(jax.random.PRNGKey(0),
                              ref_get_config(arch).smoke())


def _pair(arch):
    p = _ref_params(arch)
    return (ref_get_config(arch).smoke(), get_config(arch).smoke(), p,
            params_from_jax(jax.tree.map(np.asarray, p), "cpu"))


@pytest.mark.parametrize("arch,window", [
    ("qwen2-0.5b", None), ("qwen2-0.5b", 8), ("xlstm-350m", None),
    ("hymba-1.5b", None), ("hymba-1.5b", 8)])
def test_init_cache_shapes_and_dtypes(arch, window):
    ref_cfg, cfg = ref_get_config(arch).smoke(), get_config(arch).smoke()
    want = dict(_flat(ref_tr.init_cache(ref_cfg, 3, 20, window=window,
                                        dtype=jnp.bfloat16)))
    got = dict(_flat(tr.init_cache(cfg, 3, 20, window=window,
                                   dtype=torch.bfloat16, device="cpu")))
    assert got.keys() == want.keys()
    for name, w in want.items():
        assert tuple(got[name].shape) == w.shape, name
        assert str(got[name].dtype)[6:] == str(w.dtype), name
        np.testing.assert_array_equal(got[name].float().numpy(), _np(w))


@pytest.mark.parametrize("arch,window,cache_dtype", [
    ("qwen2-0.5b", None, "float32"), ("qwen2-0.5b", 8, "float32"),
    ("xlstm-350m", None, "float32"), ("hymba-1.5b", None, "float32"),
    ("hymba-1.5b", None, "bfloat16")])
def test_decode_step_matches_reference(arch, window, cache_dtype):
    """A bf16 K/V cache under the f32 params holds K and V rounded to
    bf16 on both sides; the attention promotes them to f32."""
    ref_cfg, cfg, p, pt = _pair(arch)
    steps = 10
    toks = np.random.default_rng(3).integers(
        0, cfg.vocab, size=(2, steps)).astype(np.int32)
    ref_step = jax.jit(functools.partial(ref_tr.decode_step, cfg=ref_cfg,
                                         window=window))
    ref_cache = ref_tr.init_cache(ref_cfg, 2, steps, window=window,
                                  dtype=jnp.dtype(cache_dtype))
    cache = tr.init_cache(cfg, 2, steps, window=window,
                          dtype=getattr(torch, cache_dtype), device="cpu")
    for t in range(steps):
        want, ref_cache = ref_step(p, cache=ref_cache,
                                   token=jnp.asarray(toks[:, t:t + 1]),
                                   pos=jnp.int32(t))
        before = {n: c.clone() for n, c in _flat(cache)}
        got, new = tr.decode_step(pt, cfg, cache, torch.from_numpy(
            toks[:, t:t + 1]), t, window=window)
        # the caller's cache is left as it was
        for n, c in _flat(cache):
            assert torch.equal(c, before[n]), n
        cache = new
        assert _rel(got.numpy(), _np(want)) < STEP_RTOL, t
        want_c = dict(_flat(ref_cache))
        for name, c in _flat(cache):
            g, w = c.float().numpy(), _np(want_c[name])
            if c.dtype == torch.bfloat16:
                # K and V agree to f32's last bits before their bf16
                # rounding, which may then differ by one bf16 step
                assert (np.abs(g - w) <= BF16_STEP * np.abs(w)).all(), \
                    (t, name)
            else:
                assert _rel(g, w) < STEP_RTOL, (t, name)


def test_decode_step_refuses_a_cache_that_promotes_the_residual():
    """bf16 params over an f32 K/V cache (``beam_search``'s default cache
    dtype): the attention's f32 output would make the residual f32, and
    the reference's layer scan fails on its carry; the port raises."""
    arch = "qwen2-0.5b"
    ref_cfg = dataclasses.replace(ref_get_config(arch).smoke(),
                                  dtype="bfloat16")
    cfg = dataclasses.replace(get_config(arch).smoke(), dtype="bfloat16")
    p = ref_tr.init_params(jax.random.PRNGKey(0), ref_cfg)
    pt = params_from_jax(jax.tree.map(np.asarray, p), "cpu")
    tok = np.zeros((1, 1), np.int32)
    with pytest.raises(TypeError, match="carry"):
        ref_tr.decode_step(p, ref_cfg, ref_tr.init_cache(
            ref_cfg, 1, 4, dtype=jnp.float32), jnp.asarray(tok), 0)
    with pytest.raises(ValueError, match="residual"):
        tr.decode_step(pt, cfg, tr.init_cache(
            cfg, 1, 4, dtype=torch.float32, device="cpu"),
            torch.from_numpy(tok), 0)
    logits, _ = tr.decode_step(pt, cfg, tr.init_cache(
        cfg, 1, 4, dtype=torch.bfloat16, device="cpu"),
        torch.from_numpy(tok), 0)
    assert logits.dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "xlstm-350m",
                                  "hymba-1.5b", "olmoe-1b-7b"])
def test_decode_consistent_with_forward(arch):
    """Greedy decode logits == teacher-forced forward logits (moe with
    ample capacity, so no token is dropped either way)."""
    cfg = get_config(arch).smoke()
    if cfg.family == "moe":
        cfg = dataclasses.replace(cfg, capacity_factor=8.0)
    params = tr.init_params(cfg, seed=0, device="cpu")
    T = 12
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab, size=(1, T)).astype(np.int32))
    full, _, _ = tr.forward(params, cfg, toks)
    cache = tr.init_cache(cfg, 1, T, dtype=torch.float32, device="cpu")
    for t in range(T):
        step, cache = tr.decode_step(params, cfg, cache, toks[:, t:t + 1], t)
        np.testing.assert_allclose(step[0, 0].numpy(), full[0, t].numpy(),
                                   atol=FORWARD_TOL, rtol=FORWARD_TOL,
                                   err_msg=f"{arch} t={t}")


BEAM_CASES = [(arch, beams) for arch in ("qwen2-0.5b", "xlstm-350m",
                                         "hymba-1.5b") for beams in (1, 4)]


@pytest.mark.parametrize("arch,n_beams", BEAM_CASES)
def test_beam_search_matches_reference(arch, n_beams):
    """A 9-token prompt, 6 new tokens.  With 4 beams the EOS is the
    prompt's best next token, so one first beam is finished at once and
    extends only by EOS at no cost; the length penalty is 0.8."""
    ref_cfg, cfg, p, pt = _pair(arch)
    prompt = np.random.default_rng(5).integers(
        0, cfg.vocab, size=9).astype(np.int32)
    kw = dict(n_beams=n_beams, max_new_tokens=6)
    if n_beams > 1:
        logits, _, _ = tr.forward(pt, cfg, torch.from_numpy(prompt)[None])
        kw.update(eos_id=int(logits[0, -1].argmax()), length_penalty=0.8)
    want_t, want_s = jax.jit(functools.partial(
        ref_sampling.beam_search, cfg=ref_cfg, **kw))(p, prompt=prompt)
    got_t, got_s = beam_search(pt, cfg, prompt, **kw)
    assert got_t.dtype == torch.int32
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    assert abs(float(got_s) - float(want_s)) <= SCORE_TOL * abs(
        float(want_s))


def test_vlm_serving_fails_where_the_reference_does():
    ref_cfg, cfg, p, pt = _pair("internvl2-26b")
    prompt = [1, 2, 3]
    eng = ServeEngine(cfg, pt, ServeSettings(), device="cpu")
    ref_eng = RefServeEngine(ref_cfg, p, RefServeSettings())
    with pytest.raises(AssertionError):
        ref_eng.run([prompt])
    with pytest.raises(ValueError, match="frontend_embeds"):
        eng.run([prompt])
    with pytest.raises(AssertionError):
        ref_sampling.beam_search(p, ref_cfg, jnp.asarray(prompt))
    with pytest.raises(ValueError, match="frontend_embeds"):
        beam_search(pt, cfg, prompt)
    assert tr.paged_families() == ref_tr.paged_families()
