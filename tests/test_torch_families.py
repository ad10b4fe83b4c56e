"""The recurrent and vision families (``ssm``: xlstm-350m, ``hybrid``:
hymba-1.5b, ``vlm``: internvl2-26b) against the reference on the CPU,
one parametrised case a family at its ``.smoke()`` size in f32, flash
attention on as the configs keep it (the reference's Pallas kernels in
interpret mode, the port's Function through its plain versions).

``param_spec`` equals the reference's, key order included (a leaf's
place is its ``fold_in`` index).  ``init_params`` is the reference's
``init_params(PRNGKey(seed))``: norms, biases (``b_f`` 0, the
reference's quirk), ``m_D`` and ``m_A`` bit for bit, the drawn f32
matrices within 5 ulps (``normal``'s erfinv).  ``params_from_jax`` and
``ravel_params`` carry the new leaves bit for bit.  The loss within
1e-6 and every gradient leaf within 3e-5 relative norm (the largest
seen, 1.2e-5, is hymba's ``m_bc``, whose gradient sums through the
scan); xlstm's ``b_i`` gradient is zero but for rounding (a constant
shift of a head's input gate moves b and its running max together), so
it is held to 3e-5 of ``w_i``'s.  The prefill logits and every cache
leaf within 1e-5.  One eris round on the int8 wire, x within 1e-4
(``tests/test_torch_fl.py``'s int8 tolerance: a code flips where a draw
falls within an ulp).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.flatten_util import ravel_pytree

torch = pytest.importorskip("torch")

from torch_threads import one_thread  # noqa: E402,F401
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.core import fl as ref_fl  # noqa: E402
from repro.core.compressors import RandP as RefRandP  # noqa: E402
from repro.models import transformer as ref_tr  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax, ravel_params  # noqa: E402
from repro_torch.core import fl  # noqa: E402
from repro_torch.core.compressors import RandP  # noqa: E402
from repro_torch.models import transformer as tr  # noqa: E402

FAMILIES = ("xlstm-350m", "hymba-1.5b", "internvl2-26b")
LOSS_RTOL, GRAD_RTOL, PREFILL_RTOL, ROUND_RTOL = 1e-6, 3e-5, 1e-5, 1e-4
INIT_F32_ULPS = 5
S_TEXT = 16


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


def _unflat(leaves):
    out = {}
    for name, t in leaves.items():
        node = out
        *path, last = name.split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[last] = t
    return out


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    return ref_tr.init_params(jax.random.PRNGKey(0),
                              ref_get_config(arch).smoke())


def _pair(arch):
    """Both configs and both packages' params (the port's converted from
    the reference's, fresh each call)."""
    p = _ref_params(arch)
    return (ref_get_config(arch).smoke(), get_config(arch).smoke(), p,
            params_from_jax(jax.tree.map(np.asarray, p), "cpu"))


def _batch(cfg, lead=(2,), seed=6):
    """Tokens (lead..., S_TEXT) and, for vlm, the image's patch
    embeddings (lead..., n_frontend_tokens, d_frontend), from numpy."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, size=(*lead, S_TEXT)
                                  ).astype(np.int32)}
    if cfg.frontend == "vlm":
        out["frontend_embeds"] = rng.standard_normal(
            (*lead, cfg.n_frontend_tokens, cfg.d_frontend)).astype(
            np.float32)
    return ({k: jnp.asarray(v) for k, v in out.items()},
            {k: torch.from_numpy(v) for k, v in out.items()})


def _f32_ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


@pytest.mark.parametrize("arch", FAMILIES)
def test_param_spec_and_init_equal_the_references(arch):
    cfg, ref_cfg = get_config(arch).smoke(), ref_get_config(arch).smoke()
    spec = tr.param_spec(cfg)
    ref_spec = ref_tr.param_spec(ref_cfg)
    assert spec == ref_spec
    assert list(spec) == list(ref_spec)
    assert list(spec["blocks"]) == list(ref_spec["blocks"])
    got = dict(_flat(tr.init_params(cfg, seed=5, device="cpu")))
    want = dict(_flat(ref_tr.init_params(jax.random.PRNGKey(5), ref_cfg)))
    assert got.keys() == want.keys()
    for name, w in want.items():
        g = got[name].numpy()
        assert g.dtype == np.float32 and g.shape == w.shape, name
        leaf = name.split("/")[-1]
        if leaf.startswith(("ln", "b", "m_ln", "m_D", "m_A")):
            np.testing.assert_array_equal(g, np.asarray(w), err_msg=name)
        else:
            assert _f32_ulps(g, w).max() <= INIT_F32_ULPS, name
    if cfg.family == "ssm":
        assert not got["blocks/b_f"].any()
    if cfg.family == "hybrid":
        np.testing.assert_array_equal(
            got["blocks/m_A"][0, 0].numpy(),
            np.log(np.arange(1, cfg.ssm_state + 1, dtype=np.float32)))


@pytest.mark.parametrize("arch", FAMILIES)
def test_params_from_jax_and_ravel_carry_the_new_leaves(arch):
    _, _, p, pt = _pair(arch)
    for (name, w), (gname, g) in zip(_flat(p), _flat(pt)):
        assert name == gname
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    want, _ = ravel_pytree(p)
    flat, unravel = ravel_params(pt)
    np.testing.assert_array_equal(flat.numpy(), np.asarray(want))
    back = unravel(flat)
    for (name, t), (_, b) in zip(_flat(pt), _flat(back)):
        assert torch.equal(t, b), name


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_every_grad_match_reference(arch):
    ref_cfg, cfg, p, pt = _pair(arch)
    batch, tbatch = _batch(cfg)
    want_l, want_g = jax.jit(jax.value_and_grad(
        lambda q: ref_tr.loss_fn(q, ref_cfg, batch)))(p)
    leaves = {k: t.clone().requires_grad_() for k, t in _flat(pt)}
    loss = tr.loss_fn(_unflat(leaves), cfg, tbatch)
    grads = dict(zip(leaves, torch.autograd.grad(loss,
                                                 list(leaves.values()))))
    assert abs(float(loss.detach()) - float(want_l)) <= \
        LOSS_RTOL * abs(float(want_l))
    ref = dict(_flat(want_g))
    for name, g in grads.items():
        if name == "blocks/b_i":
            scale = np.linalg.norm(ref["blocks/w_i"])
            assert np.linalg.norm(g.numpy() - ref[name]) <= GRAD_RTOL * scale
        else:
            assert _rel(g.numpy(), ref[name]) < GRAD_RTOL, name


@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_logits_and_caches_match_reference(arch):
    """The reference's stacked caches: ssm's mLSTM states (C, n, m),
    hybrid's K/V and SSM state, vlm's K/V over image and text."""
    ref_cfg, cfg, p, pt = _pair(arch)
    batch, tbatch = _batch(cfg, seed=8)
    want, want_c, _ = ref_tr.forward(p, ref_cfg, batch["tokens"],
                                     batch.get("frontend_embeds"),
                                     mode="prefill")
    got, got_c, _ = tr.forward(pt, cfg, tbatch["tokens"], "prefill",
                               frontend_embeds=tbatch.get("frontend_embeds"))
    assert _rel(got.numpy(), _np(want)) < PREFILL_RTOL
    want_c, got_c = dict(_flat(want_c)), dict(_flat(got_c))
    assert got_c.keys() == want_c.keys()
    for name, w in want_c.items():
        assert tuple(got_c[name].shape) == w.shape, name
        assert _rel(got_c[name].numpy(), _np(w)) < PREFILL_RTOL, name


@pytest.mark.parametrize("arch", FAMILIES)
def test_one_int8_eris_round_matches_reference(arch):
    """One eris round, K = 2 clients of 2 x 16 tokens (vlm: each with its
    own image embeddings), A = 8, RandP(0.25) DSC on the int8 wire, each
    package drawing its own keys from the config's seed."""
    ref_cfg, cfg, p, pt = _pair(arch)
    kw = dict(method="eris", K=2, A=8, lr=0.1, use_dsc=True, int8_wire=True)
    ref_run = ref_fl.FLRun(
        ref_fl.FLConfig(**kw, compressor=RefRandP(p=0.25)), p,
        lambda q, b: ref_tr.loss_fn(q, ref_cfg, b))
    run = fl.FLRun(fl.FLConfig(**kw, compressor=RandP(p=0.25)), pt,
                   lambda q, b: tr.loss_fn(q, cfg, b), device="cpu")
    batch, tbatch = _batch(cfg, lead=(2, 2), seed=7)
    ref_run.step(batch)
    run.step(tbatch)
    x = run.x.numpy()
    assert np.isfinite(x).all()
    assert _rel(x, np.asarray(ref_run.x)) < ROUND_RTOL
