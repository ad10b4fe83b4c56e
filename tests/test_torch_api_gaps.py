"""Public functions of the reference and their counterparts in the port,
on the same inputs and keys, on the CPU:

* ``models.transformer.param_count`` and ``active_param_count``, the
  counts over ``param_spec`` that the dry run records, for every arch
  (``ModelConfig.param_count``'s formula differs for hybrid and ssm);
* ``core.compressors.get_compressor``: the same class and fields for each
  name, with the reference's defaults (RandP p = 0.1, RandK and TopK k =
  n // 10 or 102 without n, QSGD s = 16) and its ``ValueError``; the
  keyed operators give the reference's jitted values bit for bit
  (RandK's Gumbel ranks are held elsewhere, ``tests/test_torch_fl.py``);
* ``core.server_opt.fednova_scale``: 1 / max(tau, 1) in f32, bit for
  bit;
* ``serve.sampling.sample_one``: one row through ``sample``, the tokens
  bit for bit over greedy, temperature, top-k and top-p settings and
  several keys.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import ARCHS  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.core import compressors as ref_comp  # noqa: E402
from repro.core import server_opt as ref_opt  # noqa: E402
from repro.models import transformer as ref_tr  # noqa: E402
from repro.serve import sampling as ref_sampling  # noqa: E402
from repro_torch import random  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import compressors as comp  # noqa: E402
from repro_torch.core import server_opt  # noqa: E402
from repro_torch.models import transformer as tr  # noqa: E402
from repro_torch.serve import sampling  # noqa: E402

@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_match_the_reference(arch):
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    assert tr.param_count(cfg) == ref_tr.param_count(ref_cfg)
    assert tr.active_param_count(cfg) == ref_tr.active_param_count(ref_cfg)


CASES = [("identity", None, {}), ("none", 500, {}), ("rand_p", None, {}),
         ("RAND_P", None, {"p": 0.25}), ("rand_k", None, {}),
         ("rand_k", 500, {}), ("rand_k", 5, {}), ("rand_k", 500, {"k": 7}),
         ("qsgd", None, {}), ("qsgd", 10, {"s": 4}), ("top_k", None, {}),
         ("top_k", 2000, {}), ("top_k", 2000, {"k": 3})]


@pytest.mark.parametrize("name,n,kw", CASES)
def test_get_compressor_matches_the_reference(name, n, kw):
    want = ref_comp.get_compressor(name, n, **kw)
    got = comp.get_compressor(name, n, **kw)
    assert type(got).__name__ == type(want).__name__
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    if got.name in ("identity", "rand_p", "qsgd", "top_k"):
        x = np.random.default_rng(7).standard_normal(500).astype(np.float32)
        out = got(random.PRNGKey(3), torch.from_numpy(x))
        # the port rounds as XLA compiles the reference's jitted round
        ref = jax.jit(lambda k, v: want(k, v))(jax.random.PRNGKey(3),
                                                jnp.asarray(x))
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_get_compressor_unknown_name_raises_the_references_error():
    with pytest.raises(ValueError) as want:
        ref_comp.get_compressor("sign_sgd")
    with pytest.raises(ValueError) as got:
        comp.get_compressor("sign_sgd")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_fednova_scale_matches_the_reference(dtype):
    tau = np.array([0, 1, 2, 3, 5, 7, 10, 64, 1000], dtype)
    want = np.asarray(ref_opt.fednova_scale(jnp.asarray(tau)))
    got = server_opt.fednova_scale(torch.from_numpy(tau))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


SETTINGS = [dict(), dict(temperature=0.7), dict(temperature=1.0, top_k=5),
            dict(temperature=1.3, top_p=0.8),
            dict(temperature=0.9, top_k=40, top_p=0.95)]


@pytest.mark.parametrize("setting", range(len(SETTINGS)))
def test_sample_one_tokens_equal_the_references(setting):
    kw = SETTINGS[setting]
    logits = np.random.default_rng(setting).standard_normal(
        (8, 512)).astype(np.float32) * 3
    for i in range(8):
        key = random.fold_in(random.PRNGKey(11), i)
        jkey = jax.random.fold_in(jax.random.PRNGKey(11), i)
        got = sampling.sample_one(key, torch.from_numpy(logits[i]),
                                  sampling.SamplingParams(**kw))
        want = ref_sampling.sample_one(jkey, jnp.asarray(logits[i]),
                                       ref_sampling.SamplingParams(**kw))
        assert got.dtype == torch.int32 and got.shape == ()
        assert int(got) == int(want), (kw, i)
