"""The LM loss and its gradients, the parameter flattening order, and
the flash-attention routing of the port's transformer against the
reference, on the CPU (split from ``tests/test_torch_fl.py``, whose
helpers it shares): each zoo member's smoke variant in f32, flash
attention off or on on both sides, the loss and every gradient leaf
within 1e-5 relative norm.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.flatten_util import ravel_pytree

torch = pytest.importorskip("torch")

from torch_threads import one_thread  # noqa: E402,F401
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import transformer as ref_tr  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax, ravel_params  # noqa: E402
from repro_torch.models import transformer as tr  # noqa: E402
from test_torch_fl import _rel  # noqa: E402


# ---------------------------------------------------- model, flattening
def _smoke_pair(dtype="float32", flash=False, arch="eris-gptneo-1.3b"):
    ref_cfg = dataclasses.replace(ref_get_config(arch).smoke(),
                                  flash_attention=flash, dtype=dtype)
    cfg = dataclasses.replace(get_config(arch).smoke(),
                              flash_attention=flash, dtype=dtype)
    p = ref_tr.init_params(jax.random.PRNGKey(0), ref_cfg)
    return ref_cfg, cfg, p, params_from_jax(jax.tree.map(np.asarray, p),
                                            "cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ravel_params_order_equals_ravel_pytree(dtype):
    _, _, p, pt = _smoke_pair(dtype)
    want, _ = ravel_pytree(p)
    flat, unravel = ravel_params(pt)
    assert flat.dtype == getattr(torch, dtype) and flat.numel() == 1_443_072
    np.testing.assert_array_equal(flat.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    # unravel casts each leaf back to its own dtype, as JAX's does
    back = unravel(flat.float())
    assert back["blocks"]["wq"].dtype == getattr(torch, dtype)
    assert torch.equal(back["embed"], pt["embed"])


# the zoo's dense and audio members: eris-gptneo-1.3b flash off and on,
# the others flash off but starcoder2-3b (flash is held in its own tests,
# and the Pallas kernels' interpret mode is slow)
ZOO_GRAD_CASES = [("eris-gptneo-1.3b", False), ("eris-gptneo-1.3b", True),
                  ("qwen3-32b", False), ("musicgen-medium", False),
                  ("starcoder2-3b", True), ("starcoder2-15b", False)]


@pytest.mark.parametrize(
    "arch,flash", ZOO_GRAD_CASES,
    ids=[str(f) if a == "eris-gptneo-1.3b" else f"{a}-{f}"
         for a, f in ZOO_GRAD_CASES])
def test_loss_and_every_grad_match_reference(arch, flash):
    """A zoo member's smoke variant in f32, flash attention off or on
    on both sides (on: the reference's Pallas kernels in interpret mode,
    the port's Function through its plain versions): the loss and the
    gradient of every leaf within 1e-5 relative norm, with and without a
    loss mask."""
    ref_cfg, cfg, p, pt = _smoke_pair(flash=flash, arch=arch)
    rng = np.random.default_rng(6)
    toks = rng.integers(0, cfg.vocab, size=(2, 16)).astype(np.int32)
    mask = (rng.random((2, 16)) < 0.7).astype(np.float32)
    for use_mask in (False, True):
        batch = {"tokens": jnp.asarray(toks)}
        tbatch = {"tokens": torch.from_numpy(toks)}
        if use_mask:
            batch["loss_mask"] = jnp.asarray(mask)
            tbatch["loss_mask"] = torch.from_numpy(mask)
        want_l, want_g = jax.value_and_grad(
            lambda q: ref_tr.loss_fn(q, ref_cfg, batch))(p)
        leaves = {k: v.requires_grad_() for k, v in
                  [(k, t.clone()) for k, t in _flat(pt)]}
        loss = tr.loss_fn(_unflat(leaves), cfg, tbatch)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        assert abs(float(loss.detach()) - float(want_l)) < \
            1e-5 * abs(float(want_l))
        ref_leaves = dict(_flat(want_g))
        for (name, _), g in zip(leaves.items(), grads):
            assert _rel(g.numpy(), ref_leaves[name]) < 1e-5, name


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


def test_flash_attention_training_runs_the_flash_function_and_prefill_does_not(
        monkeypatch):
    """With cfg.flash_attention, the training shapes the reference sends
    through its Pallas flash kernels go through the port's flash Function:
    on the CPU both backward plain versions run once per layer and its
    forward twice (the config's full remat recomputes each layer in the
    backward), and the chunked attention never does.  Prefill and a shape the
    128-blocks do not tile take the chunked attention, as the reference
    routes them."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import layers
    _, cfg, _, pt = _smoke_pair(flash=True)
    calls = {"flash_fwd_ref": 0, "flash_dq_ref": 0, "flash_dkv_ref": 0,
             "causal_attention": 0}

    def spy(module, name):
        fn = getattr(module, name)

        def counted(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        monkeypatch.setattr(module, name, counted)

    for name in ("flash_fwd_ref", "flash_dq_ref", "flash_dkv_ref"):
        spy(fa, name)
    spy(layers, "causal_attention")
    leaves = {n: t.clone().requires_grad_() for n, t in _flat(pt)}
    toks = torch.zeros(2, 16, dtype=torch.int32)
    loss = tr.loss_fn(_unflat(leaves), cfg, {"tokens": toks})
    torch.autograd.grad(loss, list(leaves.values()))
    L = cfg.n_layers
    assert cfg.remat_policy == "full"
    assert calls == {"flash_fwd_ref": 2 * L, "flash_dq_ref": L,
                     "flash_dkv_ref": L, "causal_attention": 0}
    assert tr.uses_flash_kernel(cfg, 16) and not tr.uses_flash_kernel(cfg, 192)
    logits, caches, _ = tr.forward(pt, cfg, toks, "prefill")
    assert logits.shape == (2, 16, cfg.vocab) and caches is not None
    assert not logits.requires_grad
    tr.loss_fn(pt, cfg, {"tokens": torch.zeros(1, 192, dtype=torch.int32)})
    assert calls["causal_attention"] == 2 * L
    assert calls["flash_fwd_ref"] == 2 * L
