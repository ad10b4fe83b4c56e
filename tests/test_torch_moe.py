"""The MoE family (``repro_torch/models/moe.py`` and the moe branches of
``models/transformer.py``) and the reference's init draws, against the
reference on the CPU.

``route_tokens`` is held on its routes bit for bit (``disp``, the drops,
which tokens reach which expert slot), its combine weights and aux terms
within 1e-6 (torch's and XLA's softmax differ in the last bits), in each
of: ample capacity, drops, an indivisible T padded into groups, a bf16
router, and exact ties (two identical router columns: both packages put
the lower expert first).  ``moe_ffn`` within 1e-5 relative norm in f32
and 2e-2 in bf16 (its expert products round to bf16 on both sides).
The loss and every gradient of the ``.smoke()`` variants of olmoe-1b-7b
and phi3.5-moe-42b-a6.6b, flash off and on (on: the reference's Pallas
kernels in interpret mode), within 1e-5 relative, as the dense models'
(``tests/test_torch_fl.py``).  Two paged decode steps of olmoe's smoke
variant within the paged tests' tolerance.  ``init_params`` against the
reference's ``init_params(PRNGKey(seed))``: f32 leaves within 5 ulps
(``normal``'s 4, and the scale's rounding), bf16 leaves within one bf16
step, norms and biases bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_thread  # noqa: E402,F401
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro.models import transformer as ref_tr  # noqa: E402
from repro_torch import random  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import transformer as tr  # noqa: E402

MOE_ARCHS = ("olmoe-1b-7b", "phi3.5-moe-42b-a6.6b")
ROUTE_TOL, FFN_RTOL, FFN_BF16_RTOL, GRAD_RTOL = 1e-6, 1e-5, 2e-2, 1e-5
INIT_F32_ULPS = 5


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


# ------------------------------------------------------------ routing
def _route_case(name):
    """(xg (g, t, D), router (D, E), valid (g, t), top_k, cf, dtype)."""
    rng = np.random.default_rng(7)
    g, t, D, E = 2, 16, 32, 8
    xg = rng.standard_normal((g, t, D)).astype(np.float32)
    w = (rng.standard_normal((D, E)) / np.sqrt(D)).astype(np.float32)
    valid = np.ones((g, t), bool)
    k, cf, dtype = 2, 4.0, "float32"
    if name == "drops":
        cf = 0.5
    elif name == "padded":
        valid[1, 11:] = False
        cf = 1.0
    elif name == "bf16":
        dtype, cf = "bfloat16", 1.25
    elif name == "ties":
        w[:, 3] = w[:, 2]               # experts 2 and 3 tie on every token
        w[:, 6] = w[:, 5]
        k, cf = 3, 1.0
    return xg, w, valid, k, cf, dtype


@pytest.mark.parametrize("case", ["ample", "drops", "padded", "bf16", "ties"])
def test_route_tokens_matches_reference(case):
    xg, w, valid, k, cf, dtype = _route_case(case)
    jd = jnp.dtype(dtype)
    rd, rc, raux = ref_moe.route_tokens(
        jnp.asarray(xg).astype(jd), jnp.asarray(w).astype(jd),
        jnp.asarray(valid), top_k=k, capacity_factor=cf)
    td = getattr(torch, dtype)
    disp, comb, aux = moe.route_tokens(
        torch.from_numpy(xg).to(td), torch.from_numpy(w).to(td),
        torch.from_numpy(valid), top_k=k, capacity_factor=cf)
    assert disp.dtype == td and comb.dtype == td
    np.testing.assert_array_equal(disp.float().numpy(), _np(rd))
    np.testing.assert_array_equal(comb.float().numpy() != 0, _np(rc) != 0)
    tol = ROUTE_TOL if dtype == "float32" else 2 ** -8
    np.testing.assert_allclose(comb.float().numpy(), _np(rc), rtol=tol,
                               atol=tol)
    for name in ("load_balance", "dropped_frac"):
        np.testing.assert_allclose(float(aux[name]), float(raux[name]),
                                   rtol=ROUTE_TOL, atol=ROUTE_TOL)
    if case in ("drops", "padded"):
        assert float(aux["dropped_frac"]) > 0 or case == "padded"
    if case == "ties":
        # lax.top_k's order: the lower expert of a tied pair first
        _, idx = moe.sorted_top_k(torch.tensor([[0.5, 0.2, 0.2, 0.1]]), 2)
        assert idx.tolist() == [[0, 1]]


@pytest.mark.parametrize("T,dtype", [(40, "float32"), (64, "float32"),
                                     (40, "bfloat16")])
def test_moe_ffn_matches_reference(T, dtype):
    """T = 40 over groups of 16: two full groups and one of 8 real and 8
    padded rows; T = 64 divides."""
    rng = np.random.default_rng(3)
    D, E, Fd = 32, 4, 48
    x = rng.standard_normal((1, T, D)).astype(np.float32)
    ws = [(rng.standard_normal(s) / np.sqrt(s[-2])).astype(np.float32)
          for s in ((D, E), (E, D, Fd), (E, D, Fd), (E, Fd, D))]
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    ry, raux = ref_moe.moe_ffn(jnp.asarray(x).astype(jd),
                               *[jnp.asarray(w).astype(jd) for w in ws],
                               top_k=2, capacity_factor=1.0, group=16)
    y, aux = moe.moe_ffn(torch.from_numpy(x).to(td),
                         *[torch.from_numpy(w).to(td) for w in ws],
                         top_k=2, capacity_factor=1.0, group=16)
    assert y.shape == (1, T, D) and y.dtype == td
    rtol = FFN_RTOL if dtype == "float32" else FFN_BF16_RTOL
    assert _rel(y.float().numpy(), _np(ry)) < rtol
    np.testing.assert_allclose(float(aux["dropped_frac"]),
                               float(raux["dropped_frac"]), atol=ROUTE_TOL)
    np.testing.assert_allclose(float(aux["load_balance"]),
                               float(raux["load_balance"]), rtol=1e-5)


def test_expert_parallel_dispatch_names_its_queue():
    """A model axis whose plan shards no experts (``plan.moe`` False, as
    for an expert count the axis does not divide) leaves ``moe_ffn`` on
    its replicated path, bit for bit, and issues no collective (the
    runtime has no group).  The expert-parallel dispatch itself is held
    to the reference's in ``tests/test_torch_tp.py`` (moe_tp2, moe_tp4)."""
    from repro_torch.models import shard_plan as sp
    g = torch.Generator().manual_seed(3)
    x, w = torch.randn(1, 4, 8, generator=g), torch.randn(8, 2, generator=g)
    wg, wu = (torch.randn(2, 8, 4, generator=g) for _ in range(2))
    wd = torch.randn(2, 4, 8, generator=g)
    rt = sp.TPRuntime(None, 2, 1, sp.TPPlan(2, attn=True))
    y0, a0 = moe.moe_ffn(x, w, wg, wu, wd, top_k=1, group=4)
    y1, a1 = moe.moe_ffn(x, w, wg, wu, wd, top_k=1, group=4, tp=rt)
    assert torch.equal(y0, y1)
    assert all(torch.equal(a0[k], a1[k]) for k in a0)


# ------------------------------------------------ loss and every grad
def _pair(arch, flash=False, dtype="float32", seed=0, **fields):
    ref_cfg = dataclasses.replace(ref_get_config(arch).smoke(),
                                  flash_attention=flash, dtype=dtype,
                                  **fields)
    cfg = dataclasses.replace(get_config(arch).smoke(),
                              flash_attention=flash, dtype=dtype, **fields)
    p = ref_tr.init_params(jax.random.PRNGKey(seed), ref_cfg)
    return ref_cfg, cfg, p, params_from_jax(jax.tree.map(np.asarray, p),
                                            "cpu")


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


@pytest.mark.parametrize("arch,flash", [(a, f) for a in MOE_ARCHS
                                        for f in (False, True)])
def test_moe_loss_and_every_grad_match_reference(arch, flash):
    """The loss (CE + 0.01 x the layers' mean load balance) and the
    gradient of every leaf, router included, on (2, 128) tokens: 256
    tokens in groups of 32.  olmoe's smoke variant keeps its capacity
    factor (1.25: 20 slots an expert, none dropped here); phi3.5-moe's
    runs at 0.5 (8 slots), so capacity drops routes."""
    fields = {} if arch == "olmoe-1b-7b" else {"capacity_factor": 0.5}
    ref_cfg, cfg, p, pt = _pair(arch, flash, **fields)
    toks = np.random.default_rng(6).integers(
        0, cfg.vocab, size=(2, 128)).astype(np.int32)
    want_l, want_g = jax.value_and_grad(
        lambda q: ref_tr.loss_fn(q, ref_cfg, {"tokens": jnp.asarray(toks)}))(p)
    leaves = {k: t.clone().requires_grad_() for k, t in _flat(pt)}
    loss = tr.loss_fn(_unflat(leaves), cfg, {"tokens": torch.from_numpy(toks)})
    grads = torch.autograd.grad(loss, list(leaves.values()))
    assert abs(float(loss.detach()) - float(want_l)) < \
        GRAD_RTOL * abs(float(want_l))
    ref_leaves = dict(_flat(want_g))
    assert "blocks/router" in leaves
    for (name, _), g in zip(leaves.items(), grads):
        assert _rel(g.numpy(), ref_leaves[name]) < GRAD_RTOL, name
    # the aux term is in the loss: the forward's load balance, as the
    # reference's scan means it over the layers
    _, _, aux = tr.forward(pt, cfg, torch.from_numpy(toks), "prefill")
    _, _, raux = ref_tr.forward(p, ref_cfg, jnp.asarray(toks),
                                mode="prefill")
    np.testing.assert_allclose(float(aux["load_balance"]),
                               float(raux["load_balance"]), rtol=1e-5)
    assert float(aux["load_balance"]) > 0
    if fields:
        x = pt["embed"][torch.from_numpy(toks).long()]
        _, _, drop = moe.route_tokens(
            x.reshape(-1, cfg.moe_group_size, cfg.d_model),
            pt["blocks"]["router"][0],
            torch.ones(toks.size // cfg.moe_group_size, cfg.moe_group_size,
                       dtype=torch.bool),
            top_k=cfg.top_k, capacity_factor=cfg.capacity_factor)
        assert float(drop["dropped_frac"]) > 0


def test_moe_paged_decode_steps_match_reference():
    """Two batched decode steps of olmoe's smoke variant through random
    pools: rows at ragged depths and one inactive slot; at batch 3 each
    expert holds one slot per group, so routes drop as in serving."""
    ref_cfg, cfg, p, pt = _pair("olmoe-1b-7b")
    B, bs, P = 3, 4, 5
    N = B * P + 1
    rng = np.random.default_rng(11)
    shape = (cfg.n_layers, N, cfg.n_kv_heads, bs, cfg.hd)
    kp = rng.standard_normal(shape).astype(np.float32)
    vp = rng.standard_normal(shape).astype(np.float32)
    tbl = np.arange(1, N, dtype=np.int32).reshape(B, P)
    tbl[0] = 0
    ctx = np.array([0, 6, 13], np.int32)
    toks = rng.integers(0, cfg.vocab, size=(B, 1)).astype(np.int32)
    ref_pools = {"k": jnp.asarray(kp), "v": jnp.asarray(vp)}
    pools = {"k": torch.from_numpy(kp.copy()), "v": torch.from_numpy(vp.copy())}
    for _ in range(2):
        ref_logits, ref_pools = ref_tr.paged_decode_step(
            p, ref_cfg, ref_pools, jnp.asarray(tbl), jnp.asarray(ctx),
            jnp.asarray(toks), use_kernel=True)
        logits, pools = tr.paged_decode_step(
            pt, cfg, pools, torch.from_numpy(tbl), torch.from_numpy(ctx),
            torch.from_numpy(toks).long(), use_kernel=True)
        np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                                   rtol=1e-4, atol=1e-4)
        for n in ("k", "v"):
            np.testing.assert_allclose(pools[n].numpy(),
                                       np.asarray(ref_pools[n]),
                                       rtol=1e-4, atol=1e-4)
        toks = np.array(ref_logits[:, 0].argmax(-1))[:, None]
        ctx = ctx + np.array([0, 1, 1], np.int32)


# ------------------------------------------------------------- init
def _f32_ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


@pytest.mark.parametrize("arch,dtype", [
    ("qwen2-0.5b", "float32"), ("musicgen-medium", "bfloat16"),
    ("olmoe-1b-7b", "float32"), ("olmoe-1b-7b", "bfloat16")])
def test_init_params_equal_the_references_draws(arch, dtype):
    """``init_params(cfg, seed)`` is the reference's
    ``init_params(PRNGKey(seed), cfg)`` under both threefry layouts: a
    dense (qkv bias, tied embeddings), an audio and a moe smoke config."""
    cfg = dataclasses.replace(get_config(arch).smoke(), dtype=dtype)
    ref_cfg = dataclasses.replace(ref_get_config(arch).smoke(), dtype=dtype)
    old = jax.config.jax_threefry_partitionable
    try:
        for part in (True, False):
            jax.config.update("jax_threefry_partitionable", part)
            random.partitionable = part
            got = dict(_flat(tr.init_params(cfg, seed=5, device="cpu")))
            want = dict(_flat(ref_tr.init_params(jax.random.PRNGKey(5),
                                                 ref_cfg)))
            assert got.keys() == want.keys()
            for name, w in want.items():
                g = got[name]
                assert g.dtype == getattr(torch, dtype), name
                assert tuple(g.shape) == tuple(w.shape), name
                wf, gf = _np(w), g.float().numpy()
                if name.split("/")[-1].startswith(("ln", "b", "q_norm",
                                                   "k_norm")):
                    np.testing.assert_array_equal(gf, wf)
                elif dtype == "float32":
                    assert _f32_ulps(gf, wf).max() <= INIT_F32_ULPS, name
                else:
                    step = np.spacing(np.abs(wf).astype(np.float32)) * 2**16
                    assert (np.abs(gf - wf) <= step).all(), name
    finally:
        jax.config.update("jax_threefry_partitionable", old)
        random.partitionable = True
