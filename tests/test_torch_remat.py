"""Rematerialization (``ModelConfig.remat_policy``) on the port's training
paths, against the reference on the CPU, in f32 at smoke size.

* The policy table: an unknown name raises the reference's
  ``ValueError``, word for word.
* ``loss_fn``'s gradient under each of the five policies against the
  reference's under the same policy (qwen2-0.5b, 2 x 48 tokens over
  query chunks of 16, so the chunked attention's own checkpoints nest in
  the layers'), and under ``full`` for moe, ssm, hybrid and vlm: the loss
  within 1e-6, each leaf within 3e-5 relative norm
  (``tests/test_torch_families.py``'s gates).
* The port's gradient under every policy equal to its own ``none``
  gradient bit for bit, every family: the recompute and the kept
  products give the forward's values.  No forward draws from torch's
  RNG, so no RNG state is stashed for the recompute.
* The DLG second derivative (the gradient of a gradient match with
  respect to the input embeddings) under every policy equal to ``none``'s
  bit for bit, and under ``full`` against the reference's (1e-4, as
  ``tests/test_torch_privacy.py``).
* Across two gloo ranks (one ``torch.distributed.run`` launch): the TP
  gradient at model 2 and the pipelined gradient at pp 2 under ``full``,
  ``dots`` and ``offload_dots`` equal to ``none``'s bit for bit on every
  rank, and under ``full`` within the reference's TP and pipe gates of
  its replicated ``loss_fn`` under ``full`` (loss 1e-5; a leaf's max
  error 1e-3 of its max).
* On the meta device under ``Account`` (qwen2-0.5b, 4 x 256 tokens,
  flash on): the peaks fall in the order none > dots_batch = dots >
  full (olmoe-1b-7b's expert einsums make dots_batch > dots),
  offload_dots' device peak at most dots' less what it sent to the host
  plus one layer's products (what is back on the device while a layer
  recomputes); ``full``'s flops are ``none``'s plus each layer's forward
  but its down projection (torch's checkpoint stops recomputing after
  the last op whose output the backward saved, as jax's remat recomputes
  only what its backward reads), ``flash_fwd`` declared twice a layer.
  At model 2 on a fake world of 2 (a subprocess), ``full`` sends the
  attention's ring exit of every layer again, kind by kind, in count and
  bytes.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.flatten_util  # noqa: F401
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_thread  # noqa: E402,F401
from conftest import SUBPROC_ENV  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import transformer as ref_tr  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax, ravel_params  # noqa: E402
from repro_torch.launch.accounting import Account  # noqa: E402
from repro_torch.models import transformer as tr  # noqa: E402
from repro_torch.privacy import harness  # noqa: E402

POLICIES = ("none", "full", "dots", "dots_batch", "offload_dots")
LOSS_RTOL, GRAD_RTOL, DLG_RTOL = 1e-6, 3e-5, 1e-4
TP_LOSS_TOL, TP_GRAD_TOL = 1e-5, 1e-3
B, S = 2, 48
DENSE = dict(dtype="float32", attn_chunk=16)
FAMILIES = ("olmoe-1b-7b", "xlstm-350m", "hymba-1.5b", "internvl2-26b")


def _cfgs(arch, policy, **over):
    over = dict(over, remat_policy=policy)
    return (dataclasses.replace(ref_get_config(arch).smoke(), **over),
            dataclasses.replace(get_config(arch).smoke(), **over))


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


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _batch(cfg, seed=3):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.frontend == "vlm":
        out["frontend_embeds"] = rng.standard_normal(
            (B, cfg.n_frontend_tokens, cfg.d_frontend)).astype(np.float32)
    return out


def _ref_grad(ref_cfg, params, batch):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    loss, g = jax.jit(jax.value_and_grad(
        lambda q: ref_tr.loss_fn(q, ref_cfg, jb)))(params)
    return float(loss), dict(_flat(g))


def _port_grad(cfg, params, batch):
    leaves = {k: t.clone().requires_grad_() for k, t in _flat(params)}
    loss = tr.loss_fn(_unflat(leaves), cfg,
                      {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))


def _ref_params(ref_cfg, seed=0):
    return ref_tr.init_params(jax.random.PRNGKey(seed), ref_cfg)


def _port_params(ref_params):
    return params_from_jax(jax.tree.map(np.asarray, ref_params), "cpu")


def _against_reference(arch, policy, **over):
    ref_cfg, cfg = _cfgs(arch, policy, **over)
    p = _ref_params(ref_cfg)
    batch = _batch(cfg)
    want_l, want_g = _ref_grad(ref_cfg, p, batch)
    loss, grads = _port_grad(cfg, _port_params(p), batch)
    assert abs(float(loss) - want_l) <= LOSS_RTOL * abs(want_l)
    for name, g in grads.items():
        if name == "blocks/b_i":          # xlstm's: zero but for rounding
            scale = np.linalg.norm(want_g["blocks/w_i"])
            assert np.linalg.norm(g.numpy() - want_g[name]) <= \
                GRAD_RTOL * scale
        else:
            assert _rel(g.numpy(), want_g[name]) < GRAD_RTOL, (policy, name)


def test_unknown_policy_raises_the_references_error():
    with pytest.raises(ValueError) as want:
        ref_tr._remat_policy("bogus")
    with pytest.raises(ValueError) as got:
        tr._remat_policy("bogus")
    assert str(got.value) == str(want.value)
    # "none" is the callers' test in both, not a name of the table
    with pytest.raises(ValueError):
        tr._remat_policy("none")
    cfg = dataclasses.replace(get_config("qwen2-0.5b").smoke(),
                              remat_policy="bogus")
    params = tr.init_params(cfg, device="cpu")
    tokens = torch.zeros((1, 8), dtype=torch.long)
    with pytest.raises(ValueError, match="remat_policy 'bogus'"):
        tr.loss_fn(params, cfg, {"tokens": tokens})
    # prefill never remats, so it takes no policy
    tr.forward(params, cfg, tokens, "prefill")


@pytest.mark.parametrize("policy", POLICIES)
def test_dense_grad_matches_the_reference_under_each_policy(policy):
    _against_reference("qwen2-0.5b", policy, **DENSE)


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_grad_matches_the_reference_under_full(arch):
    _against_reference(arch, "full", dtype="float32")


@pytest.mark.parametrize("arch", ("qwen2-0.5b",) + FAMILIES)
def test_every_policy_equals_none_bit_for_bit(arch):
    _, base = _cfgs(arch, "none", **DENSE)
    params = tr.init_params(base, seed=1, device="cpu")
    batch = _batch(base, seed=4)
    rng = torch.random.get_rng_state()
    want_l, want = _port_grad(base, params, batch)
    for policy in POLICIES[1:]:
        loss, got = _port_grad(dataclasses.replace(base, remat_policy=policy),
                               params, batch)
        assert torch.equal(loss, want_l), policy
        for name, g in got.items():
            assert torch.equal(g, want[name]), (policy, name)
    assert torch.equal(torch.random.get_rng_state(), rng)


def _dlg_second_derivative(cfg, params, toks, emb):
    """d/d(dummy) of |grad(dummy) - grad(emb)|^2, through ``loss_fn``'s
    gradient taken with ``create_graph`` (``harness.flat_grad``)."""
    x_flat, unravel = ravel_params(params)
    grad_fn = harness.flat_grad(
        lambda p, d: tr.loss_fn(p, cfg, {"tokens": toks,
                                         "inputs_embeds": d}),
        unravel, create_graph=True)
    g_obs = grad_fn(x_flat, emb).detach()
    dummy = (emb + 0.1).clone().requires_grad_()
    match = torch.sum((grad_fn(x_flat, dummy) - g_obs) ** 2)
    return torch.autograd.grad(match, dummy)[0]


def test_dlg_double_backward_under_every_policy():
    base = harness.tiny_lm_config()
    ref_cfg = dataclasses.replace(ref_get_config("qwen2-0.5b").smoke(),
                                  **{f.name: getattr(base, f.name) for f in
                                     dataclasses.fields(base)})
    jp = _ref_params(ref_cfg, seed=2)
    params = _port_params(jp)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, base.vocab, (1, 40)).astype(np.int32)
    emb = params["embed"][torch.from_numpy(toks[0]).long()][None]
    got = {p: _dlg_second_derivative(
        dataclasses.replace(base, remat_policy=p), params,
        torch.from_numpy(toks), emb) for p in POLICIES}
    for p in POLICIES[1:]:
        assert torch.equal(got[p], got["none"]), p
    # the reference's, under its default full remat
    jx, junravel = jax.flatten_util.ravel_pytree(jp)

    def jgrad(d):
        return jax.grad(lambda f: ref_tr.loss_fn(
            junravel(f), ref_cfg,
            {"tokens": jnp.asarray(toks), "inputs_embeds": d}))(jx)

    jg_obs = jax.jit(jgrad)(jnp.asarray(emb.numpy()))
    want = np.asarray(jax.jit(jax.grad(
        lambda d: jnp.sum((jgrad(d) - jg_obs) ** 2)))(
        jnp.asarray((emb + 0.1).numpy())))
    assert ref_cfg.remat_policy == "full"
    np.testing.assert_allclose(got["full"].numpy(), want, rtol=DLG_RTOL,
                               atol=DLG_RTOL * np.abs(want).max())


def _meta_record(cfg, n_layers=None, grad=True):
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    leaves = {k: torch.empty(shape, device="meta", requires_grad=grad)
              for k, shape in _flat(tr.param_spec(cfg))}
    tokens = torch.zeros((4, 256), dtype=torch.long, device="meta")
    with Account(None, "meta", inputs=list(leaves.values())) as acc:
        with torch.set_grad_enabled(grad):
            loss = tr.loss_fn(_unflat(leaves), cfg, {"tokens": tokens})
            if grad:
                torch.autograd.grad(loss, list(leaves.values()))
        del loss
    return acc.record()


def test_meta_peaks_and_the_recompute_under_account():
    dense = dataclasses.replace(get_config("qwen2-0.5b").smoke(),
                                dtype="float32")
    moe = dataclasses.replace(get_config("olmoe-1b-7b").smoke(),
                              dtype="float32")
    assert tr.uses_flash_kernel(dense, 256)
    rec = {p: _meta_record(dataclasses.replace(dense, remat_policy=p))
           for p in POLICIES}
    peak = {p: r["peak_bytes"] - r["argument_bytes"] for p, r in rec.items()}
    # with flash, no batched product is left in a dense layer
    assert peak["none"] > peak["dots_batch"] == peak["dots"] > peak["full"]
    moe_peak = {}
    for p in ("dots", "dots_batch"):
        r = _meta_record(dataclasses.replace(moe, remat_policy=p))
        moe_peak[p] = r["peak_bytes"] - r["argument_bytes"]
    assert moe_peak["dots_batch"] > moe_peak["dots"]      # expert einsums
    host = rec["offload_dots"]["offload_bytes"]
    assert host > 0 and all(r["offload_bytes"] == 0 for p, r in rec.items()
                            if p != "offload_dots")
    L = dense.n_layers
    assert peak["offload_dots"] <= peak["dots"] - host + host // L
    # full recomputes each layer's forward up to the last op whose output
    # the backward saved: all but the down projection (and the residual
    # add after it), as the reference's remat recomputes what its
    # backward reads.  A layer's forward: the difference of forwards at
    # 4 and 2 layers.
    fwd = {n: _meta_record(dense, n, grad=False)["flops"] for n in (2, 4)}
    tokens = 4 * 256
    per_layer = (fwd[4] - fwd[2]) / 2 - 2 * tokens * dense.d_ff * \
        dense.d_model
    recompute = rec["full"]["flops"] - rec["none"]["flops"]
    assert recompute == L * per_layer
    assert rec["none"]["flops"] < rec["dots"]["flops"] < rec["full"]["flops"]
    assert {k: v["launches"] for k, v in rec["full"]["kernels"].items()} \
        == {"flash_fwd": 2 * L, "flash_dq": L, "flash_dkv": L}
    assert rec["none"]["kernels"]["flash_fwd"]["launches"] == L


COLLECTIVES_SCRIPT = textwrap.dedent("""
    import dataclasses, json
    import torch
    from repro_torch.configs import get_config
    from repro_torch.dist import sharding as sh
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.accounting import Account
    from repro_torch.models import shard_plan as sp
    from repro_torch.models import transformer as tr
    from repro_torch.convert import tree_map
    torch.set_num_threads(1)

    def empty(spec):
        return {k: empty(v) if isinstance(v, dict)
                else torch.empty(v, device="meta") for k, v in spec.items()}

    mesh_lib.init_dryrun_group(2)
    mesh = mesh_lib.make_host_mesh(data=1, model=2, device="cpu")
    out = {}
    for name, layers, policy, grad in (("none", 2, "none", True),
                                       ("full", 2, "full", True),
                                       ("fwd2", 2, "full", False),
                                       ("fwd4", 4, "full", False)):
        cfg = dataclasses.replace(get_config("qwen2-0.5b").smoke(),
                                  dtype="float32", n_layers=layers,
                                  remat_policy=policy)
        rt = sp.TPRuntime(mesh.get_group("model"), 2, 0, tr.tp_plan(cfg, 2))
        params = empty(tr.param_spec(cfg))
        local = tree_map(lambda x, s: sh.tp_shard(x, s, 2, 0).clone()
                         .requires_grad_(grad), params, sh.tp_specs(cfg, 2))
        tokens = torch.zeros((4, 256), dtype=torch.long, device="meta")
        with Account(mesh, "meta") as acc, torch.set_grad_enabled(grad):
            loss = tr.loss_fn(local, cfg, {"tokens": tokens}, tp=rt)
            if grad:
                torch.autograd.grad(loss, [t for t in
                                           torch.utils._pytree.tree_leaves(
                                               local)])
        c = acc.record()["collective_bytes"]
        out[name] = {"bytes": c["axes"]["model"],
                     "counts": c["axis_counts"]["model"]}
    print("COLL" + json.dumps(out))
""")


def test_meta_recompute_issues_the_layers_collectives_again():
    """At model 2 a layer's forward sends two ring all-reduces (the
    attention's exit and the FFN's); the recompute sends the attention's
    again, since the FFN's exit feeds nothing the backward saved.  The
    reference's remat adds the same hops (``test_torch_dryrun.py``)."""
    r = subprocess.run([sys.executable, "-c", COLLECTIVES_SCRIPT],
                       capture_output=True, text=True, timeout=300,
                       env=SUBPROC_ENV)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads([ln for ln in r.stdout.splitlines()
                      if ln.startswith("COLL")][-1][4:])
    for what in ("bytes", "counts"):
        none, full = out["none"][what], out["full"][what]
        f2, f4 = out["fwd2"][what], out["fwd4"][what]
        assert set(full) == set(none) == {"collective-permute", "all-reduce"}
        per_layer = (f4["collective-permute"] - f2["collective-permute"]) / 2
        assert full["collective-permute"] - none["collective-permute"] == \
            2 * per_layer / 2 > 0, what
        assert full["all-reduce"] == none["all-reduce"], what


WORKER = textwrap.dedent("""
    import dataclasses, os, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.convert import tree_leaves, tree_unflatten
    from repro_torch.dist import sharding as sh
    from repro_torch.launch.mesh import init_process_group
    from repro_torch.models import shard_plan as sp
    from repro_torch.models import transformer as tr

    torch.set_num_threads(1)
    work = sys.argv[1]
    raw = np.load(os.path.join(work, "inputs.npz"))
    init_process_group("cpu")
    rank = dist.get_rank()
    group = dist.new_group([0, 1])
    tree = {}
    for key in raw.files:
        if key.startswith("param/"):
            node, path = tree, key[6:].split("/")
            for p in path[:-1]:
                node = node.setdefault(p, {})
            node[path[-1]] = torch.from_numpy(raw[key])
    batch = {"tokens": torch.from_numpy(raw["tokens"])}
    out = {}
    for policy in ("none", "full", "dots", "offload_dots"):
        cfg = dataclasses.replace(get_config("qwen2-0.5b").smoke(),
                                  dtype="float32", attn_chunk=16,
                                  remat_policy=policy)
        # model 2
        rt = sp.TPRuntime(group, 2, rank, tr.tp_plan(cfg, 2))
        specs = tree_leaves(sh.tp_specs(cfg, 2))
        leaves = [sh.tp_shard(x, s, 2, rank).clone().requires_grad_()
                  for x, s in zip(tree_leaves(tree), specs)]
        loss = tr.loss_fn(tree_unflatten(tree, leaves), cfg, batch, tp=rt)
        grads = sh.tp_grad_sync(list(torch.autograd.grad(loss, leaves)),
                                specs, rt)
        out[f"tp/{policy}/loss"] = loss.detach().numpy()
        for i, g in enumerate(grads):
            out[f"tp/{policy}/g{i}"] = g.numpy()
        # pp 2, two microbatches
        pipe = sp.PipeRuntime(group, 2, rank,
                              sp.build_pipeline_plan(cfg, 2, 2))
        pdims = tree_leaves(sh.pipe_dims(cfg, 2))
        leaves = [sh.cut_piece(x, ((d, 2, rank),)).clone().requires_grad_()
                  for x, d in zip(tree_leaves(tree), pdims)]
        loss = tr.pipeline_loss_fn(tree_unflatten(tree, leaves), cfg,
                                   batch, pipe=pipe)
        grads = sh.pipe_grad_sync(list(torch.autograd.grad(loss, leaves)),
                                  pdims, pipe)
        out[f"pp/{policy}/loss"] = loss.detach().numpy()
        for i, g in enumerate(grads):
            out[f"pp/{policy}/g{i}"] = g.numpy()
    np.savez(os.path.join(work, f"rank{rank}.npz"), **out)
    dist.destroy_process_group()
""")


def test_tp_and_pipelined_grads_under_remat(tmp_path):
    ref_cfg, cfg = _cfgs("qwen2-0.5b", "full", **DENSE)
    p = _ref_params(ref_cfg, seed=4)
    batch = _batch(cfg, seed=6)
    batch["tokens"] = np.concatenate([batch["tokens"]] * 2)   # B = 4
    np.savez(tmp_path / "inputs.npz", tokens=batch["tokens"],
             **{"param/" + k: np.asarray(v) for k, v in _flat(p)})
    (tmp_path / "worker.py").write_text(WORKER)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", str(tmp_path / "worker.py"),
         str(tmp_path)], cwd=repo, env=dict(SUBPROC_ENV, OMP_NUM_THREADS="1"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        want_l, want_g = _ref_grad(ref_cfg, p, batch)
        _, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err[-3000:]
    from repro_torch.dist import sharding as sh
    from repro_torch.convert import tree_leaves
    names = [k for k, _ in _flat(tr.param_spec(cfg))]
    specs = tree_leaves(sh.tp_specs(cfg, 2))
    pdims = tree_leaves(sh.pipe_dims(cfg, 2))
    for rank in range(2):
        got = dict(np.load(tmp_path / f"rank{rank}.npz"))
        for axis in ("tp", "pp"):
            for policy in ("full", "dots", "offload_dots"):
                for key in [k for k in got if k.startswith(f"{axis}/none/")]:
                    np.testing.assert_array_equal(
                        got[key.replace("/none/", f"/{policy}/")], got[key],
                        err_msg=f"rank {rank} {key} {policy}")
            loss = float(got[f"{axis}/full/loss"])
            assert abs(loss - want_l) <= TP_LOSS_TOL, (axis, loss, want_l)
            for i, name in enumerate(names):
                w = torch.from_numpy(np.array(want_g[name]))
                w = (sh.tp_shard(w, specs[i], 2, rank) if axis == "tp" else
                     sh.cut_piece(w, ((pdims[i], 2, rank),))).numpy()
                err = np.abs(got[f"{axis}/full/g{i}"] - w).max()
                assert err <= TP_GRAD_TOL * max(np.abs(w).max(), 1e-4), \
                    (axis, rank, name, err)
