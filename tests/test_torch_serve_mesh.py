"""The port's serving over a ("data", "model") mesh against the reference,
on the CPU: one ``torch.distributed.run --nproc-per-node 8`` launch of a
worker script this test writes, gloo ranks, every case f32.

* Decode under TP: ``paged_decode_step`` with a ``TPRuntime`` on each
  rank's TP piece of the params and its kv heads of the pools, against
  the reference's replicated ``paged_decode_step`` (its plain attention)
  on the same numpy inputs: the gathered logits within ``LOGIT_TOL``
  relative to their scale, and each rank's pools after the step equal to
  its slice of the reference's new pools within the same.  qwen2-0.5b's
  smoke config at tp 2 (attention and vocab sharded), at tp 4 (its 2 kv
  heads do not divide: attention replicated, the pools whole) and
  eris-gptneo-1.3b's at vocab 509 (the replicated-vocab fallback).
* The reference's own mesh case (``tests/test_serve.py``'s
  ``MESH_SERVE_SCRIPT``): qwen2-0.5b smoke at 2 layers, its 8 prompts and
  settings, the engine on a (4, 2) mesh: the manual path with attention
  sharded, tokens equal to the reference's meshless engine's (which its
  own test pins its mesh tokens to), the peak within the pool.  Then the
  fallback at ``max_concurrency=6`` (the slots do not divide the 4 client
  positions) and a pool small enough to preempt, each against the
  reference's meshless engine with the same settings.

The reference runs in this process, meanwhile.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_thread  # noqa: E402,F401
from conftest import SUBPROC_ENV  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import transformer as ref_tr  # noqa: E402
from repro.serve import ServeEngine as RefServeEngine  # noqa: E402
from repro.serve import ServeSettings as RefServeSettings  # noqa: E402

WORLD = 8
LOGIT_TOL = 1e-5
# (name, arch, ModelConfig overrides, tp)
DECODE = [
    ("qwen2_tp2", "qwen2-0.5b", {}, 2),
    ("qwen2_tp4_replicated_attn", "qwen2-0.5b", {}, 4),
    ("gptneo_vocab509", "eris-gptneo-1.3b", dict(vocab=509), 2),
]
ROWS, BLOCK, BLOCKS, PAGES = 4, 8, 24, 4
CTX = [5, 17, 0, 30]            # row 2 inactive: ctx 0, an all-scratch table
# tests/test_serve.py's MESH_SERVE_SCRIPT settings, and two variants
MESH_SETTINGS = dict(max_concurrency=8, block_size=8, num_blocks=64,
                     max_model_len=48, prefill_bucket=16, max_new_tokens=5,
                     cache_dtype="float32")
SERVE = [
    ("manual", {}),
    ("fallback", dict(max_concurrency=6)),
    # 11 usable blocks for 8 requests of 2 pages each: the youngest are
    # preempted and replayed
    ("preempt", dict(num_blocks=12)),
]


def _serve_cfg():
    return dataclasses.replace(ref_get_config("qwen2-0.5b").smoke(),
                               n_layers=2, dtype="float32")


def _prompts(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, size=int(rng.integers(3, 11))).tolist()
            for _ in range(8)]


def _flat(tree, prefix):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_flat(val, f"{prefix}/{key}"))
        else:
            out[f"{prefix}/{key}"] = np.asarray(val)
    return out


def _perturbed(flat: dict, rng) -> dict:
    """The init draws with every norm scale and bias moved off its 1 or 0
    by 0.1 normal, as ``test_torch_tp._inputs`` draws them, so that a
    norm or bias leaf cut at the wrong index shows in the logits."""
    out = {}
    for key, x in flat.items():
        leaf = key.rsplit("/", 1)[1]
        if leaf.startswith(("ln", "q_norm", "k_norm", "b")):
            x = x + 0.1 * rng.standard_normal(x.shape)
        out[key] = x.astype(np.float32)
    return out


def _inputs() -> dict:
    """Numpy params of every case (the reference's init draws, norms and
    biases perturbed), the decode cases' pools, tables, contexts and
    tokens."""
    out = {}
    for k, (name, arch, over, tp) in enumerate(DECODE):
        cfg = dataclasses.replace(ref_get_config(arch).smoke(), **over)
        rng = np.random.default_rng(100 + k)
        out.update(_perturbed(_flat(ref_tr.init_params(
            jax.random.PRNGKey(k), cfg), f"{name}/param"), rng))
        shape = (cfg.n_layers, BLOCKS, cfg.n_kv_heads, BLOCK, cfg.hd)
        out[f"{name}/k"] = rng.standard_normal(shape).astype(np.float32)
        out[f"{name}/v"] = rng.standard_normal(shape).astype(np.float32)
        tables = np.zeros((ROWS, PAGES), np.int32)
        used = rng.permutation(np.arange(1, BLOCKS))
        for r, ctx in enumerate(CTX):
            n = -(-(ctx + 1) // BLOCK) if ctx else 0
            tables[r, :n] = used[r * PAGES:r * PAGES + n]
        out[f"{name}/tables"] = tables
        out[f"{name}/ctx"] = np.asarray(CTX, np.int32)
        out[f"{name}/tokens"] = rng.integers(0, cfg.vocab,
                                             (ROWS, 1)).astype(np.int32)
    out.update(_perturbed(_flat(ref_tr.init_params(
        jax.random.PRNGKey(0), _serve_cfg()), "serve/param"),
        np.random.default_rng(99)))
    return out


WORKER = textwrap.dedent("""
    import dataclasses, json, os, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.dist import sharding as sh
    from repro_torch.launch.mesh import init_process_group, make_host_mesh
    from repro_torch.models import shard_plan as sp
    from repro_torch.models import transformer as tr
    from repro_torch.serve import ServeEngine, ServeSettings

    work = sys.argv[1]
    torch.set_num_threads(1)
    spec = json.load(open(os.path.join(work, "spec.json")))
    raw = np.load(os.path.join(work, "inputs.npz"))
    init_process_group("cpu")
    rank = dist.get_rank()
    groups = {2: dist.new_group([0, 1]), 4: dist.new_group([0, 1, 2, 3])}
    out = {}

    def tree(prefix):
        t = {}
        for key in raw.files:
            if key.startswith(prefix + "/"):
                node, path = t, key[len(prefix) + 1:].split("/")
                for p in path[:-1]:
                    node = node.setdefault(p, {})
                node[path[-1]] = torch.from_numpy(raw[key])
        return t

    # decode under TP: each rank of the group on its pieces
    for name, arch, over, tp in spec["decode"]:
        if rank >= tp:
            continue
        cfg = dataclasses.replace(get_config(arch).smoke(), **over)
        plan = dataclasses.replace(tr.tp_plan(cfg, tp), seq=False,
                                   seq_ce=False, ctx=1)
        rt = sp.TPRuntime(groups[tp], tp, rank, plan)
        params = sh.tp_piece(tree(name + "/param"), cfg, tp, rank)
        heads = sh.paged_pool_heads(cfg, plan, tp, rank)
        lo = heads.start
        pools = {n: torch.from_numpy(raw[f"{name}/{n}"])[:, :, lo:heads.stop]
                 .clone() for n in ("k", "v")}
        logits, pools = tr.paged_decode_step(
            params, cfg, pools, torch.from_numpy(raw[name + "/tables"]),
            torch.from_numpy(raw[name + "/ctx"]),
            torch.from_numpy(raw[name + "/tokens"]), use_kernel=True, tp=rt)
        out[name + "/logits"] = logits.numpy()
        out[name + "/attn"] = np.asarray(plan.attn)
        out[name + "/vocab"] = np.asarray(plan.vocab)
        for n in ("k", "v"):
            out[f"{name}/{n}"] = pools[n].numpy()
            out[f"{name}/{n}_lo"] = np.asarray(lo)

    # the engine on a (4, 2) mesh of all eight ranks
    mesh = make_host_mesh(4, 2, device="cpu")
    cfg = dataclasses.replace(get_config("qwen2-0.5b").smoke(), n_layers=2,
                              dtype="float32")
    params = tree("serve/param")
    for name, over in spec["serve"]:
        ss = ServeSettings(**dict(spec["settings"], **over))
        eng = ServeEngine(cfg, params, ss, mesh=mesh, device="cpu")
        outs = eng.run(spec["prompts"])
        st = eng.stats()
        out[name + "/tokens"] = np.asarray(json.dumps(
            [o.tokens for o in outs]))
        out[name + "/meta"] = np.asarray(json.dumps({
            "manual": eng._manual, "kernel": eng._use_kernel,
            "attn": eng._tp_plan.attn, "slots": list(eng._slots),
            "pool_heads": eng.pools["k"].shape[2],
            "peak": st["peak_blocks"], "cap": st["block_capacity"],
            "preemptions": sum(o.preemptions for o in outs)}))
    np.savez(os.path.join(work, f"port_{rank}.npz"), **out)
    dist.destroy_process_group()
""")


def _ref_decode(name, arch, over, inputs):
    """The reference's replicated decode step: logits and new pools."""
    cfg = dataclasses.replace(ref_get_config(arch).smoke(), **over)
    params = {}
    for key, x in inputs.items():
        if key.startswith(name + "/param/"):
            node, path = params, key[len(name) + 7:].split("/")
            for p in path[:-1]:
                node = node.setdefault(p, {})
            node[path[-1]] = jnp.asarray(x)
    logits, pools = ref_tr.paged_decode_step(
        params, cfg, {n: jnp.asarray(inputs[f"{name}/{n}"])
                      for n in ("k", "v")},
        jnp.asarray(inputs[name + "/tables"]),
        jnp.asarray(inputs[name + "/ctx"]),
        jnp.asarray(inputs[name + "/tokens"]), use_kernel=False)
    return np.asarray(logits), {n: np.asarray(p) for n, p in pools.items()}


def _ref_tokens(inputs):
    """The reference's meshless engine's tokens in each serving case."""
    cfg = _serve_cfg()
    params = {}
    for key, x in inputs.items():
        if key.startswith("serve/param/"):
            node, path = params, key[len("serve/param/"):].split("/")
            for p in path[:-1]:
                node = node.setdefault(p, {})
            node[path[-1]] = jnp.asarray(x)
    prompts = _prompts(cfg.vocab)
    out = {}
    for name, over in SERVE:
        ss = RefServeSettings(**dict(MESH_SETTINGS, **over))
        out[name] = [o.tokens for o in
                     RefServeEngine(cfg, params, ss).run(prompts)]
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's eight-rank launch beside the reference's decode steps
    and engines in this process.  Returns (the reference's decode
    results, its tokens per serving case, the eight ranks' arrays)."""
    work = tmp_path_factory.mktemp("serve_mesh")
    inputs = _inputs()
    np.savez(work / "inputs.npz", **inputs)
    (work / "spec.json").write_text(json.dumps(
        {"decode": DECODE, "serve": SERVE, "settings": MESH_SETTINGS,
         "prompts": _prompts(_serve_cfg().vocab)}))
    (work / "worker.py").write_text(WORKER)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(WORLD), str(work / "worker.py"), str(work)],
        cwd=repo, env=dict(SUBPROC_ENV, OMP_NUM_THREADS="1"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        decode = {c[0]: _ref_decode(*c[:3], inputs) for c in DECODE}
        tokens = _ref_tokens(inputs)
        _, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err[-3000:]
    return decode, tokens, [dict(np.load(work / f"port_{r}.npz"))
                            for r in range(WORLD)]


def _rel(got, want) -> float:
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.mark.parametrize("name,arch,over,tp", DECODE,
                         ids=[c[0] for c in DECODE])
def test_tp_decode_step_matches_the_references(runs, name, arch, over, tp):
    """Every rank of the group returns the full logits, within
    ``LOGIT_TOL`` of the reference's replicated step, and its pools hold
    its slice of the reference's new pools (the new K/V written at each
    row's position, scratch included) within the same."""
    decode, _, ranks = runs
    logits, pools = decode[name]
    want_attn, want_vocab = {"qwen2_tp2": (True, True),
                             "qwen2_tp4_replicated_attn": (False, True),
                             "gptneo_vocab509": (True, False)}[name]
    for r in range(tp):
        got = ranks[r]
        assert (bool(got[name + "/attn"]), bool(got[name + "/vocab"])) == \
            (want_attn, want_vocab)
        assert got[name + "/logits"].shape == logits.shape
        assert _rel(got[name + "/logits"], logits) <= LOGIT_TOL, (name, r)
        for n in ("k", "v"):
            local = got[f"{name}/{n}"]
            lo = int(got[f"{name}/{n}_lo"])
            want = pools[n][:, :, lo:lo + local.shape[2]]
            assert _rel(local, want) <= LOGIT_TOL, (name, r, n)


@pytest.mark.parametrize("name,over", SERVE, ids=[c[0] for c in SERVE])
def test_mesh_engine_tokens_equal_the_references(runs, name, over):
    """At (4, 2): every rank's tokens equal the reference's meshless
    engine's; the manual path (attention sharded, each data position two
    contiguous slots, the pools at one kv head) where the slots divide,
    the fallback (every slot on every rank) at 6; the pool's peak within
    its capacity; the small pool preempts."""
    _, tokens, ranks = runs
    metas = [json.loads(str(r[name + "/meta"])) for r in ranks]
    for r, rank in enumerate(ranks):
        assert json.loads(str(rank[name + "/tokens"])) == tokens[name], \
            (name, r)
        meta = metas[r]
        assert meta["kernel"] and meta["attn"] and meta["pool_heads"] == 1
        assert meta["peak"] <= meta["cap"]
        if name == "fallback":
            assert not meta["manual"] and meta["slots"] == list(range(6))
        else:
            assert meta["manual"]
            assert meta["slots"] == [2 * (r // 2), 2 * (r // 2) + 1]
    assert (metas[0]["preemptions"] > 0) == (name == "preempt")
