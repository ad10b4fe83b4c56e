"""The port's mesh serving of the MoE family and from a checkpoint, against
the reference, on the CPU: one ``torch.distributed.run --nproc-per-node
4`` launch of a worker script this test writes (gloo ranks) beside one
JAX subprocess on four forced host devices, every case f32.

* olmoe-1b-7b's smoke config at 2 layers on a (data 2, model 2) mesh,
  the experts sharded over "model": the tokens equal the reference's
  engine's on the same (2, 2) mesh of host devices.  Its meshless tokens
  are not the target: a rank's decode batch is its data position's four
  slots, and the experts' capacity follows that batch, in both packages.
* ``ServeEngine.from_checkpoint(..., mesh=)``: qwen2-0.5b's smoke config
  at 2 layers, its params stored at a (data 2, model 2) train mesh
  (``launch/train.store_params``, ``store_cuts``) and saved by those four
  ranks; served on a (data 1, model 2) mesh of ranks 0 and 1, sampled:
  each rank's restored leaves equal its TP piece of the whole leaves,
  and the tokens equal the reference's meshless engine's.
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
from repro.serve import SamplingParams as RefSamplingParams  # noqa: E402
from repro.serve import ServeEngine as RefServeEngine  # noqa: E402
from repro.serve import ServeSettings as RefServeSettings  # noqa: E402

WORLD = 4
SETTINGS = dict(max_concurrency=8, block_size=8, num_blocks=64,
                max_model_len=48, prefill_bucket=16, max_new_tokens=5,
                cache_dtype="float32")
SAMPLED = dict(temperature=0.8, top_k=20, top_p=0.95)
# (name, arch, sampled)
CASES = [("moe", "olmoe-1b-7b", False), ("ckpt", "qwen2-0.5b", True)]


def _cfg(arch):
    return dataclasses.replace(ref_get_config(arch).smoke(), n_layers=2,
                               dtype="float32")


def _prompts(vocab):
    rng = np.random.default_rng(1)
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


def _tree(raw, prefix, cast):
    t = {}
    for key in raw:
        if key.startswith(prefix + "/"):
            node, path = t, key[len(prefix) + 1:].split("/")
            for p in path[:-1]:
                node = node.setdefault(p, {})
            node[path[-1]] = cast(raw[key])
    return t


COMMON = textwrap.dedent("""
    import dataclasses, json, os, sys
    import numpy as np

    def tree(raw, prefix, cast):
        t = {}
        for key in raw:
            if key.startswith(prefix + "/"):
                node, path = t, key[len(prefix) + 1:].split("/")
                for p in path[:-1]:
                    node = node.setdefault(p, {})
                node[path[-1]] = cast(raw[key])
        return t
""")

REF_SCRIPT = COMMON + textwrap.dedent("""
    work = sys.argv[1]
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp
    from jax.sharding import Mesh
    from repro.configs import get_config
    from repro.serve import ServeEngine, ServeSettings

    spec = json.load(open(os.path.join(work, "spec.json")))
    raw = dict(np.load(os.path.join(work, "inputs.npz")))
    cfg = dataclasses.replace(get_config("olmoe-1b-7b").smoke(), n_layers=2,
                              dtype="float32")
    mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
    eng = ServeEngine(cfg, tree(raw, "moe/param", jnp.asarray),
                      ServeSettings(**spec["settings"]), mesh=mesh)
    outs = eng.run(spec["prompts"]["moe"])
    json.dump({"tokens": [o.tokens for o in outs], "manual": eng._manual,
               "moe": eng._tp_plan.moe},
              open(os.path.join(work, "ref.json"), "w"))
""")

WORKER = COMMON + textwrap.dedent("""
    work = sys.argv[1]
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.convert import tree_leaves
    from repro_torch.checkpoint import msgpack_ckpt as ck
    from repro_torch.dist import sharding as sh
    from repro_torch.launch import train
    from repro_torch.launch.mesh import init_process_group, make_host_mesh
    from repro_torch.serve import SamplingParams, ServeEngine, ServeSettings

    torch.set_num_threads(1)
    spec = json.load(open(os.path.join(work, "spec.json")))
    raw = dict(np.load(os.path.join(work, "inputs.npz")))
    init_process_group("cpu")
    rank = dist.get_rank()
    out = {}

    def cfg_of(arch):
        return dataclasses.replace(get_config(arch).smoke(), n_layers=2,
                                   dtype="float32")

    # olmoe on the (2, 2) mesh
    mesh = make_host_mesh(2, 2, device="cpu")
    cfg = cfg_of("olmoe-1b-7b")
    eng = ServeEngine(cfg, tree(raw, "moe/param", torch.from_numpy),
                      ServeSettings(**spec["settings"]), mesh=mesh,
                      device="cpu")
    outs = eng.run(spec["prompts"]["moe"])
    out["moe/tokens"] = json.dumps([o.tokens for o in outs])
    out["moe/meta"] = json.dumps({"manual": eng._manual,
                                  "moe": eng._tp_plan.moe,
                                  "slots": list(eng._slots)})

    # the checkpoint: stored and saved at (data 2, model 2)
    cfg = cfg_of("qwen2-0.5b")
    whole = tree(raw, "ckpt/param", torch.from_numpy)
    settings = train.TrainSettings()
    ck.save_sharded(os.path.join(work, "ckpt"),
                    train.store_params(whole, cfg, mesh, settings),
                    cuts=train.store_cuts(cfg, mesh, settings))
    dist.barrier()

    class HandMesh:
        # (data 1, model 2) over ranks 0 and 1
        mesh_dim_names = ("data", "model")

        def __init__(self, group):
            self.group = group

        def size(self, i):
            return (1, 2)[i]

        def get_group(self, name):
            assert name == "model", name
            return self.group

    pair = dist.new_group([0, 1])
    if rank < 2:
        serve_mesh = HandMesh(pair)
        ss = ServeSettings(**spec["settings"],
                           sampling=SamplingParams(**spec["sampled"]))
        eng = ServeEngine.from_checkpoint(os.path.join(work, "ckpt"), cfg,
                                          ss, mesh=serve_mesh, device="cpu")
        want = tree_leaves(sh.tp_piece(whole, cfg, 2, rank))
        got = tree_leaves(eng.params)
        out["ckpt/pieces"] = json.dumps({
            "equal": all(torch.equal(g, w) for g, w in zip(got, want)),
            "shapes": [list(g.shape) for g in got]})
        out["ckpt/tokens"] = json.dumps(
            [o.tokens for o in eng.run(spec["prompts"]["ckpt"])])
    with open(os.path.join(work, f"port_{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()
""")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's mesh engine in a subprocess, the port's four-rank
    launch, and the reference's meshless engine on the checkpoint's
    params in this process, side by side.  Returns (the inputs, the
    reference's mesh result, its meshless checkpoint tokens, the four
    ranks' results)."""
    work = tmp_path_factory.mktemp("serve_mesh_moe")
    inputs = {}
    for k, (name, arch, _) in enumerate(CASES):
        inputs.update(_flat(ref_tr.init_params(jax.random.PRNGKey(k),
                                               _cfg(arch)), f"{name}/param"))
    np.savez(work / "inputs.npz", **inputs)
    prompts = {name: _prompts(_cfg(arch).vocab) for name, arch, _ in CASES}
    (work / "spec.json").write_text(json.dumps(
        {"settings": SETTINGS, "sampled": SAMPLED, "prompts": prompts}))
    (work / "worker.py").write_text(WORKER)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [
        subprocess.Popen([sys.executable, "-c", REF_SCRIPT, str(work)],
                         cwd=repo, env=SUBPROC_ENV, stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True),
        subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", str(WORLD), str(work / "worker.py"),
             str(work)],
            cwd=repo, env=dict(SUBPROC_ENV, OMP_NUM_THREADS="1"),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)]
    try:
        ss = RefServeSettings(**SETTINGS,
                              sampling=RefSamplingParams(**SAMPLED))
        ckpt = [o.tokens for o in RefServeEngine(
            _cfg("qwen2-0.5b"), _tree(inputs, "ckpt/param", jnp.asarray),
            ss).run(prompts["ckpt"])]
        results = [proc.communicate(timeout=600) for proc in procs]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for proc, (_, err) in zip(procs, results):
        assert proc.returncode == 0, err[-3000:]
    ref = json.loads((work / "ref.json").read_text())
    ranks = [json.loads((work / f"port_{r}.json").read_text())
             for r in range(WORLD)]
    return inputs, ref, ckpt, ranks


def test_moe_mesh_tokens_equal_the_references_mesh_engine(runs):
    """olmoe at (2, 2), expert parallel, every rank's tokens equal the
    reference's engine's on its (2, 2) mesh; both take the manual path,
    each data position four slots."""
    _, ref, _, ranks = runs
    assert ref["manual"] and ref["moe"]
    for r, rank in enumerate(ranks):
        meta = json.loads(rank["moe/meta"])
        assert meta["manual"] and meta["moe"]
        assert meta["slots"] == list(range(4 * (r // 2), 4 * (r // 2) + 4))
        assert json.loads(rank["moe/tokens"]) == ref["tokens"], r


def test_from_checkpoint_onto_a_serve_mesh(runs):
    """The (2, 2) train mesh's checkpoint served at (1, 2): each rank
    restored exactly its TP piece of every leaf (the column- and
    vocab-sharded ones at half their width), and both ranks' sampled
    tokens equal the reference's meshless engine's."""
    inputs, _, ckpt, ranks = runs
    whole = [list(x.shape) for x in jax.tree.leaves(
        _tree(inputs, "ckpt/param", np.asarray))]
    for r in range(2):
        pieces = json.loads(ranks[r]["ckpt/pieces"])
        assert pieces["equal"], r
        assert pieces["shapes"] != whole
        assert sum(np.prod(s) for s in pieces["shapes"]) < \
            sum(np.prod(s) for s in whole)
        assert json.loads(ranks[r]["ckpt/tokens"]) == ckpt, r
