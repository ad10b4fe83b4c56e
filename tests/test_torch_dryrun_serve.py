"""The serving shapes' dry run (``launch/serve.lower_step`` under
``launch.accounting.Account``) against the reference's HLO analysis of its
own ``lower_step``, every zoo config on meta, a real gloo launch against
a fake world, two 512-device cases and the sweep.

The reference compiles its GSPMD prefill and dense decode for forced host
devices and runs ``hlo_analysis.analyze`` on the HLO (a subprocess); the
port runs the programs its mesh engine runs (the TP prefill, the paged
decode at the rank's heads) on the meta device at a fake world of 4 (a
second subprocess).  The setup: qwen2-0.5b smoke in f32 (2 layers, d 256,
vocab 512, 4 heads over 2 kv heads of 64), ``prefill_32k`` and
``decode_32k`` on the (data 2, model 2) mesh, ``long_500k`` on (data 1,
model 2): its one sequence does not divide over two data ranks, and the
reference's cache sharding refuses it there.

* The client axis: no collective in either record, for every shape.
* Flops: equal, term by term.  Both shard the attention heads over the
  model axis (the reference's ``use`` layout puts wq/wk/wv's head dims
  there and XLA follows), and the paged kernel's declaration at a full
  table, 4 B H hd P bs a layer, is what the reference's dense attention
  over the whole cache counts; under long_500k's window both count the
  8,192 positions.
* The model axis (bytes, count), reference / port:
  - prefill_32k: all-gather 5,368,709,120 (8), all-reduce 1,084,227,584
    (6) / ring hops (collective-permute) 2,684,354,560 (20), the logits'
    all-gather 32,768 (1);
  - decode_32k: all-gather 2,148,139,008 (10; 2,147,483,648 of it the f16
    K/V cache, which its partitioner gathers over the model axis to meet
    the head-sharded queries), all-reduce 132,352 (6) / ring hops 196,608
    (12), all-reduce 131,072 (2), all-gather 131,072 (1);
  - long_500k: all-gather 8,398,848 (10), all-reduce 2,068 (6) / ring
    hops 3,072 (12), all-reduce 2,048 (2), all-gather 2,048 (1).
  The port's pools hold the rank's kv heads, so nothing of the cache
  crosses the model axis.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

from conftest import SUBPROC_ENV
from repro_torch.configs import ARCHS, get_config

SHAPES = {"prefill_32k": (2, 2), "decode_32k": (2, 2), "long_500k": (1, 2)}

REF_SCRIPT = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import dataclasses, json
    import jax
    import numpy as np
    from repro.configs import get_config
    from repro.launch import hlo_analysis, serve
    cfg = dataclasses.replace(get_config("qwen2-0.5b").smoke(),
                              dtype="float32")
    out = {}
    for shape, (d, m) in %r.items():
        mesh = jax.sharding.Mesh(
            np.array(jax.devices()[:d * m]).reshape(d, m), ("data", "model"))
        hlo = serve.lower_step(cfg, mesh, shape).compile().as_text()
        out[shape] = hlo_analysis.analyze(hlo, model_axis_size=m)
    print("REF" + json.dumps(out))
""" % SHAPES)

PORT_SCRIPT = textwrap.dedent("""
    import dataclasses, json
    import torch
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as mesh_lib, serve
    from repro_torch.launch.accounting import Account
    torch.set_num_threads(1)
    mesh_lib.init_dryrun_group(4)
    cfg = dataclasses.replace(get_config("qwen2-0.5b").smoke(),
                              dtype="float32")
    out = {}
    for shape, (d, m) in %r.items():
        mesh = DeviceMesh("cpu", torch.arange(d * m).reshape(d, m),
                          mesh_dim_names=("data", "model"))
        step, inputs = serve.lower_step(cfg, mesh, shape)
        with Account(mesh, "meta", inputs=inputs) as acc:
            step(*inputs)
        out[shape] = acc.record()
    print("PORT" + json.dumps(out))
""" % SHAPES)


def _run(script: str) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, "-c", script],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=SUBPROC_ENV)


def _tagged(proc, tag: str, timeout: int = 600) -> dict:
    stdout, stderr = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, stderr[-3000:]
    line = [ln for ln in stdout.splitlines() if ln.startswith(tag)][-1]
    return json.loads(line[len(tag):])


@pytest.fixture(scope="module")
def records():
    procs = {"REF": _run(REF_SCRIPT), "PORT": _run(PORT_SCRIPT)}
    try:
        return {tag: _tagged(proc, tag) for tag, proc in procs.items()}
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_client_axis_equal_reference(records, shape):
    r = records["REF"][shape]["collective_bytes"]
    p = records["PORT"][shape]["collective_bytes"]
    for key in ("axes", "axis_counts", "axis_dtypes"):
        assert p[key].get("client", {}) == r[key].get("client", {}) == {}
    assert set(p["axes"]) == set(r["axes"]) == {"model"}
    assert p["wire_dtype"] == r["wire_dtype"] == ""


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_flops_equal_reference(records, shape):
    """Equal; at the decode shapes the paged kernel's declared flops are
    the attention term of the reference's count, 4 B H hd keys a layer at
    the rank's rows and heads."""
    ref, port = records["REF"][shape], records["PORT"][shape]
    assert port["flops"] == ref["flops"] > 0
    if shape == "prefill_32k":
        assert not port["kernels"]
        return
    d, _ = SHAPES[shape]
    rows = {"decode_32k": 128 // d, "long_500k": 1}[shape]
    keys = {"decode_32k": 32768, "long_500k": 8192}[shape]
    layers, heads, hd = 2, 2, 64
    paged = port["kernels"]["paged_attention"]
    assert paged["launches"] == layers
    assert paged["flops"] == layers * 4 * rows * heads * hd * keys


MODEL_AXIS = {   # kind: (reference bytes, count), (port bytes, count)
    "prefill_32k": {"all-gather": ((5368709120, 8), (32768, 1)),
                    "all-reduce": ((1084227584, 6), None),
                    "collective-permute": (None, (2684354560, 20))},
    "decode_32k": {"all-gather": ((2148139008, 10), (131072, 1)),
                   "all-reduce": ((132352, 6), (131072, 2)),
                   "collective-permute": (None, (196608, 12))},
    "long_500k": {"all-gather": ((8398848, 10), (2048, 1)),
                  "all-reduce": ((2068, 6), (2048, 2)),
                  "collective-permute": (None, (3072, 12))},
}


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_model_axis_records(records, shape):
    """The model-axis records the docstring states, of both packages."""
    for tag, i in (("REF", 0), ("PORT", 1)):
        cb = records[tag][shape]["collective_bytes"]
        got = {k: (cb["axes"]["model"][k], cb["axis_counts"]["model"][k])
               for k in cb["axes"]["model"]}
        want = {k: v[i] for k, v in MODEL_AXIS[shape].items()
                if v[i] is not None}
        assert got == want, tag


ZOO_SCRIPT = textwrap.dedent("""
    import dataclasses, json
    import torch
    from repro_torch.configs import ARCHS, get_config
    from repro_torch.launch import mesh as mesh_lib, serve
    from repro_torch.launch.accounting import Account
    from repro_torch.launch.shapes import SHAPES
    torch.set_num_threads(1)
    mesh_lib.init_dryrun_group(4)
    mesh = mesh_lib.make_host_mesh(data=2, model=2, device="cpu")
    out = {}
    for arch in ARCHS:
        cfg = dataclasses.replace(get_config(arch).smoke(), attn_chunk=2048)
        for shape in ("prefill_32k", "decode_32k", "long_500k"):
            step, inputs = serve.lower_step(cfg, mesh, shape)
            with Account(mesh, "meta", inputs=inputs) as acc:
                res = step(*inputs)
            rec = acc.record()
            out[arch + " " + shape] = {
                "paged": rec["kernels"].get("paged_attention", {}).get(
                    "launches", 0),
                "kernels": sorted(rec["kernels"]),
                "axes": sorted(rec["collective_bytes"]["axes"]),
                "flops": rec["flops"],
                "logits": list(res[0].shape),
                "meta": all(t.device.type == "meta" for t in
                            torch.utils._pytree.tree_leaves(res))}
    print("ZOO" + json.dumps(out))
""")


@pytest.fixture(scope="module")
def zoo():
    return _tagged(_run(ZOO_SCRIPT), "ZOO")


@pytest.mark.parametrize("arch", ARCHS)
def test_every_family_serves_on_meta(zoo, arch):
    """``lower_step``'s programs of every zoo config (smoke size, the
    attention's query chunk 2,048 where the smoke configs' 32 would run
    1,024 chunks a layer; the shapes' full batch and length) on the meta
    device at a fake (2, 2) world: the paged kernel n_layers times at the decode shapes of the
    paged families, never in a prefill or in the recurrent families'
    dense decode; the logits of the rank's rows (one at long_500k, its
    one sequence on every data rank), full width (gathered under a
    vocab-parallel plan); nothing off the model axis."""
    from repro_torch.models import transformer as tr
    cfg = get_config(arch).smoke()
    for shape, rows in (("prefill_32k", 16), ("decode_32k", 64),
                        ("long_500k", 1)):
        run = zoo[arch + " " + shape]
        paged = shape != "prefill_32k" and cfg.family in tr.paged_families()
        assert run["paged"] == (cfg.n_layers if paged else 0), shape
        assert run["kernels"] == (["paged_attention"] if paged else [])
        assert run["logits"] == [rows, 1, cfg.vocab], shape
        assert run["axes"] in ([], ["model"]) and run["meta"], shape
        assert run["flops"] > 0, shape


STEP_WORKER = textwrap.dedent("""
    import dataclasses, json, sys
    import torch, torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.convert import tree_leaves
    from repro_torch.launch import mesh as mesh_lib, serve
    from repro_torch.launch.accounting import Account
    from repro_torch.models import transformer as tr
    torch.set_num_threads(1)
    cfg = dataclasses.replace(get_config("qwen2-0.5b").smoke(),
                              dtype="float32")
    CASES = {"prefill": ("prefill", 4, 64, None),
             "decode": ("decode", 4, 40, None),
             "window": ("decode", 4, 41, 16)}

    def run(mesh, device, params=None):
        out = {}
        for name, (kind, b, s, w) in CASES.items():
            step, inputs = serve.serve_program(cfg, mesh, kind, b, s, w,
                                               device=device, params=params)
            if device == "cpu":
                serve.fill_inputs(inputs, cfg, seed=0)
            with Account(mesh, device) as acc:
                step(*inputs)
            out[name] = acc.record()
        return out

    mesh_lib.init_process_group("cpu")
    mesh = mesh_lib.make_host_mesh(data=2, model=2, device="cpu")
    params = tr.init_params(cfg, seed=0, device="cpu")
    real, rank = run(mesh, "cpu", params), dist.get_rank()
    dist.destroy_process_group()
    if rank != 0:
        sys.exit(0)
    mesh_lib.init_dryrun_group(4)
    mesh = mesh_lib.make_host_mesh(data=2, model=2, device="cpu")
    print("ACCOUNTS" + json.dumps({"real": real,
                                   "meta": run(mesh, "meta")}))
    dist.destroy_process_group()
""")


def test_fake_world_serving_collectives_equal_a_gloo_launch(tmp_path):
    """Rank 0 of a real (data 2, model 2) gloo launch of the smoke serving
    programs (prefill 4 x 64; the paged decode at 39 cached positions, and
    at 40 under a window of 16) and the same programs on the meta device
    in a fake world of 4: the same collective record, kind by kind, axis
    by axis, dtype by dtype, bytes and counts.  The flops too, where the
    plain version counts what the declaration does (the prefill and the
    full table; under the window it counts every position of the
    table)."""
    script = tmp_path / "worker.py"
    script.write_text(STEP_WORKER)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", str(script)],
        cwd=repo, env=dict(SUBPROC_ENV, OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    line = [ln for ln in r.stdout.splitlines()
            if ln.startswith("ACCOUNTS")][-1]
    out = json.loads(line[len("ACCOUNTS"):])
    for name in ("prefill", "decode", "window"):
        real, meta = out["real"][name], out["meta"][name]
        assert real["collective_bytes"] == meta["collective_bytes"], name
        assert set(real["collective_bytes"]["axes"]) == {"model"}, name
        if name != "window":
            assert real["flops"] == meta["flops"] > 0, name
    assert out["meta"]["decode"]["kernels"]["paged_attention"][
        "launches"] == 2


PIPE_SCRIPT = textwrap.dedent("""
    import dataclasses, json
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as mesh_lib, serve
    from repro_torch.launch.accounting import Account
    torch.set_num_threads(1)
    mesh_lib.init_dryrun_group(8)
    cfg = dataclasses.replace(get_config("qwen2-0.5b").smoke(),
                              attn_chunk=2048)
    from torch.distributed.device_mesh import DeviceMesh
    out = {}
    for n, mesh in ((2, DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                                   mesh_dim_names=("data", "model"))),
                    (3, mesh_lib.make_host_mesh(data=2, pipe=2, model=2,
                                                device="cpu"))):
        recs = []
        for shape in ("prefill_32k", "decode_32k", "long_500k"):
            step, inputs = serve.lower_step(cfg, mesh, shape)
            with Account(mesh, "meta", inputs=inputs) as acc:
                step(*inputs)
            recs.append(acc.record())
        out[n] = recs
    print("PIPE" + json.dumps(out))
""")


def test_pipe_positions_run_the_same_program():
    """With a pipe axis (--pp) every pipe position runs the serving
    program whole, as the reference's lowering replicates over 'pipe':
    at (data 2, pipe 2, model 2) rank 0's records equal (data 2, model
    2)'s, shape by shape."""
    out = _tagged(_run(PIPE_SCRIPT), "PIPE")
    assert out["3"] == out["2"]


def _dryrun(tmp_path, *args):
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *args,
         "--multi-pod", "--out", str(tmp_path)],
        capture_output=True, text=True, timeout=600, env=SUBPROC_ENV)
    assert r.returncode == 0, (r.stdout[-500:], r.stderr[-2000:])
    assert r.stdout.strip().splitlines()[-1].startswith("OK ")


@pytest.mark.parametrize("arch,shape,kv_local", [
    ("qwen2-0.5b", "decode_32k", 2), ("eris-gptneo-1.3b", "long_500k", 1)])
def test_512_device_serving(tmp_path, arch, shape, kv_local):
    """One rank of 2x16x16: its share of the slots (4 of 128 over 32
    clients; long_500k's one slot on every client), its kv heads (qwen2's
    2 do not divide 16, so its pools replicate them; eris-gptneo's 16 do,
    one a rank), the paged kernel n_layers times, every collective on the
    model axis, the workspace kept apart from the peak."""
    from repro_torch.kernels import paged_attention as pa
    _dryrun(tmp_path, "--arch", arch, "--shape", shape)
    rec = json.loads((tmp_path / f"{arch.replace('.', '_')}__{shape}_mp"
                      ".json").read_text())
    cfg = get_config(arch)
    assert rec["mesh"] == "2x16x16" and rec["devices"] == 512
    assert rec["tp"] == {"size": 16} and rec["kind"] == "decode"
    cb = rec["collective_bytes_per_device"]
    assert set(cb["axes"]) == {"model"} and rec["wire_dtype"] == ""
    paged = rec["kernels"]["paged_attention"]
    assert paged["launches"] == cfg.n_layers
    rows, keys = (4, 32768) if shape == "decode_32k" else (1, 8192)
    heads = kv_local * (cfg.n_heads // cfg.n_kv_heads)
    assert paged["flops"] == cfg.n_layers * 4 * rows * heads * cfg.hd * keys
    pages = 32768 // 16 if shape == "decode_32k" else 524288 // 16
    assert rec["paged_workspace_bytes"] == pa.workspace_bytes(
        rows, heads, kv_local, cfg.hd, pages, 16)
    mem = rec["memory"]
    assert mem["peak_bytes"] >= mem["argument_bytes"] > 0
    assert rec["compile_s"] is None and rec["run_device"] == "meta"


def test_sweep_runs_one_serving_case(tmp_path):
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.sweep", "--archs",
         "xlstm-350m", "--shapes", "long_500k", "--meshes", "16x16",
         "--out", str(tmp_path)],
        capture_output=True, text=True, timeout=600, env=SUBPROC_ENV)
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-2000:])
    assert "DONE 1/1 ok" in r.stdout
    assert "OK xlstm-350m long_500k mesh=16x16" in r.stdout
    rec = json.loads((tmp_path / "xlstm-350m__long_500k.json").read_text())
    assert rec["devices"] == 256 and rec["tp"] == {"size": 16}
    assert rec["kernels"] == {} and rec["paged_workspace_bytes"] == 0
