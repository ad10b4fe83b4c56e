"""The port's dry-run account against the reference's HLO analysis, every
family and knob on the meta device, and the sweep.

The reference lowers and compiles its step for 4 forced host devices and
runs ``hlo_analysis.analyze`` on the HLO (a subprocess, as its own
multi-device tests do); the port runs the same step on the meta device at
a fake world of 4 under ``launch.accounting.Account`` (a second
subprocess).  The setup: qwen2-0.5b smoke in f32 (2 layers, d 256, vocab
512, 4 heads over 2 kv heads), the (data 2, model 2) mesh, ``train_1k``
(256 x 1024 tokens), the int8 wire.  At the reference's defaults (full
remat, the flash kernels):

* the client axis is equal kind by kind in bytes (the reference fuses
  the loss and grad-norm psums into one 8-byte all-reduce, the port
  sends two of 4), and the wire is int8;
* the model axis: the all-reduces are equal; the port's ring hops
  (``overlap_collectives``) are the reference's less the 8 that its remat
  recomputes (the port keeps the activations, which changes no value);
* flops: the port counts 1.148x the reference's.  Both count the flash
  kernels dense, but the reference's trip-count heuristic takes the
  interpret-mode backward kernels' nested grid loop once per outer trip
  (its dq and dk/dv come to an eighth of their dense count), while its
  remat adds the forward again.

With the remat off (``remat_policy="none"``, the program the port runs)
and the plain attention, the model axis is equal kind by kind but for the
reference's one 8-byte reduce-scatter of an iota (its model-axis index,
which a torch rank knows), and the flops differ by two terms the test
computes from the shapes: the reference's one-hot matmul for the
embedding gradient (``dense_embed_grad``; the port scatters the rows) and
the attention scores its chunked attention recomputes in the backward.

Then ``lower_train_step``'s step of every zoo config, and the step with
each scenario and async knob, run on the meta device at a fake world of
8 (one subprocess), and the sweep over one case.
"""
import json
import subprocess
import sys
import textwrap

import pytest

from conftest import SUBPROC_ENV
from repro_torch.configs import ARCHS

REF_SCRIPT = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import dataclasses, json
    from repro.configs import get_config
    from repro.launch import hlo_analysis, train as tl
    from repro.launch.mesh import make_host_mesh
    mesh = make_host_mesh(2, 2)
    out = {}
    for name, kw in (("defaults", {}),
                     ("no_remat_plain", dict(remat_policy="none",
                                             flash_attention=False))):
        cfg = dataclasses.replace(get_config("qwen2-0.5b").smoke(),
                                  dtype="float32", **kw)
        hlo = tl.lower_train_step(
            cfg, mesh, "train_1k",
            tl.TrainSettings(int8_wire=True)).compile().as_text()
        out[name] = hlo_analysis.analyze(hlo, model_axis_size=2)
    print("REF" + json.dumps(out))
""")

PORT_SCRIPT = textwrap.dedent("""
    import dataclasses, json
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as mesh_lib, train as tl
    from repro_torch.launch.accounting import Account
    torch.set_num_threads(1)
    mesh_lib.init_dryrun_group(4)
    mesh = mesh_lib.make_host_mesh(data=2, model=2, device="cpu")
    out = {}
    for name, flash in (("flash", True), ("plain", False)):
        cfg = dataclasses.replace(get_config("qwen2-0.5b").smoke(),
                                  dtype="float32", flash_attention=flash)
        step, inputs = tl.lower_train_step(
            cfg, mesh, "train_1k", tl.TrainSettings(int8_wire=True))
        with Account(mesh, "meta", inputs=inputs[:4]) as acc:
            step(*inputs)
        out[name] = acc.record()
    print("PORT" + json.dumps(out))
""")


META_SCRIPT = textwrap.dedent("""
    import dataclasses, json
    import torch
    from repro_torch.configs import ARCHS, get_config
    from repro_torch.launch import mesh as mesh_lib, shapes, train as tl
    from repro_torch.launch.accounting import Account
    torch.set_num_threads(1)
    mesh_lib.init_dryrun_group(8)
    KNOBS = {"no_fsa": dict(fsa=False),
             "ldp": dict(ldp_eps=1.0, grad_dtype="float32"),
             "secure_mask": dict(secure_mask=True, grad_dtype="float32"),
             "failures": dict(agg_dropout=0.25, link_failure=0.1,
                              int8_wire=True),
             "fedbuff": dict(async_buffer=True, buffer_cadence=2,
                             client_dropout=0.25, delay_max=2,
                             int8_wire=True),
             "dsc": dict(use_dsc=True),
             "dsc_int8_unfused": dict(use_dsc=True, int8_wire=True,
                                      fused_wire=False),
             "capture_views": dict(capture_views=True, int8_wire=True)}
    cases = [(a, dict(data=2, model=2, pipe=2),
              dict(int8_wire=True, use_dsc=True, microbatches=2))
             for a in ARCHS]
    cases += [(k, dict(data=8), kw) for k, kw in KNOBS.items()]
    out = {}
    for name, axes, kw in cases:
        mesh = mesh_lib.make_host_mesh(device="cpu", **axes)
        cfg = get_config(name if name in ARCHS else "qwen2-0.5b").smoke()
        step, inputs = tl.lower_train_step(cfg, mesh, "train_1k",
                                           tl.TrainSettings(**kw))
        batch = shapes.token_spec(cfg, 8, 128)
        with Account(mesh, "meta") as acc:
            res = step(*inputs[:3], batch, inputs[4])
        rec = acc.record()
        out[name] = {"axes": sorted(rec["collective_bytes"]["axes"]),
                     "kernels": sorted(rec["kernels"]),
                     "flops": rec["flops"],
                     "meta": all(t.device.type == "meta" for t in
                                 torch.utils._pytree.tree_leaves(res[0]))}
    print("META" + json.dumps(out))
""")


def _run(script: str, tag: str) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, "-c", script],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=SUBPROC_ENV)


@pytest.fixture(scope="module")
def records():
    procs = {"REF": _run(REF_SCRIPT, "REF"), "PORT": _run(PORT_SCRIPT,
                                                          "PORT")}
    out = {}
    try:
        for tag, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=600)
            assert proc.returncode == 0, stderr[-3000:]
            line = [ln for ln in stdout.splitlines()
                    if ln.startswith(tag)][-1]
            out[tag] = json.loads(line[len(tag):])
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out["REF"], out["PORT"]


BIG_HOP = 128 * 1024 * 64 * 4   # a quarter of one (128, 1024, 256) f32


def test_client_axis_and_wire_equal_reference(records):
    ref, port = records
    r, p = ref["defaults"]["collective_bytes"], \
        port["flash"]["collective_bytes"]
    assert p["axes"]["client"] == r["axes"]["client"]
    assert p["axis_dtypes"]["client"] == r["axis_dtypes"]["client"]
    assert p["wire_dtype"] == r["wire_dtype"] == "s8"
    counts = dict(r["axis_counts"]["client"], **{"all-reduce": 2})
    assert p["axis_counts"]["client"] == counts
    # the port's record does not depend on the attention path
    assert port["plain"]["collective_bytes"] == p


def test_model_axis_against_reference(records):
    ref, port = records
    p = port["flash"]["collective_bytes"]["axes"]["model"]
    full = ref["defaults"]["collective_bytes"]["axes"]["model"]
    none = ref["no_remat_plain"]["collective_bytes"]["axes"]["model"]
    # the reference's remat sends 8 more ring hops
    assert full["collective-permute"] - p["collective-permute"] == \
        8 * BIG_HOP
    assert full["all-reduce"] == p["all-reduce"]
    # without it, every kind within 2% (equal) but the reference's
    # axis-index iota: one reduce-scatter of f32[2]
    assert none["reduce-scatter"] == 8 and "reduce-scatter" not in p
    for kind, nbytes in none.items():
        if kind != "reduce-scatter":
            assert abs(p[kind] - nbytes) <= 0.02 * nbytes, kind
            assert p[kind] == nbytes, kind


def test_flops_against_reference(records):
    ref, port = records
    ratio = port["flash"]["flops"] / ref["defaults"]["flops"]
    assert abs(ratio - 1.148) < 0.005, ratio
    # remat off, plain attention: the port's flops plus the reference's
    # one-hot embedding gradient and its recomputed attention scores
    tokens, d, v_loc, heads, seq, hd, layers = 128 * 1024, 256, 256, 2, \
        1024, 64, 2
    one_hot = 2 * tokens * v_loc * d
    rescore = layers * 2 * 128 * heads * seq * seq * hd
    want = ref["no_remat_plain"]["flops"]
    got = port["plain"]["flops"]
    assert abs(got / want - 0.915) < 0.005, got / want
    assert abs(got + one_hot + rescore - want) <= 1e-3 * want


@pytest.fixture(scope="module")
def meta_runs():
    proc = _run(META_SCRIPT, "META")
    stdout, stderr = proc.communicate(timeout=600)
    assert proc.returncode == 0, stderr[-3000:]
    line = [ln for ln in stdout.splitlines() if ln.startswith("META")][-1]
    return json.loads(line[len("META"):])


@pytest.mark.parametrize("arch", ARCHS)
def test_every_family_steps_on_meta_over_three_axes(meta_runs, arch):
    """``lower_train_step``'s step of every zoo config (smoke size, 8 x
    128 tokens) runs on the meta device at (data 2, pipe 2, model 2),
    DSC on the fused int8 wire: its collectives ride all three axes, the
    wire kernels declare, the flash kernels too where the family has
    attention, and the state it returns stays on meta."""
    run = meta_runs[arch]
    assert run["axes"] == ["client", "model", "pipe"] and run["meta"]
    want = {"dsc_quantize", "dequantize"}
    if arch != "xlstm_350m":
        want |= {"flash_fwd", "flash_dq", "flash_dkv"}
    assert set(run["kernels"]) == want and run["flops"] > 0


KNOB_KERNELS = {"no_fsa": [], "ldp": [], "secure_mask": [],
                "failures": ["dequantize", "quantize"],
                "fedbuff": ["dequantize", "quantize"], "dsc": [],
                "dsc_int8_unfused": ["dequantize", "quantize"],
                "capture_views": ["dequantize", "quantize"]}


@pytest.mark.parametrize("knob", sorted(KNOB_KERNELS))
def test_every_knob_steps_on_meta(meta_runs, knob):
    """The step's scenario and async knobs on the meta device at (data
    8): LDP's clip factor and the FedBuff cadence read host values, which
    the dry run takes as placeholders (the clip) or keeps on the host
    (the buffer's w and t)."""
    run = meta_runs[knob]
    flash = ["flash_dkv", "flash_dq", "flash_fwd"]
    assert run["kernels"] == sorted(flash + KNOB_KERNELS[knob])
    assert run["axes"] == ["client"] and run["meta"]


MESH_SCRIPT = textwrap.dedent("""
    import json
    import torch.distributed as dist
    from repro_torch.dist import sharding as sh
    from repro_torch.launch import mesh as mesh_lib
    mesh_lib.init_dryrun_group(512)
    out = {}
    for pipe in (1, 4):
        mesh = mesh_lib.make_production_mesh(multi_pod=True, pipe=pipe)
        group = sh.client_group(mesh)
        out[pipe] = {"names": list(mesh.mesh_dim_names),
                     "shape": list(mesh.mesh.shape),
                     "axes": list(sh.client_axes(mesh)),
                     "count": sh.client_count(mesh),
                     "ranks": dist.get_process_group_ranks(group),
                     "rank": sh.client_rank(mesh)}
    print("MESH" + json.dumps(out))
""")


def test_production_mesh_client_group_order():
    """Rank 0's client group on the multi-pod meshes: every rank that
    shares its model (and pipe) position, pod major then data, the
    reference's flattening of ("pod", "data")."""
    proc = _run(MESH_SCRIPT, "MESH")
    stdout, stderr = proc.communicate(timeout=300)
    assert proc.returncode == 0, stderr[-3000:]
    out = json.loads([ln for ln in stdout.splitlines()
                      if ln.startswith("MESH")][-1][len("MESH"):])
    assert out["1"]["names"] == ["pod", "data", "model"]
    assert out["1"]["shape"] == [2, 16, 16]
    assert out["4"]["names"] == ["pod", "data", "pipe", "model"]
    assert out["4"]["shape"] == [2, 4, 4, 16]
    for pipe, stride in (("1", 16), ("4", 64)):
        run = out[pipe]
        assert run["axes"] == ["pod", "data"] and run["rank"] == 0
        n = 32 if pipe == "1" else 8
        assert run["count"] == n
        assert run["ranks"] == [p * 256 + d * stride
                                for p in range(2) for d in range(n // 2)]


def test_sweep_runs_one_case(tmp_path):
    """``python -m repro_torch.launch.sweep`` over one small case: its
    summary line, its log and its record."""
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.sweep", "--archs",
         "xlstm-350m", "--shapes", "train_1k", "--meshes", "16x16",
         "--extra=--int8-wire", "--out", str(tmp_path)],
        capture_output=True, text=True, timeout=600, env=SUBPROC_ENV)
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-2000:])
    assert "DONE 1/1 ok" in r.stdout
    assert "OK xlstm-350m train_1k mesh=16x16" in r.stdout
    rec = json.loads((tmp_path / "xlstm-350m__train_1k.json").read_text())
    assert rec["devices"] == 256 and rec["wire_dtype"] == "s8"
    assert (tmp_path / "sweep.log").read_text().count("DONE") == 1
