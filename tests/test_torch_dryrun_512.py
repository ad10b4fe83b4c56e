"""The port's 512-device dry runs, held to the reference's assertions.

``tests/test_distributed.py`` pins four 512-device lowerings of the
reference through its HLO analysis (the int8 wire with ring attention,
expert parallelism, sequence parallelism against its base plan, and
qwen3-32b's pipeline).  Here the same four cases run through the port's
``python -m repro_torch.launch.dryrun`` (one process posing as rank 0 of
a fake world of 512, the step on the meta device under an account) and
each record is held to every assertion the reference's test makes of its
own.  The pipeline case, which takes longer than a minute on one worker,
is ``tests/test_torch_dryrun_pipe.py``.
"""
import json
import subprocess
import sys

from conftest import SUBPROC_ENV

PIN = "flash_attention=false,overlap_collectives=false"


def dryrun(tmp_path, *args, timeout=900) -> None:
    """One ``repro_torch.launch.dryrun`` case in its own process (its own
    fake world), artefacts into ``tmp_path``."""
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *args,
         "--out", str(tmp_path)],
        capture_output=True, text=True, timeout=timeout, env=SUBPROC_ENV)
    assert r.returncode == 0, (r.stdout[-500:], r.stderr[-2000:])
    assert r.stdout.strip().splitlines()[-1].startswith("OK ")


def test_512_device_int8_wire(tmp_path):
    """``test_512_device_lowering_int8_wire``'s assertions: FFN and vocab
    shard 16-way, attention rides the context-parallel ring, the FSA
    stage crosses the client axes as int8, disjoint from the model
    axis."""
    dryrun(tmp_path, "--arch", "qwen2-0.5b", "--shape", "train_1k",
           "--multi-pod", "--int8-wire", "--opt", PIN)
    rec = json.loads((tmp_path / "qwen2-0_5b__train_1k_mp.json").read_text())
    assert rec["mesh"] == "2x16x16" and rec["devices"] == 512
    assert rec["wire_dtype"] == "s8"
    dtypes = rec["collective_bytes_per_device"]["dtypes"]
    a2a = dtypes["all-to-all"]
    assert a2a.get("s8", 0) > 0
    assert a2a.get("s8", 0) > 10 * a2a.get("f32", 0)
    cb = rec["collective_bytes_per_device"]
    assert "reduce-scatter" not in cb["axes"].get("client", {})
    assert dtypes["reduce-scatter"].get("s8", 0) == 0
    assert dtypes["reduce-scatter"].get("f32", 0) < 1e4
    assert rec["tp"] == {"size": 16, "attn": False, "ffn": True,
                         "vocab": True, "moe": False, "mixer": False,
                         "seq": False, "ctx": 16, "seq_ce": False,
                         "sharded_leaves": 4}
    axes, counts = cb["axes"], cb["axis_counts"]
    assert axes["model"]["all-reduce"] > 0
    assert counts["model"]["all-reduce"] >= 2 * 24
    assert counts["model"]["collective-permute"] >= 24 * 15
    assert counts.get("all", {}).get("collective-permute", 0) == 0
    assert axes["client"]["all-gather"] > 0
    assert axes["client"]["all-to-all"] > 0
    assert "all-to-all" not in axes.get("model", {})
    # the XLA-only keys stay, null
    assert rec["compile_s"] is None and rec["xla_cost_flops"] is None


def test_512_device_moe_expert_parallel(tmp_path):
    """``test_512_device_lowering_moe_expert_parallel``'s assertions:
    expert weights model-sharded, token dispatch and combine as model-axis
    all-to-alls, the client wire still int8 and client-only."""
    dryrun(tmp_path, "--arch", "olmoe-1b-7b", "--shape", "train_1k",
           "--multi-pod", "--int8-wire", "--opt", PIN)
    rec = json.loads(
        (tmp_path / "olmoe-1b-7b__train_1k_mp.json").read_text())
    assert rec["devices"] == 512
    tp = rec["tp"]
    assert tp["size"] == 16 and tp["moe"] and tp["vocab"] and tp["attn"]
    assert tp["sharded_leaves"] == 9
    axes = rec["collective_bytes_per_device"]["axes"]
    counts = rec["collective_bytes_per_device"]["axis_counts"]
    assert axes["model"]["all-to-all"] > 0
    assert counts["model"]["all-to-all"] >= 4 * 16
    assert rec["wire_dtype"] == "s8"
    a2a_model = rec["collective_bytes_per_device"]["axis_dtypes"][
        "model"]["all-to-all"]
    assert a2a_model.get("s8", 0) == 0
    assert axes["client"]["all-to-all"] > 0


def test_512_device_seq_parallel(tmp_path):
    """``test_512_device_lowering_seq_parallel``'s assertions: the
    sequence-parallel plan turns the base plan's model-axis psum bytes
    into reduce-scatter bytes, the per-region all-reduces go, and the
    ring-weighted model-axis link cost stays within 1.25x the base's."""
    for opt, tag in [("vocab=50176," + PIN, "base"),
                     ("vocab=50176,seq_parallel=true," + PIN, "seq")]:
        dryrun(tmp_path, "--arch", "eris-gptneo-1.3b", "--shape",
               "train_1k", "--multi-pod", "--int8-wire", "--opt", opt,
               "--tag", tag)
    base = json.loads(
        (tmp_path / "eris-gptneo-1_3b__train_1k_mp_base.json").read_text())
    seq = json.loads(
        (tmp_path / "eris-gptneo-1_3b__train_1k_mp_seq.json").read_text())
    assert not base["tp"]["seq"] and seq["tp"]["seq"]
    assert base["tp"]["attn"] and seq["tp"]["attn"]
    b_ax = base["collective_bytes_per_device"]["axes"]
    s_ax = seq["collective_bytes_per_device"]["axes"]
    b_cnt = base["collective_bytes_per_device"]["axis_counts"]
    s_cnt = seq["collective_bytes_per_device"]["axis_counts"]
    assert b_cnt["model"].get("reduce-scatter", 0) == 0
    rs, ar = s_ax["model"]["reduce-scatter"], b_ax["model"]["all-reduce"]
    assert abs(rs - ar) / ar < 0.02, (rs, ar)
    assert s_cnt["model"]["all-reduce"] < b_cnt["model"]["all-reduce"] / 8
    assert s_ax["model"].get("all-gather", 0) > 0

    def model_link_cost(rec):
        n = rec["tp"]["size"]
        w = {"all-reduce": 2 * (n - 1) / n, "all-gather": (n - 1) / n,
             "reduce-scatter": (n - 1) / n, "all-to-all": (n - 1) / n}
        model = rec["collective_bytes_per_device"]["axes"]["model"]
        return sum(v * w.get(k, 1.0) for k, v in model.items())

    assert model_link_cost(seq) <= model_link_cost(base) * 1.25, (
        model_link_cost(seq), model_link_cost(base))
    assert seq["wire_dtype"] == "s8"
    assert s_ax["client"]["all-to-all"] > 0
