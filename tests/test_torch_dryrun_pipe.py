"""The port's 512-device pipeline dry run (qwen3-32b at pp 4 with 8
microbatches on the 2x4x4x16 mesh), held to the assertions of the
reference's ``test_512_device_lowering_26b_pipeline``.  Slow, as the
reference's is: the step runs 16 layers x 11 wavefront ticks of ring
attention on the meta device, over a minute on one worker."""
import json

import pytest

from test_torch_dryrun_512 import dryrun


@pytest.mark.slow
def test_512_device_26b_pipeline(tmp_path):
    dryrun(tmp_path, "--arch", "qwen3-32b", "--shape", "train_4k",
           "--multi-pod", "--pp", "4", "--microbatches", "8")
    rec = json.loads(
        (tmp_path / "qwen3-32b__train_4k_mp_pp4.json").read_text())
    assert rec["devices"] == 512 and rec["mesh"] == "2x4x4x16"
    assert rec["params"] > 26e9
    assert rec["pp"] == {"size": 4, "microbatches": 8,
                         "layers_per_stage": 16,
                         "bubble_fraction": pytest.approx(3 / 11)}
    tp = rec["tp"]
    assert tp["size"] == 16 and tp["ffn"] and tp["vocab"]
    assert not tp["attn"] and tp["ctx"] == 16
    axes = rec["collective_bytes_per_device"]["axes"]
    counts = rec["collective_bytes_per_device"]["axis_counts"]
    assert counts["pipe"]["collective-permute"] >= 11
    assert axes["pipe"]["collective-permute"] > 0
    assert counts["pipe"]["all-reduce"] > 0
    assert counts.get("all", {}).get("collective-permute", 0) == 0
    total_bytes = 4 * rec["params"]
    per_dev = rec["param_bytes_per_device"]
    assert per_dev <= 2.5 * total_bytes / (16 * 4), per_dev
    assert per_dev < total_bytes / 8
