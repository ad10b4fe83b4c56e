"""Twelve more of the model axis's paths through ``loss_fn``, against the
reference, on the CPU, by ``tests/test_torch_tp.py``'s machinery (two
JAX subprocesses on four forced host devices beside one four-rank gloo
launch, the same gates): the paths that file's twelve cases leave out.

* ``overlap_collectives=False``, the plain psum pair (the one the
  reference's three-engine parity runs): dense at tp 2 and 4 (masked),
  moe, hybrid, sequence parallel and ssm.  The TP decode step of
  ``ServeEngine``'s mesh path takes the same pair after ``wo``.
* the vlm family with its image embeddings (internvl2-26b), the audio
  family (musicgen-medium), eris-gptneo-1.3b at vocab 509 (the
  replicated-vocab fallback that serving eris-gptneo-1.3b at 50,257
  takes), qwen3-32b masked, starcoder2-3b at tp 4, phi3.5-moe at tp 2.
"""
import pytest

pytest.importorskip("torch")

from torch_threads import one_thread  # noqa: E402,F401
from test_torch_tp import DENSE, check_case, launch  # noqa: E402

PLAIN = dict(overlap_collectives=False)
# (name, tp, arch, ModelConfig overrides, loss mask)
CASES = [
    ("tp2_plain", 2, "qwen2-0.5b", dict(DENSE, **PLAIN), False),
    ("tp4_masked_plain", 4, "qwen2-0.5b", dict(DENSE, **PLAIN), True),
    ("moe_tp2_plain", 2, "olmoe-1b-7b",
     dict(n_layers=1, moe_group_size=8, **PLAIN), False),
    ("hybrid_tp2_plain", 2, "hymba-1.5b", dict(n_layers=1, **PLAIN), False),
    ("seq_tp2_plain", 2, "qwen2-0.5b",
     dict(n_layers=1, seq_parallel=True, **PLAIN), False),
    ("ssm_tp2_plain", 2, "xlstm-350m", dict(n_layers=1, **PLAIN), False),
    ("vlm_tp2", 2, "internvl2-26b", dict(n_layers=1), False),
    ("audio_tp2", 2, "musicgen-medium", dict(n_layers=1), False),
    ("gptneo_vocab509_tp2", 2, "eris-gptneo-1.3b",
     dict(n_layers=1, vocab=509), False),
    ("qwen3_tp2_masked", 2, "qwen3-32b", dict(n_layers=1), True),
    ("starcoder2_tp4", 4, "starcoder2-3b", dict(n_layers=1), False),
    ("phi35_moe_tp2", 2, "phi3.5-moe-42b-a6.6b",
     dict(n_layers=1, moe_group_size=8), False),
]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return launch(tmp_path_factory, CASES, conj=False)


@pytest.mark.parametrize("name,tp,arch,over,mask", CASES,
                         ids=[c[0] for c in CASES])
def test_tp_loss_fn_matches_the_references(runs, name, tp, arch, over,
                                           mask):
    """Loss and every merged gradient leaf against the reference's TP
    and replicated results (``test_torch_tp.check_case``)."""
    check_case(runs, name, tp, arch, over)
