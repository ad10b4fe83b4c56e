"""The port's distributed FSA step against the reference's, on the CPU:
DSC on the int8 wire (fused and unfused), FedAvg and bf16 params, four
ranks, by ``tests/test_torch_train.py``'s launch and gates, in a launch
of their own so that the two halves run side by side.
"""
import pytest

pytest.importorskip("torch")

from torch_threads import one_thread  # noqa: E402,F401
from test_torch_train import A, CONFIGS, WIRE, check_step, launch  # noqa: E402

WORLDS = {A: [c for c in CONFIGS if c[0] in WIRE]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return launch(tmp_path_factory, WORLDS)


@pytest.mark.parametrize(
    "world,name,dtype,opt,fields,tol,metric_tol,state_tol",
    [(w, *c) for w, cs in WORLDS.items() for c in cs],
    ids=[c[0] for cs in WORLDS.values() for c in cs])
def test_port_step_matches_reference_step(runs, world, name, dtype, opt,
                                          fields, tol, metric_tol,
                                          state_tol):
    check_step(runs, world, name, dtype, fields, tol, metric_tol,
               state_tol)


def test_bf16_params_are_f32_after_an_adam_step(runs):
    """The reference's adam delta is f32 for bf16 params (its bias
    correction is an f32 array), so every stored leaf is f32 after one
    step; the port's are the same."""
    _, _, ref_dtypes, port_dtypes = runs[1][A]
    assert set(ref_dtypes["bf16_adam"]) == {"float32"}
    assert all(set(pd["bf16_adam"]) == {"float32"} for pd in port_dtypes)
