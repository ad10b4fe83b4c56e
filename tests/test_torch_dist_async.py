"""One rank's distributed step with an async knob on, and the card's
configuration and the microbatch count at n_client = 1, against the
reference's step on one device, in one process on the CPU (split from
``tests/test_torch_dist.py``; the scenario knobs are
``tests/test_torch_dist_knobs.py``, whose runner it shares).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_thread  # noqa: E402,F401
from repro_torch.convert import tree_leaves  # noqa: E402
from test_torch_dist import group  # noqa: E402,F401
from test_torch_dist_knobs import (ASYNC, KNOBS, _flat,  # noqa: E402
                                   _one_rank_runs, check_knob)


@pytest.mark.parametrize("what,fields,tol",
                         [k for k in KNOBS if k[0] in ASYNC],
                         ids=[k[0] for k in KNOBS if k[0] in ASYNC])
def test_one_rank_knob_step_matches_reference(group, what, fields, tol):
    check_knob(what, fields, tol)


def test_one_rank_step_matches_reference(group):
    """The card's configuration at its n_client = 1 (every leaf sharded
    whole): DSC on the fused int8 wire with adam, two steps on the
    one-rank gloo group against the reference's step on one device, from
    the same params (f32 smoke config; 1e-4 as the multi-rank test's
    int8 configurations), keys ``PRNGKey(i)``; then the state's dtypes."""
    fields = dict(grad_dtype="float32", use_dsc=True, int8_wire=True)
    _, (rp, _, _, rm), (pp, dsc_ref, state, pm) = _one_rank_runs(
        fields, 2, "adam", 1e-2)
    got, want = _flat(pp), _flat(rp)
    assert np.linalg.norm(got - want) <= 1e-4 * np.linalg.norm(want)
    np.testing.assert_allclose([m[0] for m in pm], [m[0] for m in rm],
                               rtol=1e-4)
    assert [x.shape for x in tree_leaves(dsc_ref["s_clients"])] == [
        (1, *x.shape) for x in pp]
    assert int(state.t) == 2 and state.t.dtype == torch.int32


def test_microbatches_without_a_pipe_axis_are_the_references(group):
    """``microbatches > 1`` on a mesh with no pipe axis: the reference's
    inactive pipeline plan ignores the count, and so does the port: two
    sgd steps at microbatches 2 on the one-rank gloo group against the
    reference's step on one device, params within 1e-5 of the motion,
    losses and grad norms within 1e-5."""
    p0, (rp, _, _, rm), (pp, _, _, pm) = _one_rank_runs(
        dict(grad_dtype="float32", microbatches=2), 2)
    want, got = _flat(rp), _flat(pp)
    assert np.linalg.norm(got - want) <= 1e-5 * np.linalg.norm(
        want - _flat(p0))
    np.testing.assert_allclose(pm, rm, rtol=1e-5, atol=0)
