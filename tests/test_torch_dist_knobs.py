"""One rank's distributed step with a scenario knob on, against the
reference's step on one device, in one process on the CPU (split from
``tests/test_torch_dist.py``, whose one-rank gloo group it shares): LDP,
secure masks, aggregator dropout and link failure here; the async knobs
in ``tests/test_torch_dist_async.py``.
"""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_thread  # noqa: E402,F401
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.launch import mesh as ref_mesh  # noqa: E402
from repro.launch import train as ref_train  # noqa: E402
from repro.optim import optimizers as ref_opt  # noqa: E402
from repro_torch import random  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax, tree_leaves  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.optim import optimizers as opt_lib  # noqa: E402
from test_torch_dist import _settings, group  # noqa: E402,F401

ASYNC = ("async_buffer", "async_", "client_dropout", "delay_max")


# one knob of the scenario and async matrix a case, at one rank: its
# field set, and the params' tolerance as a share of the motion (int8:
# a code flips where a draw falls within an ulp of its fraction).  At
# PRNGKey(0..2) the one-rank draws kill the aggregator at steps 2 and 3
# (agg_dropout 0.5), the link at steps 1 and 2 (link_failure 0.5), and
# drop the client at step 1 (client_dropout 0.25); measured 3.4e-6 to
# 5.1e-6 of the motion, int8 1.1e-4 to 2.4e-4, LDP 9.2e-8.
KNOBS = [
    ("ldp_eps", dict(ldp_eps=8.0), 1e-5),
    ("secure_mask", dict(secure_mask=True), 1e-5),
    ("agg_dropout", dict(agg_dropout=0.5), 1e-5),
    ("link_failure", dict(int8_wire=True, link_failure=0.5), 1e-3),
    ("async_buffer", dict(int8_wire=True, async_buffer=True,
                          buffer_cadence=2), 1e-3),
    ("async_", dict(async_buffer=True,
                    async_=dict(delay_max=1, client_dropout=0.25)), 1e-5),
    ("client_dropout", dict(async_buffer=True, client_dropout=0.25), 1e-5),
    ("delay_max", dict(async_buffer=True, delay_max=2, buffer_cadence=2),
     1e-5),
]


def _one_rank_runs(fields, steps, opt_name="sgd", lr=0.05):
    """``steps`` steps of the reference's step on one device and of the
    port's on the one-rank gloo group (the group fixture's), from the same
    params (f32 smoke config) and tokens, keys ``PRNGKey(i)``.  Returns
    (params0's leaves, the reference's, the port's), each of the last two
    (params leaves, DSC/buffer state, optimizer state, [(loss,
    grad_norm)] a step)."""
    cfg = get_config("qwen2-0.5b").smoke()
    ref_cfg = ref_get_config("qwen2-0.5b").smoke()
    from repro.models import transformer as ref_tr
    params0 = ref_tr.init_params(jax.random.PRNGKey(1), ref_cfg)
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (8, 32)).astype(
        np.int32)
    rmesh = ref_mesh.make_host_mesh(data=1, model=1)
    ropt = getattr(ref_opt, opt_name)(lr)
    rsettings = _settings(ref_train, fields)
    rstep, shardings = ref_train.make_train_step(ref_cfg, rmesh, ropt,
                                                 rsettings)
    with rmesh:
        rp = jax.device_put(params0, shardings["store"])
        rs = ropt.init(rp)
        rd = ref_train.init_dsc_state(ref_cfg, rmesh, rsettings)
        jstep = jax.jit(rstep)
        rm = []
        for i in range(steps):
            rp, rs, rd, m = jstep(rp, rs, rd, {"tokens": toks},
                                  jax.random.PRNGKey(i))
            rm.append((float(m["loss"]), float(m["grad_norm"])))
    mesh = mesh_lib.make_host_mesh(device="cpu")
    settings = _settings(train, fields)
    opt = getattr(opt_lib, opt_name)(lr)
    step = train.make_train_step(cfg, mesh, opt, settings, device="cpu")
    params = train.store_params(params_from_jax(
        jax.tree.map(np.asarray, params0), device="cpu"), cfg, mesh, settings)
    state = opt.init(params)
    dsc_ref = train.init_dsc_state(cfg, mesh, settings, device="cpu")
    pm = []
    for i in range(steps):
        params, state, dsc_ref, m = step(params, state, dsc_ref,
                                         {"tokens": torch.from_numpy(toks)},
                                         random.PRNGKey(i))
        pm.append((float(m["loss"]), float(m["grad_norm"])))
    return ([np.asarray(x) for x in jax.tree.leaves(params0)],
            ([np.asarray(x) for x in jax.tree.leaves(rp)], rd, rs, rm),
            ([x.numpy() for x in tree_leaves(params)], dsc_ref, state, pm))


def _flat(leaves):
    return np.concatenate([np.ravel(x) for x in leaves])


def check_knob(what, fields, tol):
    """Three sgd steps with one scenario or async knob on, on the one-rank
    gloo group, against the reference's step on one device: params within
    ``tol`` of the motion, losses and grad norms within 1e-4 (a held
    round's grad norm exactly 0 in both), and the FedBuff buffer: t and w
    equal, u within ``tol`` of its norm."""
    fields = dict(grad_dtype="float32", **fields)
    p0, (rp, rd, _, rm), (pp, pd, _, pm) = _one_rank_runs(fields, 3)
    want, got = _flat(rp), _flat(pp)
    err = np.linalg.norm(got - want) / np.linalg.norm(want - _flat(p0))
    assert err <= tol, f"{what}: params {err:.3e} of the motion"
    np.testing.assert_allclose(pm, rm, rtol=1e-4, atol=0)
    if fields.get("async_buffer"):
        rbuf, pbuf = rd["buffer"], pd["buffer"]
        assert int(pbuf["t"]) == int(rbuf["t"]) == 3
        assert float(pbuf["w"]) == float(rbuf["w"])
        ru = _flat(jax.tree.leaves(rbuf["u"]))
        pu = _flat([x.numpy() for x in tree_leaves(pbuf["u"])])
        assert np.linalg.norm(pu - ru) <= tol * np.linalg.norm(ru)
    held = [i for i, (_, gn) in enumerate(rm) if gn == 0.0]
    if what in ("agg_dropout", "async_buffer", "delay_max"):
        assert held, f"{what}: no step held still"


@pytest.mark.parametrize("what,fields,tol",
                         [k for k in KNOBS if k[0] not in ASYNC],
                         ids=[k[0] for k in KNOBS if k[0] not in ASYNC])
def test_one_rank_knob_step_matches_reference(group, what, fields, tol):
    check_knob(what, fields, tol)
