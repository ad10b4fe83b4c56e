"""Whole ERIS rounds of eris-gptneo-1.3b's smoke variant with flash
attention on both sides against the reference's ``FLRun``, on the CPU
(split from ``tests/test_torch_fl.py``): participation, error feedback
and fresh masks here, the DSC cases in
``tests/test_torch_fl_flash_dsc.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_thread  # noqa: E402,F401
from repro.core import fl as ref_fl  # noqa: E402
from repro.core.compressors import Identity as RefIdentity  # noqa: E402
from repro.core.compressors import RandP as RefRandP  # noqa: E402
from repro.core.compressors import TopK as RefTopK  # noqa: E402
from repro.models import transformer as ref_tr  # noqa: E402
from repro_torch.core import fl, pipeline  # noqa: E402
from repro_torch.core.compressors import Identity, RandP, TopK  # noqa: E402
from repro_torch.models import transformer as tr  # noqa: E402
from test_torch_fl import SMOKE_N, _rel  # noqa: E402
from test_torch_fl_grads import _smoke_pair  # noqa: E402


# the round on the smoke model with flash on both sides, each run keyed
# by its own seed: DSC alone, participation, error feedback and fresh
# masks hold the reference to 1e-5 like the MLP trajectories; on the int8
# wire a code flips where a draw falls within an ulp of its fraction, so
# two gradients that differ in their last bits move x by a quantization
# step here and there (1e-4, as the card-vs-host round in
# test_torch_cuda.py).  (FLConfig fields, compressor, tolerance)
FLASH_ROUNDS = {
    "dsc-pallas": (dict(use_dsc=True, compress_impl="pallas"), "rand_p",
                   1e-5),
    "dsc-int8-fused": (dict(use_dsc=True, int8_wire=True,
                            compress_impl="fused"), "rand_p", 1e-4),
    "dsc-jnp": (dict(use_dsc=True), "rand_p", 1e-5),
    "dsc-jnp-int8": (dict(use_dsc=True, int8_wire=True), "rand_p", 1e-4),
    "participation": (dict(participation=0.5, K=3), "identity", 1e-5),
    "ef-topk": (dict(use_ef=True), "top_k", 1e-5),
    "fresh-masks-random": (dict(fresh_masks=True, mask_scheme="random"),
                           "identity", 1e-5),
}


def _compressors(name):
    """(reference's, port's) compressor of a FLASH_ROUNDS case."""
    if name == "rand_p":
        return RefRandP(p=0.25), RandP(p=0.25)
    if name == "top_k":
        return RefTopK(k=SMOKE_N // 10), TopK(k=SMOKE_N // 10)
    return RefIdentity(), Identity()


def check_flash_round(case):
    """Two eris rounds (K = 2 unless the case says, A = 8, 2 x 16 tokens a
    client) of eris-gptneo-1.3b's smoke variant with flash_attention on
    both sides, each run keyed by its own seed: no seed is handed over."""
    fields, comp, tol = FLASH_ROUNDS[case]
    ref_comp, port_comp = _compressors(comp)
    ref_cfg, cfg, p, pt = _smoke_pair(flash=True)
    kw = dict(dict(method="eris", K=2, A=8, lr=0.1), **fields)
    ref_run = ref_fl.FLRun(ref_fl.FLConfig(**kw, compressor=ref_comp), p,
                           lambda q, b: ref_tr.loss_fn(q, ref_cfg,
                                                       {"tokens": b}))
    run = fl.FLRun(fl.FLConfig(**kw, compressor=port_comp), pt,
                   lambda q, b: tr.loss_fn(q, cfg, {"tokens": b}),
                   device="cpu")
    toks = np.random.default_rng(7).integers(
        0, cfg.vocab, size=(kw["K"], 2, 16)).astype(np.int32)
    dropped = 0
    for t in range(2):
        ref_run.step(jnp.asarray(toks))
        run.step(torch.from_numpy(toks))
        assert _rel(run.x.numpy(), np.asarray(ref_run.x)) < tol, t
        w = pipeline.participation_weights(run.keys.part, kw["K"],
                                           run.cfg.participation)
        dropped += 0 if w is None else int((w == 0).sum())
    # the participation case drops a client in one of its rounds
    assert (dropped > 0) == (case == "participation")


@pytest.mark.parametrize("case", sorted(c for c in FLASH_ROUNDS
                                        if not c.startswith("dsc")))
def test_flrun_with_flash_tracks_reference_on_the_smoke_model(case):
    check_flash_round(case)
