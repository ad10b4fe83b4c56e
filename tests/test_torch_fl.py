"""The port's FL round against the reference, on the CPU: the flat-vector
math (Theorem B.1, the compressors' constants, masks, server optimizers)
and whole ``FLRun`` trajectories, each side drawing its own keys from the
same seed (the port's threefry stream is jax's).  The LM loss, its
gradients and the flattening order are ``tests/test_torch_fl_grads.py``;
the smoke model's rounds with flash attention,
``tests/test_torch_fl_flash.py`` and ``tests/test_torch_fl_flash_dsc.py``.

Trajectories are held to 1e-5 relative norm, not to bits: the two
frameworks' gradients differ in the last bits, and the streamed client
sum adds in another order than the reference's einsum.  Given the same
gradient, the compression is held to bits.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_thread  # noqa: E402,F401
from repro.core import baselines as ref_bl  # noqa: E402
from repro.core import dsc as ref_dsc  # noqa: E402
from repro.core import fl as ref_fl  # noqa: E402
from repro.core import masks as ref_masks  # noqa: E402
from repro.core import server_opt as ref_so  # noqa: E402
from repro.core.compressors import Identity as RefIdentity  # noqa: E402
from repro.core.compressors import Int8RoundTrip as RefInt8RoundTrip  # noqa: E402
from repro.core.compressors import RandP as RefRandP  # noqa: E402
from repro.core.pipeline import split_round_keys  # noqa: E402
from repro_torch import random  # noqa: E402
from repro_torch.core import dsc, fl, fsa, masks, pipeline  # noqa: E402
from repro_torch.core import server_opt  # noqa: E402
from repro_torch.core.compressors import (Identity, Int8RoundTrip,  # noqa: E402
                                          RandP, TopK)
from repro_torch.launch import fl_train  # noqa: E402

DIM, HID, CLASSES, K, S = 8, 16, 3, 3, 16
SMOKE_N = 1_443_072        # eris-gptneo-1.3b's smoke variant's parameters


# ------------------------------------------------------------ helpers
def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _mlp_params(seed=0):
    """examples/quickstart.py's MLP, made with numpy."""
    rng = np.random.default_rng(seed)
    return {"w1": (0.3 * rng.standard_normal((DIM, HID))).astype(np.float32),
            "b1": np.zeros(HID, np.float32),
            "w2": (0.3 * rng.standard_normal((HID, CLASSES))).astype(
                np.float32),
            "b2": np.zeros(CLASSES, np.float32)}


def _mlp_data(seed=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((K, S, DIM)).astype(np.float32)
    w = rng.standard_normal((DIM, CLASSES))
    y = np.argmax(x @ w + 0.5 * rng.standard_normal((K, S, CLASSES)),
                  -1).astype(np.int32)
    return x, y


def _ref_mlp_loss(p, batch):
    x, y = batch
    h = jnp.tanh(x @ p["w1"] + p["b1"])
    logp = jax.nn.log_softmax(h @ p["w2"] + p["b2"])
    return -jnp.take_along_axis(logp, y[:, None], 1).mean()


def _mlp_loss(p, batch):
    x, y = batch
    h = torch.tanh(x @ p["w1"] + p["b1"])
    logp = torch.log_softmax(h @ p["w2"] + p["b2"], -1)
    return -logp.gather(1, y.long()[:, None]).mean()


def _run_both(ref_cfg, cfg, rounds=3):
    """Both FLRuns on the quickstart MLP, each with its own keys from the
    configs' seed.  Returns the two x per round."""
    p0 = _mlp_params()
    x, y = _mlp_data()
    ref_run = ref_fl.FLRun(ref_cfg, {k: jnp.asarray(v) for k, v in p0.items()},
                           _ref_mlp_loss)
    run = fl.FLRun(cfg, {k: torch.from_numpy(v.copy()) for k, v in p0.items()},
                   _mlp_loss, device="cpu")
    out = []
    for _ in range(rounds):
        ref_run.step((jnp.asarray(x), jnp.asarray(y)))
        run.step((torch.from_numpy(x), torch.from_numpy(y)))
        out.append((run.x.numpy().copy(), np.asarray(ref_run.x)))
    return out


# ------------------------------------------------------------- FLRun
CASES = {
    "fedavg": dict(method="fedavg"),
    "eris-A8": dict(method="eris", A=8),
    "eris-dsc-int8-fused": dict(method="eris", A=8, use_dsc=True,
                                int8_wire=True, compress_impl="fused"),
    "eris-dsc-pallas": dict(method="eris", A=8, use_dsc=True,
                            compress_impl="pallas"),
    "eris-int8": dict(method="eris", A=8, int8_wire=True),
    "eris-dsc-pallas-views": dict(method="eris", A=8, use_dsc=True,
                                  compress_impl="pallas", keep_views=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_flrun_tracks_reference(case):
    """x after each of 3 rounds within 1e-5 relative norm of the
    reference's FLRun (K = 3, 16 samples a client, RandP(p=0.25) where DSC
    is on), each run keyed by its own seed."""
    kw = dict(CASES[case], K=K, lr=0.3)
    dsc_on = kw.get("use_dsc", False)
    ref_cfg = ref_fl.FLConfig(**kw, compressor=RefRandP(p=0.25) if dsc_on
                              else RefIdentity())
    cfg = fl.FLConfig(**kw, compressor=RandP(p=0.25) if dsc_on
                      else Identity())
    for t, (got, want) in enumerate(_run_both(ref_cfg, cfg)):
        assert _rel(got, want) < 1e-5, (t, _rel(got, want))


def test_theorem_b1_literal_fsa_equals_fedavg_bit_exactly():
    """Theorem B.1 in the port: the literal sharded round equals the
    algebraic one and FedAvg's formula bit for bit, for any (n, A, K) and
    weights; and the reference's agrees to rounding."""
    rng = np.random.default_rng(3)
    for n, A, Kc in ((8, 1, 1), (37, 3, 2), (200, 8, 6), (64, 5, 4)):
        x = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
        g = torch.from_numpy(rng.standard_normal((Kc, n)).astype(np.float32))
        w = torch.from_numpy(rng.uniform(0.5, 2.0, Kc).astype(np.float32))
        for scheme in ("strided", "contiguous"):
            assign = masks.make_assignment(n, A, scheme)
            out = fsa.fsa_round_sharded(x, g, assign, A, 0.31, weights=w)
            alg = fsa.fsa_round(x, g, 0.31, weights=w)
            fedavg = x - 0.31 * fsa.weighted_sum(list(g), w, Kc)
            assert torch.equal(out.x_new, alg) and torch.equal(alg, fedavg)
            ref = ref_bl.fedavg_round(jnp.asarray(x.numpy()),
                                      jnp.asarray(g.numpy()), 0.31,
                                      weights=jnp.asarray(w.numpy()))
            np.testing.assert_allclose(out.x_new.numpy(), np.asarray(ref),
                                       rtol=0, atol=1e-6)
            views = out.shard_views
            for a in range(A):
                m = masks.mask_for(assign, a)
                assert not (views[a] * (1 - m)).any()


def test_flrun_eris_literal_fsa_equals_fedavg_bit_exactly():
    x, y = _mlp_data()
    batches = (torch.from_numpy(x), torch.from_numpy(y))
    runs = []
    for kw in (dict(method="fedavg"),
               dict(method="eris", A=8, keep_views=True)):
        p0 = {k: torch.from_numpy(v) for k, v in _mlp_params().items()}
        run = fl.FLRun(fl.FLConfig(K=K, lr=0.3, **kw), p0, _mlp_loss,
                       device="cpu")
        views = [run.step(batches, collect_views=True) for _ in range(4)]
        runs.append((run.x, views[-1]))
    assert torch.equal(runs[0][0], runs[1][0])
    assert runs[0][1].shape == (K, runs[0][0].numel())        # transmitted
    assert runs[1][1].shape == (8, K, runs[0][0].numel())     # A shards


def test_run_fl_scan_is_run_fl():
    x, y = _mlp_data()
    cfg = fl.FLConfig(method="eris", K=K, A=8, rounds=4, lr=0.3,
                      use_dsc=True, compressor=RandP(p=0.25),
                      compress_impl="pallas", seed=5)

    def params():
        return {k: torch.from_numpy(v) for k, v in _mlp_params().items()}

    def batches(t, seed):
        return (torch.from_numpy(x), torch.from_numpy(y))

    full = (torch.from_numpy(x[0]), torch.from_numpy(y[0]))
    a, la = fl.run_fl(cfg, params(), _mlp_loss, batches, full, 2,
                      device="cpu")
    b, lb = fl.run_fl_scan(cfg, params(), _mlp_loss, batches, full, 2,
                           device="cpu")
    assert torch.equal(a.x, b.x) and la == lb and len(la) == 3
    c = fl.FLRun(cfg, params(), _mlp_loss, device="cpu")
    xs = c.run_scanned((torch.from_numpy(np.stack([x] * 4)),
                        torch.from_numpy(np.stack([y] * 4))))
    assert xs.shape == (4, a.n) and torch.equal(xs[-1], a.x)


# ---------------------------------------------- constants, masks, server
def test_round_constants_equal_reference():
    for p in (0.1, 0.25, 1.0):
        ours, theirs = RandP(p=p), RefRandP(p=p)
        for n in (2, 195, 1000, 1_443_072, 2**30 + 1, 1_816_565_760):
            assert ours.omega(n) == theirs.omega(n)
            assert ours.retention(n) == theirs.retention(n)
            assert ours.wire_bits(n) == float(theirs.wire_bits(n))
            i8, ri8 = Int8RoundTrip(inner=ours), RefInt8RoundTrip(inner=theirs)
            assert (i8.omega(n), i8.retention(n), i8.wire_bits(n)) == \
                (ri8.omega(n), ri8.retention(n), ri8.wire_bits(n))
        assert dsc.gamma_star(ours.omega(0)) == \
            ref_dsc.gamma_star(theirs.omega(0))
    assert Identity().wire_bits(100) == RefIdentity().wire_bits(100)
    # the reference's positional trap, kept: the first field is the name
    assert RandP(0.25).p == RefRandP(0.25).p == 0.1


def test_flconfig_fields_equal_reference():
    ours = {f.name: f.default for f in dataclasses.fields(fl.FLConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(ref_fl.FLConfig)}
    assert list(ours) == list(theirs)
    for name, default in theirs.items():
        if name == "compressor":
            assert type(ours[name]).__name__ == type(default).__name__
        else:
            assert ours[name] == default, name


def test_masks_equal_reference():
    for n, A in ((10, 3), (1000, 8), (7, 7), (5, 8)):
        for scheme in ("strided", "contiguous"):
            ours = masks.make_assignment(n, A, scheme)
            theirs = ref_masks.make_assignment(n, A, scheme)
            np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
            assert masks.check_disjoint_complete(ours, A)
            np.testing.assert_array_equal(
                masks.shard_sizes(ours, A).numpy(),
                np.asarray(ref_masks.shard_sizes(theirs, A)))
            np.testing.assert_array_equal(
                masks.masks_stacked(ours, A).numpy(),
                np.asarray(ref_masks.masks_stacked(theirs, A)))


@pytest.mark.parametrize("name", ["fedavg", "fedadam", "fedyogi"])
def test_server_opt_equals_reference(name):
    rng = np.random.default_rng(4)
    x = rng.standard_normal(50).astype(np.float32)
    ours, theirs = server_opt.get_server_opt(name, 0.1), \
        ref_so.get_server_opt(name, 0.1)
    s, rs = ours.init(torch.from_numpy(x)), theirs.init(jnp.asarray(x))
    for t in range(3):
        v = rng.standard_normal(50).astype(np.float32)
        d, s = ours.update(torch.from_numpy(v), s)
        rd, rs = theirs.update(jnp.asarray(v), rs)
        np.testing.assert_allclose(d.numpy(), np.asarray(rd), rtol=1e-5,
                                   atol=1e-7)


def test_dsc_aggregate_equals_reference():
    rng = np.random.default_rng(5)
    v = rng.standard_normal((3, 40)).astype(np.float32)
    s_agg = rng.standard_normal(40).astype(np.float32)
    st = dsc.DSCState(torch.zeros(3, 40), torch.from_numpy(s_agg.copy()))
    u, s_new = dsc.aggregate(st, torch.from_numpy(v), 0.4)
    ru, rs = ref_dsc.aggregate(ref_dsc.DSCState(jnp.zeros((3, 40)),
                                                jnp.asarray(s_agg)),
                               jnp.asarray(v), 0.4)
    np.testing.assert_allclose(u.numpy(), np.asarray(ru), rtol=1e-6)
    np.testing.assert_allclose(s_new.numpy(), np.asarray(rs), rtol=1e-6)
    assert s_new is st.s_agg                     # updated in place


def test_unported_paths_name_their_queue(monkeypatch):
    """The round's configurations all run since the round matrix came
    (``tests/test_torch_rounds.py`` steps the six that raised here), and
    the simulator's inputs that raised here, naming ROADMAP queue 1.2,
    run since the key stream's remainder came: the Dirichlet split
    (jax's gamma sampler; ``tests/test_torch_data.py`` holds it to the
    reference) and the original threefry layout's draws over 2**32 - 1
    or more counters (the LDP noise of three full-width clients;
    ``tests/test_torch_gamma.py`` holds its blocks to jax)."""
    from repro_torch import data
    x, y = data.federated_classification(random.PRNGKey(0), K, 8, alpha=0.5)
    assert x.shape == (K, 8, 16) and y.shape == (K, 8)
    monkeypatch.setattr(random, "partitionable", False)
    shape, edge = (3, 1_816_565_760), 2**32 - 1
    noise = random.normal(random.PRNGKey(0), shape, window=(edge - 4,
                                                            edge + 4))
    assert torch.isfinite(noise).all() and noise.shape == (8,)
    assert torch.equal(noise[4:], random.normal(
        random.PRNGKey(0), shape, window=(edge, edge + 4)))
    p0 = {k: torch.from_numpy(v) for k, v in _mlp_params().items()}
    for kw in (dict(agg_dropout=0.1), dict(method="fedbuff"),
               dict(method="soteriafl")):
        assert fl.FLRun(fl.FLConfig(**kw), p0, _mlp_loss, device="cpu")


# the paths that waited on the key stream and now run: each builds its
# FLRun and steps once on the MLP, as the reference does
KEYED_PATHS = {
    "dsc-jnp": dict(use_dsc=True, compressor=RandP(p=0.5)),
    "participation": dict(participation=0.5),
    "fresh-masks": dict(fresh_masks=True),
    "error-feedback": dict(use_ef=True, compressor=TopK(k=8)),
}


@pytest.mark.parametrize("case", sorted(KEYED_PATHS))
def test_keyed_paths_now_run(case):
    x, y = _mlp_data()
    p0 = {k: torch.from_numpy(v) for k, v in _mlp_params().items()}
    run = fl.FLRun(fl.FLConfig(K=K, **KEYED_PATHS[case]), p0, _mlp_loss,
                   device="cpu")
    run.step((torch.from_numpy(x), torch.from_numpy(y)))
    assert run.t == 1 and bool(run.x.isfinite().all())
    assert RandP(p=0.5)(random.PRNGKey(0), torch.ones(64)).count_nonzero() \
        < 64
    assert masks.make_assignment(10, 2, "random",
                                 key=random.PRNGKey(1)).bincount().tolist() \
        == [5, 5]


def test_flrun_runs_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p0 = {k: torch.from_numpy(v) for k, v in _mlp_params().items()}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fl.FLRun(fl.FLConfig(method="fedavg"), p0, _mlp_loss)


@pytest.mark.parametrize("flag", [True, False])
def test_flrun_round_keys_and_kernel_seeds_equal_reference(flag, monkeypatch):
    """Round by round, FLRun's role keys and the kernel seeds its stages
    take (``_seed_of`` the comp and wire keys, and of the comp key's two
    halves) equal the reference's, under both threefry layouts; and so
    do run_fl's data keys."""
    monkeypatch.setattr(random, "partitionable", flag)
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", flag)
    try:
        run = fl.FLRun(fl.FLConfig(K=K, seed=11), {
            k: torch.from_numpy(v) for k, v in _mlp_params().items()},
            _mlp_loss, device="cpu")
        x, y = _mlp_data()
        key = jax.random.PRNGKey(11)
        for _ in range(3):
            run.step((torch.from_numpy(x), torch.from_numpy(y)))
            key, sub = jax.random.split(key)
            want = split_round_keys(sub)
            for name in want._fields:
                np.testing.assert_array_equal(
                    getattr(run.keys, name).numpy(), getattr(want, name))
            k_in, k_q = jax.random.split(want.comp)
            got = [pipeline._seed_of(k) for k in
                   (run.keys.comp, *random.split(run.keys.comp),
                    run.keys.wire)]
            assert got == [int(jax.random.bits(k, dtype=jnp.uint32))
                           for k in (want.comp, k_in, k_q, want.wire)]
        data_key = jax.random.PRNGKey(12)
        for t, got in enumerate(fl._data_keys(fl.FLConfig(seed=11,
                                                          rounds=3))):
            data_key, sub = jax.random.split(data_key)
            np.testing.assert_array_equal(got.numpy(), sub)
    finally:
        jax.config.update("jax_threefry_partitionable", old)


@pytest.mark.parametrize("p,int8,chunk", [(0.25, False, None),
                                          (0.3, False, 4096),
                                          (0.25, True, 4096),
                                          (0.3, True, None)])
def test_jnp_round_compression_is_bit_identical(p, int8, chunk, monkeypatch):
    """Given the same gradient (a loss whose gradient is the batch), two
    jnp-DSC rounds leave every client's shift bit for bit as the
    reference's jitted round leaves it: the threefry RandP mask, v =
    (g - s) * f32(1/p), the int8 round trip, and s + gamma v fused into
    one multiply-add as XLA compiles it.  ``chunk`` draws the mask 4096
    coordinates at a time, as the full-width round draws it 2**24 at a
    time."""
    if chunk:
        monkeypatch.setattr(random, "CHUNK", chunk)
    K_, n = 3, 20_011
    g = np.random.default_rng(10).standard_normal((2, K_, n)).astype(
        np.float32)
    kw = dict(method="eris", K=K_, A=4, lr=0.1, use_dsc=True,
              int8_wire=int8, seed=3)
    ref_run = ref_fl.FLRun(ref_fl.FLConfig(**kw, compressor=RefRandP(p=p)),
                           {"w": jnp.zeros(n)},
                           lambda q, b: jnp.sum(q["w"] * b))
    run = fl.FLRun(fl.FLConfig(**kw, compressor=RandP(p=p)),
                   {"w": torch.zeros(n)}, lambda q, b: (q["w"] * b).sum(),
                   device="cpu")
    for t in range(2):
        ref_run.step(jnp.asarray(g[t]))
        run.step(torch.from_numpy(g[t]))
        np.testing.assert_array_equal(run.state.dsc.s_clients.numpy(),
                                      np.asarray(ref_run.dsc.s_clients))
        assert _rel(run.x.numpy(), np.asarray(ref_run.x)) < 1e-6


def test_keyed_masks_equal_reference():
    """The random scheme (a threefry permutation of the strided
    assignment), the weighted assignment with and without its
    permutation, and a coalition's union mask, as the reference's."""
    for n, A, seed in ((10, 3, 0), (1000, 8, 1), (5000, 5, 2)):
        key, jkey = random.PRNGKey(seed), jax.random.PRNGKey(seed)
        ours = masks.make_assignment(n, A, "random", key=key)
        theirs = ref_masks.make_assignment(n, A, "random", key=jkey)
        np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
        assert masks.check_disjoint_complete(ours, A)
        w = [1.0, 2.0, 0.5][:min(A, 3)] + [1.0] * (A - 3)
        for k, jk in ((None, None), (key, jkey)):
            np.testing.assert_array_equal(
                masks.make_weighted_assignment(n, w, key=k).numpy(),
                np.asarray(ref_masks.make_weighted_assignment(n, w, key=jk)))
        np.testing.assert_array_equal(
            masks.union_mask(ours, [0, A - 1]).numpy(),
            np.asarray(ref_masks.union_mask(theirs, [0, A - 1])))
    with pytest.raises(ValueError, match="needs a PRNG key"):
        masks.make_assignment(10, 2, "random")


@pytest.mark.parametrize("vocab", [96, 50257])
def test_fl_train_tokens_are_the_examples(vocab):
    """The launcher's client tokens are examples/fl_train_lm.py's:
    ``lm_token_batches(fold_in(PRNGKey(0), 1), 4, 4, 64, vocab)``, token
    for token, at the smoke vocabulary and GPT-Neo's."""
    from repro.data import lm_token_batches as ref_tokens
    got = fl_train.client_tokens(0, 4, 4, 64, vocab)
    want = ref_tokens(jax.random.fold_in(jax.random.PRNGKey(0), 1), 4, 4,
                      64, vocab)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_fl_train_launcher_runs_on_the_cpu():
    run = fl_train.main(["--device", "cpu", "--rounds", "2", "--K", "2",
                         "--seq", "16", "--batch", "2", "--dsc",
                         "--int8-wire"])
    assert run.cfg.compress_impl == "jnp"
    assert run.t == 2 and all(np.isfinite(float(v))
                              for v in run.client_losses[-1])
    assert run.x.dtype == torch.float32
    assert run.state.dsc.s_clients.abs().sum() > 0
