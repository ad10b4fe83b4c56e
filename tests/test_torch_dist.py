"""The distributed step's pieces against the reference, in one process on
the CPU: the optimizers (bit for bit, dtypes included), the FSA layout
and its wire accounting, one leaf's int8 wire payload and the DSC leaf
update (bit for bit), the wire seeds, the mesh, the raise sites of what
is not ported yet, msgpack checkpoints both ways, and the one-rank
view tap.  One rank's whole step against the reference's on one device,
with each scenario and async knob, is ``tests/test_torch_dist_knobs.py``
and ``tests/test_torch_dist_async.py``.

The multi-rank step is ``tests/test_torch_train.py``.
"""
import dataclasses
import functools
import importlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
dist = pytest.importorskip("torch.distributed")

from torch_threads import one_thread  # noqa: E402,F401
from repro.checkpoint import msgpack_ckpt as ref_ck  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.core.compressors import RandP as RefRandP  # noqa: E402
from repro.core.pipeline import DSCCompress as RefDSCCompress  # noqa: E402
from repro.dist import sharding as ref_sh  # noqa: E402
from repro.kernels import dsc_quantize as ref_dq  # noqa: E402
from repro.kernels import quantize as ref_q  # noqa: E402
from repro.launch import mesh as ref_mesh  # noqa: E402
from repro.launch import train as ref_train  # noqa: E402
from repro.optim import optimizers as ref_opt  # noqa: E402
from repro_torch import random  # noqa: E402
from repro_torch.checkpoint import msgpack_ckpt as ck  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import (params_from_jax, tree_leaves,  # noqa: E402
                                 tree_map)
from repro_torch.core.compressors import RandP  # noqa: E402
from repro_torch.core.pipeline import DSCCompress  # noqa: E402
from repro_torch.dist import sharding as sh  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import transformer as tr  # noqa: E402
from repro_torch.optim import optimizers as opt_lib  # noqa: E402

ARCHS = ("eris-gptneo-1.3b", "qwen2-0.5b")


# ------------------------------------------------------------ helpers
def _to_torch(x):
    a = np.array(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _bits(x):
    """A leaf's dtype name and its raw bit pattern, for either package."""
    if isinstance(x, torch.Tensor):
        name = str(x.dtype).replace("torch.", "")
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return name, x.numpy().tobytes()
    a = np.asarray(x)
    return a.dtype.name, a.tobytes()


def _same(port, ref, what=""):
    pl, rl = tree_leaves(port), jax.tree.leaves(ref)
    assert len(pl) == len(rl), what
    for i, (p, r) in enumerate(zip(pl, rl)):
        pb, rb = _bits(p), _bits(r)
        assert pb[0] == rb[0], f"{what} leaf {i}: dtype {pb[0]} vs {rb[0]}"
        assert pb[1] == rb[1], f"{what} leaf {i}: bits differ"


def _ref_mesh(n):
    """A stand-in for a (n data, 1 model) jax Mesh: the reference's layout
    helpers read only its axis names and its device grid's shape."""
    return types.SimpleNamespace(axis_names=("data", "model"),
                                 devices=np.empty((n, 1), object))


# ------------------------------------------------------------ optimizers
OPTIMIZERS = {
    "sgd": lambda lib: lib.sgd(0.05),
    "momentum": lambda lib: lib.momentum(0.05),
    "adam": lambda lib: lib.adam(1e-2),
    "adam_wd": lambda lib: lib.adam(1e-2, weight_decay=0.1),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizers_match_reference_bit_for_bit(name, dtype):
    """Three updates on the same numpy trees: deltas, states and params
    equal to the un-jitted reference's in bits and dtypes (JAX's weak
    scalars and promotion: a bf16 param's adam delta and new value are
    f32, and so are its moments from the second step on)."""
    rng = np.random.default_rng(3)
    p0 = {"w": rng.standard_normal((33, 17)),
          "blocks": {"b": 0.1 * rng.standard_normal((9,)),
                     "k": rng.standard_normal((2, 5, 8))}}
    rp = jax.tree.map(lambda x: jnp.asarray(x, jnp.float32).astype(dtype),
                      p0)
    pp = tree_map(lambda x: torch.from_numpy(x).float().to(
        getattr(torch, dtype)), p0)
    ref, port = OPTIMIZERS[name](ref_opt), OPTIMIZERS[name](opt_lib)
    rs, ps = ref.init(rp), port.init(pp)
    _same(ps, rs, "init")
    for t in range(3):
        g = jax.tree.map(lambda x: rng.standard_normal(x.shape), p0)
        rg = jax.tree.map(lambda x, p: jnp.asarray(x, jnp.float32).astype(
            p.dtype), g, rp)
        pg = tree_map(lambda x, p: torch.from_numpy(x).float().to(p.dtype),
                      g, pp)
        rd, rs = ref.update(rg, rs, rp)
        pd, ps = port.update(pg, ps, pp)
        _same(pd, rd, f"step {t} delta")
        _same(ps, rs, f"step {t} state")
        rp = jax.tree.map(jnp.add, rp, rd)
        pp = tree_map(torch.add, pp, pd)
        _same(pp, rp, f"step {t} params")
    if name.startswith("adam") and dtype == "bfloat16":
        assert {str(x.dtype) for x in tree_leaves(pp)} == {"torch.float32"}


# --------------------------------------------------------- the FSA layout
@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("arch", ARCHS)
def test_fsa_layout_and_wire_bytes_match_reference(arch, n):
    """Scatter dims, int8 wire layouts, wire bytes (int8, bf16 and f32)
    and resident param bytes of the full-width trees, by shape only."""
    cfg, ref_cfg, mesh = get_config(arch), ref_get_config(arch), _ref_mesh(n)
    assert (tree_leaves(sh.fsa_scatter_dims(cfg, n))
            == jax.tree.leaves(ref_sh.fsa_scatter_dims(ref_cfg, mesh)))
    assert ([dataclasses.astuple(w) for w in tree_leaves(
        sh.int8_wire_layouts(cfg, n))]
        == [dataclasses.astuple(w) for w in jax.tree.leaves(
            ref_sh.int8_wire_layouts(ref_cfg, mesh))])
    for int8, grad_bytes in ((True, 2), (False, 2), (False, 4)):
        assert (sh.mesh_wire_bytes(cfg, n, int8=int8, grad_bytes=grad_bytes)
                == ref_sh.mesh_wire_bytes(ref_cfg, mesh, int8=int8,
                                          grad_bytes=grad_bytes))
    assert (sh.param_bytes_per_device(cfg, n)
            == ref_sh.param_bytes_per_device(ref_cfg, mesh))


SHAPES = [((8, 12), 4), ((6, 10, 9), 3), ((5, 7), 4), ((3, 100, 7), 3),
          ((4, 10, 30), 4), ((24, 16, 64), 8), ((7,), 7), ((12,), 1)]


@pytest.mark.parametrize("shape,n", SHAPES)
def test_split_merge_and_store_shards_match_reference(shape, n):
    """``scatter_dim_for`` and ``wire_layout_for`` equal the reference's;
    ``split_shards`` gives its rows, row a is aggregator a's store shard,
    and ``merge_shards`` inverts it."""
    dim = sh.scatter_dim_for(shape, n)
    assert dim == ref_sh.scatter_dim_for(shape, n)
    assert (dataclasses.astuple(sh.wire_layout_for(shape, n))
            == dataclasses.astuple(ref_sh.wire_layout_for(shape, n)))
    if dim < 0:
        return
    x = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    rows = sh.split_shards(torch.from_numpy(x), dim, n)
    np.testing.assert_array_equal(
        rows.numpy(), np.asarray(ref_sh.split_shards(jnp.asarray(x), dim, n)))
    back = sh.merge_shards(rows, dim, shape, n)
    np.testing.assert_array_equal(back.numpy(), x)
    for a in range(n):
        np.testing.assert_array_equal(
            sh.store_shard(torch.from_numpy(x), dim, n, a).reshape(-1),
            rows[a])


@functools.partial(jax.jit, static_argnames=("dim", "n", "fused"))
def _ref_payload(g, s, seed_mask, seed_round, *, dim, n, fused):
    """The payload lines of the reference's ``_int8_wire_exchange`` and
    ``_fused_wire_exchange`` (``launch/train.py:230-238``, ``:286-299``),
    jitted as the step is, with the kernels in interpret mode."""
    lay = ref_sh.wire_layout_for(g.shape, n)
    m, mp = lay.shard_elems, lay.padded_elems
    rows = jnp.pad(ref_sh.split_shards(g.astype(jnp.float32), dim, n),
                   ((0, 0), (0, mp - m)))
    block_b = ref_train._quant_block_b(n * lay.n_blocks)
    if not fused:
        q, scale = ref_q.quantize(rows.reshape(-1), seed_round,
                                  block_b=block_b, interpret=True)
        return q.reshape(n, mp), scale.reshape(n, lay.n_blocks), s
    s_rows = jnp.pad(ref_sh.split_shards(s.astype(jnp.float32), dim, n),
                     ((0, 0), (0, mp - m)))
    q, scale, s_new = ref_dq.dsc_quantize(
        rows.reshape(-1), s_rows.reshape(-1), seed_mask, seed_round,
        p=0.1, gamma=0.5, block_b=block_b, interpret=True)
    s_new = ref_sh.merge_shards(s_new.reshape(n, mp)[:, :m], dim, g.shape,
                                n).astype(s.dtype)
    return q.reshape(n, mp), scale.reshape(n, lay.n_blocks), s_new


@pytest.mark.parametrize("fused", [False, True], ids=["int8", "dsc_int8"])
@pytest.mark.parametrize("shape,n,gdt", [
    ((4, 64, 48), 4, "float32"),
    ((3, 100, 7), 3, "float32"),       # a ragged segment (700 of 768)
    ((4, 10, 30), 4, "bfloat16"),      # ragged (300 of 512), bf16 g
    ((2, 96, 130), 2, "float32"),
])
def test_wire_payload_matches_reference(shape, n, gdt, fused):
    """One leaf's int8 payload on identical inputs: codes, scales and
    (fused) s' bit for bit with the reference's kernels, all n_client
    segments quantized in one call keyed from index 0."""
    rng = np.random.default_rng(sum(shape) + n)
    g = rng.standard_normal(shape).astype(np.float32)
    s = (0.3 * rng.standard_normal(shape)).astype(np.float32)
    dim = sh.scatter_dim_for(shape, n)
    seed_mask, seed_round = 0x9E3779B9, 0x1234567 + n
    rq, rsc, rs = _ref_payload(jnp.asarray(g).astype(gdt), jnp.asarray(s),
                               jnp.uint32(seed_mask), jnp.uint32(seed_round),
                               dim=dim, n=n, fused=fused)
    tg = torch.from_numpy(g).to(getattr(torch, gdt))
    if fused:
        q, sc, s_new = train.fused_payload(tg, torch.from_numpy(s.copy()),
                                           dim, n, seed_mask, seed_round,
                                           0.1, 0.5)
        np.testing.assert_array_equal(s_new.numpy(), np.asarray(rs))
    else:
        q, sc = train.int8_payload(tg, dim, n, seed_round)
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(sc.numpy(), np.asarray(rsc))


def test_mean_of_rows_is_xlas():
    """The aggregator's ``rows.mean(0)``: XLA sums the rows in order and
    multiplies by the f32 reciprocal of their count, which differs from a
    division at 3 rows; the port's equals it bit for bit at 2-8 rows."""
    rng = np.random.default_rng(5)
    for n in range(2, 9):
        rows = rng.standard_normal((n, 4099)).astype(np.float32)
        want = np.asarray(jax.jit(lambda r: r.mean(0))(rows))
        got = train._mean_rows(torch.from_numpy(rows)).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("gdt,sdt", [
    ("float32", "float32"), ("bfloat16", "float32"),
    ("bfloat16", "bfloat16"), ("float32", "float16")])
@pytest.mark.parametrize("p,gamma", [(0.1, 0.5), (0.3, 0.37)])
def test_apply_leaf_matches_reference(gdt, sdt, p, gamma):
    """``DSCCompress.apply_leaf`` against the reference's, jitted as in
    its step: v and s' bit for bit (RandP's x / p as XLA's reciprocal
    multiply; s + gamma v one FMA for an f32 s)."""
    rng = np.random.default_rng(7)
    g = rng.standard_normal((3, 40, 24)).astype(np.float32)
    s = (0.3 * rng.standard_normal((3, 40, 24))).astype(np.float32)
    jg, js = jnp.asarray(g).astype(gdt), jnp.asarray(s).astype(sdt)
    key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(3), 5), 2)
    rv, rs = jax.jit(RefDSCCompress(compressor=RefRandP(p=p),
                                    gamma=gamma).apply_leaf)(key, jg, js)
    tkey = random.fold_in(random.fold_in(random.PRNGKey(3), 5), 2)
    s_in = _to_torch(js)
    v, s_new = DSCCompress(compressor=RandP(p=p), gamma=gamma).apply_leaf(
        tkey, _to_torch(jg), s_in)
    _same([v, s_new], [rv, rs], "apply_leaf")
    assert _bits(s_in) == _bits(js)          # s is not modified


def test_wire_and_dsc_seeds_match_jax():
    """The step's uint32 seeds: ``bits(fold_in(fold_in(key, 0x3177 + i),
    a))`` (the wire) and ``bits(fold_in(fold_in(key, i), a))`` (DSC), a
    0-d draw, for every leaf index of the smoke trees and four ranks."""
    for seed in (0, 1, 7):
        key, tkey = jax.random.PRNGKey(seed), random.PRNGKey(seed)
        for i in range(16):
            for a in range(4):
                for salt in (train.WIRE_SALT, 0):
                    want = int(jax.random.bits(jax.random.fold_in(
                        jax.random.fold_in(key, salt + i), a),
                        dtype=jnp.uint32))
                    got = random.bits(random.fold_in(
                        random.fold_in(tkey, salt + i), a))
                    assert got.dim() == 0 and int(got) == want


def test_f32_leaves_of_a_bf16_config_train_in_f32():
    """After an adam step a bf16 model's params are f32: the port's
    forward takes them as the reference's does (in f32), so the loss of
    f32 leaves under the bf16 config equals the f32 config's in both."""
    ref_cfg = dataclasses.replace(ref_get_config("qwen2-0.5b").smoke(),
                                  dtype="bfloat16")
    from repro.models import transformer as ref_tr
    params = ref_tr.init_params(jax.random.PRNGKey(0),
                                dataclasses.replace(ref_cfg,
                                                    dtype="float32"))
    toks = np.random.default_rng(0).integers(0, ref_cfg.vocab, (2, 32))
    want = float(ref_tr.loss_fn(params, ref_cfg,
                                {"tokens": jnp.asarray(toks)}))
    cfg = dataclasses.replace(get_config("qwen2-0.5b").smoke(),
                              dtype="bfloat16")
    tp = params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    got = tr.loss_fn(tp, cfg, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.float32
    assert abs(float(got) - want) <= 1e-5 * abs(want)


# -------------------------------------------------------- mesh and raises
@pytest.fixture(scope="module")
def group():
    """A one-rank gloo group in this process, for the mesh and the
    one-rank step."""
    device = mesh_lib.init_process_group("cpu")
    yield device
    dist.destroy_process_group()


def test_make_host_mesh(group, monkeypatch):
    """A one-axis ``DeviceMesh`` over the group; the reference's
    validation messages (its device-count hint names torchrun here);
    ``model > 1`` lays a 2-D ``("data", "model")`` mesh, model minor-most
    (built for real over gloo ranks in ``tests/test_torch_tp_step.py``);
    ``pipe > 1`` lays the 3-D ``("data", "pipe", "model")`` mesh (built
    for real in ``tests/test_torch_pipe_step.py``)."""
    mesh = mesh_lib.make_host_mesh(device="cpu")
    assert mesh.mesh_dim_names == ("data",) and sh.client_count(mesh) == 1
    for kw in (dict(data=2), dict(pipe=0), dict(model=2)):
        with pytest.raises(ValueError) as ref_err:
            ref_mesh.make_host_mesh(**kw)
        with pytest.raises(ValueError) as err:
            mesh_lib.make_host_mesh(device="cpu", **kw)
        head = str(ref_err.value).split("raise the device count")[0]
        assert str(err.value).startswith(head.split(" or ")[0]), kw
    monkeypatch.setattr(dist, "get_world_size", lambda *a, **k: 4)
    import torch.distributed.device_mesh as dm
    laid = []
    monkeypatch.setattr(dm, "init_device_mesh",
                        lambda *a, **k: laid.append((a, k)) or "mesh")
    assert mesh_lib.make_host_mesh(device="cpu", model=2) == "mesh"
    assert mesh_lib.make_host_mesh(device="cpu", data=1, model=4) == "mesh"
    for kw in (dict(pipe=2), dict(model=2, pipe=2)):
        assert mesh_lib.make_host_mesh(device="cpu", **kw) == "mesh"
    three = {"mesh_dim_names": ("data", "pipe", "model")}
    assert laid == [(("cpu", (2, 2)), {"mesh_dim_names": ("data", "model")}),
                    (("cpu", (1, 4)), {"mesh_dim_names": ("data", "model")}),
                    (("cpu", (2, 2, 1)), three), (("cpu", (1, 2, 2)), three)]


UNPORTED_CALLS = [
    ("lower_train_step", lambda: train.lower_train_step(None, None), "1.12"),
    ("make_production_mesh", lambda: mesh_lib.make_production_mesh(),
     "1.12"),
]


@pytest.mark.parametrize("what,call,queue", UNPORTED_CALLS,
                         ids=[n for n, _, _ in UNPORTED_CALLS])
def test_unported_paths_name_their_queue(what, call, queue):
    """Each knob and entry point the port does not run yet raises
    NotImplementedError naming its ROADMAP queue."""
    with pytest.raises(NotImplementedError, match=f"queue {queue}"):
        call()


def test_capture_views_with_a_pipe_axis_is_the_references_error():
    """The tap refuses a pipe axis with the reference's words (meshes
    stubbed)."""
    ref_mesh_stub = types.SimpleNamespace(
        axis_names=("data", "pipe"), devices=np.zeros((1, 2)),
        shape={"data": 1, "pipe": 2})
    with pytest.raises(ValueError) as ref_err:
        ref_train.make_train_step(
            ref_get_config("qwen2-0.5b").smoke(), ref_mesh_stub,
            ref_opt.sgd(0.1), ref_train.TrainSettings(capture_views=True))
    mesh_stub = types.SimpleNamespace(mesh_dim_names=("data", "pipe"),
                                      size=lambda i: (1, 2)[i])
    with pytest.raises(ValueError) as err:
        train.make_train_step(get_config("qwen2-0.5b").smoke(), mesh_stub,
                              opt_lib.sgd(0.1),
                              train.TrainSettings(capture_views=True))
    assert str(err.value) == str(ref_err.value)


# (name, TrainSettings fields) of the one-rank tap: every wire the tap
# takes, with failures and arrivals
TAP_WIRES = [
    ("f32", dict(grad_dtype="float32")),
    ("bf16", dict(grad_dtype="bfloat16")),
    ("int8", dict(grad_dtype="float32", int8_wire=True)),
    ("dsc_fused_int8", dict(grad_dtype="float32", int8_wire=True,
                            use_dsc=True, dsc_p=1.0)),
    ("dsc_unfused_int8", dict(grad_dtype="float32", int8_wire=True,
                              use_dsc=True, dsc_p=1.0, fused_wire=False)),
    ("dsc_f32", dict(grad_dtype="float32", use_dsc=True, dsc_p=1.0)),
    ("int8_failures", dict(grad_dtype="float32", int8_wire=True,
                           agg_dropout=0.5, link_failure=0.5)),
    ("f32_failures", dict(grad_dtype="float32", agg_dropout=0.5,
                          link_failure=0.5)),
    ("bf16_failures", dict(grad_dtype="bfloat16", agg_dropout=0.5,
                           link_failure=0.5)),
    ("int8_arrivals", dict(grad_dtype="float32", int8_wire=True,
                           async_buffer=True, client_dropout=0.5)),
]


@pytest.mark.parametrize("name,fields", TAP_WIRES,
                         ids=[n for n, _ in TAP_WIRES])
def test_one_rank_tap_views_are_the_applied_update(group, name, fields):
    """At n_client = 1 the aggregator's reduction of its one row is that
    row: each step's captured views, put through Eq. 4 (with DSC) and
    sgd's own update from the pre-step params, give the post-step params
    bit for bit, leaf by leaf (what ``chip_smoke.py`` holds on the card
    at full width).  Every leaf is captured as (1, 1, m) f32."""
    from repro_torch.core.dsc import fma_shift
    from repro_torch.privacy import harness
    cfg = harness.tiny_lm_config()
    mesh = mesh_lib.make_host_mesh(device="cpu")
    settings = train.TrainSettings(capture_views=True, **fields)
    opt = opt_lib.sgd(0.1)
    step = train.make_train_step(cfg, mesh, opt, settings, device="cpu")
    params = train.store_params(tr.init_params(cfg, seed=1, device="cpu"),
                                cfg, mesh, settings)
    state, dsc_ref = opt.init(params), train.init_dsc_state(
        cfg, mesh, settings, device="cpu")
    toks = {"tokens": random.randint(random.PRNGKey(5), (2, 32), 0,
                                     cfg.vocab)}
    s_agg = [torch.zeros(x.shape) for x in tree_leaves(params)]
    zero_rows = 0
    for t in range(2):
        pre = [x.clone() for x in tree_leaves(params)]
        params, state, dsc_ref, _, views = step(params, state, dsc_ref,
                                                toks, random.PRNGKey(t))
        assert sorted(views, key=int) == [str(i) for i in range(len(pre))]
        for i, (p0, p1) in enumerate(zip(pre, tree_leaves(params))):
            v = views[str(i)]
            assert v.dtype == torch.float32 and v.shape == (1, 1, p0.numel())
            u = v[0, 0].view(p0.shape)
            zero_rows += int(not u.any())
            if settings.use_dsc:
                u, s_prev = s_agg[i] + u, s_agg[i]
                s_agg[i] = fma_shift(settings.dsc_gamma, u - s_prev, s_prev)
            g = u.to(p0.dtype)
            assert torch.equal(p1, p0 + opt_lib.weak(-0.1, g) * g), (name,
                                                                     t, i)
    if "failures" in name or "arrivals" in name:
        assert zero_rows, "no dropped row in two steps"


def _settings(package, fields):
    """``package.TrainSettings(**fields)``, an ``async_`` dict made into
    that package's ``AsyncSettings``."""
    fields = dict(fields)
    if "async_" in fields:
        mod = ("repro.core.settings" if package is ref_train
               else "repro_torch.core.settings")
        fields["async_"] = importlib.import_module(mod).AsyncSettings(
            **fields["async_"])
    return package.TrainSettings(**fields)


VALIDATION = [
    dict(async_buffer=True, use_dsc=True),
    dict(ldp_eps=1.0, fsa=False),
    dict(secure_mask=True, int8_wire=True),
    dict(secure_mask=True),                       # bf16 wire
    dict(secure_mask=True, grad_dtype="float32", agg_dropout=0.1),
    dict(agg_dropout=0.1, async_buffer=True),
    # a flat knob that disagrees with the attached AsyncSettings
    dict(client_dropout=0.1, async_=dict(client_dropout=0.2)),
    # the resolved arrival dropout, not the flat field, refuses the mask
    dict(secure_mask=True, grad_dtype="float32",
         async_=dict(client_dropout=0.1)),
]


@pytest.mark.parametrize("fields", VALIDATION,
                         ids=lambda f: "+".join(sorted(f)))
def test_validation_errors_are_the_references(fields):
    """The reference's ValueErrors before any unported knob, word for
    word."""
    ref_cfg = ref_get_config("qwen2-0.5b").smoke()
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    with pytest.raises(ValueError) as ref_err:
        ref_train.make_train_step(ref_cfg, mesh, ref_opt.sgd(0.1),
                                  _settings(ref_train, fields))
    with pytest.raises(ValueError) as err:
        train.make_train_step(get_config("qwen2-0.5b").smoke(), None,
                              opt_lib.sgd(0.1), _settings(train, fields))
    assert str(err.value) == str(ref_err.value)


def test_cohort_batch_is_the_references():
    """``cohort_batch`` draws the reference's cohort (ids and gathered
    rows, bit for bit) from a population of 8 at n_client 4."""
    toks = np.arange(8 * 3 * 5, dtype=np.int32).reshape(8, 3, 5)
    ids, rows = ref_train.cohort_batch({"tokens": jnp.asarray(toks)},
                                       jax.random.PRNGKey(7), 8, 4)
    got_ids, got = train.cohort_batch({"tokens": torch.from_numpy(toks)},
                                      random.PRNGKey(7), 8, 4)
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(ids))
    np.testing.assert_array_equal(got["tokens"].numpy(),
                                  np.asarray(rows["tokens"]))


# ------------------------------------------------------------ checkpoints
def _ckpt_tree(rng):
    return {"embed": rng.standard_normal((16, 8)).astype(np.float32),
            "blocks": {"w": rng.standard_normal((2, 8, 12)).astype(
                np.float32),
                "ln": rng.standard_normal((2, 8)).astype(np.float32)},
            "ln_f": rng.standard_normal((7,)).astype(np.float32)}


def _store_shards(tree, dims, rank, world=4):
    return tree_map(lambda x, d: sh.store_shard(x, d, world, rank), tree,
                    dims)


def test_port_sharded_checkpoint_reads_in_the_reference(tmp_path):
    """Four ranks' store shards written by the port's ``save_sharded``
    (each rank its own piece, replicated leaves once) read whole by the
    reference's ``restore_sharded``, bit for bit, f32 and bf16."""
    rng = np.random.default_rng(11)
    full = _ckpt_tree(rng)
    dims = {"embed": 1, "blocks": {"w": 2, "ln": 1}, "ln_f": -1}
    for dtype in (torch.float32, torch.bfloat16):
        tree = tree_map(lambda x: torch.from_numpy(x).to(dtype), full)
        path = tmp_path / str(dtype)
        for rank in range(4):
            ck.save_sharded(path, _store_shards(tree, dims, rank), dims,
                            rank=rank, world=4)
        target = jax.tree.map(lambda x: np.zeros(x.shape, np.float32), full)
        got = ref_ck.restore_sharded(path, target)
        _same(tree, got, str(dtype))
        back = ck.restore_sharded(path, tree, dims, rank=2, world=4)
        for x, want in zip(tree_leaves(back), tree_leaves(
                _store_shards(tree, dims, 2))):
            assert _bits(x) == _bits(want)


def test_reference_checkpoints_read_in_the_port(tmp_path):
    """The reference's single-file and sharded checkpoints (f32 and bf16
    leaves, and an adam state with its int32 step count) read by the
    port bit for bit, and the port's single file read by the reference."""
    rng = np.random.default_rng(12)
    tree = jax.tree.map(jnp.asarray, _ckpt_tree(rng))
    tree["blocks"]["w"] = tree["blocks"]["w"].astype(jnp.bfloat16)
    state = ref_opt.adam(1e-2).init(tree)
    for name, obj in (("params", tree), ("adam", state)):
        target = jax.tree.map(lambda x: torch.empty(x.shape), obj)
        target = (opt_lib.AdamState(*target) if name == "adam" else target)
        ref_ck.save(tmp_path / f"{name}.msgpack", obj)
        _same(ck.restore(tmp_path / f"{name}.msgpack", target), obj, name)
        ref_ck.save_sharded(tmp_path / name, obj)
        _same(ck.restore_sharded(tmp_path / name, target), obj, name)
        _same(ck.restore_any(tmp_path / name, target), obj, name)
    port_tree = params_from_jax(jax.tree.map(np.asarray, tree), device="cpu")
    ck.save(tmp_path / "port.msgpack", port_tree)
    _same(port_tree, ref_ck.restore(tmp_path / "port.msgpack", tree), "port")


def test_msgpack_is_not_imported_on_the_chip_smoke_path():
    """The card's machine may lack ``msgpack``: neither ``chip_smoke.py``
    nor the step's modules import it (the checkpoint functions import it
    when called)."""
    import subprocess
    import sys
    from conftest import SUBPROC_ENV
    code = ("import sys; sys.path.insert(0, '.'); import chip_smoke; "
            "from repro_torch.launch import train, mesh; "
            "from repro_torch.checkpoint import msgpack_ckpt; "
            "assert 'msgpack' not in sys.modules, 'msgpack imported'")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, env=SUBPROC_ENV)
    assert r.returncode == 0, r.stderr[-2000:]


def test_train_settings_are_the_references():
    """``TrainSettings``: every field of the reference's, with its
    default."""
    ref = {f.name: f.default for f in dataclasses.fields(
        ref_train.TrainSettings)}
    port = {f.name: f.default for f in dataclasses.fields(
        train.TrainSettings)}
    assert port == ref


@pytest.mark.parametrize("n", [1, 4])
@pytest.mark.parametrize("use_dsc", [False, True])
@pytest.mark.parametrize("async_buffer", [False, True])
def test_abstract_train_state_is_the_references_cut_to_one_rank(
        n, use_dsc, async_buffer):
    """This rank's shapes and dtypes of (params_stored, opt_state,
    dsc_ref): the reference's global ones with each sharded leaf cut to
    1/n at its scatter dim (s_k: one block of the client stack; the
    FedBuff buffer's u like the params, f32, its w and t scalars)."""
    arch = "qwen2-0.5b"
    settings = dict(use_dsc=use_dsc, async_buffer=async_buffer)
    rp, rs, rd = ref_train.abstract_train_state(
        ref_get_config(arch).smoke(), _ref_mesh(n), ref_opt.adam(1e-2),
        ref_train.TrainSettings(**settings))
    pp, ps, pd = train.abstract_train_state(
        get_config(arch).smoke(), n, opt_lib.adam(1e-2),
        train.TrainSettings(**settings))
    dims = tree_leaves(sh.fsa_scatter_dims(get_config(arch).smoke(), n))

    def cut(shape, d):
        shape = list(shape)
        if d >= 0:
            shape[d] //= n
        return tuple(shape)

    def meta(t):
        return tuple(t.shape), str(t.dtype).replace("torch.", "")

    ref_p = [(cut(x.shape, d), str(x.dtype))
             for x, d in zip(jax.tree.leaves(rp), dims)]
    if async_buffer:
        rb, pb = rd["buffer"], pd["buffer"]
        assert [meta(t) for t in tree_leaves(pb["u"])] == [
            (cut(x.shape, d), str(x.dtype))
            for x, d in zip(jax.tree.leaves(rb["u"]), dims)]
        assert [meta(pb[k]) for k in "wt"] == [
            ((), str(rb[k].dtype)) for k in "wt"]
        rd, pd = rd["dsc"], pd["dsc"]
    assert [meta(t) for t in tree_leaves(pp)] == ref_p
    assert [meta(t) for t in tree_leaves(ps)] == \
        ref_p + ref_p + [((), "int32")]
    if use_dsc:
        sc = [((1, *x.shape[1:]), str(x.dtype))
              for x in jax.tree.leaves(rd["s_clients"])]
        sa = [(cut(x.shape, d), str(x.dtype))
              for x, d in zip(jax.tree.leaves(rd["s_agg"]), dims)]
        assert [meta(t) for t in tree_leaves(pd["s_clients"])] == sc
        assert [meta(t) for t in tree_leaves(pd["s_agg"])] == sa
    else:
        assert [meta(t) for t in tree_leaves(pd)] == [
            (tuple(x.shape), str(x.dtype)) for x in jax.tree.leaves(rd)]
