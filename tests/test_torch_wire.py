"""The port's wire kernels against the reference, on the CPU: each plain
version against its Pallas kernel in interpret mode, and each compress
stage against the reference's stage, bit for bit.

What "the reference's bits" are is decided by how XLA compiles the
interpret-mode kernels on the CPU, and the port follows it:
* ``max|x| / 127`` becomes ``max|x| * f32(1/127)`` (quantize and
  dsc_quantize);
* dsc_quantize's ``s + gamma * q * scale`` is one fused multiply-add;
* dsc_update's ``s + gamma * v`` rounds twice in the simulator's jitted
  round, as its source reads.  Jitted alone, XLA contracts it to an FMA
  in some coordinates or all of them, depending on the fusion (a traced
  seed, a bf16 g, the scalar loop epilogue of a ragged n); the kernel test
  allows either rounding there and the stage test holds the port to the
  simulator's bits.
v is ``(g - s) * f32(1/p)`` as the Pallas kernels write it, not the jnp
oracles' ``/ p``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_thread  # noqa: E402,F401
from repro.core import dsc as ref_dsc  # noqa: E402
from repro.core.compressors import Int8RoundTrip as RefInt8RoundTrip  # noqa: E402
from repro.core.compressors import RandP as RefRandP  # noqa: E402
from repro.core.pipeline import DSCCompress as RefDSCCompress  # noqa: E402
from repro.core.pipeline import Int8Wire as RefInt8Wire  # noqa: E402
from repro.core.pipeline import split_round_keys  # noqa: E402
from repro.kernels import dsc_quantize as ref_dq  # noqa: E402
from repro.kernels import dsc_update as ref_du  # noqa: E402
from repro.kernels import quantize as ref_q  # noqa: E402
from repro_torch.core import dsc as dsc_lib  # noqa: E402
from repro_torch.core.compressors import Int8RoundTrip, RandP  # noqa: E402
from repro_torch import random  # noqa: E402
from repro_torch.core import pipeline  # noqa: E402
from repro_torch.core.pipeline import (DSCCompress, Int8Wire,  # noqa: E402
                                       RoundState)
from repro_torch.kernels import dsc_quantize as dq  # noqa: E402
from repro_torch.kernels import dsc_update as du  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import quantize as qz  # noqa: E402

GAMMA = 0.37
SMOKE_N = 1_443_072   # eris-gptneo-1.3b's smoke variant: 256 | n, 1024 does not


def _vec(n, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return (scale * rng.standard_normal(n)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _bf16_pair(a):
    """The same bf16 values for both frameworks."""
    j = jnp.asarray(a).astype(jnp.bfloat16)
    return j, _t(np.asarray(j.astype(jnp.float32))).bfloat16()


@functools.lru_cache(maxsize=None)
def _ref_dsc_update(p):
    return jax.jit(functools.partial(ref_du.dsc_update, p=p, gamma=GAMMA,
                                     interpret=True))


@functools.lru_cache(maxsize=None)
def _ref_dsc_quantize(p):
    return jax.jit(functools.partial(ref_dq.dsc_quantize, p=p, gamma=GAMMA,
                                     interpret=True))


_ref_quantize = jax.jit(functools.partial(ref_q.quantize, interpret=True))
_ref_dequantize = jax.jit(functools.partial(ref_q.dequantize, interpret=True))


# --------------------------------------------------- plain vs interpret
@pytest.mark.parametrize("n", [2048, 4096 + 1000, 9293])
@pytest.mark.parametrize("p", [0.25, 0.3, 1.0])
def test_dsc_update_plain_matches_pallas(n, p):
    """v bit for bit.  s' = s + gamma * v: XLA rounds the reference's line
    once (an FMA) or twice depending on how it fuses the call (the same
    kernel jitted with a constant or a traced seed differs), so here every
    coordinate must equal one of the two roundings; the port's
    two-rounding form is held bit for bit to the simulator's jitted stage
    in test_compress_stage_matches_reference."""
    g, s = _vec(n, 1), _vec(n, 2, 0.3)
    v_ref, s_ref = _ref_dsc_update(p)(jnp.asarray(g), jnp.asarray(s),
                                      jnp.uint32(5))
    v, s_new = du.dsc_update(_t(g), _t(s), 5, p=p, gamma=GAMMA)
    np.testing.assert_array_equal(v.numpy(), np.asarray(v_ref))
    fused = ref.fma_f32(GAMMA, v, _t(s)).numpy()
    s_ref = np.asarray(s_ref)
    assert np.all((s_ref == s_new.numpy()) | (s_ref == fused))
    np.testing.assert_array_equal(s_new.numpy(), (_t(s) + GAMMA * v).numpy())


def test_dsc_update_bf16_gradient():
    """A bf16 g: v comes back in bf16, rounded from the f32 v, and s' is
    built from the unrounded f32 v (dsc_update.py:39-42).  v matches the
    Pallas kernel bit for bit; s' is held to the simulator's two-rounding
    form here, and bit for bit to the jitted simulator stage in
    test_compress_stage_matches_reference."""
    n, p = 3072, 0.25
    g32, s = _vec(n, 3), _vec(n, 4, 0.3)
    gj, gt = _bf16_pair(g32)
    v_ref, _ = _ref_dsc_update(p)(gj, jnp.asarray(s), jnp.uint32(9))
    v, s_new = du.dsc_update(gt, _t(s), 9, p=p, gamma=GAMMA)
    assert v.dtype == torch.bfloat16
    np.testing.assert_array_equal(v.float().numpy(),
                                  np.asarray(v_ref.astype(jnp.float32)))
    v32, _ = du.dsc_update(gt.float(), _t(s), 9, p=p, gamma=GAMMA)
    torch.testing.assert_close(s_new, _t(s) + GAMMA * v32, rtol=0, atol=0)
    assert not torch.equal(v32, v.float())      # the cast did round


@pytest.mark.parametrize("n", [256, 256 * 9 + 77, 5000])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_plain_matches_pallas(n, dtype):
    x = _vec(n, 5, 3.0)
    if dtype == "bfloat16":
        xj, xt = _bf16_pair(x)
    else:
        xj, xt = jnp.asarray(x), _t(x)
    q_ref, sc_ref = _ref_quantize(xj, jnp.uint32(7))
    q, sc = qz.quantize(xt, 7)
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))
    np.testing.assert_array_equal(sc.numpy(), np.asarray(sc_ref))
    np.testing.assert_array_equal(qz.dequantize(q, sc).numpy(),
                                  np.asarray(_ref_dequantize(q_ref, sc_ref)))
    assert q.shape == (qz.padded(n),) and not q[n:].any()


@pytest.mark.parametrize("n", [8 * 256, 2305, 511])
@pytest.mark.parametrize("p", [0.25, 1.0])
def test_dsc_quantize_plain_matches_pallas(n, p):
    """Codes, scales and s' bit for bit, at ragged n."""
    g, s = _vec(n, 6), _vec(n, 7, 0.1)
    q_ref, sc_ref, s_ref = _ref_dsc_quantize(p)(
        jnp.asarray(g), jnp.asarray(s), jnp.uint32(11), jnp.uint32(12))
    q, sc, s_new = dq.dsc_quantize(_t(g), _t(s), 11, 12, p=p, gamma=GAMMA)
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))
    np.testing.assert_array_equal(sc.numpy(), np.asarray(sc_ref))
    np.testing.assert_array_equal(s_new.numpy(), np.asarray(s_ref))


def test_dsc_quantize_takes_bf16_gradient_as_its_f32_values():
    g32, s = _vec(2048, 8), _vec(2048, 9, 0.1)
    _, gt = _bf16_pair(g32)
    a = dq.dsc_quantize(gt, _t(s), 1, 2, p=0.25, gamma=GAMMA)
    b = dq.dsc_quantize(gt.float(), _t(s), 1, 2, p=0.25, gamma=GAMMA)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


# ------------------------------------------------ index base, zero blocks
WRAP = 2**32 - 4096           # straddles the 2**32 wrap within a window


@pytest.mark.parametrize("kernel", ["dsc_update", "quantize", "dsc_quantize"])
@pytest.mark.parametrize("base", [0, 3 * SMOKE_N, WRAP])
def test_window_with_index_base_equals_slice_of_whole(kernel, base):
    """A window computed alone with its index_base equals the same slice
    of the whole vector; past 2**32 the index wraps, so at WRAP the whole
    vector's coordinates from 4096 on are those of base 0 shifted."""
    n, start = 16384, 4096
    g, s = _t(_vec(n, 10)), _t(_vec(n, 11, 0.3))

    def run(lo, b):
        if kernel == "dsc_update":
            return du.dsc_update(g[lo:], s[lo:], 3, p=0.25, gamma=GAMMA,
                                 index_base=b)
        if kernel == "quantize":
            return qz.quantize(g[lo:], 3, index_base=b)
        return dq.dsc_quantize(g[lo:], s[lo:], 3, 4, p=0.25, gamma=GAMMA,
                               index_base=b)

    whole, window = run(0, base), run(start, base + start)
    for w, part in zip(whole, window):
        lo = start if w.numel() == n else start // 256   # scales: per 256
        assert torch.equal(w[lo:], part)
    if base == WRAP:
        for w, part in zip(whole, run(start, 0)):
            lo = start if w.numel() == n else start // 256
            assert torch.equal(w[lo:], part)


def test_index_base_changes_the_draws():
    """The base a streamed client passes matters: client 2's codes at the
    right base (2 * n_pad, n_pad rounded to 256) differ from those at the
    base a 1024-padding would give, at the smoke transformer's n."""
    n = SMOKE_N
    g = _t(_vec(n, 12))
    right = qz.quantize(g, 5, index_base=2 * qz.padded(n))[0]
    wrong = qz.quantize(g, 5, index_base=2 * qz.padded(n, du.LANES))[0]
    assert not torch.equal(right, wrong)


def test_zero_block_and_ragged_tail_never_move_scales_or_shift():
    n = 3 * 256 + 40
    g = _vec(n, 13)
    g[256:512] = 0.0                     # a zero block
    s = np.zeros(n, np.float32)
    s[256:512] = 0.0
    q, sc, s_new = dq.dsc_quantize(_t(g), _t(s), 1, 2, p=1.0, gamma=GAMMA)
    assert float(sc[1]) == 0.0 and not q[256:512].any()
    assert not q[n:].any() and q.numel() == 4 * 256
    assert not s_new[256:512].any()
    # the tail's padding holds zeros: the last block's scale is that of
    # its 40 real coordinates alone
    last = _t(g[3 * 256:])
    assert float(sc[3]) == float(last.abs().max() * ref.INV127)
    qq, sq = qz.quantize(_t(g), 9)
    assert float(sq[1]) == 0.0 and not qq[256:512].any() and not qq[n:].any()


def test_wire_constants_equal_reference():
    assert qz.QBLOCK == ref_q.QBLOCK and du.LANES == ref_du.LANES
    for n in (1, 255, 256, 1000, SMOKE_N, 1_816_565_760):
        assert qz.wire_payload_bytes(n) == ref_q.wire_payload_bytes(n)


def test_wrappers_have_no_kernel_for_other_devices():
    """Neither the plain version nor a kernel: a meta tensor raises."""
    g = torch.zeros(1024, device="meta")
    with pytest.raises(ValueError, match="no kernel for meta"):
        ops.dsc_update(g, g, 1, p=0.5, gamma=0.1)
    with pytest.raises(ValueError, match="no kernel for meta"):
        ops.quantize(g, 1)
    with pytest.raises(ValueError, match="no kernel for meta"):
        ops.dsc_quantize(g, g, 1, 2, p=0.5, gamma=0.1)
    with pytest.raises(ValueError, match="no kernel for meta"):
        ops.dequantize(torch.zeros(256, dtype=torch.int8, device="meta"),
                       torch.zeros(1, device="meta"))


def test_wrappers_check_their_inputs():
    g = torch.zeros(512)
    with pytest.raises(ValueError, match="p must be"):
        du.dsc_update(g, g, 1, p=0.0, gamma=0.1)
    with pytest.raises(ValueError, match="uint32"):
        qz.quantize(g, 2**32)
    with pytest.raises(TypeError, match="float32"):
        dq.dsc_quantize(g, g.double(), 1, 2, p=0.5, gamma=0.1)
    with pytest.raises(ValueError, match="contiguous vector"):
        du.dsc_update(g, torch.zeros(511), 1, p=0.5, gamma=0.1)


def test_out_updates_the_shift_in_place():
    g, s = _t(_vec(1000, 14)), _t(_vec(1000, 15, 0.2))
    want = dq.dsc_quantize(g, s, 1, 2, p=0.25, gamma=GAMMA)
    s_in = s.clone()
    got = dq.dsc_quantize(g, s_in, 1, 2, p=0.25, gamma=GAMMA, out=s_in)
    assert got[2] is s_in and torch.equal(s_in, want[2])
    s_in = s.clone()
    v, s_out = du.dsc_update(g, s_in, 1, p=0.25, gamma=GAMMA, out=s_in)
    assert s_out is s_in
    assert torch.equal(s_in, du.dsc_update(g, s, 1, p=0.25, gamma=GAMMA)[1])


# ---------------------------------------------- compress stages, (K, n)
@pytest.mark.parametrize("config,dtype", [("pallas", "float32"),
                                          ("pallas", "bfloat16"),
                                          ("fused", "float32"),
                                          ("int8", "float32"),
                                          ("jnp", "float32"),
                                          ("jnp", "bfloat16"),
                                          ("jnp-int8", "float32")])
def test_compress_stage_matches_reference(config, dtype):
    """The port's stage, fed the reference's (K, n) gradients and the
    round keys of the same seed one client at a time, transmits the
    reference stage's values and leaves its shift state, bit for bit, at
    K = 3 and the smoke transformer's n (a multiple of 256 but not of
    1024, so that a per-client index base built from the wrong padding
    fails).  The kernels' paths at p = 0.25; the threefry (jnp) paths at
    p = 0.3, whose 1/p is not exact (the reference's jit multiplies by
    f32(1/p))."""
    K, n = 3, SMOKE_N
    rng = np.random.default_rng(16)
    grads = rng.standard_normal((K, n)).astype(np.float32)
    s0 = (0.1 * rng.standard_normal((K, n))).astype(np.float32)
    g_j = jnp.asarray(grads)
    if dtype == "bfloat16":
        g_j = g_j.astype(jnp.bfloat16)
    keys = split_round_keys(jax.random.PRNGKey(21))
    port_keys = pipeline.split_round_keys(random.PRNGKey(21))
    ref_state = ref_dsc.DSCState(jnp.asarray(s0), jnp.zeros(n))
    if config == "int8":
        ref_stage, stage = RefInt8Wire(), Int8Wire()
        want_v = np.asarray(jax.jit(
            lambda k, v: ref_stage.apply(k, None, v)[0])(keys, g_j))
        want_s = None
    else:
        p = 0.3 if config.startswith("jnp") else 0.25
        impl = config.split("-")[0]
        if config in ("pallas", "jnp"):
            rc, c = RefRandP(p=p), RandP(p=p)
        else:
            rc = RefInt8RoundTrip(inner=RefRandP(p=p))
            c = Int8RoundTrip(inner=RandP(p=p))
        ref_stage = RefDSCCompress(compressor=rc, gamma=GAMMA, impl=impl)
        stage = DSCCompress(compressor=c, gamma=GAMMA, impl=impl)
        v_j, st = jax.jit(ref_stage.compress)(keys.comp, ref_state, g_j)
        want_v, want_s = np.asarray(v_j.astype(jnp.float32)), \
            np.asarray(st.s_clients)
    state = RoundState(None, dsc_lib.DSCState(_t(s0), torch.zeros(n)), ())
    g_t = _t(np.asarray(g_j.astype(jnp.float32)))
    if dtype == "bfloat16":
        g_t = g_t.bfloat16()
    for k in range(K):
        v = stage.apply(port_keys, state, g_t[k], k)
        np.testing.assert_array_equal(v.float().numpy(), want_v[k])
    if want_s is not None:
        np.testing.assert_array_equal(state.dsc.s_clients.numpy(), want_s)
