"""The arithmetic of the f32 flash forward, dq and dk/dv on the tensor
cores (``csrc/flash_f32_sm90.cu``: 3xTF32) against the reference's Pallas
kernels on the CPU.

A torch emulation of the kernels' products goes through the same numpy
inputs as ``_flash_fwd_call`` and ``_flash_bwd_call`` in interpret mode,
in f32, and is held to the gate that the card tests and chip_smoke.py hold
the kernels to: 1e-4 absolute plus 1e-4 relative (``TOL_F32``).

The emulation.  Each f32 operand x enters a product as two tf32 terms:
big = x rounded to tf32 (10 mantissa bits) to nearest, ties away from zero
(the kernel adds 2**12 to the bits, and the tensor cores drop the low 13),
and small = x - big truncated to tf32 (the tensor cores drop its low 13
bits); a b is a_small b_big + a_big b_small + a_big b_big, summed in f32.
The forward takes q_hat = q * f32(d**-0.5), the reference's online softmax
over 64-key tiles within its lo/hi bounds, and P V per tile; dq and dk/dv
take p = exp(s - lse) and ds = p (dp - delta) from the same split
products; dq sums ds K a 64-key tile at a time within the same bounds and
multiplies by the scale once, dk/dv sums the G query heads of a kv head in
f32.  Both are fed the reference's own lse and delta.  What the emulation
leaves out reorders the same f32 sums: the split of each tile between two
warps and their merge, and the tensor cores' own order inside an mma.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_thread  # noqa: E402,F401
from repro.kernels import flash_attention as ref_fa  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

TOL_F32 = 1e-4                                # the kernels' gate on the card
TILE = 64                                     # the kernels' q- and k-tiles

# (B, H, KV, S, d, causal, window): every head dim, full and causal, GQA 7,
# a window over several k-tiles, a ragged S
CASES = {
    "d16-causal": (1, 2, 2, 128, 16, True, None),
    "d32-causal": (1, 2, 1, 128, 32, True, None),
    "d64-full": (2, 2, 2, 64, 64, False, None),
    "d128-causal": (1, 2, 2, 128, 128, True, None),
    "gqa7-d64": (1, 14, 2, 128, 64, True, None),
    "window100-s256": (1, 2, 1, 256, 32, True, 100),
    "ragged-s100": (1, 2, 2, 100, 64, True, None),
}


def _tf32(x: torch.Tensor, rna: bool) -> torch.Tensor:
    """x (f32) at tf32's 10 mantissa bits: to nearest, ties away from zero
    (``rna``), else truncated."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    if rna:
        bits = bits + 0x1000
    bits = bits & 0xFFFFE000
    bits = torch.where(bits >= 2**31, bits - 2**32, bits)
    return bits.to(torch.int32).view(torch.float32)


def _terms(x: torch.Tensor):
    big = _tf32(x, rna=True)
    return big, _tf32(x - big, rna=False)


def _product(a: torch.Tensor, b: torch.Tensor, terms: int = 3):
    """a @ b as the kernels take it: three tf32 products (one: big x big)."""
    a_big, a_small = _terms(a)
    b_big, b_small = _terms(b)
    if terms == 1:
        return a_big @ b_big
    return a_small @ b_big + a_big @ b_small + a_big @ b_big


def _mask(S, causal, window):
    pos = torch.arange(S)
    seen = torch.ones(S, S, dtype=torch.bool)
    if causal:
        seen &= pos[None] <= pos[:, None]
    if window:
        seen &= pos[None] > pos[:, None] - window
    return seen


def _k_tiles(qt, n, causal, window):
    """The k-tiles q-tile qt sees: the reference's lo/hi at 64-row tiles."""
    hi = min(n, qt + 1) if causal else n
    lo = max(0, (qt * TILE - window + 1) // TILE) if window else 0
    return range(lo, hi)


def _forward(q, k, v, causal, window, terms=3):
    """The f32 forward kernel's arithmetic: (o, lse (B * H, S))."""
    B, H, S, d = q.shape
    G = H // k.shape[1]
    qh = q * float(np.float32(d ** -0.5))
    kf, vf = (t.repeat_interleave(G, 1) for t in (k, v))
    seen = _mask(S, causal, window)
    n = -(-S // TILE)
    o = torch.zeros(B, H, S, d)
    lse = torch.zeros(B, H, S)
    for qt in range(n):
        rows = torch.arange(qt * TILE, min(qt * TILE + TILE, S))
        m = torch.full((B, H, len(rows)), -1e30)
        l = torch.zeros_like(m)
        acc = torch.zeros(B, H, len(rows), d)
        for kt in _k_tiles(qt, n, causal, window):
            cols = torch.arange(kt * TILE, min(kt * TILE + TILE, S))
            s = _product(qh[:, :, rows], kf[:, :, cols].transpose(-1, -2),
                         terms)
            s = torch.where(seen[rows][:, cols], s, -1e30)
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + _product(p, vf[:, :, cols], terms)
            m = m_new
        l_safe = l.clamp_min(1e-30)
        o[:, :, rows] = acc / l_safe[..., None]
        lse[:, :, rows] = m + torch.log(l_safe)
    return o, lse.reshape(B * H, S)


def _dq(q, k, v, do, lse, delta, causal, window, terms=3):
    """The f32 dq kernel's arithmetic: per 64-row q-tile and each k-tile it
    sees, s and dp from the split products, ds = p (dp - delta), and the
    tile's ds K summed apart and added to dq; the scale once, at the
    end."""
    B, H, S, d = q.shape
    G = H // k.shape[1]
    scale = float(np.float32(d ** -0.5))
    qh = q * scale
    kf, vf = (t.repeat_interleave(G, 1) for t in (k, v))
    lse, delta = lse.view(B, H, S, 1), delta.view(B, H, S, 1)
    seen = _mask(S, causal, window)
    n = -(-S // TILE)
    dq = torch.zeros(B, H, S, d)
    for qt in range(n):
        rows = torch.arange(qt * TILE, min(qt * TILE + TILE, S))
        acc = torch.zeros(B, H, len(rows), d)
        for kt in _k_tiles(qt, n, causal, window):
            cols = torch.arange(kt * TILE, min(kt * TILE + TILE, S))
            kc = kf[:, :, cols]
            s = _product(qh[:, :, rows], kc.transpose(-1, -2), terms)
            s = torch.where(seen[rows][:, cols], s, -1e30)
            p = torch.exp(s - lse[:, :, rows])
            dp = _product(do[:, :, rows], vf[:, :, cols].transpose(-1, -2),
                          terms)
            acc = acc + _product(p * (dp - delta[:, :, rows]), kc, terms)
        dq[:, :, rows] = acc * scale
    return dq


def _dkv(q, k, v, do, lse, delta, causal, window, terms=3):
    """The f32 dk/dv kernel's arithmetic, the group's heads summed."""
    B, H, S, d = q.shape
    G = H // k.shape[1]
    qh = q * float(np.float32(d ** -0.5))
    kf, vf = (t.repeat_interleave(G, 1) for t in (k, v))
    s = _product(qh, kf.transpose(-1, -2), terms)
    s = torch.where(_mask(S, causal, window), s, -1e30)
    p = torch.exp(s - lse.view(B, H, S, 1))
    ds = p * (_product(do, vf.transpose(-1, -2), terms)
              - delta.view(B, H, S, 1))
    dv = _product(p.transpose(-1, -2), do, terms)
    dk = _product(ds.transpose(-1, -2), qh, terms)
    return tuple(t.view(B, -1, G, S, d).sum(2) for t in (dk, dv))


def _inputs(case, seed=7):
    B, H, KV, S, d, causal, window = CASES[case]
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(shape).astype(np.float32)
              for shape in ((B, H, S, d), (B, KV, S, d), (B, KV, S, d),
                            (B, H, S, d))]
    return arrays, dict(causal=causal, window=window)


def _np(x) -> np.ndarray:
    return np.asarray(x, np.float64)


@functools.lru_cache(maxsize=None)
def _reference(case):
    """The reference's interpret-mode forward and backward kernels on the
    case's inputs: (o, lse, dq, dk, dv) as numpy arrays."""
    arrays, mask = _inputs(case)
    q, k, v, do = (jnp.asarray(a) for a in arrays)
    block = min(ref.FLASH_BLOCK, arrays[0].shape[2])
    o, lse = ref_fa._flash_fwd_call(q, k, v, mask["causal"], mask["window"],
                                    block, block, True)
    dq, dk, dv = ref_fa._flash_bwd_call(q, k, v, o, lse, do, mask["causal"],
                                        mask["window"], block, block, True)
    return tuple(np.array(t) for t in (o, lse, dq, dk, dv))


def _gate_shares(case, terms=3, names=("o", "lse", "dk", "dv")):
    """The largest error of the named outputs (of o, lse, dq, dk and dv)
    against the reference's interpret-mode kernels, as a share of
    TOL_F32 + TOL_F32 |ref|."""
    arrays, mask = _inputs(case)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in arrays)
    want = dict(zip(("o", "lse", "dq", "dk", "dv"), _reference(case)))
    tlse = torch.from_numpy(want["lse"])
    delta = ref.flash_delta(torch.from_numpy(want["o"]), tdo)
    got = {}
    if {"o", "lse"} & set(names):
        got["o"], got["lse"] = _forward(tq, tk, tv, **mask, terms=terms)
    if "dq" in names:
        got["dq"] = _dq(tq, tk, tv, tdo, tlse, delta, **mask, terms=terms)
    if {"dk", "dv"} & set(names):
        got["dk"], got["dv"] = _dkv(tq, tk, tv, tdo, tlse, delta, **mask,
                                    terms=terms)
    shares = {}
    for name in names:
        got_, want_ = got[name], want[name]
        assert tuple(got_.shape) == tuple(want_.shape), name
        err = np.abs(_np(got_) - _np(want_))
        shares[name] = float((err / (TOL_F32 + TOL_F32 * np.abs(_np(want_))))
                             .max())
    return shares


def _tf32_by_value(x: np.ndarray, rna: bool) -> np.ndarray:
    """tf32 from the value: |x| = f 2**e with f in [1, 2), f kept to 10
    fractional bits, ties away from zero (``rna``) or truncated."""
    mag = np.abs(x.astype(np.float64))
    e = np.floor(np.log2(mag))
    f = mag / 2.0 ** e * 1024
    f = np.floor(f + 0.5) if rna else np.floor(f)
    return (np.sign(x) * f / 1024 * 2.0 ** e).astype(np.float32)


def test_tf32_rounding_matches_its_definition():
    """``_tf32`` against the rounding by value: ties away from zero at bit
    13 (1 + 2**-11 rounds up, and -(1 + 2**-11) down), the carry into the
    exponent (2 - 2**-23 is 2), and truncation."""
    rng = np.random.default_rng(0)
    x = np.concatenate([
        np.array([1 + 2**-11, 1 + 2**-10 + 2**-11, -(1 + 2**-11),
                  1 + 2**-11 - 2**-23, 2 - 2**-23], np.float32),
        (rng.standard_normal(4096) * 10.0 ** rng.integers(-6, 6, 4096))
        .astype(np.float32)])
    for rna in (True, False):
        got = _tf32(torch.from_numpy(x), rna=rna).numpy()
        np.testing.assert_array_equal(got, _tf32_by_value(x, rna))
    got = _tf32(torch.from_numpy(x[:5]), rna=True).numpy()
    np.testing.assert_array_equal(got, np.array(
        [1 + 2**-10, 1 + 2**-9, -(1 + 2**-10), 1.0, 2.0], np.float32))


@pytest.mark.parametrize("case", sorted(CASES))
def test_three_tf32_products_hold_the_f32_gate(case):
    """o, lse, dk and dv of the kernels' 3xTF32 arithmetic within
    1e-4 + 1e-4 |ref| of the reference's f32 kernels."""
    shares = _gate_shares(case)
    assert max(shares.values()) <= 1.0, (case, shares)


@pytest.mark.parametrize("case", sorted(CASES))
def test_dq_three_tf32_products_hold_the_f32_gate(case):
    """dq of the dq kernel's 3xTF32 arithmetic, fed the reference's own lse
    and delta, within 1e-4 + 1e-4 |ref| of the reference's f32 dq."""
    shares = _gate_shares(case, names=("dq",))
    assert shares["dq"] <= 1.0, (case, shares)


def test_one_tf32_term_breaks_the_f32_gate():
    """Why the kernels split their operands: a single tf32 product (big x
    big, 10 mantissa bits) misses the 1e-4 gate on o, dq, dk and dv."""
    shares = _gate_shares("d128-causal", terms=1,
                          names=("o", "lse", "dq", "dk", "dv"))
    assert min(shares["o"], shares["dq"], shares["dk"],
               shares["dv"]) > 1.0, shares
