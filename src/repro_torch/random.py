"""The threefry key stream of ``jax.random`` (``jax._src.prng`` and
``jax._src.random``), bit for bit, in torch.

Keys are ``(..., 2)`` int64 tensors whose two columns hold the uint32
words of a jax key (``jax.random.PRNGKey``'s uint32 pair), kept on the
host.  Every 32-bit value is an int64 masked to 32 bits after each add
and rotate: torch's uint32 covers too few ops, and not the same ones on
every build.  The hash itself, :func:`threefry2x32`, takes Python ints
as well as tensors, so a single key is split or folded without a tensor
op at all.

Counter layout.  jax has two, chosen by ``jax_threefry_partitionable``;
:data:`partitionable` mirrors that flag (True: jax >= 0.5's default;
False: the layout of the jax 0.4 that CI pins):

* partitionable: element i of a draw hashes the counter pair (i >> 32,
  i & 0xFFFFFFFF), and its 32 bits are the two output words xored.
* original: the draw is ``threefry_2x32(key, iota(n))``: the n counters
  (padded with one 0 when n is odd) are cut into halves and hashed in
  pairs, element i with element i + ceil(n / 2); element i keeps the
  first output word if it lies in the first half, the second otherwise.
  ``split`` uses the same layout over 2 * num counters.  A draw of
  2**32 - 1 or more counters goes block by block (:func:`_bits_window`).

Large draws.  ``bits``, ``uniform``, ``bernoulli``, ``randint`` and
``normal`` take a ``window``:
the flat elements [lo, hi) of the draw over ``shape``, the same values
whatever the window, so a caller consumes an n = 1.8e9 draw chunk by
chunk and never holds an n-sized temporary.  Without a window they
compute the whole draw :data:`CHUNK` elements at a time.

The floating-point draws round as XLA compiles them on the CPU, where
that is what the reference runs: ``uniform``'s ``floats * (max - min) +
min`` is one fused multiply-add, and ``choice`` takes XLA's blocked
cumulative sum (:func:`cumsum`).  ``gumbel`` and ``normal`` go through
``log`` and ``erfinv``, whose last bits differ between XLA and torch:
they agree with jax to a few ulps, not bit for bit.  So do ``gamma``,
``loggamma`` and ``dirichlet``, which add ``log``, ``log1p``, ``pow`` and
``exp``; their results below f32's smallest normal are flushed to zero,
as XLA's CPU code flushes subnormals.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.kernels.ref import fma_f32

MASK = 0xFFFFFFFF
# mirrors jax's ``jax_threefry_partitionable`` (see the module docstring)
partitionable = True
# elements a bulk draw computes at a time: an int64 temporary is 128 MB
CHUNK = 1 << 24

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = float(np.finfo(np.float32).tiny)

Shape = Union[int, Sequence[int]]
IntOrTensor = Union[int, torch.Tensor]


# ------------------------------------------------------------------ hash
def _rotl(x: IntOrTensor, r: int) -> IntOrTensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k1: IntOrTensor, k2: IntOrTensor, x1: IntOrTensor,
                 x2: IntOrTensor) -> Tuple[IntOrTensor, IntOrTensor]:
    """Threefry-2x32 with 20 rounds, as ``prng._threefry2x32_lowering``:
    the key words (k1, k2) hash the counter words (x1, x2).  Arguments are
    Python ints or int64 tensors holding uint32 values, broadcast against
    each other."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & MASK
    x2 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & MASK
    return x1, x2


# ------------------------------------------------------------------ keys
def PRNGKey(seed: int) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` as jax builds it with 64-bit types off
    (its default): the seed's low 32 bits, behind a zero word."""
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64)


def _words(key: torch.Tensor):
    """A key's two words: Python ints for one key, (B, 1) columns for a
    (B, 2) batch of keys (jax's ``vmap`` over keys)."""
    if key.shape[-1] != 2:
        raise ValueError(f"a key is (..., 2) uint32 words, got shape "
                         f"{tuple(key.shape)}")
    if key.dim() == 1:
        return int(key[0]), int(key[1])
    if key.dim() == 2:
        return key[:, :1], key[:, 1:]
    raise ValueError(f"keys are (2,) or (B, 2), got {tuple(key.shape)}")


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in``: the key hashes the counters (0, data)."""
    k1, k2 = _words(key)
    return torch.tensor(threefry2x32(k1, k2, 0, int(data) & MASK),
                        dtype=torch.int64, device=key.device)


def split(key: torch.Tensor, num: Shape = 2) -> torch.Tensor:
    """``jax.random.split``: ``(*shape, 2)`` new keys; ``(B, *shape, 2)``
    for a (B, 2) batch of keys (jax's ``vmap``)."""
    shape = (num,) if isinstance(num, int) else tuple(num)
    count = math.prod(shape)
    k1, k2 = _words(key)
    if partitionable:
        i = torch.arange(count, dtype=torch.int64, device=key.device)
        out = torch.stack(threefry2x32(k1, k2, i >> 32, i & MASK), -1)
    else:
        out = _iota_hash(k1, k2, 2 * count, 0, 2 * count, key.device)
    return out.reshape(*key.shape[:-1], *shape, 2)


# ------------------------------------------------------------------ bits
def _iota_hash(k1, k2, n: int, lo: int, hi: int, device) -> torch.Tensor:
    """Elements [lo, hi) of ``threefry_2x32(key, iota(n))``, n < 2**32:
    counter i pairs with i + ceil(n / 2), and an odd n pads the second
    half with one 0."""
    half = (n + 1) // 2
    i = torch.arange(lo, hi, dtype=torch.int64, device=device)
    first = i < half
    a = torch.where(first, i, i - half)
    b = a + half
    b = torch.where(b < n, b, 0)
    y1, y2 = threefry2x32(k1, k2, a, b)
    return torch.where(first, y1, y2)


def _block_key(k1, k2, nkeys: int, b: int, device):
    """Key b of the original layout's ``split(key, nkeys)``: elements 2b
    and 2b + 1 of ``threefry_2x32(key, iota(2 * nkeys))``."""
    w = _iota_hash(k1, k2, 2 * nkeys, 2 * b, 2 * b + 2, device)
    if w.dim() == 1:
        return int(w[0]), int(w[1])
    return w[:, :1], w[:, 1:]


def _bits_window(k1, k2, n: int, lo: int, hi: int, device) -> torch.Tensor:
    """Flat elements [lo, hi) of a 32-bit draw of n elements.

    The original layout hashes at most 2**32 - 1 counters at once: from
    that count on (``prng._threefry_random_bits_original``) the key is
    split into nblocks + 1 keys, block b < nblocks is
    ``threefry_2x32(key b, iota(2**32 - 1))`` and the last block hashes
    the remaining n mod (2**32 - 1) counters (none when n is a multiple)."""
    if partitionable:
        i = torch.arange(lo, hi, dtype=torch.int64, device=device)
        y1, y2 = threefry2x32(k1, k2, i >> 32, i & MASK)
        return y1 ^ y2
    if n < MASK:
        return _iota_hash(k1, k2, n, lo, hi, device)
    nblocks, rem = divmod(n, MASK)
    parts = []
    for b in range(lo // MASK, (hi - 1) // MASK + 1 if hi > lo else 0):
        start = b * MASK
        bk1, bk2 = _block_key(k1, k2, nblocks + 1, b, device)
        size = MASK if b < nblocks else rem
        parts.append(_iota_hash(bk1, bk2, size, max(lo, start) - start,
                                min(hi, start + MASK) - start, device))
    if not parts:
        return _iota_hash(k1, k2, 1, 0, 0, device)
    return torch.cat(parts, -1)


def _shape(shape: Shape) -> Tuple[int, ...]:
    return (shape,) if isinstance(shape, int) else tuple(shape)


def _draw(key, shape, device, window, fn, dtype):
    """``fn(flat_bits)`` over the draw of ``shape``: on the flat window
    [lo, hi) when one is given, else over the whole draw, CHUNK elements
    at a time, reshaped to ``shape`` (with a leading batch for a (B, 2)
    batch of keys)."""
    shape = _shape(shape)
    n = math.prod(shape)
    device = key.device if device is None else torch.device(device)
    k1, k2 = _words(key)
    if isinstance(k1, torch.Tensor):
        k1, k2 = k1.to(device), k2.to(device)
    if window is not None:
        lo, hi = window
        if not 0 <= lo <= hi <= n:
            raise ValueError(f"window [{lo}, {hi}) outside a draw of {n}")
        return fn(_bits_window(k1, k2, n, lo, hi, device))
    batch = () if key.dim() == 1 else (key.shape[0],)
    out = torch.empty(batch + (n,), dtype=dtype, device=device)
    for lo in range(0, n, CHUNK):
        hi = min(n, lo + CHUNK)
        out[..., lo:hi] = fn(_bits_window(k1, k2, n, lo, hi, device))
    return out.reshape(batch + shape)


def bits(key: torch.Tensor, shape: Shape = (), *, device=None,
         window: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` as int64 values in
    [0, 2**32)."""
    return _draw(key, shape, device, window, lambda b: b, torch.int64)


def _float_bits(b: torch.Tensor) -> torch.Tensor:
    """[0, 1) from 32 random bits: the 23 high bits as the mantissa of a
    float in [1, 2), minus 1."""
    return ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0


def uniform(key: torch.Tensor, shape: Shape = (), minval: float = 0.0,
            maxval: float = 1.0, *, device=None,
            window: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """``jax.random.uniform`` in f32: ``max(min, floats * (max - min) +
    min)``, the multiply-add fused as XLA compiles ``_uniform``."""
    lo, hi = np.float32(minval), np.float32(maxval)
    scale = float(hi - lo)

    def fn(b):
        f = _float_bits(b)
        if scale != 1.0 or lo != 0.0:
            f = fma_f32(scale, f, torch.full_like(f, float(lo)))
        return f.clamp_min(float(lo))

    return _draw(key, shape, device, window, fn, torch.float32)


def bernoulli(key: torch.Tensor, p: Union[float, torch.Tensor] = 0.5,
              shape: Optional[Shape] = None, *, device=None,
              window: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """``jax.random.bernoulli`` (its default ``mode='low'``):
    ``uniform < p`` with p in f32.  A tensor p is taken whole (no
    window) and gives the shape when ``shape`` is None."""
    if isinstance(p, torch.Tensor):
        if window is not None:
            raise ValueError("bernoulli with a tensor p takes no window")
        u = uniform(key, tuple(p.shape) if shape is None else shape,
                    device=p.device if device is None else device)
        return u < p.float()
    p32 = float(np.float32(p))
    return _draw(key, () if shape is None else shape, device, window,
                 lambda b: _float_bits(b) < p32, torch.bool)


def _mulmod32(a: torch.Tensor, m: int) -> torch.Tensor:
    """(a * m) mod 2**32 for a < 2**32 and an int m < 2**32, in two
    16-bit halves of m so that no product leaves int64."""
    lo = a * (m & 0xFFFF)
    hi = ((a * (m >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK


def randint(key: torch.Tensor, shape: Shape, minval: int, maxval: int, *,
            device=None, window: Optional[Tuple[int, int]] = None
            ) -> torch.Tensor:
    """``jax.random.randint`` into int32 (returned as int64): two 32-bit
    draws folded modulo the span, as ``random._randint`` does in
    uint32.  With a ``window``, the flat elements [lo, hi) of the draw
    over ``shape``.  A (B, 2) batch of keys draws (B, *shape)."""
    lo32, hi32 = -2**31, 2**31 - 1
    minval = min(max(int(minval), lo32), hi32)
    out_of_range = int(maxval) > hi32
    maxval = min(max(int(maxval), lo32), hi32)
    span = (maxval - minval) & MASK
    if maxval <= minval:
        span = 1
    elif out_of_range:
        span = (span + 1) & MASK
    keys = split(key)
    k1, k2 = keys[..., 0, :], keys[..., 1, :]
    higher = bits(k1, shape, device=device, window=window)
    lower = bits(k2, shape, device=device, window=window)
    if span == 0:                      # the full 2**32 range
        offset = lower
    else:
        mult = (2**16 % span) ** 2 % 2**32 % span
        offset = ((_mulmod32(higher % span, mult) + lower % span) & MASK) \
            % span
    return (minval + offset + 2**31) % 2**32 - 2**31


def permutation(key: torch.Tensor, x: Union[int, torch.Tensor], *,
                device=None) -> torch.Tensor:
    """``jax.random.permutation`` of ``arange(x)`` or of a 1-D tensor:
    jax's ``_shuffle``, rounds of a stable sort by fresh 32-bit keys, as
    many rounds as jax takes (exponent 3)."""
    if isinstance(x, int):
        device = key.device if device is None else device
        x = torch.arange(x, dtype=torch.int64, device=device)
    if x.dim() != 1:
        raise ValueError("permutation takes an int or a 1-D tensor")
    rounds = int(np.ceil(3 * np.log(max(1, x.numel()))
                         / np.log(np.iinfo(np.uint32).max)))
    for _ in range(rounds):
        key, sub = split(key)
        order = torch.sort(bits(sub, x.shape, device=x.device),
                           stable=True).indices
        x = x[order]
    return x


# ---------------------------------------------------- floating-point draws
def gumbel(key: torch.Tensor, shape: Shape = (), *, device=None
           ) -> torch.Tensor:
    """``jax.random.gumbel`` (``mode='low'``): ``-log(-log(u))``, u
    uniform in [tiny, 1).  A (B, 2) batch of keys draws (B, *shape)."""
    u = uniform(key, shape, _TINY, 1.0, device=device)
    return -torch.log(-torch.log(u))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical`` over the last axis: the first argmax of
    gumbel noise plus the logits.  With a (B, 2) batch of keys, row b of
    the (B, V) logits draws with key b (jax's ``vmap``)."""
    shape = tuple(logits.shape) if key.dim() == 1 else logits.shape[1:]
    g = gumbel(key, shape, device=logits.device)
    return torch.argmax(g + logits.float(), dim=-1)


# Giles' single-precision erfinv, the polynomial XLA expands erf_inv into
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def _erfinv(x: torch.Tensor) -> torch.Tensor:
    w = -torch.log1p(-x * x)
    small = w < 5.0
    w = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(small, _ERFINV_LT5[0], _ERFINV_GE5[0])
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = torch.where(small, a, b) + p * w
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


def normal(key: torch.Tensor, shape: Shape = (), *, device=None,
           window: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """``jax.random.normal`` in f32: ``sqrt(2) * erfinv(u)``, u uniform in
    (-1, 1).  With a ``window``, the flat elements [lo, hi) of the draw
    over ``shape``."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(key, shape, lo, 1.0, device=device, window=window)
    return float(np.float32(np.sqrt(2))) * _erfinv(u)


# ------------------------------------------------------------- sequences
def reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of a 1-D f32 tensor in XLA's CPU order: windows of 32
    summed in order (the zero padding split around the data), window
    sums windowed again while more than 32 remain, the last ones summed
    in order."""
    x = x.float()
    while x.numel() > 32:
        n = x.numel()
        pad = -n % 32
        x = torch.nn.functional.pad(x, (pad // 2, pad - pad // 2))
        rows = x.view(-1, 32)
        acc = rows[:, 0]
        for j in range(1, 32):
            acc = acc + rows[:, j]
        x = acc
    acc = torch.zeros((), dtype=torch.float32, device=x.device)
    for v in x:
        acc = acc + v
    return acc


def cumsum(x: torch.Tensor) -> torch.Tensor:
    """The inclusive sum along the last axis of an f32 tensor in XLA's
    CPU order (its reduce-window rewrite): rows of 16 summed in order,
    the rows' totals scanned the same way while more than 16 remain,
    each row then offset by the sum of the rows before it."""
    x = x.float()
    n = x.shape[-1]
    if n <= 16:
        return _row_scan(x)
    pad = -n % 16
    rows = torch.nn.functional.pad(x, (0, pad)).unflatten(-1, (-1, 16))
    scanned = _row_scan(rows)
    totals = cumsum(scanned[..., -1])
    carry = torch.nn.functional.pad(totals[..., :-1], (1, 0))
    return (scanned + carry[..., None]).flatten(-2)[..., :n]


def _row_scan(x: torch.Tensor) -> torch.Tensor:
    out = torch.empty_like(x)
    acc = x[..., 0]
    out[..., 0] = acc
    for j in range(1, x.shape[-1]):
        acc = acc + x[..., j]
        out[..., j] = acc
    return out


def choice(key: torch.Tensor, a: int, shape: Shape = (), *,
           p: torch.Tensor, device=None) -> torch.Tensor:
    """``jax.random.choice(key, a, shape, replace=True, p=p)`` for an int
    a: ``searchsorted(cumsum(p), cumsum(p)[-1] * (1 - u))``."""
    if p.shape != (a,):
        raise ValueError(f"p must have shape ({a},), got {tuple(p.shape)}")
    device = p.device if device is None else device
    cum = cumsum(p.float().to(device))
    r = cum[-1] * (1.0 - uniform(key, shape, device=device))
    return torch.searchsorted(cum, r.reshape(-1)).reshape(r.shape)


# ------------------------------------------------------- gamma, Dirichlet
_SQUEEZE = float(np.float32(0.0331))
_THIRD = float(np.float32(1.0 / 3.0))


def exponential(key: torch.Tensor, shape: Shape = (), *, device=None,
                window: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """``jax.random.exponential`` in f32: ``-log1p(-u)``, u uniform in
    [0, 1)."""
    return -torch.log1p(-uniform(key, shape, device=device, window=window))


def _rejected(X, V, U, d):
    """``_gamma_one``'s loop condition: True while the draw is still
    rejected (the squeeze test and the log test both fail).  XLA fuses
    ``1 - 0.0331 * X**2`` into one multiply-add; in ``X / 2 + d * (...)``
    the half is exact, so fused or not it rounds the same."""
    one = torch.ones_like(X)
    squeeze = U >= fma_f32(-_SQUEEZE, X * X, one)
    return squeeze & (torch.log(U) >= fma_f32(
        X, torch.full_like(X, 0.5), d * ((1.0 - V) + torch.log(V))))


def _gamma_one(keys: torch.Tensor, alpha: torch.Tensor, log_space: bool
               ) -> torch.Tensor:
    """``jax._src.random._gamma_one`` (Marsaglia-Tsang) for a batch: keys
    (n, 2), alpha (n,) f32, on one device.  Each element runs its own
    rejection loop on its own key; the loops run together, each pass over
    the elements still rejected, until every one is accepted."""
    one = torch.ones_like(alpha)
    boost = alpha >= 1.0
    a = torch.where(boost, alpha, alpha + 1.0)
    d = a - _THIRD
    c = _THIRD / torch.sqrt(d)
    ks = split(keys)
    key, subkey = ks[:, 0].contiguous(), ks[:, 1]
    X, V, U = torch.zeros_like(a), one.clone(), torch.full_like(a, 2.0)
    todo = torch.arange(a.numel(), device=a.device)
    while todo.numel():
        k3 = split(key[todo], 3)
        key[todo] = k3[:, 0]
        x, v = _gamma_normal(k3[:, 1].contiguous(), c[todo])
        X[todo], V[todo] = x * x, (v * v) * v
        U[todo] = uniform(k3[:, 2].contiguous(), ())
        todo = todo[_rejected(X[todo], V[todo], U[todo], d[todo])]
    if log_space:
        logs = -exponential(subkey.contiguous(), ())
        lb = torch.where(boost | (logs == 0), torch.zeros_like(logs),
                         logs * (1.0 / alpha))
        return (torch.log(d) + torch.log(V)) + lb
    samples = 1.0 - uniform(subkey.contiguous(), ())
    b = torch.where(boost, one, _ftz(_powf(samples, 1.0 / alpha)))
    return _ftz((d * V) * b)


def _gamma_normal(keys: torch.Tensor, c: torch.Tensor):
    """The inner loop of ``_gamma_one``: redraw ``x = normal`` from the
    key's split until ``v = 1 + x * c`` (one multiply-add) is positive."""
    x = torch.zeros_like(c)
    v = torch.full_like(c, -1.0)
    todo = torch.arange(c.numel(), device=c.device)
    while todo.numel():
        s = split(keys[todo])
        keys[todo] = s[:, 0]
        xx = normal(s[:, 1].contiguous(), ())
        vv = fma_f32(xx, c[todo], torch.ones_like(xx))
        x[todo], v[todo] = xx, vv
        todo = todo[vv <= 0]
    return x, v


def _ftz(x: torch.Tensor) -> torch.Tensor:
    """Subnormal f32 values flushed to (signed) zero, as XLA's CPU code
    runs with flush-to-zero on."""
    return torch.where(x.abs() < _TINY, x * 0.0, x)


def _powf(base: torch.Tensor, exp: torch.Tensor) -> torch.Tensor:
    """f32 ``pow`` elementwise, taken in double and rounded to f32."""
    return torch.pow(base.double(), exp.double()).float()


def _gamma(key, a, shape, device, log_space: bool) -> torch.Tensor:
    device = key.device if device is None else torch.device(device)
    a = torch.as_tensor(a, dtype=torch.float32, device=device)
    shape = tuple(a.shape) if shape is None else _shape(shape)
    alpha = a.broadcast_to(shape).reshape(-1)
    n = alpha.numel()
    keys = split(key, n).reshape(n, 2).to(device)
    return _gamma_one(keys, alpha, log_space).reshape(shape)


def gamma(key: torch.Tensor, a, shape: Optional[Shape] = None, *,
          device=None) -> torch.Tensor:
    """``jax.random.gamma(key, a, shape)`` in f32: element i (row-major
    over ``shape``, a broadcast to it) runs ``_gamma_one`` on key i of
    ``split(key, prod(shape))``."""
    return _gamma(key, a, shape, device, log_space=False)


def loggamma(key: torch.Tensor, a, shape: Optional[Shape] = None, *,
             device=None) -> torch.Tensor:
    """``jax.random.loggamma``: the log of :func:`gamma`'s draw, computed
    in log space (the same keys and loop)."""
    return _gamma(key, a, shape, device, log_space=True)


def _softmax(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax`` over the last axis of an f32 tensor:
    ``exp(x - max) / sum``."""
    e = _ftz(torch.exp(x - x.amax(-1, keepdim=True)))
    return _ftz(e / e.sum(-1, keepdim=True))


def dirichlet(key: torch.Tensor, alpha, shape: Optional[Shape] = None, *,
              device=None) -> torch.Tensor:
    """``jax.random.dirichlet(key, alpha, shape)`` in f32: ``loggamma``
    over ``shape + alpha.shape[-1:]``, then ``softmax`` over the last
    axis."""
    alpha = torch.as_tensor(alpha, dtype=torch.float32)
    if alpha.dim() < 1:
        raise ValueError("dirichlet requires alpha.ndim >= 1")
    shape = tuple(alpha.shape[:-1]) if shape is None else _shape(shape)
    return _softmax(loggamma(key, alpha, shape + tuple(alpha.shape[-1:]),
                            device=device))
