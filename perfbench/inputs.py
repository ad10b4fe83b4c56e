"""The benchmark's inputs, made from ``--seed``: the same seed gives the
same weights and tokens on a device, and both sides of the correctness
check (the program and the plain reference) are handed these same
tensors.

Weights are drawn leaf by leaf on the device, each leaf from a generator
seeded by (seed, leaf name), in one call a leaf and in the type it is
served in: norm scales are ones, biases zeros, every other matrix
standard normal times fan_in ** -0.5 (fan_in the second-to-last dim).
A leaf can therefore be drawn again alone, which is how the check
recovers the initial weights without keeping a copy of them.

Tokens are uniform over the vocabulary, one generator per (seed, round),
so round r's K client batches are the same whoever asks for them.

The check's sample of coordinates is ``SAMPLE`` indices of the flat
parameter vector, uniform and sorted.
"""
from __future__ import annotations

import hashlib

import torch

_MASK63 = (1 << 63) - 1
SAMPLE = 1 << 20


def stream_seed(seed: int, *labels) -> int:
    """A generator seed for one stream of ``seed``: a 63-bit hash of the
    seed and the labels, so streams of one seed never overlap and any
    seed up to 2**63 is taken whole."""
    text = "/".join(str(x) for x in (int(seed), *labels)).encode()
    return int.from_bytes(hashlib.sha256(text).digest()[:8], "little") & _MASK63


def generator(device, seed: int, *labels) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        stream_seed(seed, *labels))


def leaf_kind(name: str) -> str:
    """How a leaf starts: ``ones`` for norm scales, ``zeros`` for biases,
    ``normal`` for the rest (the last component of its path decides)."""
    last = name.rsplit("/", 1)[-1]
    if last.startswith(("ln", "q_norm", "k_norm")):
        return "ones"
    if last.startswith("b"):
        return "zeros"
    return "normal"


@torch.no_grad()
def draw_leaf(name: str, shape, dtype: torch.dtype, seed: int,
              device) -> torch.Tensor:
    """Leaf ``name`` of the weights of ``seed``, on ``device``."""
    kind = leaf_kind(name)
    if kind == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    if kind == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    out = torch.randn(shape, dtype=dtype, device=device,
                      generator=generator(device, seed, "weights", name))
    return out.mul_(fan_in ** -0.5)


def draw_tree(spec: dict, dtype: torch.dtype, seed: int, device,
              prefix: str = "") -> dict:
    """A nested dict of leaves for a nested dict of shapes."""
    out = {}
    for key, value in spec.items():
        name = f"{prefix}{key}"
        if isinstance(value, dict):
            out[key] = draw_tree(value, dtype, seed, device, name + "/")
        else:
            out[key] = draw_leaf(name, tuple(value), dtype, seed, device)
    return out


def leaf_names(spec: dict, prefix: str = "") -> list:
    """(name, shape) of every leaf in ravel order: dict keys sorted,
    depth first (``jax.flatten_util.ravel_pytree``'s order)."""
    out = []
    for key in sorted(spec):
        value = spec[key]
        if isinstance(value, dict):
            out += leaf_names(value, f"{prefix}{key}/")
        else:
            out.append((f"{prefix}{key}", tuple(value)))
    return out


def round_tokens(seed: int, rnd: int, K: int, batch: int, seq: int,
                 vocab: int, device) -> torch.Tensor:
    """Round ``rnd``'s client batches: (K, batch, seq) int32 token ids,
    uniform over the vocabulary."""
    return torch.randint(0, vocab, (K, batch, seq), dtype=torch.int32,
                         device=device,
                         generator=generator(device, seed, "tokens", rnd))


def sample_coords(seed: int, n: int, device) -> torch.Tensor:
    """The check's ``SAMPLE`` coordinates of an n-vector: sorted int64."""
    idx = torch.randint(0, n, (SAMPLE,), dtype=torch.int64, device=device,
                        generator=generator(device, seed, "sample"))
    return idx.sort().values


def leaf_bounds(sample: torch.Tensor, offsets: list) -> list:
    """For sorted ``sample`` and ascending ``offsets``, the positions at
    which the sample enters each offset: sample[b[j]:b[j+1]] lies in
    [offsets[j], offsets[j+1])."""
    return torch.searchsorted(
        sample, torch.tensor(offsets, dtype=torch.int64,
                             device=sample.device)).tolist()
