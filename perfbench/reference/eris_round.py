"""ERIS rounds, plainly (arXiv:2602.08617, Algorithm 1 with Sec. 3.2.2's
shifted compression), from the benchmark's inputs, in float32.

Round t, every client k of K: g_k = grad of the loss at the model's
weights (the flat parameter vector x rounded to the model's dtype, as a
model served in that dtype computes), on round t's batch; v_k = C(g_k -
s_k), s_k += gamma v_k (``wire.compress_client``).  The aggregators'
sharded mean with Eq. 4's compensation is, coordinate by coordinate,
u = s_agg + mean_k v_k, s_agg += gamma mean_k v_k, whatever the
number of aggregators (Theorem B.1); the server takes x -= lr u.  The
round keys: PRNGKey(seed), split each round into (next, sub), sub split
five ways with the compression's key second.  gamma is Theorem 3.2's
sqrt((1 + 2w) / (2 (1 + w)^3)) with w = 1/p - 1 for RandP(p).

What is read for the check: each client's loss of each round, each
leaf's norm of round 1's update u (what the server is handed), of the
change x_T - x_0 after the T = ``compare.CHECK_ROUNDS`` rounds, and of
round 1's raw gradients (the mean over clients of each leaf's norm),
which tells which leaves the reference moves at all; at the seed's
sample of coordinates, round 1's u and whether any client's mask kept
each.
"""
from __future__ import annotations

import math

import torch

from perfbench import compare, inputs
from perfbench.reference import model, threefry, wire

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def gamma_star(p: float) -> float:
    w = 1.0 / p - 1.0
    return math.sqrt((1.0 + 2.0 * w) / (2.0 * (1.0 + w) ** 3))


def _norms(vec: torch.Tensor, leaves: list) -> list:
    return [float(torch.linalg.vector_norm(vec[off:off + size]))
            for _, _, off, size in leaves]


def layout(m: dict) -> tuple:
    """(leaves as (name, shape, offset, size) in ravel order, n)."""
    out, off = [], 0
    for name, shape in inputs.leaf_names(model.param_spec(m)):
        size = math.prod(shape)
        out.append((name, shape, off, size))
        off += size
    return out, off


def initial_leaf(m: dict, leaf, seed: int, device) -> torch.Tensor:
    name, shape, _, size = leaf
    return inputs.draw_leaf(name, shape, DTYPES[m["dtype"]], seed,
                            device).float().reshape(size)


def _leaf(flat: torch.Tensor, grad: torch.Tensor, shape, off: int,
          size: int) -> torch.Tensor:
    leaf = flat[off:off + size].view(shape).detach().requires_grad_()
    leaf.grad = grad[off:off + size].view(shape)
    return leaf


def _tree(leaves: list, flat: torch.Tensor, grad: torch.Tensor) -> dict:
    """The weights as a nested dict of leaf tensors over ``flat``, each
    accumulating its gradient into its slice of ``grad``.  A block leaf,
    stacked on its layer axis, is a list of one leaf a layer: the
    gradient of a layer's slice of a stacked leaf would be a zero tensor
    of the whole stack (2.1 GB for OLMoE's experts) before it is added."""
    tree: dict = {}
    for name, shape, off, size in leaves:
        if name.startswith("blocks/"):
            per = size // shape[0]
            leaf = [_leaf(flat, grad, shape[1:], off + i * per, per)
                    for i in range(shape[0])]
        else:
            leaf = _leaf(flat, grad, shape, off, size)
        node = tree
        *parents, last = name.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf
    return tree


def run(m: dict, traffic: dict, seed: int, device, *, fp8: bool = False
        ) -> dict:
    """The reference's readings over the ``CHECK_ROUNDS`` rounds of
    ``seed``, its float32 products in float32 (TF32 off)."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _run(m, traffic, seed, device, fp8)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def _run(m: dict, traffic: dict, seed: int, device, fp8: bool) -> dict:
    rnd = traffic["round"]
    K, lr, p = rnd["K"], rnd["lr"], traffic["compressor"]["p"]
    path = "fused" if rnd.get("compress_impl") == "fused" else "jnp"
    if rnd.get("int8_wire") != (path == "fused"):
        raise ValueError("the reference runs RandP DSC on the jnp path "
                         "without the wire or on the fused path with it")
    gamma = gamma_star(p)
    leaves, n = layout(m)
    dtype = DTYPES[m["dtype"]]
    mm = model.Products(fp8)
    x = torch.empty(n, dtype=torch.float32, device=device)
    for leaf in leaves:
        x[leaf[2]:leaf[2] + leaf[3]] = initial_leaf(m, leaf, seed, device)
    s = torch.zeros(K, n, dtype=torch.float32, device=device)
    s_agg = torch.zeros(n, dtype=torch.float32, device=device)
    weights = torch.empty(n, dtype=torch.float32, device=device)
    grad = torch.empty(n, dtype=torch.float32, device=device)
    acc = torch.empty(n, dtype=torch.float32, device=device)
    key = threefry.PRNGKey(seed)
    sample = inputs.sample_coords(seed, n, device)
    kept = torch.zeros(sample.numel(), dtype=torch.bool, device=device)
    losses, grad_norms, update_norms = [], None, None
    for r in range(compare.CHECK_ROUNDS):
        key, sub = threefry.split(key, 2)
        comp_key = threefry.split(sub, 5)[1]
        for _, _, off, size in leaves:   # no n-sized transient
            weights[off:off + size] = x[off:off + size].to(dtype)
        tree = _tree(leaves, weights, grad)
        toks = inputs.round_tokens(seed, r, K, traffic["batch"],
                                   traffic["seq"], m["vocab"], device)
        acc.zero_()
        round_losses = []
        for k in range(K):
            grad.zero_()
            total = 0.0
            for row in toks[k]:
                loss = model.row_loss(m, tree, row, toks.shape[1], mm)
                loss.backward()
                total += float(loss.detach())
                del loss
            round_losses.append(total)
            if r == 0:
                norms = _norms(grad, leaves)
                grad_norms = ([a + b / K for a, b in zip(grad_norms, norms)]
                              if grad_norms else [b / K for b in norms])
            wire.compress_client(grad, s[k], comp_key, k, K, p=p,
                                 gamma=gamma, path=path, acc=acc,
                                 weight=1.0 / K,
                                 sample=sample if r == 0 else None,
                                 kept=kept)
        del tree
        losses.append(round_losses)
        # u = s_agg + mean; s_agg += gamma mean; x -= lr u
        acc.add_(s_agg)
        if r == 0:
            update_norms = _norms(acc, leaves)
            u_sample = acc[sample].cpu()
        s_agg.mul_(1.0 - gamma).add_(acc, alpha=gamma)
        x.add_(acc, alpha=-lr)
    del s, s_agg, weights, grad, acc
    change = []
    for leaf in leaves:
        _, _, off, size = leaf
        x0 = initial_leaf(m, leaf, seed, device)
        change.append(float(torch.linalg.vector_norm(x[off:off + size] - x0)))
    return {"losses": losses, "update_norms": update_norms,
            "change_norms": change, "grad_norms": grad_norms,
            "u_sample": u_sample, "mask_sample": kept.cpu(),
            "leaves": [leaf[0] for leaf in leaves]}
