"""Per-rank work and traffic of a run, counted where it happens: the
port's counterpart of ``repro/launch/hlo_analysis.py``.

The reference compiles its step and parses XLA's HLO text: while-loop trip
counts, replica groups, fusion bodies.  PyTorch runs eagerly and has no
such program, so nothing here parses text.  An :class:`Account` counts
the same quantities as the run makes them:

  * aten ops, through a ``TorchDispatchMode``: ``flops`` of the
    matmul-like ops (``torch.utils.flop_counter``'s formulas), and
    ``traffic_bytes``, the bytes of the operands and results of every
    aten op that is not a view (nor an allocation);
  * collectives, at their call sites in ``dist/collectives.py``:
    ``collective_bytes`` in the reference's structure, per kind, dtype
    and mesh axis.  The payload is max(operand, result) bytes; the axis
    is the mesh dimension of the group ("model", "pipe", "client" for
    the client axes and their flattened group, else "all");
  * the hand-written kernels, which declare their flops and their
    operand and result bytes (:func:`declare`) where they launch on the
    card, and where they only allocate their outputs on the meta device:
    the seven training kernels, and the paged decode kernel, which
    declares the bytes it reads of its pools, counted by shapes, in place
    of the pools' whole size.

An eager run executes every layer, so no trip count is needed, and a
collective knows its group, so no replica group is parsed.  A collective
on a one-rank group is the identity and records nothing, as the
reference's HLO has no collective there.

The account also keeps the peak of live tensor storage on its device
(each storage counted once, however many views share it), and apart from
the traffic the bytes of collectives that a gloo group stages through the
host on the card (``staging_bytes``): copies and host-side work that
exist only because several ranks share one card.

A rematerialized region that keeps its products in host memory
(``models/remat.py``, ``offload_dots``) records what it copies out
(:func:`offload`): the device read is traffic, the copy is
``offload_bytes`` and no part of the device's peak; the copy back in
the recompute is an aten op like any other.

A loop whose every trip runs the same ops on tensors of the same shapes
(a recurrence replayed token by token, a scan's chunks) may iterate over
:func:`trips`: on the meta device under an account, with grad disabled,
it runs the first trip and a second one counted for all the rest, as the
reference's analysis multiplies a while loop's body by its trip count
(the second trip sees what the first left live, as every later trip
does); anywhere else it runs them all.

With no account active each hook costs one check.
"""
from __future__ import annotations

import weakref
from typing import Any, Optional, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
DTYPE_NAMES = {torch.float64: "f64", torch.float32: "f32",
               torch.bfloat16: "bf16", torch.float16: "f16",
               torch.float8_e4m3fn: "f8e4m3fn", torch.float8_e5m2: "f8e5m2",
               torch.int64: "s64", torch.int32: "s32", torch.int16: "s16",
               torch.int8: "s8", torch.uint64: "u64", torch.uint32: "u32",
               torch.uint16: "u16", torch.uint8: "u8", torch.bool: "pred",
               torch.complex64: "c64", torch.complex128: "c128"}
_ALLOCATIONS = ("empty", "empty_like", "empty_strided", "new_empty",
                "new_empty_strided")

_ACTIVE: Optional["Account"] = None


def active() -> Optional["Account"]:
    """The account that is counting, or None."""
    return _ACTIVE


def declare(name: str, inputs, outputs, flops: float = 0.0,
            nbytes: Optional[int] = None) -> None:
    """A hand-written kernel's work, recorded by its wrapper where it
    launches (or, on the meta device, would launch): one launch of
    ``name`` with ``flops`` and the bytes of its operand and result
    tensors, or ``nbytes`` where the kernel reads only part of an operand.
    Does nothing with no account active."""
    if _ACTIVE is not None:
        _ACTIVE.kernel(name, inputs, outputs, flops, nbytes)


def offload(t: torch.Tensor) -> None:
    """A tensor copied from the device to host memory, to come back in
    the backward.  Does nothing with no account active."""
    if _ACTIVE is not None and t.device.type == _ACTIVE.device_type:
        n = _ACTIVE._scale * _nbytes([t])
        _ACTIVE.offload_bytes += n
        _ACTIVE.traffic_bytes += n


def trips(seq: Sequence, device) -> Sequence:
    """The items of a loop to run: all of ``seq``, but on the meta device
    under an active account with grad disabled only its first two, and
    while the second runs everything the account counts is counted
    ``len(seq) - 1`` times (the live memory is not: each trip frees what
    the one before it made).  For loops whose trips differ in values
    only, never in shapes or ops.  With grad enabled every trip runs: a
    graph of two trips would give a backward (and a checkpoint's
    recompute) of two.  A loop that keeps each trip's output holds,
    during its last trip on the card, all the earlier ones: the meta peak
    lacks all but two of them (the caller allocates the rest after the
    loop)."""
    if _ACTIVE is None or torch.device(device).type != "meta" \
            or len(seq) <= 2 or torch.is_grad_enabled():
        return seq
    return _ACTIVE._scaled(seq)


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def wire_dtype(dtypes: dict) -> str:
    """Dominant payload dtype of the FSA reduce-scatter stage (the
    reference's ``_wire_dtype``): reduce-scatter when the payload is
    summable on the wire, else the all-to-all scatter half of the
    quantized exchange."""
    for kind in ("reduce-scatter", "all-to-all"):
        if dtypes.get(kind):
            return max(dtypes[kind], key=dtypes[kind].get)
    return ""


class Account(TorchDispatchMode):
    """Counts one rank's work while it is entered (``with Account(...) as
    acc:``).  ``mesh`` names the groups' axes; ``device`` is the device
    whose traffic and memory count (ops that touch only host tensors, as
    the key derivations do, are not its traffic); ``inputs``, a tree of
    tensors live at entry, are the run's arguments: their bytes are
    ``argument_bytes`` and they count toward the peak until freed.

    After the run, :meth:`record` gives the reference's ``analyze()``
    keys (``flops``, ``traffic_bytes``, ``collective_bytes``) with the
    peak, the arguments, the staging and offloaded bytes and the kernels'
    declarations.
    """

    def __init__(self, mesh=None, device: Any = "meta", inputs=None):
        super().__init__()
        self.device_type = torch.device(device).type
        self.axes = _group_axes(mesh) if mesh is not None else {}
        self.flops = 0.0
        self.traffic_bytes = 0.0
        self.staging_bytes = 0.0
        self.offload_bytes = 0.0
        self.kernels: dict = {}
        self._coll = {k: 0.0 for k in COLLECTIVES}
        self._counts = {k: 0 for k in COLLECTIVES}
        self._dtypes: dict = {k: {} for k in COLLECTIVES}
        self._axes: dict = {}
        self._axis_counts: dict = {}
        self._axis_dtypes: dict = {}
        self._staged = 0
        self._scale = 1
        self._live: dict = {}
        self.live_bytes = self.peak_bytes = 0
        self._track([t for t in tree_leaves(inputs)
                     if isinstance(t, torch.Tensor)])
        self.argument_bytes = self.live_bytes

    # ------------------------------------------------------ entering
    def __enter__(self):
        global _ACTIVE
        if _ACTIVE is not None:
            raise RuntimeError("an Account is already counting")
        _ACTIVE = self
        return super().__enter__()

    def __exit__(self, *exc):
        global _ACTIVE
        _ACTIVE = None
        return super().__exit__(*exc)

    # ------------------------------------------------------ memory
    def _track(self, tensors) -> None:
        for t in tensors:
            if t.device.type != self.device_type:
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self._live:
                continue
            self._live[key] = st.nbytes()
            self.live_bytes += self._live[key]
            weakref.finalize(st, self._free, key)
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def _free(self, key) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    # ------------------------------------------------------ aten ops
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace != "aten":
            return out
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        if not any(t.device.type == self.device_type for t in ins + outs):
            return out
        self._track(outs)
        packet = func.overloadpacket
        if packet in flop_registry:
            self.flops += self._scale * float(flop_registry[packet](
                *args, **kwargs, out_val=out))
        if func.is_view or packet.__name__ in _ALLOCATIONS:
            return out
        moved = self._scale * (_nbytes(ins) + _nbytes(outs))
        if self._staged:
            self.staging_bytes += moved
        else:
            self.traffic_bytes += moved
        return out

    # ------------------------------------------------------ hooks
    def kernel(self, name: str, inputs, outputs, flops: float,
               nbytes: Optional[int] = None) -> None:
        moved = self._scale * (_nbytes(inputs) + _nbytes(outputs)
                               if nbytes is None else nbytes)
        flops = self._scale * float(flops)
        k = self.kernels.setdefault(name, {"launches": 0, "flops": 0.0,
                                           "bytes": 0})
        k["launches"] += self._scale
        k["flops"] += flops
        k["bytes"] += moved
        self.flops += flops
        self.traffic_bytes += moved

    def collective(self, kind: str, group, x, staged: bool, run):
        """Runs the collective ``run()`` over ``group`` and records its
        payload: max(operand, result) bytes in the larger side's dtype,
        one op per tensor for a ``collective-permute`` of a list.  The
        aten ops of a collective that the group stages through the host
        count as ``staging_bytes``."""
        self._staged += int(staged)
        try:
            out = run()
        finally:
            self._staged -= int(staged)
        axis = self.axes.get(getattr(group, "group_name", None), "all")
        pairs = (list(zip(x, out)) if isinstance(x, (list, tuple))
                 else [(x, out)])
        for a, b in pairs:
            big = a if _nbytes([a]) >= _nbytes([b]) else b
            self._add(kind, axis, DTYPE_NAMES.get(big.dtype, str(big.dtype)),
                      float(_nbytes([big])))
        return out

    def _add(self, kind: str, axis: str, dt: str, nbytes: float) -> None:
        nbytes *= self._scale
        self._coll[kind] += nbytes
        self._counts[kind] += self._scale
        self._dtypes[kind][dt] = self._dtypes[kind].get(dt, 0.0) + nbytes
        ax = self._axes.setdefault(axis, {})
        ax[kind] = ax.get(kind, 0.0) + nbytes
        axc = self._axis_counts.setdefault(axis, {})
        axc[kind] = axc.get(kind, 0) + self._scale
        axd = self._axis_dtypes.setdefault(axis, {}).setdefault(kind, {})
        axd[dt] = axd.get(dt, 0.0) + nbytes

    def _scaled(self, seq: Sequence):
        """:func:`trips`' two trips, the second counted ``len(seq) - 1``
        times."""
        yield seq[0]
        self._scale *= len(seq) - 1
        try:
            yield seq[1]
        finally:
            self._scale //= len(seq) - 1

    # ------------------------------------------------------ results
    def collective_bytes(self) -> dict:
        """The reference's ``collective_bytes`` record: per kind the
        payload bytes, then ``counts``, ``dtypes``, ``axes``,
        ``axis_counts``, ``axis_dtypes`` and ``wire_dtype`` (read from
        the client axis, else "all")."""
        out: dict = dict(self._coll)
        out["counts"] = dict(self._counts)
        out["dtypes"] = {k: dict(v) for k, v in self._dtypes.items()}
        out["axes"] = {a: dict(v) for a, v in self._axes.items()}
        out["axis_counts"] = {a: dict(v)
                              for a, v in self._axis_counts.items()}
        out["axis_dtypes"] = {a: {k: dict(d) for k, d in v.items()}
                              for a, v in self._axis_dtypes.items()}
        out["wire_dtype"] = wire_dtype(self._axis_dtypes.get("client")
                                       or self._axis_dtypes.get("all")
                                       or {})
        return out

    def record(self) -> dict:
        return {"flops": self.flops, "traffic_bytes": self.traffic_bytes,
                "collective_bytes": self.collective_bytes(),
                "staging_bytes": self.staging_bytes,
                "offload_bytes": self.offload_bytes,
                "argument_bytes": self.argument_bytes,
                "peak_bytes": self.peak_bytes,
                "kernels": {k: dict(v) for k, v in self.kernels.items()}}


def _group_axes(mesh) -> dict:
    """Group name -> axis label for every mesh axis of more than one rank,
    and the flattened client group of several client axes."""
    from repro_torch.dist import sharding as sh
    names = tuple(mesh.mesh_dim_names)
    axes = {}
    for name in names:
        if sh.axis_size(mesh, name) > 1:
            label = name if name in ("model", "pipe") else "client"
            axes[mesh.get_group(name).group_name] = label
    if sh.client_count(mesh) > 1:
        axes[sh.client_group(mesh).group_name] = "client"
    return axes
