"""Meshes of the distributed step (``repro/launch/mesh.py``) over
``torch.distributed``.

One process per mesh position.  :func:`init_process_group` joins the
default group (under ``torchrun``) or makes a one-rank group on a
loopback port (under plain ``python``); :func:`make_host_mesh` lays the
``"data"`` axis, and a ``"model"`` axis minor-most, over it: rank a *
model + j is aggregator a's model position j.  With a pipe axis the mesh
is the reference's ``("data", "pipe", "model")``: rank (a * pipe + s) *
model + j is aggregator a's stage s at model position j, and
``mesh.get_group("pipe")`` is the stage ring of its (a, j).  The serving
engine takes the 2-D mesh as it is (``serve/engine.ServeEngine(...,
mesh=)``).  Ranks that share one card pass ``backend="gloo"``: each
process then has its own paged-kernel workspace, and the kernel's
one-stream rule holds in each.

Defined as functions, so importing this module touches no process group.
"""
from __future__ import annotations

import datetime
import os
import socket

import torch
import torch.distributed as dist

from repro_torch import DeviceLike, resolve_device

# CPU tensors go through gloo, CUDA tensors through NCCL
BACKENDS = {"cpu": "cpu:gloo", "cuda": "cpu:gloo,cuda:nccl"}
TIMEOUT_S = 600.0           # a collective that waits longer fails the run


def free_port() -> int:
    """A TCP port free on the loopback interface."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return int(s.getsockname()[1])


def init_process_group(device: DeviceLike = None,
                       backend: str | None = None) -> torch.device:
    """Join the default process group and return this rank's device.

    Under ``torchrun`` (``RANK``/``WORLD_SIZE`` in the environment) the
    group is the launcher's; otherwise a one-rank group on a free loopback
    port.  ``device`` is the CUDA card unless the caller asks for the CPU;
    on the card each rank takes card ``LOCAL_RANK`` modulo the cards
    there are.  ``backend`` is the caller's choice, by default
    ``cpu:gloo,cuda:nccl`` on the card and ``cpu:gloo`` on the CPU.
    ``"gloo"`` on the card is how several ranks share one card (NCCL
    refuses two ranks on one device): every collective of a CUDA tensor
    then goes through host buffers (``dist.collectives``)."""
    device = resolve_device(device)
    if device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", "0"))
        torch.cuda.set_device(local % torch.cuda.device_count())
        device = torch.device("cuda", torch.cuda.current_device())
    if dist.is_initialized():
        return device
    timeout = datetime.timedelta(seconds=TIMEOUT_S)
    backend = backend or BACKENDS[device.type]
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://",
                                timeout=timeout)
    else:
        dist.init_process_group(
            backend, init_method=f"tcp://127.0.0.1:{free_port()}",
            world_size=1, rank=0, timeout=timeout)
    return device


def make_production_mesh(*, multi_pod: bool = False, pipe: int = 1):
    """The reference's 256/512-device TPU production mesh, which only its
    ahead-of-time lowering (``launch/dryrun.py``) builds: ROADMAP queue
    1.12, with the lowering."""
    raise NotImplementedError(
        "make_production_mesh: the 256/512-device production mesh serves "
        "the reference's lowering for accounting, not ported yet: ROADMAP "
        "queue 1.12")


def make_host_mesh(data: int | None = None, model: int = 1, pipe: int = 1,
                   device: DeviceLike = None):
    """A ``DeviceMesh`` over the initialised process group's ranks: one
    ``"data"`` axis, or with ``model > 1`` the 2-D ``("data", "model")``
    mesh, model minor-most (the model group is consecutive ranks), or
    with ``pipe > 1`` the reference's 3-D ``("data", "pipe", "model")``
    mesh, model minor-most, then pipe.  Validates the factorization up
    front, with the reference's messages."""
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError(
            "make_host_mesh: no process group; call "
            "launch.mesh.init_process_group() first (or run under torchrun)")
    n = dist.get_world_size()
    if pipe < 1:
        raise ValueError(f"pipe axis size {pipe} must be >= 1")
    inner = model * pipe
    if model < 1 or inner < 1 or n % inner != 0:
        raise ValueError(
            f"model axis size {model} x pipe {pipe} must divide the {n} "
            f"available device(s) (n % (model*pipe) == "
            f"{n % inner if inner else 'undef'}); "
            f"pick --model-axis/--pp from the divisors of {n}, or launch "
            f"more ranks (torchrun --nproc-per-node <n>)")
    if data is None:
        data = n // inner
    if data < 1 or data * inner != n:
        raise ValueError(
            f"mesh ({data} data x {pipe} pipe x {model} model) needs "
            f"{data * inner} devices but {n} are available; leave "
            f"data=None to infer data = n // (model*pipe) = {n // inner}")
    device_type = resolve_device(device).type
    if pipe > 1:
        return init_device_mesh(device_type, (data, pipe, model),
                                mesh_dim_names=("data", "pipe", "model"))
    if model == 1:
        return init_device_mesh(device_type, (data,),
                                mesh_dim_names=("data",))
    return init_device_mesh(device_type, (data, model),
                            mesh_dim_names=("data", "model"))
