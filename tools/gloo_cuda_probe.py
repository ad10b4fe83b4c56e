#!/usr/bin/env python3
"""Which collectives a gloo process group carries on CUDA tensors, on
the installed torch: two ranks on cuda:0 (the way the model-axis phase of
``chip_smoke.py`` shares one card), each collective in its own pair of
processes so that a crash ends only its own probe.  Prints one line a
collective: ``ok`` with the result checked, the error, or the exit code.
The port stages every collective of a CUDA tensor on a gloo group
through host buffers (``src/repro_torch/dist/collectives.py``) whatever
this prints; it says what gloo itself would have done.

    python3 tools/gloo_cuda_probe.py
"""
import os
import pathlib
import socket
import sys

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _probe(rank: int, name: str, port: int, out: str) -> None:
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    dist.init_process_group("gloo", rank=rank, world_size=2)
    dev = torch.device("cuda", 0)
    x = torch.full((4,), float(rank + 1), device=dev)
    try:
        if name == "all_reduce":
            dist.all_reduce(x)
            ok = x.tolist() == [3.0] * 4
        elif name == "broadcast":
            dist.broadcast(x, 0)
            ok = x.tolist() == [1.0] * 4
        elif name == "all_gather":
            parts = [torch.empty_like(x) for _ in range(2)]
            dist.all_gather(parts, x)
            ok = [p[0].item() for p in parts] == [1.0, 2.0]
        elif name == "reduce_scatter":
            y = torch.empty(2, device=dev)
            dist.reduce_scatter(y, list(x.chunk(2)))
            ok = y.tolist() == [3.0, 3.0]
        elif name == "all_to_all_single":
            y = torch.empty_like(x)
            dist.all_to_all_single(y, x)
            ok = y.tolist() == [1.0, 1.0, 2.0, 2.0]
        elif name == "send_recv":
            y = torch.empty_like(x)
            ops = [dist.P2POp(dist.isend, x, 1 - rank),
                   dist.P2POp(dist.irecv, y, 1 - rank)]
            for w in dist.batch_isend_irecv(ops):
                w.wait()
            ok = y.tolist() == [float(2 - rank)] * 4
        msg = "ok" if ok else f"wrong result {x.tolist()}"
    except Exception as e:                     # noqa: BLE001 - reported
        msg = f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"
    if rank == 0:
        with open(out, "w") as f:
            f.write(msg)
    dist.destroy_process_group()


def main() -> None:
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)}")
    build = pathlib.Path(__file__).resolve().parents[1] / "build"
    build.mkdir(exist_ok=True)
    out = str(build / "gloo_probe.txt")
    for name in ("all_reduce", "broadcast", "all_gather", "reduce_scatter",
                 "all_to_all_single", "send_recv"):
        if os.path.exists(out):
            os.remove(out)
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        ctx = mp.start_processes(_probe, args=(name, port, out), nprocs=2,
                                 join=False, start_method="spawn")
        for p in ctx.processes:
            p.join(60)
        codes = []
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
            codes.append(p.exitcode)
        res = open(out).read() if os.path.exists(out) else "no result"
        print(f"gloo on CUDA tensors: {name}: {res} (exit codes {codes})",
              flush=True)


if __name__ == "__main__":
    sys.exit(main())
