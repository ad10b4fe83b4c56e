"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles with
``nvcc -gencode arch=compute_90a,code=sm_90a`` into
``build/kernels/lib<name>-<hash>.so`` under the repository root (listed in
``.gitignore``).  The hash of the source and of the shared headers
(``csrc/*.cuh``) is in the file name, so an edited kernel is rebuilt and
a built one is reused.  No source is built with fast math: the wire
kernels rely on IEEE division.  PyTorch's own extension
build (torch.utils.cpp_extension) compiles PyTorch's headers into every
build, which costs minutes on each fresh machine; a C interface builds
in seconds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time
from typing import Dict, List, Optional, Sequence

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

_loaded: Dict[str, ctypes.CDLL] = {}
_bound: Dict[str, "ctypes._CFuncPtr"] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found (not on PATH, no /usr/local/cuda): "
                       "the CUDA kernels build only where the toolkit is")


def sources() -> List[str]:
    """The name of every kernel source under ``csrc/``."""
    return sorted(path.stem for path in CSRC.glob("*.cu"))


def library_path(name: str) -> pathlib.Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build(names: Optional[Sequence[str]] = None) -> Dict[str, float]:
    """Compile every named source (all of them by default) that is not
    built yet, one ``nvcc`` per source, all started together.  Returns the seconds each build took
    (0.0 for a library that was already there); ``-Xptxas -v``'s report
    of registers and shared memory is kept in ``<library>.log``."""
    names = sources() if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
               "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        started[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True), time.monotonic())
    seconds = {name: 0.0 for name in names}
    failures = []
    for name, (proc, t0) in started.items():
        log, _ = proc.communicate()
        seconds[name] = time.monotonic() - t0
        out = library_path(name)
        out.with_name(out.name + ".log").write_text(log)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        if proc.returncode:
            failures.append(f"nvcc failed for {name}.cu:\n{log[-4000:]}")
        else:
            os.replace(tmp, out)
    if failures:
        raise RuntimeError("\n".join(failures))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib


def bind(name: str, symbol: str, argtypes: Sequence) -> "ctypes._CFuncPtr":
    """``symbol`` of source ``name``'s library, typed: every pointer and
    the stream as ``c_void_p``, so that ctypes does not cut them to 32
    bits.  The C function returns a ``cudaError_t``."""
    fn = _bound.get(symbol)
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _bound[symbol] = fn
    return fn


def raise_on_error(name: str, err: int) -> None:
    """Raise if a launch of source ``name``'s kernel was refused: a refused
    launch never runs, and a later synchronize does not report it."""
    if err:
        text = getattr(load(name), f"{name}_error_string")
        text.argtypes = [ctypes.c_int]
        text.restype = ctypes.c_char_p
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{text(err).decode()}")
