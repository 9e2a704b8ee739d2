"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``csrc/*.cu`` file exposes a plain C interface (pointers, ints and a
stream, returning the launch's ``cudaError_t``), so it compiles with
``nvcc`` alone in seconds — no PyTorch headers.  Libraries land in
``build/kernels/`` at the root of the checkout (listed in ``.gitignore``),
named by a hash of the source and the flags, so an edited source rebuilds
and an unchanged one is reused.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import tempfile
from typing import Dict, Iterable, List

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    return str(pathlib.Path(home) / "bin" / "nvcc")


def _target(name: str) -> pathlib.Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def _start(name: str) -> "tuple[subprocess.Popen, pathlib.Path, pathlib.Path]":
    """Start one ``nvcc`` writing to a temporary file beside the target."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    target = _target(name)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, pathlib.Path(tmp), target


def build(names: Iterable[str]) -> List[pathlib.Path]:
    """Compile every named source that has no current library, all ``nvcc``
    processes started together; raises with the compiler's output if one
    fails.  Returns the library paths."""
    names = list(names)
    pending = [_start(n) for n in names if not _target(n).exists()]
    errors = []
    for proc, tmp, target in pending:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            errors.append(f"nvcc failed for {target.name}:\n{log}")
        else:
            os.replace(tmp, target)
    if errors:
        raise RuntimeError("\n".join(errors))
    return [_target(n) for n in names]


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        (path,) = build([name])
        lib = ctypes.CDLL(str(path))
        _LIBS[name] = lib
    return lib


def launch_on(device: int, fn, *args) -> int:
    """Call the C entry ``fn(*args, stream)`` on the current stream of CUDA
    device ``device`` (an index), with that device current; returns its
    error code.  Switches the current device only when it differs: the
    switch costs host time on every launch."""
    import torch
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    stream = raw(device) if raw is not None else \
        torch.cuda.current_stream(device).cuda_stream
    if device == torch.cuda.current_device():
        return fn(*args, stream)
    with torch.cuda.device(device):
        return fn(*args, stream)


def sources() -> List[str]:
    """Names of every CUDA source of the port."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))
