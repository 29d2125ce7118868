"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by its own
``nvcc`` process (all sources at once, in parallel) into
``build/lib<name>-<hash>.so``, where the hash covers the source, the
shared headers (``csrc/*.cuh``) and the flags, so an edited source or
header is rebuilt and an unchanged one is reused. The
libraries are loaded with :mod:`ctypes`: every pointer and the stream are
``ctypes.c_void_p``, every size a ``ctypes.c_int``, and every C entry
returns ``cudaGetLastError()``, which :func:`check` turns into an
exception. Nothing here runs at import time.

Set ``GNN_TRACKING_TORCH_BUILD`` to build elsewhere than ``<repo>/build``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (
    "fused_relational", "fused_relational_bf16", "csr_segment", "pairwise_topk",
    "cc_neighbors", "banded_topk", "ivf_probe", "pairwise_topk_split", "fused_relational_wide",
    "edge_join",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
)

_LIBS: dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    default = Path(__file__).resolve().parent.parent / "build"
    return Path(os.environ.get("GNN_TRACKING_TORCH_BUILD", default))


def nvcc() -> str:
    for var in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(var)
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(found).exists():
        msg = "nvcc not found: put it on PATH or set CUDA_HOME"
        raise RuntimeError(msg)
    return found


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return build_dir() / f"lib{name}-{digest}.so"


def build(*, ptxas_verbose: bool = False) -> dict[str, str]:
    """Compile every library that is not built yet, one
    ``nvcc`` per source, all started together. Returns the compiler's
    output per source that was built (register and shared-memory use with
    ``ptxas_verbose``)."""
    build_dir().mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in SOURCES:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS]
        if ptxas_verbose:
            cmd += ["-Xptxas", "-v"]
        cmd += ["-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        jobs.append((name, out, tmp, proc))
    logs = {}
    failed = []
    for name, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def library(name: str, signatures: dict[str, list]) -> ctypes.CDLL:
    """Load (building first if needed) ``lib<name>`` and declare the C
    entries in ``signatures`` (name -> argtypes; every entry returns int)."""
    lib = _LIBS.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build()
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in signatures.items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        lib.error_string.argtypes = [ctypes.c_int]
        lib.error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = f"{what}: CUDA error {err} ({lib.error_string(err).decode()})"
        raise RuntimeError(msg)


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_ptr(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float
D = ctypes.c_double
