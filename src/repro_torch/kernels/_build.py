"""Build the CUDA sources in ``repro_torch/csrc`` and bind them with ctypes.

Each ``csrc/<name>.cu`` (with the shared ``csrc/*.cuh`` headers) compiles on
its own into ``build/repro_torch/lib<name>-<hash>.so`` at the repository
root, with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC

The file name carries a hash of the sources and flags, so an edited source
builds anew and an unchanged one is loaded as built.  The sources include no
PyTorch header: every entry point is a plain C function taking device
pointers, sizes and the CUDA stream, and returning ``cudaGetLastError()``.
Nothing is built at import time; :func:`library` builds on first use and
:func:`build_all` builds every source at once, one ``nvcc`` process each.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["SOURCES", "CSRC", "BUILD_DIR", "NVCC_FLAGS", "nvcc_command",
           "library", "bind", "build_all", "check", "on_card", "require_dtype"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("lords_matmul", "lords_decode", "attn_prefill", "attn_decode")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo")

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels of "
        "repro_torch are built from source on the machine with the card")


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest(name)}.so"


def nvcc_command(name: str, out: Path, nvcc: str = "nvcc") -> list[str]:
    return [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(out),
            str(CSRC / f"{name}.cu")]


def _start(name: str) -> tuple[subprocess.Popen, Path, Path] | None:
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.Popen(nvcc_command(name, tmp, _nvcc()),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, out


def _finish(name: str, job) -> None:
    if job is None:
        return
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)  # atomic: a reader never sees a partial library


def build_all() -> None:
    """Build every stale source, all ``nvcc`` processes in parallel."""
    with _LOCK:
        jobs = {name: _start(name) for name in SOURCES}
        for name, job in jobs.items():
            _finish(name, job)


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<name>.cu``, built if stale."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            _finish(name, _start(name))
            lib = _LIBS[name] = ctypes.CDLL(str(_lib_path(name)))
        return lib


_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}


def bind(name: str, fn: str, signature: str):
    """The C entry point ``fn`` of ``csrc/<name>.cu``.  ``signature`` has
    one letter per argument: ``p`` a pointer or the stream (``c_void_p``,
    never cut to 32 bits), ``i`` an ``int``, ``f`` a ``float``.  Every entry
    point returns an ``int`` (its ``cudaGetLastError()``)."""
    f = getattr(library(name), fn)
    f.argtypes = [_CTYPES[c] for c in signature]
    f.restype = ctypes.c_int
    return f


def check(err: int, what: str) -> None:
    """Raise if a launch reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def on_card(what: str, **tensors) -> bool:
    """Validate a wrapper's operands and say where they lie.

    All operands must share one device.  True: they are on a CUDA device,
    contiguous and 16-byte aligned, and the wrapper launches its kernel.
    False: they are on the CPU, and the wrapper runs its plain version.
    Any other device raises.
    """
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1:
        raise ValueError(f"{what}: operands on several devices {devices}")
    device = devices.pop()
    if device.type == "cpu":
        return False
    if device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {device}")
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be 16-byte aligned")
    return True


def require_dtype(what: str, t, dtype, name: str) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{what}: {name} must be {dtype}, got {t.dtype}")
