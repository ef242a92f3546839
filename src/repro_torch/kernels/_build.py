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
import re
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["SOURCES", "CSRC", "BUILD_DIR", "NVCC_FLAGS", "nvcc_command",
           "library", "bind", "build_all", "check", "on_card", "require_dtype",
           "resource_usage"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("lords_matmul", "lords_decode", "attn_prefill", "attn_decode",
           "attn_decode_mla", "lords_matmul_t", "lords_grad", "lut_quantize",
           "block_matmul", "block_matmul_t", "block_grad")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas=-v")

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
_LOGS: dict[str, str] = {}  # nvcc's output of the sources built by this process


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
    _LOGS[name] = log


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


_BUILTIN = {"a": "int8_t", "h": "uint8_t", "i": "int", "f": "float", "b": "bool"}


def _demangle(mangled: str) -> str:
    """``name<args>`` of a mangled template kernel <length><name>I<args>E
    whose arguments are integers (Li4E, Lb0E), builtin types (a, h, f) or
    names (13__nv_bfloat16, NS_5PagedE); the mangled name otherwise."""
    # the innermost <length><name>: a namespace's hash may spell one too
    for k in reversed(list(re.finditer(r"(?=(\d+)([A-Za-z_]\w*?_kernel)I)", mangled))):
        if int(k.group(1)) != len(k.group(2)):
            continue
        rest, args = mangled[k.end(2) + 1:], []
        while rest and rest[0] != "E":
            if m := re.match(r"L[ib](\d+)E", rest):  # an integer
                args.append(m.group(1))
                rest = rest[m.end():]
            elif m := re.match(r"(NS_)?(\d+)", rest):  # a name (NS_: in a scope, E-closed)
                end = m.end() + int(m.group(2))
                args.append(rest[m.end():end])
                rest = rest[end + bool(m.group(1)):]
            elif rest[0] in _BUILTIN:
                args.append(_BUILTIN[rest[0]])
                rest = rest[1:]
            else:
                break
        else:
            if rest:
                return f"{k.group(2)}<{', '.join(args)}>"
    return mangled


def resource_usage(name: str, log: str | None = None) -> list[tuple[str, int, int]]:
    """(kernel, registers per thread, spill-store bytes) of each entry
    function of ``csrc/<name>.cu``, from ptxas's report (``-Xptxas=-v``)
    of a build made by this process (or the given log); [] if none was."""
    if log is None:
        log = _LOGS.get(name, "")
    out, kernel, spill = [], None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            kernel = _demangle(m.group(1))
            spill = 0
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and kernel is not None:
            out.append((kernel, int(m.group(1)), spill))
            kernel = None
    return out
