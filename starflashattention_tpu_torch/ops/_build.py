"""Build the CUDA sources in ``csrc/`` with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own into
``_build/<name>-<hash>.so`` (the hash is of the source, so an edited source
never loads a stale library). ``build`` starts one ``nvcc`` per source, all
at once, and waits for them together. Nothing here runs at import time:
importing the package needs neither ``nvcc`` nor a card.

Every C entry point takes its pointers and the CUDA stream as ``void*``
(ctypes would otherwise pass them as 32-bit ints) and returns
``cudaGetLastError()`` after its launch; :func:`check` raises on a non-zero
code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
SOURCES = ("cache_append", "quant_matmul", "flash_decode", "flash_prefill")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names=SOURCES) -> dict[str, dict]:
    """Compile every source in ``names`` that has no up-to-date library,
    one ``nvcc`` process per source, all started together. Returns
    ``{name: {"seconds": s, "ptxas": text}}`` for the ones compiled;
    raises with the compiler output if any fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
               "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
               "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       time.perf_counter(), tmp, out)
    results, failed = {}, []
    for name, (proc, t0, tmp, out) in procs.items():
        log, _ = proc.communicate()
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name}.cu (rc {proc.returncode}) ---\n{log}")
            continue
        os.replace(tmp, out)
        results[name] = {"seconds": secs, "ptxas": log}
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return results


def load(name: str, signatures: dict[str, list]) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (built on first use), with
    ``argtypes``/``restype`` set from ``signatures`` ({function: argtypes})."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.error_string.argtypes = [ctypes.c_int]
        lib.error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_ptr(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float
