"""ctypes bindings for the framework-free C++ page pool — the port's own copy
of the JAX ``utils/native.py`` ``NativePagePool``.

The pool lives in ``native/sfa_runtime.cc`` at the root of the repo (plain
C ABI, no framework). The port compiles that source with the host C++
compiler into its own gitignored build directory,
``starflashattention_tpu_torch/_build/libsfa_runtime-<source hash>.so``, at
first use, and never writes under ``native/``. :func:`load` returns None
when the source or a compiler is missing; callers then take the
pure-Python twin (``cache.paged.SeqPagePool``), which allocates in the same
order.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from starflashattention_tpu_torch.ops._build import BUILD_DIR

SOURCE = Path(__file__).resolve().parents[2] / "native" / "sfa_runtime.cc"
_lib = None
_tried = False


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"libsfa_runtime-{digest}.so"


def _compile(out: Path) -> None:
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    subprocess.run([cxx, "-O2", "-std=c++17", "-fPIC", "-shared", "-o", str(tmp), str(SOURCE)],
                   check=True, capture_output=True, timeout=120)
    os.replace(tmp, out)  # atomic: a concurrent build never loads a partial file


def load():
    """The loaded CDLL (built on first use), or None if unavailable."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not SOURCE.exists():
        return None
    path = library_path()
    if not path.exists():
        try:
            _compile(path)
        except (RuntimeError, OSError, subprocess.SubprocessError):
            return None
    lib = ctypes.CDLL(str(path))
    lib.sfa_pool_create.restype = ctypes.c_void_p
    lib.sfa_pool_create.argtypes = [ctypes.c_int]
    lib.sfa_pool_destroy.argtypes = [ctypes.c_void_p]
    lib.sfa_pool_free_count.restype = ctypes.c_int
    lib.sfa_pool_free_count.argtypes = [ctypes.c_void_p]
    lib.sfa_pool_seq_new.restype = ctypes.c_int
    lib.sfa_pool_seq_new.argtypes = [ctypes.c_void_p]
    lib.sfa_pool_seq_extend.restype = ctypes.c_int
    lib.sfa_pool_seq_extend.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3
    lib.sfa_pool_seq_pages.restype = ctypes.c_int
    lib.sfa_pool_seq_pages.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                       ctypes.POINTER(ctypes.c_int), ctypes.c_int]
    lib.sfa_pool_seq_free.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.sfa_pool_seq_release_prefix.restype = ctypes.c_int
    lib.sfa_pool_seq_release_prefix.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                                ctypes.POINTER(ctypes.c_int)]
    lib.sfa_pool_free_raw.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int), ctypes.c_int]
    _lib = lib
    return _lib


class NativePagePool:
    """Native-backed per-sequence page allocator (same handle API as
    ``cache.paged.SeqPagePool``)."""

    def __init__(self, num_pages: int):
        lib = load()
        if lib is None:
            raise RuntimeError("native runtime not available")
        self._lib = lib
        self._h = lib.sfa_pool_create(num_pages)
        if not self._h:
            raise ValueError("need at least 2 pages")
        self.num_pages = num_pages

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.sfa_pool_destroy(self._h)
            self._h = None

    @property
    def free_pages(self) -> int:
        return self._lib.sfa_pool_free_count(self._h)

    def seq_new(self) -> int:
        return self._lib.sfa_pool_seq_new(self._h)

    def seq_extend(self, handle: int, new_len: int, page_size: int) -> int:
        n = self._lib.sfa_pool_seq_extend(self._h, handle, new_len, page_size)
        if n < 0:
            raise MemoryError("paged KV pool exhausted")
        return n

    def seq_pages(self, handle: int) -> list[int]:
        cap = self.num_pages
        buf = (ctypes.c_int * cap)()
        n = self._lib.sfa_pool_seq_pages(self._h, handle, buf, cap)
        if n < 0:
            raise KeyError(handle)
        return list(buf[:n])

    def seq_free(self, handle: int) -> None:
        self._lib.sfa_pool_seq_free(self._h, handle)

    def seq_release_prefix(self, handle: int, n: int) -> list[int]:
        buf = (ctypes.c_int * max(n, 1))()
        got = self._lib.sfa_pool_seq_release_prefix(self._h, handle, n, buf)
        if got < 0:
            raise ValueError(f"handle {handle} owns fewer than {n} pages")
        return list(buf[:got])

    def free_raw(self, pages) -> None:
        pages = list(pages)
        buf = (ctypes.c_int * max(len(pages), 1))(*pages)
        self._lib.sfa_pool_free_raw(self._h, buf, len(pages))
