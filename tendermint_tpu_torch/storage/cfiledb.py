"""ctypes binding for the C++ FileDB engine (native/filedb.cc).

A copy of ``tendermint_tpu/storage/cfiledb.py``: the same KVStore
contract and on-disk format as the pure-Python ``storage/filedb.py``.

The library is built at first use with ``g++ -O2 -shared -fPIC`` into
the port's build directory (``build/kernels`` beside the package, listed
in ``.gitignore``, or ``$TENDERMINT_TPU_TORCH_BUILD_DIR``; see
``ops/_build.py``), named after a digest of its source and flags, and
renamed into place atomically. One divergence: the reference's loader
swallows every build error and answers "unavailable"; here a build that
fails raises :class:`NativeBuildError` with the compiler's output.
Only a missing compiler makes :func:`available` false.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import struct
import subprocess
import threading
from typing import Iterator, List, Optional, Tuple

from tendermint_tpu_torch.ops._build import build_dir
from tendermint_tpu_torch.storage.filedb import acquire_db_lock, release_db_lock
from tendermint_tpu_torch.storage.kv import KVStore

SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native", "filedb.cc")
CXX_FLAGS = ["-O2", "-shared", "-fPIC"]
LIBS = ["-lz"]

_U8P = ctypes.POINTER(ctypes.c_uint8)
_UNBOUNDED = 0xFFFFFFFF
_OPHDR = struct.Struct("<BII")
_RNGHDR = struct.Struct("<II")

_lock = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None  # guarded-by: _lock


class NativeBuildError(RuntimeError):
    """``native/filedb.cc`` did not build or load; ``output`` holds what
    the compiler printed."""

    def __init__(self, what: str, output: str = ""):
        super().__init__(f"{what}\n{output}" if output else what)
        self.output = output


def compiler() -> Optional[str]:
    """The C++ compiler the engine is built with, or None."""
    for cc in ("g++", "c++"):
        found = shutil.which(cc)
        if found:
            return found
    return None


def _lib_path() -> str:
    with open(SOURCE, "rb") as fh:
        digest = hashlib.sha256(fh.read() + " ".join(CXX_FLAGS + LIBS).encode()).hexdigest()[:16]
    return os.path.join(build_dir(), f"libfiledb-{digest}.so")


def _build(out: str) -> None:
    cc = compiler()
    if cc is None:
        raise NativeBuildError("no C++ compiler (g++ or c++) on PATH for native/filedb.cc")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run([cc, *CXX_FLAGS, SOURCE, *LIBS, "-o", tmp], capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise NativeBuildError(f"native/filedb.cc did not build (exit {proc.returncode})",
                               proc.stdout + proc.stderr)
    os.replace(tmp, out)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.filedb_open.argtypes = [ctypes.c_char_p]
    lib.filedb_open.restype = ctypes.c_void_p
    lib.filedb_close.argtypes = [ctypes.c_void_p]
    lib.filedb_get.argtypes = [ctypes.c_void_p, _U8P, ctypes.c_uint32, ctypes.POINTER(_U8P)]
    lib.filedb_get.restype = ctypes.c_int64
    lib.filedb_free.argtypes = [ctypes.c_void_p]
    lib.filedb_apply.argtypes = [ctypes.c_void_p, _U8P, ctypes.c_uint64, ctypes.c_int]
    lib.filedb_apply.restype = ctypes.c_int
    lib.filedb_sync.argtypes = [ctypes.c_void_p]
    lib.filedb_sync.restype = ctypes.c_int
    lib.filedb_count.argtypes = [ctypes.c_void_p]
    lib.filedb_count.restype = ctypes.c_uint64
    lib.filedb_garbage.argtypes = [ctypes.c_void_p]
    lib.filedb_garbage.restype = ctypes.c_uint64
    lib.filedb_range.argtypes = [
        ctypes.c_void_p, _U8P, ctypes.c_uint32, _U8P, ctypes.c_uint32, ctypes.c_int, ctypes.POINTER(_U8P),
    ]
    lib.filedb_range.restype = ctypes.c_int64
    lib.filedb_compact.argtypes = [ctypes.c_void_p]
    lib.filedb_compact.restype = ctypes.c_int
    return lib


def load() -> ctypes.CDLL:
    """Build (when stale) and load the engine; raises
    :class:`NativeBuildError` when it does not build or load."""
    global _LIB
    with _lock:
        if _LIB is None:
            out = _lib_path()
            if not os.path.exists(out):
                _build(out)
            try:
                _LIB = _bind(ctypes.CDLL(out))
            except OSError as exc:
                raise NativeBuildError(f"{out} did not load", str(exc)) from exc
        return _LIB


def available() -> bool:
    """Whether the engine can be had here: a compiler is there (a build
    that then fails raises in :func:`load`), or it is loaded already."""
    return _LIB is not None or compiler() is not None


def _buf(b: bytes):
    return (ctypes.c_uint8 * max(len(b), 1)).from_buffer_copy(b or b"\0")


class CFileDB(KVStore):
    """KVStore over the native engine; one handle, internally locked.

    Every call holds ``_lock`` while it uses the handle, and a call after
    :meth:`close` raises ``IOError``: a thread that reads a store its
    node is closing gets an error, never a freed handle."""

    engine = "c"
    COMPACT_MIN_GARBAGE = 4096

    def __init__(self, path: str):
        lib = load()
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._flock = acquire_db_lock(path)
        self._lib = lib
        self._h = lib.filedb_open(path.encode())
        if not self._h:
            release_db_lock(self._flock)
            raise IOError(f"filedb_open failed for {path}")
        self._lock = threading.RLock()

    def _handle(self):
        if not self._h:
            raise IOError("filedb: the store is closed")
        return self._h

    def get(self, key: bytes) -> Optional[bytes]:
        out = _U8P()
        with self._lock:
            n = self._lib.filedb_get(self._handle(), _buf(key), len(key), ctypes.byref(out))
        if n < 0:
            return None
        try:
            return ctypes.string_at(out, n)
        finally:
            self._lib.filedb_free(out)

    def _apply(self, recs: List[Tuple[int, bytes, bytes]], sync: bool) -> None:
        blob = bytearray()
        for op, key, value in recs:
            blob += _OPHDR.pack(op, len(key), len(value))
            blob += key
            blob += value
        with self._lock:
            h = self._handle()
            rc = self._lib.filedb_apply(h, _buf(bytes(blob)), len(blob), 1 if sync else 0)
            if rc != 0:
                raise IOError(f"filedb_apply failed rc={rc}")
            if self._lib.filedb_garbage(h) >= max(self.COMPACT_MIN_GARBAGE, 4 * self._lib.filedb_count(h)):
                self.compact()

    def set(self, key: bytes, value: bytes) -> None:
        self._apply([(1, bytes(key), bytes(value))], sync=False)

    def delete(self, key: bytes) -> None:
        self._apply([(0, bytes(key), b"")], sync=False)

    def apply_batch(self, ops) -> None:
        self._apply([(1 if op == "set" else 0, bytes(k), bytes(v) if v else b"") for op, k, v in ops], sync=True)

    def _range(self, start: Optional[bytes], end: Optional[bytes], reverse: bool) -> Iterator[Tuple[bytes, bytes]]:
        out = _U8P()
        slen = _UNBOUNDED if start is None else len(start)
        elen = _UNBOUNDED if end is None else len(end)
        with self._lock:
            n = self._lib.filedb_range(self._handle(), _buf(start or b""), slen, _buf(end or b""), elen,
                                       1 if reverse else 0, ctypes.byref(out))
        if n < 0:
            raise IOError("filedb_range failed")
        try:
            data = ctypes.string_at(out, n)
        finally:
            self._lib.filedb_free(out)
        off = 0
        while off < len(data):
            klen, vlen = _RNGHDR.unpack_from(data, off)
            off += _RNGHDR.size
            yield data[off: off + klen], data[off + klen: off + klen + vlen]
            off += klen + vlen

    def iterator(self, start=None, end=None):
        return self._range(start, end, reverse=False)

    def reverse_iterator(self, start=None, end=None):
        return self._range(start, end, reverse=True)

    def sync(self) -> None:
        with self._lock:
            self._lib.filedb_sync(self._handle())

    def compact(self) -> None:
        with self._lock:
            rc = self._lib.filedb_compact(self._handle())
        if rc != 0:
            raise IOError(f"filedb_compact failed rc={rc}")

    def close(self) -> None:
        with self._lock:
            if self._h:
                self._lib.filedb_close(self._h)
                self._h = None
            if self._flock is not None:
                release_db_lock(self._flock)
                self._flock = None
