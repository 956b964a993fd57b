"""FileDB: a crash-durable, log-structured persistent KV backend.

A copy of ``tendermint_tpu/storage/filedb.py``, on the same bytes: a
file either package writes, the other reads. The reference runs on goleveldb by default with five other backends
behind the tm-db seam (config/db.go:29, config/config.go:242). This is
the same seam's persistent default here: an append-only record log with
CRC-framed records, an in-memory ordered index, torn-tail truncation on
open (the crash-recovery story of the consensus WAL applied to the
store), and stop-the-world compaction when garbage accumulates.

Two interchangeable engines share the on-disk format byte-for-byte:
this pure-Python one and the C++ engine in native/filedb.cc (loaded via
ctypes; see cfiledb.py). ``open_db`` in storage/__init__.py picks the
C++ engine when ``g++`` is there to build it, this one otherwise; either
can open the other's files.

On-disk format (little-endian):

    file   := magic record*
    magic  := b"TMFDB01\\n"                      (8 bytes)
    record := crc32(payload) u32 | len(payload) u32 | payload
    payload:= op u8 | klen u32 | key | value     (op 1=set, 0=delete)

Durability: writes are buffered by the OS; ``sync()`` fsyncs, and a
Batch.write() with ``sync=True`` (the stores' commit path) is atomic in
the WAL sense — a torn batch tail is dropped on reopen.
"""

from __future__ import annotations

import bisect
import os
import struct
import threading
import zlib
from typing import Dict, List, Optional, Tuple

from tendermint_tpu_torch.storage.kv import KVStore

MAGIC = b"TMFDB01\n"
_HDR = struct.Struct("<II")  # crc, payload length
_OP = struct.Struct("<BI")  # op byte, key length

OP_DEL = 0
OP_SET = 1


def encode_record(op: int, key: bytes, value: bytes = b"") -> bytes:
    payload = _OP.pack(op, len(key)) + key + value
    return _HDR.pack(zlib.crc32(payload), len(payload)) + payload


class DBLockedError(RuntimeError):
    """Another process holds this database (tm-db's file-lock analog)."""


def acquire_db_lock(db_path: str):
    """Exclusive advisory lock on <db>.lock for the db's lifetime.

    Two processes on one FileDB corrupt it silently: the second opener
    (or an operator running compact-db against a RUNNING node) rewrites
    or replaces the log while the first keeps appending to an orphaned
    inode. Fail loudly instead."""
    import fcntl

    fh = open(db_path + ".lock", "a+")
    try:
        fcntl.flock(fh.fileno(), fcntl.LOCK_EX | fcntl.LOCK_NB)
    except OSError:
        fh.close()
        raise DBLockedError(
            f"database {db_path} is locked by another process "
            "(is the node still running?)"
        )
    return fh


def release_db_lock(fh) -> None:
    import fcntl

    try:
        fcntl.flock(fh.fileno(), fcntl.LOCK_UN)
    finally:
        fh.close()


class FileDB(KVStore):
    """Pure-Python engine (see module docstring for the format)."""

    engine = "py"

    def __init__(self, path: str):
        self._path = path
        self._lock = threading.RLock()
        # parent dir must exist before the .lock file can be created
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._flock = acquire_db_lock(path)
        self._index: Dict[bytes, Tuple[int, int]] = {}  # key -> (val off, len)
        self._keys: List[bytes] = []  # sorted
        self._garbage = 0  # count of dead (overwritten/deleted) records
        exists = os.path.exists(path)
        self._f = open(path, "r+b" if exists else "w+b")
        if not exists:
            self._f.write(MAGIC)
            self._f.flush()
            os.fsync(self._f.fileno())
        self._replay()

    # --- open/replay ---------------------------------------------------------

    def _replay(self) -> None:
        """Rebuild the index; truncate at the first torn/corrupt record."""
        f = self._f
        f.seek(0)
        head = f.read(len(MAGIC))
        if head != MAGIC:
            raise IOError(f"{self._path}: bad magic {head!r}")
        off = len(MAGIC)
        size = os.fstat(f.fileno()).st_size
        index: Dict[bytes, Tuple[int, int]] = {}
        while off + _HDR.size <= size:
            hdr = f.read(_HDR.size)
            if len(hdr) < _HDR.size:
                break
            crc, plen = _HDR.unpack(hdr)
            payload = f.read(plen)
            if len(payload) < plen or zlib.crc32(payload) != crc:
                break  # torn tail
            op, klen = _OP.unpack_from(payload)
            key = payload[_OP.size : _OP.size + klen]
            rec_len = _HDR.size + plen
            if op == OP_SET:
                if key in index:
                    self._garbage += 1
                index[key] = (off + _HDR.size + _OP.size + klen, plen - _OP.size - klen)
            else:
                index.pop(key, None)
            off += rec_len
        if off < size:
            f.truncate(off)
        f.seek(0, os.SEEK_END)
        self._index = index
        self._keys = sorted(index)

    # --- KVStore -------------------------------------------------------------

    def get(self, key: bytes) -> Optional[bytes]:
        with self._lock:
            ent = self._index.get(bytes(key))
            if ent is None:
                return None
            off, vlen = ent
            return os.pread(self._f.fileno(), vlen, off)

    def set(self, key: bytes, value: bytes) -> None:
        with self._lock:
            self._append([(OP_SET, bytes(key), bytes(value))], sync=False)

    def delete(self, key: bytes) -> None:
        with self._lock:
            if bytes(key) not in self._index:
                return
            self._append([(OP_DEL, bytes(key), b"")], sync=False)

    def apply_batch(self, ops) -> None:
        recs = [
            (OP_SET if op == "set" else OP_DEL, bytes(k), bytes(v) if v else b"")
            for op, k, v in ops
        ]
        with self._lock:
            self._append(recs, sync=True)

    # Auto-compact once this many dead records accumulate AND they
    # outnumber live keys 4:1 (avoids rewriting small hot stores).
    COMPACT_MIN_GARBAGE = 4096

    def _maybe_compact(self) -> None:
        if self._garbage >= max(self.COMPACT_MIN_GARBAGE, 4 * len(self._keys)):
            self.compact()

    def _append(self, recs, sync: bool) -> None:
        f = self._f
        off = f.tell()
        buf = bytearray()
        for op, key, value in recs:
            rec = encode_record(op, key, value)
            if op == OP_SET:
                if key in self._index:
                    self._garbage += 1
                else:
                    bisect.insort(self._keys, key)
                self._index[key] = (
                    off + len(buf) + _HDR.size + _OP.size + len(key),
                    len(value),
                )
            else:
                if key in self._index:
                    del self._index[key]
                    del self._keys[bisect.bisect_left(self._keys, key)]
                    self._garbage += 1
            buf += rec
        f.write(buf)
        f.flush()
        if sync:
            os.fsync(f.fileno())
        self._maybe_compact()

    def _range(self, start: Optional[bytes], end: Optional[bytes]) -> List[bytes]:
        with self._lock:
            lo = 0 if start is None else bisect.bisect_left(self._keys, start)
            hi = len(self._keys) if end is None else bisect.bisect_left(self._keys, end)
            return self._keys[lo:hi]

    def iterator(self, start=None, end=None):
        for k in self._range(start, end):
            v = self.get(k)
            if v is not None:
                yield k, v

    def reverse_iterator(self, start=None, end=None):
        for k in reversed(self._range(start, end)):
            v = self.get(k)
            if v is not None:
                yield k, v

    def sync(self) -> None:
        with self._lock:
            self._f.flush()
            os.fsync(self._f.fileno())

    def close(self) -> None:
        with self._lock:
            try:
                self._f.flush()
                os.fsync(self._f.fileno())
            finally:
                self._f.close()
                release_db_lock(self._flock)

    # --- compaction ------------------------------------------------------------

    def compact(self) -> None:
        """Rewrite live records to a fresh log and atomically swap it in."""
        with self._lock:
            tmp = self._path + ".compact"
            with open(tmp, "wb") as out:
                out.write(MAGIC)
                for k in self._keys:
                    v = self.get(k)
                    if v is not None:
                        out.write(encode_record(OP_SET, k, v))
                out.flush()
                os.fsync(out.fileno())
            self._f.close()
            os.replace(tmp, self._path)
            self._f = open(self._path, "r+b")
            self._garbage = 0
            self._replay()
