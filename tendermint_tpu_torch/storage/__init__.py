"""Key-value storage and the block store; counterpart of
:mod:`tendermint_tpu.storage`: the store seam, the in-memory store, the
file stores (``filedb.py`` and its C++ engine, ``cfiledb.py``) and the
block store.

``open_db`` is the reference's backend factory (config/db.go:29). The
store it returns tells which engine it runs on (``engine``: ``"py"`` or
``"c"``; ``MemDB`` has none)."""

import os

from tendermint_tpu_torch.storage.kv import Batch, KVStore, MemDB

FILE_BACKENDS = ("filedb", "filedb-c", "filedb-py")


def db_exists(backend: str, db_dir: str, name: str) -> bool:
    """Whether a database with this backend/name already exists on disk
    (memdb never persists). Owns the backend's naming convention so
    callers don't re-derive file paths."""
    if backend in FILE_BACKENDS:
        return bool(db_dir) and os.path.exists(os.path.join(db_dir, name + ".fdb"))
    return False


def open_db(backend: str, db_dir: str = "", name: str = "db") -> KVStore:
    """Backend factory: ``"memdb"``; ``"filedb"`` (persistent, the C++
    engine when a compiler is there to build it, the pure-Python engine
    otherwise); ``"filedb-c"`` / ``"filedb-py"`` force an engine. A
    native build that fails raises ``cfiledb.NativeBuildError``."""
    if backend == "memdb":
        return MemDB()
    if backend in FILE_BACKENDS:
        if not db_dir:
            raise ValueError(f"backend {backend!r} requires a db_dir")
        path = os.path.join(db_dir, name + ".fdb")
        if backend != "filedb-py":
            from tendermint_tpu_torch.storage import cfiledb

            if backend == "filedb-c" or cfiledb.available():
                return cfiledb.CFileDB(path)
        from tendermint_tpu_torch.storage.filedb import FileDB

        return FileDB(path)
    raise ValueError(f"unknown db backend {backend!r}")


__all__ = ["Batch", "KVStore", "MemDB", "FILE_BACKENDS", "db_exists", "open_db"]
