"""The port's file stores: the twin of ``tests/test_filedb.py`` on
``tendermint_tpu_torch.storage``, over both engines (pure Python and
the C++ one built with ``g++`` at first use), and held to the JAX
package's ``FileDB``: the same ops give the same file bytes, and each
package reads the other's files. A native build that fails raises a
typed error with the compiler's output."""

import os
import struct

import pytest

torch = pytest.importorskip("torch")

from tendermint_tpu.storage import cfiledb as jcfiledb
from tendermint_tpu.storage.filedb import FileDB as JFileDB
from tendermint_tpu_torch import storage
from tendermint_tpu_torch.storage import cfiledb, open_db
from tendermint_tpu_torch.storage.filedb import MAGIC, FileDB, encode_record

ENGINES = ["py", "c"]


def make_db(kind, path):
    if kind == "py":
        return FileDB(str(path))
    return cfiledb.CFileDB(str(path))


@pytest.mark.parametrize("kind", ENGINES)
class TestFileDB:
    def test_set_get_delete_persist(self, tmp_path, kind):
        p = tmp_path / "kv.fdb"
        db = make_db(kind, p)
        db.set(b"a", b"1")
        db.set(b"b", b"2")
        db.set(b"a", b"1x")  # overwrite
        db.delete(b"b")
        assert db.get(b"a") == b"1x"
        assert db.get(b"b") is None
        db.close()
        db2 = make_db(kind, p)
        assert db2.get(b"a") == b"1x"
        assert db2.get(b"b") is None
        db2.close()

    def test_iterators_and_ranges(self, tmp_path, kind):
        db = make_db(kind, tmp_path / "kv.fdb")
        for i in range(10):
            db.set(bytes([i]), str(i).encode())
        assert [k for k, _ in db.iterator()] == [bytes([i]) for i in range(10)]
        assert [k for k, _ in db.iterator(bytes([3]), bytes([7]))] == [bytes([i]) for i in range(3, 7)]
        assert [k for k, _ in db.reverse_iterator(bytes([3]), bytes([7]))] == [bytes([i]) for i in range(6, 2, -1)]
        db.close()

    def test_batch_is_atomic_across_reopen(self, tmp_path, kind):
        p = tmp_path / "kv.fdb"
        db = make_db(kind, p)
        b = db.new_batch()
        b.set(b"x", b"1").set(b"y", b"2").delete(b"x")
        b.write()
        db.close()
        db2 = make_db(kind, p)
        assert db2.get(b"x") is None and db2.get(b"y") == b"2"
        db2.close()

    def test_torn_tail_truncated_on_reopen(self, tmp_path, kind):
        p = tmp_path / "kv.fdb"
        db = make_db(kind, p)
        db.set(b"keep", b"v1")
        db.set(b"gone", b"v2")
        db.close()
        size = os.path.getsize(p)
        with open(p, "r+b") as f:
            f.truncate(size - 3)  # tear the last record
        db2 = make_db(kind, p)
        assert db2.get(b"keep") == b"v1"
        assert db2.get(b"gone") is None
        db2.set(b"gone", b"v3")  # tail is writable again
        db2.close()
        db3 = make_db(kind, p)
        assert db3.get(b"gone") == b"v3"
        db3.close()

    def test_corrupt_crc_truncates(self, tmp_path, kind):
        p = tmp_path / "kv.fdb"
        db = make_db(kind, p)
        db.set(b"ok", b"1")
        db.set(b"bad", b"2")
        db.close()
        size = os.path.getsize(p)
        with open(p, "r+b") as f:
            f.seek(size - 1)
            last = f.read(1)
            f.seek(size - 1)
            f.write(bytes([last[0] ^ 0xFF]))
        db2 = make_db(kind, p)
        assert db2.get(b"ok") == b"1"
        assert db2.get(b"bad") is None
        db2.close()

    def test_compact_drops_garbage_keeps_data(self, tmp_path, kind):
        p = tmp_path / "kv.fdb"
        db = make_db(kind, p)
        for i in range(50):
            db.set(b"churn", str(i).encode())
        db.set(b"stable", b"s")
        db.delete(b"churn")
        before = os.path.getsize(p)
        db.compact()
        after = os.path.getsize(p)
        assert after < before
        assert db.get(b"stable") == b"s"
        assert db.get(b"churn") is None
        db.close()
        db2 = make_db(kind, p)
        assert db2.get(b"stable") == b"s"
        db2.close()

    def test_empty_value_roundtrip(self, tmp_path, kind):
        p = tmp_path / "kv.fdb"
        db = make_db(kind, p)
        db.set(b"empty", b"")
        assert db.get(b"empty") == b""
        db.close()
        db2 = make_db(kind, p)
        assert db2.get(b"empty") == b""
        db2.close()


class TestEngineParity:
    def test_python_reads_c_files_and_back(self, tmp_path):
        p = tmp_path / "kv.fdb"
        cdb = cfiledb.CFileDB(str(p))
        cdb.set(b"from-c", b"1")
        cdb.close()
        pydb = FileDB(str(p))
        assert pydb.get(b"from-c") == b"1"
        pydb.set(b"from-py", b"2")
        pydb.close()
        cdb2 = cfiledb.CFileDB(str(p))
        assert cdb2.get(b"from-c") == b"1"
        assert cdb2.get(b"from-py") == b"2"
        assert [k for k, _ in cdb2.iterator()] == [b"from-c", b"from-py"]
        cdb2.close()

    def test_identical_bytes_for_same_ops(self, tmp_path):
        ops = [("set", b"k1", b"v1"), ("set", b"k2", b""), ("del", b"k1", None)]
        pc, pp = tmp_path / "c.fdb", tmp_path / "p.fdb"
        cdb = cfiledb.CFileDB(str(pc))
        cdb.apply_batch(ops)
        cdb.close()
        pydb = FileDB(str(pp))
        pydb.apply_batch(ops)
        pydb.close()
        assert pc.read_bytes() == pp.read_bytes()


def test_open_db_factory(tmp_path):
    mem = open_db("memdb")
    mem.set(b"k", b"v")
    db = open_db("filedb", str(tmp_path), "test")
    assert db.engine == "c"  # a compiler is here, so the reference's choice is the C++ engine
    db.set(b"k", b"v")
    db.close()
    db2 = open_db("filedb-py", str(tmp_path), "test")
    assert db2.engine == "py" and db2.get(b"k") == b"v"
    db2.close()
    db3 = open_db("filedb-c", str(tmp_path), "test")
    assert db3.engine == "c" and db3.get(b"k") == b"v"
    db3.close()
    assert storage.db_exists("filedb", str(tmp_path), "test")
    assert not storage.db_exists("filedb", str(tmp_path), "other")
    assert not storage.db_exists("memdb", str(tmp_path), "test")
    with pytest.raises(ValueError):
        open_db("filedb")  # requires db_dir
    with pytest.raises(ValueError):
        open_db("rocksdb")


def test_record_encoding_stable():
    rec = encode_record(1, b"k", b"v")
    crc, plen = struct.unpack("<II", rec[:8])
    assert plen == 5 + 1 + 1
    assert rec[8] == 1
    assert struct.unpack("<I", rec[9:13])[0] == 1
    assert rec[13:14] == b"k" and rec[14:15] == b"v"
    assert MAGIC == b"TMFDB01\n"


# --- held to the JAX package -----------------------------------------------------


def _seeded_ops(seed, n=300):
    """A seeded stream of sets, overwrites and deletes over a few keys."""
    import numpy as np

    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(n):
        key = b"key-%03d" % int(rng.integers(0, 40))
        if rng.random() < 0.2:
            ops.append(("del", key, None))
        else:
            ops.append(("set", key, rng.bytes(int(rng.integers(0, 200)))))
    return ops


def _apply(db, ops):
    for i in range(0, len(ops), 7):  # single writes and batches, in turns
        chunk = ops[i:i + 7]
        if (i // 7) % 2:
            db.apply_batch(chunk)
        else:
            for op, k, v in chunk:
                db.set(k, v) if op == "set" else db.delete(k)


def _jax_db(kind, path):
    return JFileDB(str(path)) if kind == "py" else jcfiledb.CFileDB(str(path))


@pytest.mark.parametrize("kind", ENGINES)
def test_the_same_ops_give_the_jax_packages_file_bytes(tmp_path, kind):
    """Engine for engine: the reference's two engines differ on a delete
    of an absent key (the Python one writes nothing, the C++ one a
    record), and the port keeps that."""
    ops = _seeded_ops(17)
    port_path, jax_path = tmp_path / "port.fdb", tmp_path / "jax.fdb"
    db = make_db(kind, port_path)
    _apply(db, ops)
    db.compact()  # the compacted log too
    _apply(db, ops[:50])
    db.close()
    jdb = _jax_db(kind, jax_path)
    _apply(jdb, ops)
    jdb.compact()
    _apply(jdb, ops[:50])
    jdb.close()
    assert port_path.read_bytes() == jax_path.read_bytes()


@pytest.mark.parametrize("kind", ENGINES)
def test_each_package_reads_the_others_files(tmp_path, kind):
    ops = _seeded_ops(23)
    p = tmp_path / "shared.fdb"
    db = make_db(kind, p)
    _apply(db, ops)
    want = dict(db.iterator())
    db.close()
    jdb = JFileDB(str(p))
    assert dict(jdb.iterator()) == want
    first = sorted(want)[0]
    jdb.set(b"from-jax", b"j")
    jdb.delete(first)
    want[b"from-jax"] = b"j"
    del want[first]
    jdb.close()
    db = make_db(kind, p)
    assert dict(db.iterator()) == want
    assert [k for k, _ in db.reverse_iterator()] == sorted(want, reverse=True)
    db.close()


def test_a_failed_native_build_raises_a_typed_error_with_the_compilers_output(tmp_path, monkeypatch):
    """The reference's loader swallows a failed build and answers
    "unavailable"; the port's raises ``NativeBuildError`` with what the
    compiler printed, from ``open_db`` too."""
    broken = tmp_path / "filedb.cc"
    broken.write_text("this is not C++;\n")
    monkeypatch.setenv("TENDERMINT_TPU_TORCH_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(cfiledb, "SOURCE", str(broken))
    monkeypatch.setattr(cfiledb, "_LIB", None)
    with pytest.raises(cfiledb.NativeBuildError) as err:
        cfiledb.CFileDB(str(tmp_path / "a.fdb"))
    assert "filedb.cc" in err.value.output and "error" in err.value.output
    for backend in ("filedb", "filedb-c"):
        with pytest.raises(cfiledb.NativeBuildError):
            open_db(backend, str(tmp_path), backend)
    assert not os.listdir(tmp_path / "build")  # nothing half-built left in place
    monkeypatch.setattr(cfiledb, "compiler", lambda: None)
    with pytest.raises(cfiledb.NativeBuildError, match="no C\\+\\+ compiler"):
        open_db("filedb-c", str(tmp_path), "c")
    db = open_db("filedb", str(tmp_path), "py")  # no compiler: the reference's fallback
    assert db.engine == "py"
    db.close()
