"""The port's part sets, block store, state store and genesis document
beside the JAX package's: twins of ``tests/test_part_set.py`` and of the
store and genesis parts of ``tests/test_storage.py``, and blocks the JAX
package built, carried as proto bytes, decoding in the port to the same
hash, part-set root and ``BlockMeta``. Equality is exact."""

import hashlib
import os

import numpy as np
import pytest

pytest.importorskip("torch")

from tendermint_tpu.types import Commit as JCommit, Consensus as JConsensus, make_block as jmake_block
from tendermint_tpu.types.block import BlockID as JBlockID
from tendermint_tpu.types.block_meta import BlockMeta as JBlockMeta
from tendermint_tpu.types.genesis import GenesisDoc as JGenesisDoc
from tendermint_tpu.types.part_set import PartSet as JPartSet
from tendermint_tpu.storage import MemDB as JMemDB
from tendermint_tpu.storage.blockstore import BlockStore as JBlockStore
from tendermint_tpu_torch.crypto import merkle
from tendermint_tpu_torch.encoding.canonical import Timestamp
from tendermint_tpu_torch.state import StateStore, state_from_genesis
from tendermint_tpu_torch.storage.blockstore import BlockStore
from tendermint_tpu_torch.storage.kv import MemDB
from tendermint_tpu_torch.types.block import (
    BLOCK_PART_SIZE_BYTES,
    Block,
    BlockID,
    Commit,
    Consensus,
    Data,
    Header,
    PartSetHeader,
    make_block,
)
from tendermint_tpu_torch.types.block_meta import BlockMeta
from tendermint_tpu_torch.types.genesis import GenesisDoc, GenesisValidator
from tendermint_tpu_torch.types.part_set import Part, PartSet
from tests import helpers as jhelpers
from tests.test_torch_execution import CHAIN_ID, make_commit, make_validators


def make_block_id(seed=b"block"):
    return BlockID(hashlib.sha256(seed).digest(), PartSetHeader(1, hashlib.sha256(seed + b"-parts").digest()))


# --- tests/test_part_set.py ------------------------------------------------------


class TestPartSet:
    def test_from_data_complete(self):
        data = os.urandom(5000)
        ps = PartSet.from_data(data, part_size=1024)
        assert ps.total == 5 and ps.is_complete() and ps.get_reader() == data

    def test_incremental_assembly(self):
        data = os.urandom(5000)
        src = PartSet.from_data(data, part_size=1024)
        dst = PartSet(src.header())
        for i in reversed(range(src.total)):
            assert dst.add_part(src.get_part(i))
        assert dst.is_complete() and dst.get_reader() == data

    def test_duplicate_part_ignored(self):
        src = PartSet.from_data(os.urandom(3000), part_size=1024)
        dst = PartSet(src.header())
        assert dst.add_part(src.get_part(0))
        assert not dst.add_part(src.get_part(0))

    def test_bad_proof_rejected(self):
        src = PartSet.from_data(os.urandom(3000), part_size=1024)
        other = PartSet.from_data(os.urandom(3000), part_size=1024)
        with pytest.raises(ValueError, match="proof"):
            PartSet(src.header()).add_part(other.get_part(0))

    def test_tampered_bytes_rejected(self):
        data = np.random.default_rng(20261017).integers(0, 256, 3000, dtype=np.uint8).tobytes()
        src = PartSet.from_data(data, part_size=1024)
        p = src.get_part(1)
        tampered = bytes([p.bytes[0] ^ 1]) + p.bytes[1:]  # one bit flipped: always a change
        with pytest.raises(ValueError, match="proof"):
            PartSet(src.header()).add_part(Part(index=1, bytes=tampered, proof=p.proof))

    def test_part_proto_roundtrip(self):
        p = PartSet.from_data(os.urandom(3000), part_size=1024).get_part(2)
        back = Part.from_proto_bytes(p.to_proto_bytes())
        assert back.index == p.index and back.bytes == p.bytes and back.proof == p.proof


@pytest.mark.parametrize("n_bytes,part_size", [(0, 1024), (1, 1024), (5000, 1024), (70_000, 65536),
                                                (9000, 1000)])
def test_part_sets_and_proofs_equal_the_reference(n_bytes, part_size):
    data = bytes(np.random.default_rng(n_bytes).integers(0, 256, n_bytes, dtype=np.uint8))
    tps = PartSet.from_data(data, part_size=part_size)
    jps = JPartSet.from_data(data, part_size=part_size)
    assert (tps.total, tps.hash) == (jps.total, jps.hash)
    for i in range(tps.total):
        assert tps.get_part(i).to_proto_bytes() == jps.get_part(i).to_proto_bytes()
        assert tps.get_part(i).proof.verify(tps.hash, tps.get_part(i).bytes)
    # a proof for another index or a cut aunt list does not verify
    if tps.total > 1:
        p = tps.get_part(0)
        assert not merkle.Proof(p.proof.total, 1, p.proof.leaf_hash, p.proof.aunts).verify(tps.hash, p.bytes)
        assert not merkle.Proof(p.proof.total, 0, p.proof.leaf_hash, p.proof.aunts[:-1]).verify(tps.hash, p.bytes)


# --- tests/test_storage.py --------------------------------------------------------


class TestMemDB:
    def test_ordering_and_range(self):
        db = MemDB()
        for k in [b"b", b"a", b"c", b"aa"]:
            db.set(k, k.upper())
        assert [k for k, _ in db.iterator()] == [b"a", b"aa", b"b", b"c"]
        assert [k for k, _ in db.iterator(b"aa", b"c")] == [b"aa", b"b"]
        assert [k for k, _ in db.reverse_iterator()] == [b"c", b"b", b"aa", b"a"]
        db.delete(b"aa")
        assert db.get(b"aa") is None
        assert [k for k, _ in db.iterator()] == [b"a", b"b", b"c"]

    def test_batch_atomicity(self):
        db = MemDB()
        b = db.new_batch()
        b.set(b"x", b"1").set(b"y", b"2").delete(b"x")
        assert db.get(b"x") is None and db.get(b"y") is None
        b.write()
        assert db.get(b"x") is None and db.get(b"y") == b"2"


def _make_saved_chain(n_heights=3, n_vals=3, pkg="port"):
    """``tests/test_storage.py`` ``_make_saved_chain``, in either package
    from the same seeded keys."""
    if pkg == "port":
        privs, vset = make_validators(n_vals)
        sign, store, mk, bid_cls, ps, cons, commit_cls = (
            make_commit, BlockStore(MemDB()), make_block, BlockID, PartSet, Consensus, Commit)
        block_id = make_block_id
    else:
        privs, vset = jhelpers.make_validators(n_vals)
        sign, store, mk, bid_cls, ps, cons, commit_cls = (
            jhelpers.make_commit, JBlockStore(JMemDB()), jmake_block, JBlockID, JPartSet, JConsensus, JCommit)
        block_id = jhelpers.make_block_id
    blocks = []
    prev_commit = None
    prev_bid = block_id(b"genesis")
    for h in range(1, n_heights + 1):
        last_commit = prev_commit or commit_cls()
        block = mk(h, [b"tx-%d" % h], last_commit)
        block.header.version = cons(block=11)
        block.header.chain_id = CHAIN_ID
        block.header.time = Timestamp.from_unix_ns(1_700_000_000_000_000_000 + h) if pkg == "port" \
            else type(block.header.time).from_unix_ns(1_700_000_000_000_000_000 + h)
        block.header.validators_hash = vset.hash()
        block.header.next_validators_hash = vset.hash()
        block.header.proposer_address = vset.validators[0].address
        block.header.last_block_id = prev_bid
        parts = ps.from_data(block.to_proto_bytes(), part_size=1024)
        bid = bid_cls(block.hash(), parts.header())
        seen = sign(bid, h, 0, vset, privs)
        store.save_block(block, parts, seen)
        blocks.append((block, bid, seen))
        prev_bid = bid
        prev_commit = seen
    return store, blocks, vset, privs


class TestBlockStore:
    def test_save_load_roundtrip(self):
        store, blocks, _, _ = _make_saved_chain()
        assert store.base() == 1 and store.height() == 3 and store.size() == 3
        for h, (block, bid, seen) in enumerate(blocks, start=1):
            assert store.load_block_meta(h).block_id == bid
            loaded = store.load_block(h)
            assert loaded.hash() == block.hash() and loaded.data.txs == block.data.txs
        c2 = store.load_block_commit(2)
        assert c2 is not None and c2.height == 2
        assert store.load_seen_commit().height == 3

    def test_load_by_hash(self):
        store, blocks, _, _ = _make_saved_chain()
        block = blocks[1][0]
        assert store.load_block_by_hash(block.hash()).hash() == block.hash()
        assert store.load_block_by_hash(b"\x00" * 32) is None

    def test_contiguity_enforced(self):
        store, blocks, vset, privs = _make_saved_chain(2)
        block = make_block(7, [], make_commit(make_block_id(), 6, 0, vset, privs))
        block.header.validators_hash = vset.hash()
        parts = PartSet.from_data(block.to_proto_bytes(), part_size=1024)
        with pytest.raises(ValueError, match="contiguous"):
            store.save_block(block, parts, make_commit(make_block_id(), 7, 0, vset, privs))

    def test_prune(self):
        store, _, _, _ = _make_saved_chain(3)
        assert store.prune_blocks(3) == 2
        assert store.base() == 3
        assert store.load_block(1) is None and store.load_block(3) is not None

    def test_reopen_recovers_height(self):
        store, _, _, _ = _make_saved_chain(3)
        reopened = BlockStore(store._db)
        assert reopened.base() == 1 and reopened.height() == 3


def test_jax_built_blocks_decode_in_the_port_to_the_same_hash_parts_and_meta():
    jstore, jblocks, _, _ = _make_saved_chain(4, pkg="jax")
    tstore, tblocks, _, _ = _make_saved_chain(4, pkg="port")
    for h in range(1, 5):
        jblock = jstore.load_block(h)
        raw = jblock.to_proto_bytes()
        block = Block.from_proto_bytes(raw)
        assert block.to_proto_bytes() == raw
        assert block.hash() == jblock.hash() == tblocks[h - 1][0].hash()
        tps = PartSet.from_data(raw, BLOCK_PART_SIZE_BYTES)
        jps = JPartSet.from_data(raw, BLOCK_PART_SIZE_BYTES)
        assert tps.header().hash == jps.header().hash and tps.total == jps.total
        jmeta = jstore.load_block_meta(h)
        assert BlockMeta.from_proto_bytes(jmeta.to_proto_bytes()).to_proto_bytes() == jmeta.to_proto_bytes()
        assert tstore.load_block_meta(h).to_proto_bytes() == jmeta.to_proto_bytes()
        tmeta = BlockMeta.from_block(block, tps.byte_size, BlockID(block.hash(), tps.header()))
        assert tmeta.to_proto_bytes() == JBlockMeta.from_block(
            jblock, jps.byte_size, JBlockID(jblock.hash(), jps.header())).to_proto_bytes()
    assert tstore.load_seen_commit().to_proto_bytes() == jstore.load_seen_commit().to_proto_bytes()


def test_a_block_with_evidence_decodes_saves_and_hashes_as_the_jax_package_s():
    """A JAX block carrying a duplicate vote, saved in a JAX store: the
    port decodes it to the same bytes, block hash, evidence hash and
    part-set root, builds the same block from its own copy of the
    evidence, and saves and loads it in its store unchanged."""
    from tendermint_tpu.types.evidence import DuplicateVoteEvidence as JDuplicateVoteEvidence
    from tendermint_tpu_torch.types.evidence import evidence_from_proto_bytes, evidence_list_hash
    from tests.test_vote_set import signed_vote as jsigned_vote

    jstore, jblocks, jvset, jprivs = _make_saved_chain(1, pkg="jax")
    jvotes = [jsigned_vote(jprivs[2], jvset, 2, height=1, block_id=jhelpers.make_block_id(seed))
              for seed in (b"a", b"b")]
    jev = JDuplicateVoteEvidence.new(*jvotes, type(jvotes[0].timestamp).from_unix_ns(1_700_000_000_000_000_001),
                                     jvset)
    jblock = jmake_block(2, [b"tx-2"], jblocks[0][2], evidence=[jev])
    jblock.header.chain_id = CHAIN_ID
    jblock.header.last_block_id = jblocks[0][1]
    jblock.header.proposer_address = jvset.validators[0].address
    jparts = JPartSet.from_data(jblock.to_proto_bytes(), part_size=1024)
    jstore.save_block(jblock, jparts, jblocks[0][2])
    raw = jstore.load_block(2).to_proto_bytes()

    block = Block.from_proto_bytes(raw)
    assert block.to_proto_bytes() == raw and block.hash() == jblock.hash()
    assert [ev.hash() for ev in block.evidence] == [jev.hash()]
    assert block.header.evidence_hash == evidence_list_hash(block.evidence) == jblock.evidence_hash()
    block.validate_basic()
    ev = evidence_from_proto_bytes(jev.to_proto_bytes())
    mine = make_block(2, [b"tx-2"], Commit.from_proto_bytes(jblocks[0][2].to_proto_bytes()), evidence=[ev])
    mine.header.chain_id = CHAIN_ID
    mine.header.last_block_id = BlockID.from_proto_bytes(jblocks[0][1].to_proto_bytes())
    mine.header.proposer_address = jvset.validators[0].address
    assert mine.to_proto_bytes() == raw and mine.hash() == jblock.hash()
    parts = PartSet.from_data(raw, part_size=1024)
    assert parts.header().hash == jparts.header().hash
    store, _, _, _ = _make_saved_chain(1)
    store.save_block(mine, parts, Commit.from_proto_bytes(jblocks[0][2].to_proto_bytes()))
    assert store.load_block(2).to_proto_bytes() == raw
    ev.vote_a, ev.vote_b = ev.vote_b, ev.vote_a  # out of order: validate_basic refuses the block
    with pytest.raises(ValueError, match="invalid order"):
        Block.from_proto_bytes(mine.to_proto_bytes()).validate_basic()


def _genesis_state(n_vals=3):
    privs, vset = make_validators(n_vals)
    gen = GenesisDoc(
        chain_id=CHAIN_ID,
        genesis_time=Timestamp.from_unix_ns(1_700_000_000_000_000_000),
        validators=[GenesisValidator(pub_key=v.pub_key, power=v.voting_power) for v in vset.validators],
    )
    return privs, state_from_genesis(gen)


class TestStateStore:
    def test_save_load_roundtrip(self):
        _, state = _genesis_state()
        store = StateStore(MemDB())
        store.save(state)
        loaded = store.load()
        assert loaded.chain_id == state.chain_id and loaded.last_block_height == 0
        assert loaded.validators.hash() == state.validators.hash()
        assert loaded.next_validators.hash() == state.next_validators.hash()
        assert loaded.consensus_params == state.consensus_params
        assert loaded.initial_height == 1

    def test_load_validators_at_heights(self):
        _, state = _genesis_state()
        store = StateStore(MemDB())
        store.save(state)
        assert store.load_validators(1).hash() == state.validators.hash()
        v2 = store.load_validators(2)
        assert v2.hash() == state.next_validators.hash()
        assert [v.proposer_priority for v in v2.validators] == [
            v.proposer_priority for v in state.next_validators.validators]

    def test_genesis_state_structure(self):
        _, state = _genesis_state()
        assert state.last_validators.is_nil_or_empty()
        assert len(state.validators) == 3
        assert state.next_validators.hash() == state.validators.hash()

    def test_finalize_responses(self):
        store = StateStore(MemDB())
        store.save_finalize_block_response(5, b"resp5")
        assert store.load_finalize_block_response(5) == b"resp5"
        assert store.load_finalize_block_response(6) is None


class TestGenesisDoc:
    def test_json_roundtrip(self, tmp_path):
        _, vset = make_validators(2)
        gen = GenesisDoc(
            chain_id=CHAIN_ID,
            genesis_time=Timestamp.from_unix_ns(1_700_000_000_123_456_789),
            validators=[GenesisValidator(pub_key=v.pub_key, power=v.voting_power) for v in vset.validators],
            app_state=b'{"accounts": 3}',
        )
        gen.validate_and_complete()
        path = str(tmp_path / "genesis.json")
        gen.save_as(path)
        back = GenesisDoc.from_file(path)
        assert back.chain_id == gen.chain_id and back.genesis_time == gen.genesis_time
        assert back.initial_height == 1
        assert [v.pub_key for v in back.validators] == [v.pub_key for v in gen.validators]
        assert back.validator_set().hash() == vset.hash()
        # the JSON carries the chain across: the JAX package reads the same doc
        jback = JGenesisDoc.from_json(gen.to_json())
        assert jback.to_json() == gen.to_json()
        assert jback.validator_set().hash() == vset.hash()

    def test_rejects_zero_power(self):
        _, vset = make_validators(1)
        gen = GenesisDoc(chain_id=CHAIN_ID,
                         validators=[GenesisValidator(pub_key=vset.validators[0].pub_key, power=0)])
        with pytest.raises(ValueError, match="voting power"):
            gen.validate_and_complete()


def test_genesis_state_and_its_store_equal_the_reference():
    """A genesis of three key types through JSON into both packages: the
    same states, the same state-store bytes."""
    from tendermint_tpu.state import StateStore as JStateStore, state_from_genesis as jstate_from_genesis
    from tendermint_tpu_torch.crypto.keys import Ed25519PrivKey, Secp256k1PrivKey
    from tendermint_tpu_torch.crypto.sr25519 import Sr25519PrivKey

    keys = [Ed25519PrivKey.from_seed(b"\x01" * 32), Secp256k1PrivKey(b"\x02" * 32),
            Sr25519PrivKey(b"\x03" * 32), Ed25519PrivKey.from_seed(b"\x04" * 32)]
    gen = GenesisDoc(chain_id=CHAIN_ID, genesis_time=Timestamp.from_unix_ns(1_700_000_000_000_000_000),
                     validators=[GenesisValidator(pub_key=k.pub_key(), power=10 + i)
                                 for i, k in enumerate(keys)])
    gen.consensus_params = None
    gen.validate_and_complete()
    gen.consensus_params.validator.pub_key_types = ["ed25519", "secp256k1", "sr25519"]
    raw = gen.to_json()
    tstate = state_from_genesis(GenesisDoc.from_json(raw))
    jstate = jstate_from_genesis(JGenesisDoc.from_json(raw))
    tdb, jdb = MemDB(), JMemDB()
    StateStore(tdb).save(tstate)
    JStateStore(jdb).save(jstate)
    assert list(tdb.iterator()) == list(jdb.iterator())
    assert StateStore(tdb).load_validators(2).hash() == JStateStore(jdb).load_validators(2).hash()


def test_save_block_is_one_atomic_batch():
    """``tests/test_storage.py``'s crash-consistency check: block data and
    the seen commit land in ONE batch write."""
    db = MemDB()
    writes = []
    orig_new_batch = db.new_batch

    def counting_new_batch():
        b = orig_new_batch()
        orig_write = b.write

        def write():
            writes.append(1)
            return orig_write()

        b.write = write
        return b

    db.new_batch = counting_new_batch
    bs = BlockStore(db)
    privs, vset = make_validators(2)
    header = Header(chain_id=CHAIN_ID, height=1, time=Timestamp.from_unix_ns(1_700_000_000_000_000_000),
                    validators_hash=vset.hash(), next_validators_hash=vset.hash(),
                    proposer_address=vset.validators[0].address)
    block = Block(header=header, data=Data(txs=[]), last_commit=None)
    parts = PartSet.from_data(block.to_proto_bytes(), BLOCK_PART_SIZE_BYTES)
    bs.save_block(block, parts, make_commit(make_block_id(b"atomic"), 1, 0, vset, privs))
    assert len(writes) == 1
    assert bs.load_seen_commit() is not None and bs.load_block_meta(1) is not None
