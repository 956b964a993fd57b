"""The port's BlockExecutor against the kvstore app, beside the JAX
package's: the twin of ``tests/test_execution.py``, and one seeded chain
built in both packages, hash for hash.

The port runs on ``device="cpu"``; every commit here has fewer than 16
signatures, so both packages verify LastCommits on the host tier and the
JAX package traces nothing. Equality is exact: hashes, priorities and
error messages."""

import base64

import pytest

pytest.importorskip("torch")

import tendermint_tpu_torch
from tendermint_tpu.abci import types as jabci
from tendermint_tpu.crypto.keys import Ed25519PrivKey as JEd25519PrivKey
from tendermint_tpu.state.execution import InvalidBlockError as JInvalidBlockError
from tendermint_tpu.types import BlockID as JBlockID, ExtendedCommit as JExtendedCommit
from tendermint_tpu.types.part_set import PartSet as JPartSet
from tendermint_tpu_torch.abci import types as abci
from tendermint_tpu_torch.abci.client import LocalClient
from tendermint_tpu_torch.abci.kvstore import KVStoreApplication
from tendermint_tpu_torch.crypto.keys import Ed25519PrivKey
from tendermint_tpu_torch.encoding.canonical import Timestamp
from tendermint_tpu_torch.state import StateStore, state_from_genesis
from tendermint_tpu_torch.state.execution import BlockExecutor, InvalidBlockError
from tendermint_tpu_torch.storage.blockstore import BlockStore
from tendermint_tpu_torch.storage.kv import MemDB
from tendermint_tpu_torch.types.block import (
    BLOCK_ID_FLAG_ABSENT,
    BLOCK_ID_FLAG_COMMIT,
    BLOCK_ID_FLAG_NIL,
    BlockID,
    Commit,
    CommitSig,
    ExtendedCommit,
)
from tendermint_tpu_torch.types.genesis import GenesisDoc, GenesisValidator
from tendermint_tpu_torch.types.part_set import PartSet
from tendermint_tpu_torch.types.validator import Validator
from tendermint_tpu_torch.types.validator_set import ValidatorSet
from tests import helpers as jhelpers
from tests import test_execution as jexec

CHAIN_ID = jhelpers.CHAIN_ID
BASE_NS = jexec.BASE_NS


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(tendermint_tpu_torch, "DEFAULT_DEVICE", "cpu")


# --- the port's twins of tests/helpers.py and tests/test_execution.py ---------


def make_validators(n, power=10, key_factory=None):
    """``tests/helpers.py`` ``make_validators`` in the port: the same
    seeded keys, the private keys in the set's order."""
    if key_factory is None:
        key_factory = lambda i: Ed25519PrivKey.from_seed(i.to_bytes(32, "big"))
    privs = [key_factory(i) for i in range(n)]
    vset = ValidatorSet([Validator(p.pub_key(), power) for p in privs])
    by_addr = {p.pub_key().address(): p for p in privs}
    return [by_addr[v.address] for v in vset.validators], vset


def make_commit(block_id, height, round_, vset, privs, chain_id=CHAIN_ID, absent=None,
                nil_votes=None, time_ns=BASE_NS):
    """``tests/helpers.py`` ``make_commit`` in the port."""
    absent = absent or set()
    nil_votes = nil_votes or set()
    sigs = []
    commit = Commit(height=height, round=round_, block_id=block_id)
    for i, val in enumerate(vset.validators):
        if i in absent:
            sigs.append(CommitSig.absent())
            continue
        flag = BLOCK_ID_FLAG_NIL if i in nil_votes else BLOCK_ID_FLAG_COMMIT
        cs = CommitSig(flag, val.address, Timestamp.from_unix_ns(time_ns + i), b"")
        commit.signatures.append(cs)
        cs.signature = privs[i].sign(commit.vote_sign_bytes(chain_id, len(commit.signatures) - 1))
        commit.signatures.pop()
        sigs.append(cs)
    commit.signatures = sigs
    return commit


def make_chain_env(n_vals=4, key_factory=None):
    privs, vset = make_validators(n_vals, key_factory=key_factory)
    gen = GenesisDoc(
        chain_id=CHAIN_ID,
        genesis_time=Timestamp.from_unix_ns(BASE_NS),
        validators=[GenesisValidator(pub_key=v.pub_key, power=v.voting_power) for v in vset.validators],
    )
    state = state_from_genesis(gen)
    app = KVStoreApplication()
    client = LocalClient(app)
    client.start()
    state.app_hash = client.init_chain(abci.RequestInitChain(chain_id=CHAIN_ID, initial_height=1)).app_hash
    state_store = StateStore(MemDB())
    state_store.save(state)
    clock = {"ns": BASE_NS}

    def now():
        clock["ns"] += 1_000_000_000
        return Timestamp.from_unix_ns(clock["ns"])

    executor = BlockExecutor(state_store, client, BlockStore(MemDB()), now=now, device="cpu")
    return executor, state, privs, vset, app


class _Pool:
    def __init__(self, txs):
        self.txs = txs

    def lock(self):
        pass

    def unlock(self):
        pass

    def reap_max_bytes_max_gas(self, mb, mg):
        return self.txs

    def update(self, *a, **k):
        pass

    def remove_tx_by_key(self, key):
        pass


def advance_one_height(executor, state, privs, vset, txs, last_ec):
    """``tests/test_execution.py`` ``advance_one_height`` in the port."""
    height = state.last_block_height + 1
    executor.mempool = _Pool(txs)
    block = executor.create_proposal_block(height, state, last_ec, state.validators.get_proposer().address)
    assert executor.process_proposal(block, state)
    parts = PartSet.from_data(block.to_proto_bytes())
    block_id = BlockID(block.hash(), parts.header())
    new_state = executor.apply_block(state, block_id, block)
    executor.block_store.save_block(block, parts, make_commit(block_id, height, 0, vset, privs))
    commit = make_commit(block_id, height, 0, vset, privs, time_ns=BASE_NS + height * 1_000_000_000)
    return new_state, ExtendedCommit.wrap_commit(commit)


class TestChainSlice:
    def test_three_heights_with_txs(self):
        executor, state, privs, vset, app = make_chain_env()
        ec = ExtendedCommit()
        hashes = [state.app_hash]
        for h, txs in enumerate([[b"a=1"], [b"b=2", b"c=3"], []], start=1):
            state, ec = advance_one_height(executor, state, privs, vset, txs, ec)
            assert state.last_block_height == h
            hashes.append(state.app_hash)
        assert app.query(abci.RequestQuery(data=b"b")).value == b"2"
        assert hashes[1] != hashes[0] and hashes[2] != hashes[1]
        for h in (1, 2, 3, 4):
            executor.state_store.load_validators(h)

    def test_reloaded_state_matches(self):
        executor, state, privs, vset, app = make_chain_env()
        state, ec = advance_one_height(executor, state, privs, vset, [b"x=9"], ExtendedCommit())
        loaded = executor.state_store.load()
        assert loaded.last_block_height == state.last_block_height
        assert loaded.app_hash == state.app_hash
        assert loaded.last_results_hash == state.last_results_hash
        assert loaded.validators.hash() == state.validators.hash()

    def test_invalid_block_rejected(self):
        executor, state, privs, vset, app = make_chain_env()
        state, ec = advance_one_height(executor, state, privs, vset, [], ExtendedCommit())
        block = executor.create_proposal_block(2, state, ec, state.validators.get_proposer().address)
        block.header.app_hash = b"\x01" * 32
        block._hash = None
        parts = PartSet.from_data(block.to_proto_bytes())
        with pytest.raises(InvalidBlockError, match="AppHash"):
            executor.apply_block(state, BlockID(block.hash(), parts.header()), block)

    def test_validator_update_tx_rotates_set(self):
        executor, state, privs, vset, app = make_chain_env()
        new_priv = Ed25519PrivKey.from_seed(b"\x77" * 32)
        tx = f"val:{base64.b64encode(new_priv.pub_key().bytes()).decode()}!25".encode()
        state, ec = advance_one_height(executor, state, privs, vset, [tx], ExtendedCommit())
        assert state.last_height_validators_changed == 3
        assert len(state.next_validators) == 5
        assert len(state.validators) == 4


# --- one seeded chain in both packages -----------------------------------------

NEW_SEED = b"\x77" * 32


def _txs(h):
    """Six heights of kvstore txs; at height 3 a new validator joins at
    power 25 and validator seed 1 moves to power 3."""
    txs = [b"k%d=v%d" % (h, h), b"acct%d=%d" % (h % 2, h * 7)]
    if h == 3:
        new_pub = Ed25519PrivKey.from_seed(NEW_SEED).pub_key().bytes()
        old_pub = Ed25519PrivKey.from_seed((1).to_bytes(32, "big")).pub_key().bytes()
        txs += [b"val:" + base64.b64encode(new_pub) + b"!25", b"val:" + base64.b64encode(old_pub) + b"!3"]
    return txs


def _step(executor, state, secret_of, ec, sign_commit, part_set, block_id_cls):
    """One height in either package: propose, apply, save, and sign the
    commit with the set the height had, from ``secret_of`` by address."""
    height = state.last_block_height + 1
    executor.mempool = _Pool(_txs(height))
    proposer = state.validators.get_proposer().address
    block = executor.create_proposal_block(height, state, ec, proposer)
    parts = part_set.from_data(block.to_proto_bytes())
    block_id = block_id_cls(block.hash(), parts.header())
    new_state = executor.apply_block(state, block_id, block)
    vset = new_state.last_validators
    privs = [secret_of[v.address] for v in vset.validators]
    commit = sign_commit(block_id, height, 0, vset, privs, time_ns=BASE_NS + height * 1_000_000_000)
    executor.block_store.save_block(block, parts, commit)
    return new_state, commit, block, parts


def _both_chains(n_heights=6):
    texec, tstate, tprivs, _, tapp = make_chain_env()
    jexec_, jstate, jprivs, _, japp = jexec.make_chain_env()
    tsecret = {p.pub_key().address(): p for p in tprivs + [Ed25519PrivKey.from_seed(NEW_SEED)]}
    jsecret = {p.pub_key().address(): p for p in jprivs + [JEd25519PrivKey.from_seed(NEW_SEED)]}
    tec, jec = ExtendedCommit(), JExtendedCommit()
    rows = []
    for _ in range(n_heights):
        tstate, tcommit, tblock, tparts = _step(texec, tstate, tsecret, tec, make_commit, PartSet, BlockID)
        jstate, jcommit, jblock, jparts = _step(jexec_, jstate, jsecret, jec, jhelpers.make_commit,
                                                JPartSet, JBlockID)
        tec, jec = ExtendedCommit.wrap_commit(tcommit), JExtendedCommit.wrap_commit(jcommit)
        rows.append((tstate, jstate, tblock, jblock, tparts, jparts))
    return rows, (texec, tapp), (jexec_, japp)


@pytest.fixture(scope="module")
def chains():
    return _both_chains()  # the port's executor runs on device="cpu"


def test_six_heights_equal_hash_for_hash(chains):
    rows, (texec, tapp), (jexec_, japp) = chains
    for tstate, jstate, tblock, jblock, tparts, jparts in rows:
        h = tstate.last_block_height
        assert tblock.to_proto_bytes() == jblock.to_proto_bytes(), h
        assert tblock.hash() == jblock.hash(), h
        assert tparts.header().hash == jparts.header().hash and tparts.total == jparts.total
        assert tstate.app_hash == jstate.app_hash, h
        assert tstate.last_results_hash == jstate.last_results_hash, h
        for name in ("last_validators", "validators", "next_validators"):
            tv, jv = getattr(tstate, name), getattr(jstate, name)
            assert tv.hash() == jv.hash(), (h, name)
            assert [v.proposer_priority for v in tv.validators] == [v.proposer_priority for v in jv.validators]
            assert tv.get_proposer().address == jv.get_proposer().address, (h, name)
        assert tstate.last_height_validators_changed == jstate.last_height_validators_changed
    # the update at height 3 lands in NextValidators after height 3 and
    # in Validators from height 5
    assert len(rows[2][0].next_validators) == 5 and len(rows[2][0].validators) == 4
    assert len(rows[4][0].validators) == 5
    assert tapp.query(abci.RequestQuery(data=b"k6")).value == japp.query(jabci.RequestQuery(data=b"k6")).value
    for h in range(1, 8):
        assert texec.state_store.load_validators(h).hash() == jexec_.state_store.load_validators(h).hash()
    assert texec.state_store.load_finalize_block_response(3) == jexec_.state_store.load_finalize_block_response(3)


def test_a_wrong_app_hash_and_a_bad_last_commit_fail_alike():
    def run(env, advance, part_set, block_id_cls, err_cls):
        executor, state, privs, vset, app = env
        ec = JExtendedCommit() if err_cls is JInvalidBlockError else ExtendedCommit()
        state, ec = advance(executor, state, privs, vset, [b"a=1"], ec)
        errors = []
        for corrupt in ("app_hash", "signature"):
            if corrupt == "signature":
                sig = ec.extended_signatures[1].commit_sig
                sig.signature = sig.signature[:7] + bytes([sig.signature[7] ^ 1]) + sig.signature[8:]
            block = executor.create_proposal_block(2, state, ec, state.validators.get_proposer().address)
            if corrupt == "app_hash":
                block.header.app_hash = b"\x01" * 32
                block._hash = None
            parts = part_set.from_data(block.to_proto_bytes())
            with pytest.raises(err_cls) as exc:
                executor.apply_block(state, block_id_cls(block.hash(), parts.header()), block)
            errors.append(str(exc.value))
        return errors

    terrs = run(make_chain_env(), advance_one_height, PartSet, BlockID, InvalidBlockError)
    jerrs = run(jexec.make_chain_env(), jexec.advance_one_height, JPartSet, JBlockID, JInvalidBlockError)
    assert terrs == jerrs
    assert "AppHash" in terrs[0] and "wrong signature (#1)" in terrs[1]


def test_an_absent_signer_reaches_the_app_as_not_signed():
    executor, state, privs, vset, app = make_chain_env()
    state, ec = advance_one_height(executor, state, privs, vset, [], ExtendedCommit())
    ec.extended_signatures[2].commit_sig = CommitSig.absent()
    block = executor.create_proposal_block(2, state, ec, state.validators.get_proposer().address)
    info = executor._build_last_commit_info(block, state)
    assert [v.signed_last_block for v in info.votes] == [True, True, False, True]
    assert info.votes[2].validator_address == vset.validators[2].address
    assert block.last_commit.signatures[2].block_id_flag == BLOCK_ID_FLAG_ABSENT
