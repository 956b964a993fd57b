"""The proto encodings the light store keeps blocks in, against the JAX
package on the CPU: ``Header``, ``Commit``, ``SignedHeader``,
``ValidatorSet`` (with its proposer priorities) and ``LightBlock``
bytes, for an ed25519 chain, a rotating-set chain and a mixed ed25519 +
sr25519 set; the port's decoders on the JAX bytes (equal hashes, equal
re-encodings) and on truncated bytes (the same error); the light-client
attack evidence; and ``LightStore`` over ``MemDB`` fed the same blocks.
Blocks are made with the JAX package's types and carried to the port
(``types/carry.py``), or made by the port's twin of the rotating chain;
bytes and messages must be exactly equal."""

import hashlib

import pytest

pytest.importorskip("torch")

from bench.workload import mixed_key_factory
from tendermint_tpu.crypto import keys as jkeys
from tendermint_tpu.encoding.canonical import Timestamp as JTimestamp
from tendermint_tpu.light.store import LightStore as JLightStore
from tendermint_tpu.types import block as jblock, evidence as jevidence, light as jlight
from tendermint_tpu.types.validator import Validator as JValidator
from tendermint_tpu.types.validator_set import ValidatorSet as JValidatorSet
from tendermint_tpu_torch.crypto import keys as tkeys
from tendermint_tpu_torch.crypto.keys import Ed25519PrivKey
from tendermint_tpu_torch.light.store import LightStore
from tendermint_tpu_torch.types import block as tblock, carry, evidence as tevidence
from tendermint_tpu_torch.types.light import LightBlock, SignedHeader
from tendermint_tpu_torch.types.validator import Validator
from tendermint_tpu_torch.types.validator_set import ValidatorSet
from tests import helpers
from tests.test_light import build_light_chain
from tests.test_lightd import build_rotating_chain

BASE_NS = 1_700_000_000_000_000_000


def _mixed_block(n_vals=6, height=3):
    """A light block signed by a mixed ed25519 + sr25519 set."""
    privs, vset = helpers.make_validators(n_vals, key_factory=mixed_key_factory)
    header = jblock.Header(
        version=jblock.Consensus(block=11),
        chain_id=helpers.CHAIN_ID,
        height=height,
        time=JTimestamp.from_unix_ns(BASE_NS + height * 10**9),
        last_block_id=jblock.BlockID(hashlib.sha256(b"last").digest(),
                                     jblock.PartSetHeader(2, hashlib.sha256(b"lp").digest())),
        last_commit_hash=hashlib.sha256(b"lc").digest(),
        data_hash=hashlib.sha256(b"d").digest(),
        validators_hash=vset.hash(),
        next_validators_hash=vset.hash(),
        consensus_hash=hashlib.sha256(b"cp").digest(),
        app_hash=b"\x07" * 20,
        proposer_address=vset.get_proposer().address,
    )
    bid = jblock.BlockID(header.hash(), jblock.PartSetHeader(1, hashlib.sha256(b"parts").digest()))
    # one absent and one nil signature beside the commits
    commit = helpers.make_commit(bid, height, 1, vset, privs, absent={1}, nil_votes={4},
                                 time_ns=BASE_NS + height * 10**9)
    return jlight.LightBlock(jlight.SignedHeader(header, commit), vset.copy())


@pytest.fixture(scope="module")
def blocks():
    constant, _, _ = build_light_chain(3, n_vals=4)
    return {
        "ed25519": constant,
        "rotating": build_rotating_chain(5),
        "mixed": [_mixed_block()],
    }


KINDS = ("ed25519", "rotating", "mixed")


@pytest.mark.parametrize("kind", KINDS)
def test_encodings_equal_the_reference(blocks, kind):
    for jlb in blocks[kind]:
        lb = carry.light_block(jlb)
        sh, jsh = lb.signed_header, jlb.signed_header
        assert sh.header.to_proto_bytes() == jsh.header.to_proto_bytes()
        assert sh.commit.to_proto_bytes() == jsh.commit.to_proto_bytes()
        assert sh.to_proto_bytes() == jsh.to_proto_bytes()
        assert lb.validator_set.to_proto_bytes() == jlb.validator_set.to_proto_bytes()
        assert lb.to_proto_bytes() == jlb.to_proto_bytes()
        assert (lb.height, lb.hash(), lb.header.hash()) == (jlb.height, jlb.hash(), jlb.header.hash())


@pytest.mark.parametrize("kind", KINDS)
def test_decoders_read_the_reference_bytes(blocks, kind):
    for jlb in blocks[kind]:
        raw = jlb.to_proto_bytes()
        lb = LightBlock.from_proto_bytes(raw)
        assert lb.to_proto_bytes() == raw
        assert lb.hash() == jlb.hash()
        assert lb.validator_set.hash() == jlb.validator_set.hash()
        assert lb.validator_set.get_proposer().address == jlb.validator_set.get_proposer().address
        assert [v.proposer_priority for v in lb.validator_set.validators] == [
            v.proposer_priority for v in jlb.validator_set.validators]
        lb.validate_basic(helpers.CHAIN_ID)
        jsh = jlb.signed_header
        assert SignedHeader.from_proto_bytes(jsh.to_proto_bytes()).to_proto_bytes() == jsh.to_proto_bytes()
        assert tblock.Header.from_proto_bytes(jsh.header.to_proto_bytes()).hash() == jsh.header.hash()
        commit = tblock.Commit.from_proto_bytes(jsh.commit.to_proto_bytes())
        assert commit.to_proto_bytes() == jsh.commit.to_proto_bytes()
        assert [commit.vote_sign_bytes(helpers.CHAIN_ID, i) for i in range(len(commit.signatures))] == [
            jsh.commit.vote_sign_bytes(helpers.CHAIN_ID, i) for i in range(len(commit.signatures))]


def _error(fn, raw):
    try:
        fn(raw)
    except ValueError as e:
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("kind", KINDS)
def test_truncated_bytes_raise_as_the_reference_does(blocks, kind):
    jlb = blocks[kind][-1]
    raw = jlb.to_proto_bytes()
    sh_len = len(jlb.signed_header.to_proto_bytes())
    # cuts strictly inside the signed header (field 1) and inside the
    # validator set (field 2): every one leaves a field short
    cuts = [5, sh_len // 2, sh_len, len(raw) - 40, len(raw) - 1]
    for cut in cuts:
        got = _error(LightBlock.from_proto_bytes, raw[:cut])
        assert got is not None, cut
        assert got == _error(jlight.LightBlock.from_proto_bytes, raw[:cut]), cut
    vraw = jlb.validator_set.to_proto_bytes()
    assert _error(ValidatorSet.from_proto_bytes, vraw[:-3]) == _error(JValidatorSet.from_proto_bytes, vraw[:-3])
    assert _error(ValidatorSet.from_proto_bytes, b"") == ("ValueError", "nil validator set proposer")


def test_priorities_of_a_new_set_equal_the_reference():
    """NewValidatorSet's single increment: priority = power, the proposer
    (highest power, then lower address) minus the total; unequal powers."""
    privs = [Ed25519PrivKey.from_seed(bytes([i]) * 32) for i in range(7)]
    powers = [10, 30, 30, 5, 1, 30, 12]
    tset = ValidatorSet([Validator(p.pub_key(), w) for p, w in zip(privs, powers)])
    jset = JValidatorSet([JValidator(jkeys.Ed25519PrivKey.from_seed(bytes([i]) * 32).pub_key(), w)
                          for i, w in enumerate(powers)])
    assert tset.to_proto_bytes() == jset.to_proto_bytes()
    assert tset.get_proposer().address == jset.get_proposer().address
    # a set restored without its proposer takes the highest priority,
    # as the reference's provider restores one
    again = ValidatorSet.restore([v.copy() for v in tset.validators])
    jagain = JValidatorSet()
    jagain.validators = [v.copy() for v in jset.validators]
    assert again.get_proposer().address == jagain.get_proposer().address
    assert again.get_proposer().address != tset.get_proposer().address


def test_key_types_the_port_does_not_have_raise():
    secp = b"\x12\x21" + b"\x02" * 33  # field 2: a compressed secp256k1 key
    with pytest.raises(ValueError, match="unknown key type secp256k1"):
        tkeys.pubkey_from_proto(secp)
    with pytest.raises(ValueError, match="empty PublicKey proto"):
        tkeys.pubkey_from_proto(b"")


def test_rotating_chain_twin_is_the_reference_chain():
    """``carry.build_rotating_chain`` with window 6, slide 1 and the keys
    of seeds 7000, 7001, ... gives ``tests/test_lightd.py``'s chain."""
    n = 9
    keys = [(k, k.pub_key()) for k in (Ed25519PrivKey.from_seed((7000 + i).to_bytes(32, "big"))
                                       for i in range(n + 6))]
    port = carry.build_rotating_chain(n, keys)
    ref = build_rotating_chain(n)
    assert [lb.to_proto_bytes() for lb in port] == [lb.to_proto_bytes() for lb in ref]
    # a wider slide: heights h and h + k share window - k * slide keys
    wide = carry.build_rotating_chain(3, keys[:12], window=6, slide=2)
    shared = {v.address for v in wide[0].validator_set.validators} & {
        v.address for v in wide[2].validator_set.validators}
    assert len(shared) == 2
    with pytest.raises(ValueError, match="need 16"):
        carry.build_rotating_chain(5, keys[:15], window=6, slide=2)


def test_light_client_attack_evidence_equals_the_reference(blocks):
    jlb = blocks["mixed"][0]
    common = blocks["ed25519"][1]
    jev = jevidence.LightClientAttackEvidence(
        conflicting_block=jlb, common_height=common.height,
        byzantine_validators=list(jlb.validator_set.validators[:2]),
        total_voting_power=common.validator_set.total_voting_power(),
        timestamp=common.signed_header.header.time)
    tev = tevidence.LightClientAttackEvidence(
        conflicting_block=carry.light_block(jlb), common_height=common.height,
        byzantine_validators=[carry.validator(v) for v in jlb.validator_set.validators[:2]],
        total_voting_power=common.validator_set.total_voting_power(),
        timestamp=carry.timestamp(common.signed_header.header.time))
    assert tev.bytes() == jev.bytes()
    assert tev.hash() == jev.hash()
    assert (tev.height(), tuple(tev.time())) == (jev.height(), tuple(jev.time()))
    assert [(a["type"], a["validator"], a["height"]) for a in tev.abci()] == [
        (a["type"], a["validator"], a["height"]) for a in jev.abci()]
    for trusted in (common.signed_header.header, jlb.signed_header.header):
        assert tev.conflicting_header_is_invalid(carry.header(trusted)) == jev.conflicting_header_is_invalid(trusted)


def test_light_store_over_memdb_equals_the_reference(blocks):
    chain = build_rotating_chain(7)
    jstore, tstore = JLightStore(), LightStore()
    for i in (3, 0, 6, 1, 4):  # out of order
        jstore.save_light_block(chain[i])
        tstore.save_light_block(carry.light_block(chain[i]))

    def h(lb):
        return None if lb is None else (lb.height, lb.hash())

    def view(store):
        return {
            "heights": store.heights(),
            "size": store.size(),
            "latest": h(store.latest_light_block()),
            "first": h(store.first_light_block()),
            "before": [h(store.light_block_before(x)) for x in range(0, 9)],
            "at": [h(store.light_block(x)) for x in range(0, 9)],
        }

    assert view(tstore) == view(jstore)
    assert tstore.heights() == [1, 2, 4, 5, 7]
    for store in (jstore, tstore):
        store.delete_light_block(4)
        store.prune(3)
    assert view(tstore) == view(jstore)
    assert tstore.heights() == [2, 5, 7]
    # the stored bytes are the reference's, and decode to equal blocks
    assert tstore.latest_light_block().to_proto_bytes() == jstore.latest_light_block().to_proto_bytes()
    with pytest.raises(ValueError, match="Height <= 0"):
        tstore.save_light_block(LightBlock())
