"""The hashes and the basic checks the light client reads, against the
JAX package on the CPU: merkle roots, ``Header.hash``,
``ValidatorSet.hash`` (ed25519 and mixed ed25519 + sr25519 sets), and
the messages of the ``validate_basic`` checks of ``Header``, ``Commit``,
``SignedHeader``, ``LightBlock`` and the validator set. Inputs are made
with the JAX package's types from numpy seeds and carried to the port
(``types/carry.py``); bytes and messages must be exactly equal."""

import copy
import hashlib

import numpy as np
import pytest

pytest.importorskip("torch")

from bench.workload import build_header_chain, mixed_key_factory
from tendermint_tpu.crypto import merkle as jmerkle
from tendermint_tpu.encoding.canonical import Timestamp as JTimestamp
from tendermint_tpu.types import block as jblock, light as jlight
from tendermint_tpu_torch.crypto import keys as tkeys, merkle as tmerkle
from tendermint_tpu_torch.encoding.canonical import Timestamp
from tendermint_tpu_torch.types import block as tblock, carry, light as tlight
from tendermint_tpu_torch.types.validator import Validator
from tests import helpers


@pytest.mark.parametrize("n", range(41))
def test_merkle_root_matches_jax(n):
    rng = np.random.default_rng(1000 + n)
    items = [bytes(rng.integers(0, 256, int(rng.integers(0, 80)), dtype=np.uint8)) for _ in range(n)]
    assert tmerkle.hash_from_byte_slices(items) == jmerkle.hash_from_byte_slices(items)
    if n:
        assert tmerkle.get_split_point(n + 1) == jmerkle.get_split_point(n + 1)


def test_merkle_building_blocks_match_jax():
    assert tmerkle.empty_hash() == jmerkle.empty_hash() == hashlib.sha256(b"").digest()
    assert tmerkle.leaf_hash(b"abc") == jmerkle.leaf_hash(b"abc")
    assert tmerkle.inner_hash(b"l" * 32, b"r" * 32) == jmerkle.inner_hash(b"l" * 32, b"r" * 32)
    with pytest.raises(ValueError, match="n must be >= 1"):
        tmerkle.get_split_point(0)


def _rand_hash(rng, empty_ok=True):
    if empty_ok and rng.random() < 0.2:
        return b""
    return bytes(rng.integers(0, 256, 32, dtype=np.uint8))


def _jax_header(seed, validators_hash=None):
    """A JAX-package Header with every field drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    secs = int(rng.integers(-62135596800, 4_000_000_000))
    return jblock.Header(
        version=jblock.Consensus(block=11, app=int(rng.integers(0, 2**40))),
        chain_id="chain-%d" % int(rng.integers(0, 10**6)),
        height=int(rng.integers(1, 2**62)),
        time=JTimestamp(secs, int(rng.integers(0, 10**9)) if rng.random() < 0.8 else 0),
        last_block_id=jblock.BlockID(
            _rand_hash(rng), jblock.PartSetHeader(int(rng.integers(0, 2**31)), _rand_hash(rng))
        ),
        last_commit_hash=_rand_hash(rng),
        data_hash=_rand_hash(rng),
        validators_hash=_rand_hash(rng, empty_ok=False) if validators_hash is None else validators_hash,
        next_validators_hash=_rand_hash(rng),
        consensus_hash=_rand_hash(rng),
        app_hash=bytes(rng.integers(0, 256, int(rng.integers(0, 40)), dtype=np.uint8)),
        last_results_hash=_rand_hash(rng),
        evidence_hash=_rand_hash(rng),
        proposer_address=bytes(rng.integers(0, 256, 20, dtype=np.uint8)),
    )


@pytest.mark.parametrize("seed", range(12))
def test_header_hash_matches_jax(seed):
    jh = _jax_header(seed)
    th = carry.header(jh)
    assert th.time.encode() == jh.time.encode()  # the leaf Header.hash reads
    assert th.last_block_id.to_proto_bytes() == jh.last_block_id.to_proto_bytes()
    assert th.hash() == jh.hash() and len(th.hash()) == 32


def test_header_without_validators_hash_hashes_empty():
    jh = _jax_header(99, validators_hash=b"")
    assert jh.hash() == b"" and carry.header(jh).hash() == b""


@pytest.mark.parametrize("secs,nanos", [(0, 0), (1, 0), (0, 1), (-62135596800, 0),
                                        (1_700_000_000, 999_999_999), (-1, 5)])
def test_timestamp_encoding_matches_jax(secs, nanos):
    assert Timestamp(secs, nanos).encode() == JTimestamp(secs, nanos).encode()
    assert Timestamp(secs, nanos).to_unix_ns() == JTimestamp(secs, nanos).to_unix_ns()


def _sets():
    yield "ed25519", helpers.make_validators(9)[1]
    yield "mixed", helpers.make_validators(8, key_factory=mixed_key_factory)[1]
    _, unequal = helpers.make_validators(7)
    vals = [v.copy() for v in unequal.validators]
    for i, v in enumerate(vals):
        v.voting_power = 1 + 37 * i
    yield "ed25519_unequal_power", type(unequal)(vals)


@pytest.mark.parametrize("kind", ["ed25519", "mixed", "ed25519_unequal_power"])
def test_validator_set_hash_matches_jax(kind):
    jv = dict(_sets())[kind]
    tv = carry.validator_set(jv)
    assert [v.address for v in tv.validators] == [v.address for v in jv.validators]
    assert [v.bytes() for v in tv.validators] == [v.bytes() for v in jv.validators]
    assert tv.hash() == jv.hash()
    if kind == "mixed":
        assert {v.pub_key.type for v in tv.validators} == {"ed25519", "sr25519"}
    tv.validate_basic()
    jv.validate_basic()


def test_pubkey_proto_fields_and_no_secp256k1():
    jv = dict(_sets())["mixed"]
    from tendermint_tpu.crypto.keys import pubkey_to_proto as jproto

    for v in jv.validators:
        tpk = carry.pub_key(v.pub_key)
        assert tkeys.pubkey_to_proto(tpk) == jproto(v.pub_key)
        assert tkeys.pubkey_to_proto(tpk)[0] == (0x0A if tpk.type == "ed25519" else 0x1A)

    class Secp:
        type = "secp256k1"

        def bytes(self):
            return b"\x02" * 33

    # field 2 since the port has the key type, as the reference writes it
    assert tkeys.pubkey_to_proto(Secp()) == jproto(Secp()) == b"\x12\x21" + b"\x02" * 33

    class Bls:
        type = "bls12_381"

        def bytes(self):
            return bytes(48)

    with pytest.raises(ValueError, match="unknown key type bls12_381"):
        tkeys.pubkey_to_proto(Bls())


@pytest.fixture(scope="module")
def chain():
    return build_header_chain(2, 4)


def _set(obj, path, value):
    *head, last = path.split(".")
    for name in head:
        obj = obj[int(name)] if isinstance(obj, list) else getattr(obj, name)
    if isinstance(obj, list):
        obj[int(last)] = value
    else:
        object.__setattr__(obj, last, value)


# (what to mutate on the signed header, the value); the same mutation is
# made on the JAX object and on its carried copy.
SH_CASES = {
    "valid": [],
    "header_bad_protocol": [("header.version", ("consensus", 10, 0))],
    "header_long_chain_id": [("header.chain_id", "x" * 51)],
    "header_negative_height": [("header.height", -1)],
    "header_zero_height": [("header.height", 0)],
    "header_bad_last_block_hash": [("header.last_block_id", ("bid", b"\x01" * 31, 1, b""))],
    "header_negative_part_total": [("header.last_block_id", ("bid", b"", -1, b""))],
    "header_bad_data_hash": [("header.data_hash", b"\x02" * 33)],
    "header_bad_validators_hash": [("header.validators_hash", b"\x02" * 5)],
    "header_bad_next_validators_hash": [("header.next_validators_hash", b"\x02" * 31)],
    "header_bad_consensus_hash": [("header.consensus_hash", b"\x02")],
    "header_bad_last_results_hash": [("header.last_results_hash", b"\x02" * 2)],
    "header_bad_evidence_hash": [("header.evidence_hash", b"\x02" * 3)],
    "header_bad_last_commit_hash": [("header.last_commit_hash", b"\x02" * 4)],
    "header_bad_proposer": [("header.proposer_address", b"\x03" * 19)],
    "commit_negative_height": [("commit.height", -1)],
    "commit_negative_round": [("commit.round", -2)],
    "commit_nil_block": [("commit.block_id", ("bid", b"", 0, b""))],
    "commit_no_signatures": [("commit.signatures", [])],
    "commitsig_unknown_flag": [("commit.signatures.1.block_id_flag", 7)],
    "commitsig_absent_with_address": [("commit.signatures.2.block_id_flag", 1)],
    "commitsig_absent_with_time": [("commit.signatures.2", ("absent", b"", (5, 0), b""))],
    "commitsig_absent_with_signature": [("commit.signatures.2", ("absent", b"", (0, 0), b"s"))],
    "commitsig_short_address": [("commit.signatures.0.validator_address", b"\x01" * 19)],
    "commitsig_no_signature": [("commit.signatures.3.signature", b"")],
    "commitsig_long_signature": [("commit.signatures.3.signature", b"\x01" * 65)],
    "missing_header": [("header", None)],
    "missing_commit": [("commit", None)],
    "other_chain": [("header.chain_id", "other-chain")],
    "height_mismatch": [("commit.height", 3)],
    "other_block": [("header.app_hash", b"\x09" * 32)],
}


def _value(pkg, v):
    """A mutation's value built with ``pkg``'s types."""
    if isinstance(v, tuple) and v[0] == "consensus":
        return pkg.Consensus(v[1], v[2])
    if isinstance(v, tuple) and v[0] == "bid":
        return pkg.BlockID(v[1], pkg.PartSetHeader(v[2], v[3]))
    if isinstance(v, tuple) and v[0] == "absent":
        ts = (JTimestamp if pkg is jblock else Timestamp)(*v[2])
        return pkg.CommitSig(pkg.BLOCK_ID_FLAG_ABSENT, v[1], ts, v[3])
    return v


def _outcome(fn, *args):
    try:
        fn(*args)
    except Exception as exc:  # the outcome under comparison
        return type(exc).__name__, str(exc)
    return "ok", ""


@pytest.mark.parametrize("case", list(SH_CASES))
def test_validate_basic_messages_match_jax(chain, case):
    jchain, jvset, chain_id = chain
    jsh = copy.deepcopy(jchain[1])
    tsh = carry.signed_header(jsh)
    for path, v in SH_CASES[case]:
        _set(jsh, path, _value(jblock, v))
        _set(tsh, path, _value(tblock, v))
    if jsh.header is not None:
        assert _outcome(tsh.header.validate_basic) == _outcome(jsh.header.validate_basic)
    if jsh.commit is not None:
        assert _outcome(tsh.commit.validate_basic) == _outcome(jsh.commit.validate_basic)
    want = _outcome(jsh.validate_basic, chain_id)
    assert _outcome(tsh.validate_basic, chain_id) == want
    if case == "valid":
        assert want == ("ok", "")
    jlb = jlight.LightBlock(jsh, jvset)
    tlb = tlight.LightBlock(tsh, carry.validator_set(jvset))
    assert _outcome(tlb.validate_basic, chain_id) == _outcome(jlb.validate_basic, chain_id)


def test_light_block_and_validator_checks_match_jax(chain):
    jchain, jvset, chain_id = chain
    jsh, tsh = jchain[0], carry.signed_header(jchain[0])
    other = helpers.make_validators(3)[1]
    cases = [
        (jlight.LightBlock(None, jvset), tlight.LightBlock(None, carry.validator_set(jvset))),
        (jlight.LightBlock(jsh, None), tlight.LightBlock(tsh, None)),
        (jlight.LightBlock(jsh, other), tlight.LightBlock(tsh, carry.validator_set(other))),
        (jlight.LightBlock(jsh, jvset), tlight.LightBlock(tsh, carry.validator_set(jvset))),
    ]
    for jlb, tlb in cases:
        assert _outcome(tlb.validate_basic, chain_id) == _outcome(jlb.validate_basic, chain_id)
    jval = jvset.validators[0].copy()
    tval = Validator(carry.pub_key(jval.pub_key), jval.voting_power)
    for name, value in (("voting_power", -1), ("address", b"\x01" * 19)):
        j, t = jval.copy(), copy.copy(tval)
        setattr(j, name, value)
        setattr(t, name, value)
        assert _outcome(t.validate_basic) == _outcome(j.validate_basic) != ("ok", "")
    # Commit and CommitSig encodings: the leaves of a commit hash.
    assert tsh.commit.to_proto_bytes() == jsh.commit.to_proto_bytes()
    assert tmerkle.hash_from_byte_slices(
        [cs.to_proto_bytes() for cs in tsh.commit.signatures]) == jsh.commit.hash()
