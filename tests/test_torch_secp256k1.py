"""secp256k1 in the port beside the JAX package's (which verifies through
the ``cryptography`` package): verdicts on seeded valid and malformed
signatures and keys, signatures crossing both ways, addresses, the
proto field-2 round trip, the pure-Python RIPEMD-160, and a three-type
commit whose verdicts and messages match in both ``verify_commit``s.
Equality is exact."""

import hashlib

import numpy as np
import pytest

pytest.importorskip("torch")

import tendermint_tpu_torch
from tendermint_tpu.crypto import keys as jkeys
from tendermint_tpu.types import block as jblock, validation as jval
from tendermint_tpu.types.validator_set import ValidatorSet as JValidatorSet
from tendermint_tpu_torch.crypto import keys as tkeys, secp256k1
from tendermint_tpu_torch.crypto.sr25519 import Sr25519PrivKey
from tendermint_tpu_torch.types import validation as tval
from tendermint_tpu_torch.types.block import BlockID, Commit, PartSetHeader
from tests.test_torch_execution import CHAIN_ID, make_commit, make_validators

N = secp256k1.N
P = secp256k1.P


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(tendermint_tpu_torch, "DEFAULT_DEVICE", "cpu")


def _secrets(n, seed=11):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(bytes(rng.integers(0, 256, 32, dtype=np.uint8)), "big") % (N - 1) + 1
            for _ in range(n)]


def _off_curve_x():
    x = 1
    while secp256k1.decompress(b"\x02" + x.to_bytes(32, "big")) is not None:
        x += 1
    return x


def _cases():
    """(name, pubkey bytes, message, signature) for every check the
    verifier makes."""
    out = []
    for i, secret in enumerate(_secrets(4)):
        priv = tkeys.Secp256k1PrivKey(secret.to_bytes(32, "big"))
        pub = priv.pub_key().bytes()
        msg = b"seeded message %d" % i
        sig = priv.sign(msg)
        r, s = int.from_bytes(sig[:32], "big"), int.from_bytes(sig[32:], "big")
        be = lambda v: v.to_bytes(32, "big")
        out += [
            ("valid", pub, msg, sig),
            ("high_s", pub, msg, be(r) + be(N - s)),
            ("r_zero", pub, msg, be(0) + be(s)),
            ("s_zero", pub, msg, be(r) + be(0)),
            ("r_is_n", pub, msg, be(N) + be(s)),
            ("r_over_n", pub, msg, be(r + N) + be(s) if r + N < 2**256 else be(2**256 - 1) + be(s)),
            ("s_is_n", pub, msg, be(r) + be(N)),
            ("wrong_message", pub, msg + b"!", sig),
            ("bad_prefix_04", b"\x04" + pub[1:], msg, sig),
            ("bad_prefix_00", b"\x00" + pub[1:], msg, sig),
            ("other_parity", bytes([pub[0] ^ 1]) + pub[1:], msg, sig),
            ("x_is_p", b"\x02" + be(P), msg, sig),
            ("x_over_p", b"\x03" + be(P + 5), msg, sig),
            ("off_curve", b"\x02" + be(_off_curve_x()), msg, sig),
            ("short_sig", pub, msg, sig[:63]),
            ("long_sig", pub, msg, sig + b"\x00"),
        ]
    return out


@pytest.mark.parametrize("case", _cases(), ids=lambda c: c[0])
def test_verdicts_equal_the_reference(case):
    name, pub, msg, sig = case
    got = tkeys.Secp256k1PubKey(pub).verify_signature(msg, sig)
    want = jkeys.Secp256k1PubKey(pub).verify_signature(msg, sig)
    assert got == want == (name == "valid")


def test_signatures_cross_verify_both_ways_and_addresses_match():
    for secret in _secrets(6, seed=12):
        raw = secret.to_bytes(32, "big")
        tpriv, jpriv = tkeys.Secp256k1PrivKey(raw), jkeys.Secp256k1PrivKey(raw)
        assert tpriv.pub_key().bytes() == jpriv.pub_key().bytes()
        tpub, jpub = tpriv.pub_key(), jpriv.pub_key()
        assert tpub.address() == jpub.address()
        msg = hashlib.sha256(raw).digest() * 3
        assert jpub.verify_signature(msg, tpriv.sign(msg))
        assert tpub.verify_signature(msg, jpriv.sign(msg))
        # the port's nonce is RFC 6979's: the same signature every time
        assert tpriv.sign(msg) == tpriv.sign(msg)
        proto = tkeys.pubkey_to_proto(tpub)
        assert proto == jkeys.pubkey_to_proto(jpub) and proto[0] == 0x12
        assert tkeys.pubkey_from_proto(jkeys.pubkey_to_proto(jpub)) == tpub
        assert jkeys.pubkey_from_proto(proto) == jpub
        assert tkeys.pubkey_from_type_and_bytes("secp256k1", jpub.bytes()) == tpub


def test_a_known_vector():
    """Secret 1: the public key is the generator, compressed."""
    pub = tkeys.Secp256k1PrivKey((1).to_bytes(32, "big")).pub_key().bytes()
    assert pub.hex() == "0279be667ef9dcbbac55a06295ce870b07029bfcdb2dce28d959f2815b16f81798"
    with pytest.raises(ValueError, match="out of range"):
        tkeys.Secp256k1PrivKey(N.to_bytes(32, "big"))
    with pytest.raises(ValueError, match="33 bytes"):
        tkeys.Secp256k1PubKey(pub[:32])


# The test vectors of the RIPEMD-160 paper (Dobbertin, Bosselaers, Preneel
# 1996, appendix B): they hold the pure version wherever hashlib lacks the
# digest, which is where secp256k1 addresses use it.
RIPEMD160_VECTORS = [
    (b"", "9c1185a5c5e9fc54612808977ee8f548b2258d31"),
    (b"a", "0bdc9d2d256b3ee9daae347be6f4dc835a467ffe"),
    (b"abc", "8eb208f7e05d987a9b044a8e98c6b087f15a0bfc"),
    (b"message digest", "5d0689ef49d2fae572b881b123a85ffa21595f36"),
    (b"abcdefghijklmnopqrstuvwxyz", "f71c27109c692c1b56bbdceb5b9d2865b3708dbc"),
    (b"abcdbcdecdefdefgefghfghighijhijkijkljklmklmnlmnomnopnopq",
     "12a053384a9c0c88e405a06c27dcf49ada62eb2b"),
    (b"ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789",
     "b0e20b6e3116640286ed3a87a5713079b21f5189"),
    (b"1234567890" * 8, "9b752e45573d4b39f4dbd3323cab82bf63326bfb"),
]


@pytest.mark.parametrize("msg,digest", RIPEMD160_VECTORS, ids=[str(len(m)) for m, _ in RIPEMD160_VECTORS])
def test_pure_ripemd160_matches_the_published_vectors(msg, digest):
    assert secp256k1.ripemd160_pure(msg).hex() == digest
    assert secp256k1.ripemd160(msg).hex() == digest


def test_pure_ripemd160_equals_hashlib():
    try:
        hashlib.new("ripemd160")
    except ValueError:
        pytest.skip("this host's hashlib has no RIPEMD-160 to compare with")
    data = bytes(np.random.default_rng(5).integers(0, 256, 200, dtype=np.uint8))
    for n in range(201):
        assert secp256k1.ripemd160_pure(data[:n]) == hashlib.new("ripemd160", data[:n]).digest(), n


# --- a three-type commit --------------------------------------------------------


def _three_types(i):
    if i % 3 == 0:
        return tkeys.Ed25519PrivKey.from_seed(i.to_bytes(32, "big"))
    if i % 3 == 1:
        return Sr25519PrivKey(bytes([i]) * 32)
    return tkeys.Secp256k1PrivKey((i + 7).to_bytes(32, "big"))


@pytest.fixture(scope="module")
def three_type_commit():
    privs, vset = make_validators(24, key_factory=_three_types)
    bid = BlockID(hashlib.sha256(b"three").digest(), PartSetHeader(1, hashlib.sha256(b"p").digest()))
    commit = make_commit(bid, 5, 0, vset, privs)
    jset = JValidatorSet.from_proto_bytes(vset.to_proto_bytes())
    return vset, bid, commit, jset


def _both(vset, bid, commit, jset):
    """Each package's verify_commit of the same commit: None or the
    error's (type name, message)."""
    out = []
    jcommit = jblock.Commit.from_proto_bytes(commit.to_proto_bytes())
    jbid = jblock.BlockID.from_proto_bytes(bid.to_proto_bytes())
    for fn in (lambda: tval.verify_commit(CHAIN_ID, vset, bid, 5, commit, device="cpu"),
               lambda: jval.verify_commit(CHAIN_ID, jset, jbid, 5, jcommit)):
        try:
            fn()
            out.append(None)
        except Exception as e:  # compared across packages below
            out.append((type(e).__name__, str(e)))
    return out


def test_a_three_type_commit_verifies_alike(three_type_commit):
    vset, bid, commit, jset = three_type_commit
    assert {v.pub_key.type for v in vset.validators} == {"ed25519", "sr25519", "secp256k1"}
    assert jset.hash() == vset.hash()
    assert _both(vset, bid, commit, jset) == [None, None]


@pytest.mark.parametrize("key_type", ["secp256k1", "sr25519", "ed25519"])
def test_a_bad_signature_of_each_type_fails_alike(three_type_commit, key_type):
    vset, bid, commit, jset = three_type_commit
    idx = [i for i, v in enumerate(vset.validators) if v.pub_key.type == key_type][-1]
    bad = Commit.from_proto_bytes(commit.to_proto_bytes())
    sig = bad.signatures[idx].signature
    bad.signatures[idx].signature = sig[:9] + bytes([sig[9] ^ 4]) + sig[10:]
    t, j = _both(vset, bid, bad, jset)
    assert t == j and t[1].startswith(f"wrong signature (#{idx})")


def test_the_three_type_commit_goes_to_single_verification(three_type_commit, monkeypatch):
    """The reference's route: ``MultiBatchVerifier.add`` raises for the
    secp256k1 key, and every signature is checked on the host."""
    from tendermint_tpu_torch.crypto import batch as tbatch

    vset, bid, commit, _ = three_type_commit
    secp = next(v.pub_key for v in vset.validators if v.pub_key.type == "secp256k1")
    assert not tbatch.supports_batch_verifier(secp)
    with pytest.raises(ValueError, match="does not support batching"):
        tbatch.MultiBatchVerifier(device="cpu").add(secp, b"m", bytes(64))
    monkeypatch.setattr(tbatch.MultiBatchVerifier, "verify", lambda self: pytest.fail("batched"))
    tval.verify_commit(CHAIN_ID, vset, bid, 5, commit, device="cpu")
