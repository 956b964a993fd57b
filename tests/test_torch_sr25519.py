"""The port's sr25519 host crypto (Merlin, ristretto255, schnorrkel) on
the CPU: the published vectors of tests/test_sr25519.py, the sign and
verify semantics of the reference, and parity with the JAX package's
copies on seeded inputs (tolerance 0: bytes and integers are equal)."""

from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import tendermint_tpu_torch
from tendermint_tpu.crypto import merlin as jmerlin, ristretto as jrist, sr25519 as jsr
from tendermint_tpu_torch.crypto import batch as tbatch, keys as tkeys, sr25519 as tsr
from tendermint_tpu_torch.crypto.ed25519_ref import IDENT
from tendermint_tpu_torch.crypto.keys import Ed25519PrivKey
from tendermint_tpu_torch.crypto.merlin import MerlinTranscript
from tendermint_tpu_torch.crypto.ristretto import B_POINT, compress, decompress, equals, pt_mul


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(tendermint_tpu_torch, "DEFAULT_DEVICE", "cpu")


def _privs(n, seed=1):
    rng = np.random.default_rng(seed)
    return [tsr.Sr25519PrivKey(rng.bytes(32)) for _ in range(n)]


# --- published vectors ---------------------------------------------------------


def test_merlin_published_vector():
    # merlin's transcript equivalence test: protocol "test protocol", one
    # message, one 32-byte challenge.
    t = MerlinTranscript(b"test protocol")
    t.append_message(b"some label", b"some data")
    assert t.challenge_bytes(b"challenge", 32).hex() == (
        "d5a21972d0d5fe320c0d263fac7fffb8145aa640af6e9bca177c03c7efcf0615"
    )


def test_merlin_transcript_binding_state_and_clone():
    t1, t2 = MerlinTranscript(b"proto"), MerlinTranscript(b"proto")
    t1.append_message(b"a", b"x")
    t2.append_message(b"a", b"y")
    assert t1.challenge_bytes(b"c", 16) != t2.challenge_bytes(b"c", 16)
    t = MerlinTranscript(b"proto")
    assert t.challenge_bytes(b"c", 32) != t.challenge_bytes(b"c", 32)
    t = MerlinTranscript(b"proto")
    c = t.clone()
    t.append_message(b"a", b"x")
    c.append_message(b"a", b"x")
    assert t.challenge_bytes(b"c", 32) == c.challenge_bytes(b"c", 32)


# RFC 9496 A.1: encodings of the identity, B, 2B, ..., 4B.
SMALL_MULTIPLES = [
    "0000000000000000000000000000000000000000000000000000000000000000",
    "e2f2ae0a6abc4e71a884a961c500515f58e30b6aa582dd8db6a65945e08d2d76",
    "6a493210f7499cd17fecb510ae0cea23a110e8d5b901f8acadd3095c73a3b919",
    "94741f5d5d52755ece4f23f044ee27d5d1ea1e2bd196b462166b16152a9d0259",
    "da80862773358b466ffadfe0b3293ab3d9fd53c5ea6c955358f568322daf6a57",
]


def test_ristretto_generator_multiples_and_roundtrip():
    assert compress(IDENT).hex() == SMALL_MULTIPLES[0]
    for k in range(1, len(SMALL_MULTIPLES)):
        assert compress(pt_mul(k, B_POINT)).hex() == SMALL_MULTIPLES[k]
    for k in range(1, 32):
        p = pt_mul(k, B_POINT)
        d = decompress(compress(p))
        assert d is not None and equals(d, p)


@pytest.mark.parametrize("enc", [
    "edffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff7f",  # s = p
    "ecffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff7f",  # s = p - 1
    "0100000000000000000000000000000000000000000000000000000000000000",  # odd s
])
def test_ristretto_invalid_encodings_rejected(enc):
    assert decompress(bytes.fromhex(enc)) is None
    assert decompress(bytes(31)) is None  # wrong length


def test_schnorrkel_known_keypair():
    # polkadot-js wasm-crypto known pair: ExpandEd25519 and compression.
    seed = bytes.fromhex("fac7959dbfe72f052e5a0c3c8d6530f202b02fd8f9f5ca3580ec8deb7797479e")
    assert tsr.pubkey_from_seed(seed).hex() == (
        "46ebddef8cd9bb167dc30878d7113b7e168e6f0646beffd77d69d39bad76b47a"
    )


# --- sign / verify semantics -----------------------------------------------------


def test_sign_verify_roundtrip_and_marker():
    priv = _privs(1)[0]
    pub = priv.pub_key()
    sig = priv.sign(b"tendermint sr25519 message", entropy=bytes(32))
    assert len(sig) == 64 and sig[63] & 0x80
    assert pub.verify_signature(b"tendermint sr25519 message", sig)
    assert not pub.verify_signature(b"tendermint sr25519 message!", sig)
    assert not pub.verify_signature(b"", sig)
    unmarked = sig[:63] + bytes([sig[63] & 0x7F])
    assert not pub.verify_signature(b"tendermint sr25519 message", unmarked)


def test_wrong_key_mutations_and_non_canonical_s_rejected():
    a, b = _privs(2, seed=2)
    sig = a.sign(b"msg", entropy=bytes(range(32)))
    assert not b.pub_key().verify_signature(b"msg", sig)
    for i in (0, 10, 31, 32, 45, 62):
        bad = bytearray(sig)
        bad[i] ^= 0x01
        assert not a.pub_key().verify_signature(b"msg", bytes(bad))
    assert not a.pub_key().verify_signature(b"msg", sig[:32] + b"\xff" * 32)


def test_entropy_makes_signing_deterministic_and_default_draws_urandom():
    priv = _privs(1, seed=3)[0]
    e = bytes(range(32))
    assert priv.sign(b"m", entropy=e) == priv.sign(b"m", entropy=e)
    assert priv.sign(b"m", entropy=e) != priv.sign(b"m", entropy=bytes(32))
    with mock.patch("os.urandom", return_value=e):
        assert priv.sign(b"m") == priv.sign(b"m", entropy=e)


def test_key_type_address_and_invalid_pubkey():
    priv = tsr.Sr25519PrivKey(bytes(range(32)))
    assert priv.type == tkeys.SR25519_KEY_TYPE == priv.pub_key().type
    assert priv.pub_key().verify_signature(b"m", priv.sign(b"m", entropy=bytes(32)))
    pub = tsr.Sr25519PubKey(priv.pub_key().bytes())
    assert pub == priv.pub_key() and len(pub.address()) == 20
    assert pub.address() == jsr.Sr25519PubKey(pub.bytes()).address()
    with pytest.raises(ValueError):
        tsr.Sr25519PubKey(bytes(33))
    assert tsr.Sr25519PrivKey.from_secret(b"s").bytes() == jsr.Sr25519PrivKey.from_secret(b"s").bytes()
    # A negative encoding does not decode: verify returns False, never raises.
    assert not tsr.Sr25519PubKey(b"\x01" + bytes(31)).verify_signature(b"msg", bytes(64))


# --- parity with the JAX package -------------------------------------------------


def test_transcripts_challenges_and_decode_equal_the_jax_package():
    rng = np.random.default_rng(11)
    for _ in range(8):
        msg, pub, r = rng.bytes(int(rng.integers(0, 200))), rng.bytes(32), rng.bytes(32)
        assert tsr._challenge(tsr._signing_transcript(msg), pub, r) == jsr._challenge(
            jsr._signing_transcript(msg), pub, r)
        t, j = MerlinTranscript(b"p"), jmerlin.MerlinTranscript(b"p")
        t.append_message(b"l", msg)
        j.append_message(b"l", msg)
        assert t.challenge_bytes(b"c", 64) == j.challenge_bytes(b"c", 64)
    encs = [compress(pt_mul(int(k), B_POINT)) for k in rng.integers(1, 2**62, 8)]
    encs += [bytes(rng.integers(0, 256, 32, dtype=np.uint8)) for _ in range(24)]
    for enc in encs:
        assert decompress(enc) == jrist.decompress(enc)


def test_sign_equals_the_jax_package_with_the_same_entropy():
    rng = np.random.default_rng(12)
    for priv in _privs(4, seed=12):
        msg, e = rng.bytes(109), rng.bytes(32)
        with mock.patch.object(jsr.os, "urandom", return_value=e):
            want = jsr.Sr25519PrivKey(priv.bytes()).sign(msg)
        assert priv.sign(msg, entropy=e) == want
        assert tsr.sign(priv.bytes(), msg, entropy=e) == want


def test_verify_equals_the_jax_package_on_planted_faults():
    from chip_smoke import plant_sr_faults

    rng = np.random.default_rng(13)
    privs = _privs(4, seed=13)
    n = 20
    pks = [privs[i % 4].pub_key().bytes() for i in range(n)]
    msgs = [rng.bytes(60) for _ in range(n)]
    sigs = [privs[i % 4].sign(msgs[i], entropy=rng.bytes(32)) for i in range(n)]
    kinds = plant_sr_faults(pks, msgs, sigs, range(1, n, 2))
    got = [tsr.verify(p, m, s) for p, m, s in zip(pks, msgs, sigs)]
    assert got == [jsr.verify(p, m, s) for p, m, s in zip(pks, msgs, sigs)]
    assert [i for i, ok in enumerate(got) if not ok] == sorted(
        i for i, kind in kinds.items() if kind != "identity_a")


# --- the batch verifier's host path ----------------------------------------------


def _entries(n, seed, bad=()):
    privs = _privs(n, seed=seed)
    out = []
    for i, priv in enumerate(privs):
        msg = b"m%d" % i
        sig = priv.sign(msg, entropy=bytes([i]) * 32)
        out.append((priv.pub_key(), b"tampered" if i in bad else msg, sig))
    return out


def test_batch_host_path_all_valid_and_attribution():
    bv = tsr.Sr25519BatchVerifier()
    for e in _entries(6, seed=20):
        bv.add(*e)
    assert bv.verify() == (True, [True] * 6)
    bv = tsr.Sr25519BatchVerifier()
    jbv = jsr.Sr25519BatchVerifier()
    for pub, msg, sig in _entries(6, seed=21, bad=(3,)):
        bv.add(pub, msg, sig)
        jbv.add(jsr.Sr25519PubKey(pub.bytes()), msg, sig)
    assert bv.verify() == jbv.verify() == (False, [True, True, True, False, True, True])


def test_batch_rejects_foreign_key_and_empty_batch_fails():
    bv = tsr.Sr25519BatchVerifier()
    with pytest.raises(ValueError):
        bv.add(Ed25519PrivKey.from_seed(bytes(32)).pub_key(), b"m", bytes(64))
    assert tsr.Sr25519BatchVerifier().verify() == (False, [])


def test_batch_at_threshold_takes_the_device_engine(monkeypatch):
    from tendermint_tpu_torch.ops import sr25519_batch as tsb

    calls = []
    real = tsb.verify_batch_sr
    monkeypatch.setattr(tsb, "verify_batch_sr", lambda *a, **k: calls.append(k) or real(*a, **k))
    monkeypatch.setattr(tbatch, "DEVICE_THRESHOLD", 4)
    bv = tsr.Sr25519BatchVerifier()
    for e in _entries(4, seed=22, bad=(1,)):
        bv.add(*e)
    assert bv.verify() == (False, [True, False, True, True])
    assert calls == [{"device": torch.device("cpu")}]
