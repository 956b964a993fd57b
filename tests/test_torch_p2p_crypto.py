"""The port's X25519 (RFC 7748) and ChaCha20-Poly1305 (RFC 8439), the
two host primitives of its SecretConnection.

Checked against the RFCs' own vectors, and against the ``cryptography``
wheel (which the JAX package's SecretConnection uses) on seeded random
inputs, every length a frame and a message can take.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tendermint_tpu_torch.crypto import x25519
from tendermint_tpu_torch.crypto.chacha20poly1305 import (
    CHUNK_BLOCKS,
    ChaCha20Poly1305,
    InvalidTag,
    chacha20_blocks,
    poly1305,
)

SUNSCREEN = (
    b"Ladies and Gentlemen of the class of '99: If I could offer you only one tip for the future, "
    b"sunscreen would be it."
)


@pytest.mark.parametrize(
    "scalar, u, out",
    [
        (  # RFC 7748 §5.2, first vector
            "a546e36bf0527c9d3b16154b82465edd62144c0ac1fc5a18506a2244ba449ac4",
            "e6db6867583030db3594c1a424b15f7c726624ec26b3353b10a903a6d0ab1c4c",
            "c3da55379de9c6908e94ea4df28d084f32eccf03491c71f754b4075577a28552",
        ),
        (  # RFC 7748 §5.2, second vector (u's top bit set: masked)
            "4b66e9d4d1b4673c5ad22691957d6af5c11b6421e0ea01d42ca4169e7918ba0d",
            "e5210f12786811d3f4b7959d0538ae2c31dbe7106fc03c3efc4cd549c715a493",
            "95cbde9476e8907d7aade45cb4b873f88b595a68799fa152e6f8f7647aac7957",
        ),
    ],
)
def test_x25519_rfc7748_vectors(scalar, u, out):
    assert x25519.x25519(bytes.fromhex(scalar), bytes.fromhex(u)).hex() == out


def test_x25519_rfc7748_iteration_and_key_exchange():
    # §5.2: one iteration of k = X25519(k, u), u = old k, from k = u = 9
    nine = (9).to_bytes(32, "little")
    assert x25519.x25519(nine, nine).hex() == "422c8e7a6227d7bca1350b3e2bb7279f7897b87bb6854b783c60e80311ae3079"
    # §6.1: Alice and Bob
    a = bytes.fromhex("77076d0a7318a57d3c16c17251b26645df4c2f87ebc0992ab177fba51db92c2a")
    b = bytes.fromhex("5dab087e624a8a4b79e17f8b83800ee66f3bb1292618b6fd1c2f8b27ff88e0eb")
    a_pub, b_pub = x25519.public_key(a), x25519.public_key(b)
    assert a_pub.hex() == "8520f0098930a754748b7ddcb43ef75a0dbf3a0d26381af4eba4a98eaa9b4e6a"
    assert b_pub.hex() == "de9edb7d7b7dc1b4d35b61c2ece435373f8343c85b78674dadfc7e146f882b4f"
    shared = "4a5d9d5ba4ce2de1728e3bf480350f25e07e21c947d19e3376f09b3c1e161742"
    assert x25519.exchange(a, b_pub).hex() == shared
    assert x25519.exchange(b, a_pub).hex() == shared
    # a small-order peer key gives the all-zero secret: refused
    with pytest.raises(ValueError, match="small order"):
        x25519.exchange(a, bytes(32))


def test_chacha20_poly1305_rfc8439_vectors():
    # §2.3.2: the block function
    block = chacha20_blocks(
        bytes(range(32)),
        np.array([1], dtype=np.uint32),
        np.frombuffer(bytes.fromhex("000000090000004a00000000"), dtype="<u4").reshape(1, 3).astype(np.uint32),
    )
    assert block.hex() == (
        "10f1e7e4d13b5915500fdd1fa32071c4c7d1f4c733c068030422aa9ac3d46c4e"
        "d2826446079faa0914c2d705d98b02a2b5129cd1de164eb9cbd083e8a2503c4e"
    )
    # §2.5.2: Poly1305
    key = bytes.fromhex("85d6be7857556d337f4452fe42d506a80103808afb0db2fd4abff6af4149f51b")
    assert poly1305(key, b"Cryptographic Forum Research Group").hex() == "a8061dc1305136c6c22b8baf0c0127a9"
    # §2.8.2: the AEAD
    aead = ChaCha20Poly1305(bytes(range(0x80, 0xA0)))
    nonce = bytes.fromhex("070000004041424344454647")
    aad = bytes.fromhex("50515253c0c1c2c3c4c5c6c7")
    sealed = aead.encrypt(nonce, SUNSCREEN, aad)
    assert sealed.hex() == (
        "d31a8d34648e60db7b86afbc53ef7ec2a4aded51296e08fea9e2b5a736ee62d63dbea45e8ca9671282fafb69da92728b"
        "1a71de0a9e060b2905d6a5b67ecd3b3692ddbd7f2d778b8c9803aee328091b58fab324e4fad675945585808b4831d7bc"
        "3ff4def08e4b7a9de576d26586cec64b6116" + "1ae10b594f09e26a7e902ecbd0600691"
    )
    assert aead.decrypt(nonce, sealed, aad) == SUNSCREEN
    for i in (0, 40, len(sealed) - 1):
        bad = bytearray(sealed)
        bad[i] ^= 1
        with pytest.raises(InvalidTag):
            aead.decrypt(nonce, bytes(bad), aad)


def test_seal_many_is_one_encrypt_a_frame_across_chunks():
    """A batch past CHUNK_BLOCKS blocks, each frame its own nonce and
    length, seals and opens as the frames would one at a time."""
    rng = np.random.default_rng(8439)
    aead = ChaCha20Poly1305(rng.bytes(32))
    lengths = [0, 1, 63, 64, 65, 1028] + [int(n) for n in rng.integers(0, 3000, 40)]
    assert sum(1 + -(-n // 64) for n in lengths) > CHUNK_BLOCKS
    nonces = [rng.bytes(12) for _ in lengths]
    frames = [rng.bytes(n) for n in lengths]
    sealed = aead.seal_many(nonces, frames)
    assert sealed == [aead.encrypt(n, f) for n, f in zip(nonces, frames)]
    assert aead.open_many(nonces, sealed) == frames
    tampered = list(sealed)
    tampered[7] = tampered[7][:-1] + bytes([tampered[7][-1] ^ 1])
    with pytest.raises(InvalidTag):
        aead.open_many(nonces, tampered)


def test_both_primitives_match_cryptography_on_seeded_inputs():
    pytest.importorskip("cryptography")
    from cryptography.hazmat.primitives.asymmetric.x25519 import X25519PrivateKey, X25519PublicKey
    from cryptography.hazmat.primitives.ciphers.aead import ChaCha20Poly1305 as CChaCha20Poly1305
    from cryptography.hazmat.primitives.serialization import Encoding, PublicFormat

    rng = np.random.default_rng(7748)
    for _ in range(12):
        a, b = rng.bytes(32), rng.bytes(32)
        ca = X25519PrivateKey.from_private_bytes(a)
        assert ca.public_key().public_bytes(Encoding.Raw, PublicFormat.Raw) == x25519.public_key(a)
        assert ca.exchange(X25519PublicKey.from_public_bytes(x25519.public_key(b))) == x25519.exchange(
            a, x25519.public_key(b)
        )
    for n in (0, 1, 15, 16, 17, 63, 64, 65, 1028, 1044, 70_000):
        key, nonce, aad = rng.bytes(32), rng.bytes(12), rng.bytes(int(rng.integers(0, 40)))
        msg = rng.bytes(n)
        ours, theirs = ChaCha20Poly1305(key), CChaCha20Poly1305(key)
        assert ours.encrypt(nonce, msg, aad) == theirs.encrypt(nonce, msg, aad)
        assert ours.decrypt(nonce, theirs.encrypt(nonce, msg, aad), aad) == msg
