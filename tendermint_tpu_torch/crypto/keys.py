"""Ed25519, secp256k1 and sr25519 keys and addresses.

A copy of ``tendermint_tpu/crypto/keys.py`` (reference
crypto/crypto.go:38-76): ``PubKey`` (address, bytes, verify), private
keys (sign, pub_key) and 20-byte addresses, SHA256(pubkey)[:20] for
ed25519 (crypto/crypto.go:27 AddressHash) and RIPEMD160(SHA256(pubkey))
for secp256k1 (crypto/secp256k1/secp256k1.go), and the proto encoding of
a public key that the validator-set hash reads and the stores decode.
Ed25519 verification follows ZIP-215 through the host oracle and signing
RFC 8032. secp256k1 verifies and signs on Python integers
(:mod:`tendermint_tpu_torch.crypto.secp256k1`) where the reference calls
the ``cryptography`` package; its signer's nonce is RFC 6979's, the
reference's a random one. The sr25519 keys live in
:mod:`tendermint_tpu_torch.crypto.sr25519`.
"""

from __future__ import annotations

import hashlib
import secrets
from abc import ABC, abstractmethod

from tendermint_tpu_torch.crypto import ed25519_ref, secp256k1
from tendermint_tpu_torch.encoding.proto import Reader, encode_bytes_field

ADDRESS_LEN = 20

ED25519_KEY_TYPE = "ed25519"
SECP256K1_KEY_TYPE = "secp256k1"
SR25519_KEY_TYPE = "sr25519"

ED25519_PUBKEY_SIZE = 32
ED25519_PRIVKEY_SIZE = 64
ED25519_SIG_SIZE = 64


def address_hash(data: bytes) -> bytes:
    """crypto.AddressHash: first 20 bytes of SHA-256."""
    return hashlib.sha256(data).digest()[:ADDRESS_LEN]


class PubKey(ABC):
    @abstractmethod
    def address(self) -> bytes: ...

    @abstractmethod
    def bytes(self) -> bytes: ...

    @abstractmethod
    def verify_signature(self, msg: bytes, sig: bytes) -> bool: ...

    @property
    @abstractmethod
    def type(self) -> str: ...

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, PubKey)
            and self.type == other.type
            and self.bytes() == other.bytes()
        )

    def __hash__(self) -> int:
        return hash((self.type, self.bytes()))


class Ed25519PubKey(PubKey):
    __slots__ = ("_bytes",)

    def __init__(self, data: bytes):
        if len(data) != ED25519_PUBKEY_SIZE:
            raise ValueError(f"ed25519 pubkey must be 32 bytes, got {len(data)}")
        self._bytes = bytes(data)

    def address(self) -> bytes:
        return address_hash(self._bytes)

    def bytes(self) -> bytes:
        return self._bytes

    def verify_signature(self, msg: bytes, sig: bytes) -> bool:
        if len(sig) != ED25519_SIG_SIZE:
            return False
        return ed25519_ref.verify_zip215(self._bytes, msg, sig)

    @property
    def type(self) -> str:
        return ED25519_KEY_TYPE


class Ed25519PrivKey:
    """64-byte layout: seed || pubkey (crypto/ed25519/ed25519.go:76-82)."""

    __slots__ = ("_bytes",)

    def __init__(self, data: bytes):
        if len(data) == 32:  # bare seed
            data, _ = ed25519_ref.keypair_from_seed(bytes(data))
        if len(data) != ED25519_PRIVKEY_SIZE:
            raise ValueError(f"ed25519 privkey must be 64 bytes, got {len(data)}")
        self._bytes = bytes(data)

    @classmethod
    def from_seed(cls, seed: bytes) -> "Ed25519PrivKey":
        return cls(seed)

    def bytes(self) -> bytes:
        return self._bytes

    def sign(self, msg: bytes) -> bytes:
        return ed25519_ref.sign(self._bytes, msg)

    def pub_key(self) -> Ed25519PubKey:
        return Ed25519PubKey(self._bytes[32:])

    @property
    def type(self) -> str:
        return ED25519_KEY_TYPE



# --- secp256k1 --------------------------------------------------------------

SECP256K1_N = secp256k1.N


class Secp256k1PubKey(PubKey):
    """33-byte compressed SEC1 pubkey; 64-byte r||s signatures with low-s
    requirement (crypto/secp256k1/secp256k1.go:38-217)."""

    __slots__ = ("_bytes",)

    def __init__(self, data: bytes):
        if len(data) != secp256k1.PUBKEY_SIZE:
            raise ValueError(f"secp256k1 pubkey must be 33 bytes, got {len(data)}")
        self._bytes = bytes(data)

    def address(self) -> bytes:
        return secp256k1.ripemd160(hashlib.sha256(self._bytes).digest())

    def bytes(self) -> bytes:
        return self._bytes

    def verify_signature(self, msg: bytes, sig: bytes) -> bool:
        return secp256k1.verify(self._bytes, msg, sig)

    @property
    def type(self) -> str:
        return SECP256K1_KEY_TYPE


class Secp256k1PrivKey:
    """A 32-byte big-endian secret in [1, n)."""

    __slots__ = ("_bytes", "_secret")

    def __init__(self, data: bytes):
        if len(data) != 32:
            raise ValueError("secp256k1 privkey must be 32 bytes")
        secret = int.from_bytes(data, "big")
        if not 0 < secret < secp256k1.N:
            raise ValueError("secp256k1 privkey out of range")
        self._bytes = bytes(data)
        self._secret = secret

    @classmethod
    def generate(cls) -> "Secp256k1PrivKey":
        return cls((secrets.randbelow(secp256k1.N - 1) + 1).to_bytes(32, "big"))

    def bytes(self) -> bytes:
        return self._bytes

    def sign(self, msg: bytes) -> bytes:
        """Deterministic (RFC 6979) but not constant-time, so not safe
        against timing side channels: for tests and fixtures only."""
        return secp256k1.sign(self._secret, msg)

    def pub_key(self) -> Secp256k1PubKey:
        return Secp256k1PubKey(secp256k1.public_key(self._secret))

    @property
    def type(self) -> str:
        return SECP256K1_KEY_TYPE



def pubkey_to_proto(pub: PubKey) -> bytes:
    """tendermint.crypto.PublicKey: oneof {ed25519=1, secp256k1=2, sr25519=3}
    (crypto/encoding/codec.go)."""
    if pub.type == ED25519_KEY_TYPE:
        return encode_bytes_field(1, pub.bytes())
    if pub.type == SECP256K1_KEY_TYPE:
        return encode_bytes_field(2, pub.bytes())
    if pub.type == SR25519_KEY_TYPE:
        return encode_bytes_field(3, pub.bytes())
    raise ValueError(f"unknown key type {pub.type}")


def pubkey_from_proto(data: bytes) -> PubKey:
    """The key of a tendermint.crypto.PublicKey."""
    r = Reader(data)
    for field, wire in r.fields():
        if field == 1 and wire == 2:
            return Ed25519PubKey(r.read_bytes())
        if field == 2 and wire == 2:
            return Secp256k1PubKey(r.read_bytes())
        if field == 3 and wire == 2:
            from tendermint_tpu_torch.crypto.sr25519 import Sr25519PubKey

            return Sr25519PubKey(r.read_bytes())
        r.skip(wire)
    raise ValueError("empty PublicKey proto")


def pubkey_from_type_and_bytes(key_type: str, data: bytes) -> PubKey:
    if key_type == ED25519_KEY_TYPE:
        return Ed25519PubKey(data)
    if key_type == SECP256K1_KEY_TYPE:
        return Secp256k1PubKey(data)
    if key_type == SR25519_KEY_TYPE:
        from tendermint_tpu_torch.crypto.sr25519 import Sr25519PubKey

        return Sr25519PubKey(data)
    raise ValueError(f"unknown key type {key_type}")
