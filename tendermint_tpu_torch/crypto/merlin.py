"""Merlin transcripts over STROBE-128 (Keccak-f[1600]).

A copy of ``tendermint_tpu/crypto/merlin.py``: schnorrkel (sr25519)
signatures are defined over Merlin transcripts, so the port carries the
exact STROBE-128 duplex Merlin pins down (rate 166, protocol tag
"STROBEv1.0.2") and Merlin's framing (``meta-AD(label || LE32(len))``
then ``AD`` / ``PRF`` of the data). Transcript hashing is sequential and
stays on the host; only the curve work of a batch runs on the card.
"""

from __future__ import annotations

# --- Keccak-f[1600] permutation -------------------------------------------

_ROUND_CONSTANTS = (
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
)

_ROTATION = (
    (0, 36, 3, 41, 18),
    (1, 44, 10, 45, 2),
    (62, 6, 43, 15, 61),
    (28, 55, 25, 21, 56),
    (27, 20, 39, 8, 14),
)

_MASK = (1 << 64) - 1


def _rotl(x: int, n: int) -> int:
    return ((x << n) | (x >> (64 - n))) & _MASK


def keccak_f1600(state: bytearray) -> None:
    """In-place Keccak-f[1600] over a 200-byte state (little-endian lanes)."""
    lanes = [
        int.from_bytes(state[8 * i : 8 * i + 8], "little") for i in range(25)
    ]
    # lanes[x + 5*y] layout
    for rc in _ROUND_CONSTANTS:
        # theta
        c = [
            lanes[x] ^ lanes[x + 5] ^ lanes[x + 10] ^ lanes[x + 15] ^ lanes[x + 20]
            for x in range(5)
        ]
        d = [c[(x - 1) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
        for x in range(5):
            for y in range(5):
                lanes[x + 5 * y] ^= d[x]
        # rho + pi
        b = [0] * 25
        for x in range(5):
            for y in range(5):
                b[y + 5 * ((2 * x + 3 * y) % 5)] = _rotl(
                    lanes[x + 5 * y], _ROTATION[x][y]
                )
        # chi
        for x in range(5):
            for y in range(5):
                lanes[x + 5 * y] = b[x + 5 * y] ^ (
                    (~b[(x + 1) % 5 + 5 * y]) & b[(x + 2) % 5 + 5 * y] & _MASK
                )
        # iota
        lanes[0] ^= rc
    for i in range(25):
        state[8 * i : 8 * i + 8] = lanes[i].to_bytes(8, "little")


# --- STROBE-128 ------------------------------------------------------------

_STROBE_R = 166  # 200 - 128/4 - 2

_FLAG_I = 1
_FLAG_A = 1 << 1
_FLAG_C = 1 << 2
_FLAG_T = 1 << 3
_FLAG_M = 1 << 4
_FLAG_K = 1 << 5


class Strobe128:
    """Minimal STROBE-128 duplex: exactly the subset Merlin uses
    (meta-AD, AD, PRF, KEY)."""

    __slots__ = ("state", "pos", "pos_begin", "cur_flags")

    def __init__(self, protocol_label: bytes):
        st = bytearray(200)
        st[0:6] = bytes((1, _STROBE_R + 2, 1, 0, 1, 96))
        st[6:18] = b"STROBEv1.0.2"
        keccak_f1600(st)
        self.state = st
        self.pos = 0
        self.pos_begin = 0
        self.cur_flags = 0
        self.meta_ad(protocol_label, False)

    def clone(self) -> "Strobe128":
        c = Strobe128.__new__(Strobe128)
        c.state = bytearray(self.state)
        c.pos = self.pos
        c.pos_begin = self.pos_begin
        c.cur_flags = self.cur_flags
        return c

    # internal duplex ops

    def _run_f(self) -> None:
        self.state[self.pos] ^= self.pos_begin
        self.state[self.pos + 1] ^= 0x04
        self.state[_STROBE_R + 1] ^= 0x80
        keccak_f1600(self.state)
        self.pos = 0
        self.pos_begin = 0

    def _absorb(self, data: bytes) -> None:
        for byte in data:
            self.state[self.pos] ^= byte
            self.pos += 1
            if self.pos == _STROBE_R:
                self._run_f()

    def _overwrite(self, data: bytes) -> None:
        for byte in data:
            self.state[self.pos] = byte
            self.pos += 1
            if self.pos == _STROBE_R:
                self._run_f()

    def _squeeze(self, n: int) -> bytes:
        out = bytearray(n)
        for i in range(n):
            out[i] = self.state[self.pos]
            self.state[self.pos] = 0
            self.pos += 1
            if self.pos == _STROBE_R:
                self._run_f()
        return bytes(out)

    def _begin_op(self, flags: int, more: bool) -> None:
        if more:
            if self.cur_flags != flags:
                raise ValueError("strobe: op continuation changed flags")
            return
        if flags & _FLAG_T:
            raise ValueError("strobe: transport ops unsupported")
        old_begin = self.pos_begin
        self.pos_begin = self.pos + 1
        self.cur_flags = flags
        self._absorb(bytes((old_begin, flags)))
        force_f = bool(flags & (_FLAG_C | _FLAG_K))
        if force_f and self.pos != 0:
            self._run_f()

    # public ops (Merlin's subset)

    def meta_ad(self, data: bytes, more: bool) -> None:
        self._begin_op(_FLAG_M | _FLAG_A, more)
        self._absorb(data)

    def ad(self, data: bytes, more: bool) -> None:
        self._begin_op(_FLAG_A, more)
        self._absorb(data)

    def prf(self, n: int, more: bool) -> bytes:
        self._begin_op(_FLAG_I | _FLAG_A | _FLAG_C, more)
        return self._squeeze(n)

    def key(self, data: bytes, more: bool) -> None:
        self._begin_op(_FLAG_A | _FLAG_C, more)
        self._overwrite(data)


# --- Merlin transcript ------------------------------------------------------


def _le32(n: int) -> bytes:
    return n.to_bytes(4, "little")


class MerlinTranscript:
    """Merlin v1.0 transcript: labeled absorb / challenge over Strobe128."""

    __slots__ = ("strobe",)

    def __init__(self, label: bytes):
        self.strobe = Strobe128(b"Merlin v1.0")
        self.append_message(b"dom-sep", label)

    def clone(self) -> "MerlinTranscript":
        c = MerlinTranscript.__new__(MerlinTranscript)
        c.strobe = self.strobe.clone()
        return c

    def append_message(self, label: bytes, message: bytes) -> None:
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(_le32(len(message)), True)
        self.strobe.ad(message, False)

    def append_u64(self, label: bytes, value: int) -> None:
        self.append_message(label, value.to_bytes(8, "little"))

    def challenge_bytes(self, label: bytes, n: int) -> bytes:
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(_le32(n), True)
        return self.strobe.prf(n, False)

    # Transcript-based RNG (merlin::TranscriptRngBuilder). Used for signing
    # nonces: rekey with the secret nonce seed, then with external entropy.

    def build_rng(self) -> "TranscriptRngBuilder":
        return TranscriptRngBuilder(self.strobe.clone())


class TranscriptRngBuilder:
    __slots__ = ("strobe",)

    def __init__(self, strobe: Strobe128):
        self.strobe = strobe

    def rekey_with_witness_bytes(
        self, label: bytes, witness: bytes
    ) -> "TranscriptRngBuilder":
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(_le32(len(witness)), True)
        self.strobe.key(witness, False)
        return self

    def finalize(self, entropy32: bytes) -> "TranscriptRng":
        if len(entropy32) != 32:
            raise ValueError("transcript rng entropy must be 32 bytes")
        self.strobe.meta_ad(b"rng", False)
        self.strobe.key(entropy32, False)
        return TranscriptRng(self.strobe)


class TranscriptRng:
    __slots__ = ("strobe",)

    def __init__(self, strobe: Strobe128):
        self.strobe = strobe

    def fill_bytes(self, n: int) -> bytes:
        self.strobe.meta_ad(_le32(n), False)
        return self.strobe.prf(n, False)
