"""Block types: Consensus, PartSetHeader, BlockID, CommitSig, Commit,
ExtendedCommit, Vote, Header, Data and Block.

The part of ``tendermint_tpu/types/block.py`` (types/block.go,
types/vote.go) that commit verification, the light client, the vote set
and block sync read: the block-ID flags, the commit signatures and
``Commit.vote_sign_bytes`` and ``hash``, the extended commit a block
store keeps, the ``validate_basic`` checks, the proto encodings the
hashes and the stores read and their decoders (``from_proto_bytes``),
``Header.hash``, ``Block`` with its hash and ``make_block``, and ``Vote``
with its sign-bytes, its checks and the pre-verification tag of the vote
pre-verifier (``consensus/reactor.py``). A block that carries evidence
raises: the evidence decoders and checks come with the evidence pool
(ROADMAP §A item 8c). Proposals are left out. Wire
encoding is gogoproto-compatible (ascending fields, proto3 zero
omission, non-nullable embedded messages always written), so hashes are
byte-exact with the reference.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field as dc_field
from typing import List, Optional

from tendermint_tpu_torch.crypto import merkle
from tendermint_tpu_torch.crypto.keys import ADDRESS_LEN, PubKey
from tendermint_tpu_torch.encoding.canonical import (
    SIGNED_MSG_TYPE_PRECOMMIT,
    SIGNED_MSG_TYPE_PREVOTE,
    Timestamp,
    vote_extension_sign_bytes,
    vote_sign_bytes,
)
from tendermint_tpu_torch.encoding.proto import (
    Reader,
    encode_bytes_field,
    encode_message_field,
    encode_varint_field,
)

HASH_SIZE = 32
MAX_CHAIN_ID_LEN = 50
BLOCK_PART_SIZE_BYTES = 65536  # types/params.go:21
MAX_SIGNATURE_SIZE = 64  # ed25519/sr25519
MAX_VOTE_EXTENSION_SIZE = 1024 * 1024  # types/vote.go:20

# Go's time.Time{} (January 1, year 1 UTC) in Unix seconds.
GO_ZERO_TIME = Timestamp(-62135596800, 0)

# BlockIDFlag (types/block.go:583-592)
BLOCK_ID_FLAG_ABSENT = 1
BLOCK_ID_FLAG_COMMIT = 2
BLOCK_ID_FLAG_NIL = 3

BLOCK_PROTOCOL = 11  # version/version.go BlockProtocol


def is_zero_time(ts: Timestamp) -> bool:
    return ts == GO_ZERO_TIME or ts == Timestamp(0, 0)


def validate_hash(h: bytes) -> None:
    """types/validation.go ValidateHash: empty or exactly 32 bytes."""
    if h and len(h) != HASH_SIZE:
        raise ValueError(f"expected hash size {HASH_SIZE}, got {len(h)}")


def _encode_time_field(field_no: int, ts: Timestamp) -> bytes:
    """Non-nullable stdtime field: always serialized (gogo marshaller)."""
    return encode_message_field(field_no, ts.encode())


def _decode_time(data: bytes) -> Timestamp:
    r = Reader(data)
    seconds = nanos = 0
    for f, w in r.fields():
        if f == 1 and w == 0:
            seconds = r.read_svarint()
        elif f == 2 and w == 0:
            nanos = r.read_svarint()
        else:
            r.skip(w)
    return Timestamp(seconds, nanos)


def cdc_encode_bytes(b: bytes) -> bytes:
    """gogotypes.BytesValue wrapper (types/encoding_helper.go:11)."""
    return encode_bytes_field(1, b)


def cdc_encode_string(s: str) -> bytes:
    return encode_bytes_field(1, s.encode("utf-8"))


def cdc_encode_int64(n: int) -> bytes:
    return encode_varint_field(1, n)


@dataclass(frozen=True)
class Consensus:
    """tendermint.version.Consensus {block=1, app=2}."""

    block: int = BLOCK_PROTOCOL
    app: int = 0

    def to_proto_bytes(self) -> bytes:
        return encode_varint_field(1, self.block) + encode_varint_field(2, self.app)

    @classmethod
    def from_proto_bytes(cls, data: bytes) -> "Consensus":
        r = Reader(data)
        block = app = 0
        for f, w in r.fields():
            if f == 1 and w == 0:
                block = r.read_varint()
            elif f == 2 and w == 0:
                app = r.read_varint()
            else:
                r.skip(w)
        return cls(block, app)


@dataclass(frozen=True)
class PartSetHeader:
    """types/part_set.go PartSetHeader {total=1 uint32, hash=2 bytes}."""

    total: int = 0
    hash: bytes = b""

    def is_zero(self) -> bool:
        return self.total == 0 and not self.hash

    def validate_basic(self) -> None:
        if self.total < 0:
            raise ValueError("negative Total")
        validate_hash(self.hash)

    def to_proto_bytes(self) -> bytes:
        return encode_varint_field(1, self.total) + encode_bytes_field(2, self.hash)

    @classmethod
    def from_proto_bytes(cls, data: bytes) -> "PartSetHeader":
        r = Reader(data)
        total, hash_ = 0, b""
        for f, w in r.fields():
            if f == 1 and w == 0:
                total = r.read_varint()
            elif f == 2 and w == 2:
                hash_ = r.read_bytes()
            else:
                r.skip(w)
        return cls(total, hash_)


@dataclass(frozen=True)
class BlockID:
    """types/block.go BlockID {hash=1, part_set_header=2 non-nullable}."""

    hash: bytes = b""
    part_set_header: PartSetHeader = dc_field(default_factory=PartSetHeader)

    def is_nil(self) -> bool:
        return not self.hash and self.part_set_header.is_zero()

    def is_complete(self) -> bool:
        return (
            len(self.hash) == HASH_SIZE
            and self.part_set_header.total > 0
            and len(self.part_set_header.hash) == HASH_SIZE
        )

    def validate_basic(self) -> None:
        validate_hash(self.hash)
        self.part_set_header.validate_basic()

    def key(self) -> bytes:
        """Map key: hash + psh proto (types/block.go BlockID.Key)."""
        return self.hash + self.part_set_header.to_proto_bytes()

    def to_proto_bytes(self) -> bytes:
        return encode_bytes_field(1, self.hash) + encode_message_field(
            2, self.part_set_header.to_proto_bytes()
        )

    @classmethod
    def from_proto_bytes(cls, data: bytes) -> "BlockID":
        r = Reader(data)
        hash_, psh = b"", PartSetHeader()
        for f, w in r.fields():
            if f == 1 and w == 2:
                hash_ = r.read_bytes()
            elif f == 2 and w == 2:
                psh = PartSetHeader.from_proto_bytes(r.read_bytes())
            else:
                r.skip(w)
        return cls(hash_, psh)


NIL_BLOCK_ID = BlockID()


@dataclass
class CommitSig:
    """types/block.go:604-615."""

    block_id_flag: int = BLOCK_ID_FLAG_ABSENT
    validator_address: bytes = b""
    timestamp: Timestamp = GO_ZERO_TIME
    signature: bytes = b""

    @classmethod
    def absent(cls) -> "CommitSig":
        return cls()

    def is_absent(self) -> bool:
        return self.block_id_flag == BLOCK_ID_FLAG_ABSENT

    def is_commit(self) -> bool:
        return self.block_id_flag == BLOCK_ID_FLAG_COMMIT

    def block_id(self, commit_block_id: BlockID) -> BlockID:
        """The BlockID this signature signed over (types/block.go:641-653)."""
        if self.block_id_flag == BLOCK_ID_FLAG_COMMIT:
            return commit_block_id
        if self.block_id_flag in (BLOCK_ID_FLAG_ABSENT, BLOCK_ID_FLAG_NIL):
            return NIL_BLOCK_ID
        raise ValueError(f"unknown BlockIDFlag: {self.block_id_flag}")

    def validate_basic(self) -> None:
        if self.block_id_flag not in (BLOCK_ID_FLAG_ABSENT, BLOCK_ID_FLAG_COMMIT, BLOCK_ID_FLAG_NIL):
            raise ValueError(f"unknown BlockIDFlag: {self.block_id_flag}")
        if self.block_id_flag == BLOCK_ID_FLAG_ABSENT:
            if self.validator_address:
                raise ValueError("validator address is present for absent CommitSig")
            if not is_zero_time(self.timestamp):
                raise ValueError("time is present for absent CommitSig")
            if self.signature:
                raise ValueError("signature is present for absent CommitSig")
        else:
            if len(self.validator_address) != ADDRESS_LEN:
                raise ValueError(
                    f"expected ValidatorAddress size {ADDRESS_LEN}, got "
                    f"{len(self.validator_address)}"
                )
            if not self.signature:
                raise ValueError("signature is missing")
            if len(self.signature) > MAX_SIGNATURE_SIZE:
                raise ValueError("signature is too big")

    def to_proto_bytes(self) -> bytes:
        return (
            encode_varint_field(1, self.block_id_flag)
            + encode_bytes_field(2, self.validator_address)
            + _encode_time_field(3, self.timestamp)
            + encode_bytes_field(4, self.signature)
        )

    @classmethod
    def from_proto_bytes(cls, data: bytes) -> "CommitSig":
        r = Reader(data)
        out = cls()
        for f, w in r.fields():
            if f == 1 and w == 0:
                out.block_id_flag = r.read_varint()
            elif f == 2 and w == 2:
                out.validator_address = r.read_bytes()
            elif f == 3 and w == 2:
                out.timestamp = _decode_time(r.read_bytes())
            elif f == 4 and w == 2:
                out.signature = r.read_bytes()
            else:
                r.skip(w)
        return out


@dataclass
class Commit:
    """types/block.go:815-828; signatures ordered by validator index."""

    height: int = 0
    round: int = 0
    block_id: BlockID = dc_field(default_factory=BlockID)
    signatures: List[CommitSig] = dc_field(default_factory=list)
    _hash: Optional[bytes] = dc_field(default=None, repr=False, compare=False)

    def size(self) -> int:
        return len(self.signatures)

    def vote_sign_bytes(self, chain_id: str, val_idx: int) -> bytes:
        """types/block.go:851-868: canonical sign-bytes for signature i."""
        cs = self.signatures[val_idx]
        bid = cs.block_id(self.block_id)
        return vote_sign_bytes(
            chain_id,
            SIGNED_MSG_TYPE_PRECOMMIT,
            self.height,
            self.round,
            bid.hash,
            bid.part_set_header.total,
            bid.part_set_header.hash,
            cs.timestamp,
        )

    def validate_basic(self) -> None:
        if self.height < 0:
            raise ValueError("negative Height")
        if self.round < 0:
            raise ValueError("negative Round")
        if self.height >= 1:
            if self.block_id.is_nil():
                raise ValueError("commit cannot be for nil block")
            if not self.signatures:
                raise ValueError("no signatures in commit")
            for i, cs in enumerate(self.signatures):
                try:
                    cs.validate_basic()
                except ValueError as e:
                    raise ValueError(f"wrong CommitSig #{i}: {e}") from e

    def hash(self) -> bytes:
        """Merkle root of the proto-encoded CommitSigs (types/block.go:901);
        kept once computed (a caller that edits a signature clears
        ``_hash``)."""
        if self._hash is None:
            self._hash = merkle.hash_from_byte_slices([cs.to_proto_bytes() for cs in self.signatures])
        return self._hash

    def to_proto_bytes(self) -> bytes:
        out = encode_varint_field(1, self.height)
        out += encode_varint_field(2, self.round)
        out += encode_message_field(3, self.block_id.to_proto_bytes())
        for cs in self.signatures:
            out += encode_message_field(4, cs.to_proto_bytes())
        return out

    @classmethod
    def from_proto_bytes(cls, data: bytes) -> "Commit":
        r = Reader(data)
        out = cls()
        for f, w in r.fields():
            if f == 1 and w == 0:
                out.height = r.read_svarint()
            elif f == 2 and w == 0:
                out.round = r.read_svarint()
            elif f == 3 and w == 2:
                out.block_id = BlockID.from_proto_bytes(r.read_bytes())
            elif f == 4 and w == 2:
                out.signatures.append(CommitSig.from_proto_bytes(r.read_bytes()))
            else:
                r.skip(w)
        return out


# --- ExtendedCommit (ABCI++ vote extensions) --------------------------------


@dataclass
class ExtendedCommitSig:
    """types/block.go:728-744: CommitSig + extension + extension sig."""

    commit_sig: CommitSig = dc_field(default_factory=CommitSig)
    extension: bytes = b""
    extension_signature: bytes = b""

    def validate_basic(self) -> None:
        self.commit_sig.validate_basic()
        if self.commit_sig.block_id_flag == BLOCK_ID_FLAG_COMMIT:
            if len(self.extension) > MAX_VOTE_EXTENSION_SIZE:
                raise ValueError("vote extension is too big")
            if not self.extension_signature:
                raise ValueError("vote extension signature is missing")
            if len(self.extension_signature) > MAX_SIGNATURE_SIZE:
                raise ValueError("vote extension signature is too big")
        elif self.extension_signature or self.extension:
            raise ValueError("vote extension and signature must be empty for non-commit sig")

    def ensure_extension(self) -> None:
        """types/block.go:766-779: commit sigs must carry an extension sig."""
        if self.commit_sig.block_id_flag == BLOCK_ID_FLAG_COMMIT and not self.extension_signature:
            raise ValueError("vote extension data is missing")

    def to_proto_bytes(self) -> bytes:
        cs = self.commit_sig
        return (
            encode_varint_field(1, cs.block_id_flag)
            + encode_bytes_field(2, cs.validator_address)
            + _encode_time_field(3, cs.timestamp)
            + encode_bytes_field(4, cs.signature)
            + encode_bytes_field(5, self.extension)
            + encode_bytes_field(6, self.extension_signature)
        )

    @classmethod
    def from_proto_bytes(cls, data: bytes) -> "ExtendedCommitSig":
        r = Reader(data)
        cs = CommitSig()
        ext = ext_sig = b""
        for f, w in r.fields():
            if f == 1 and w == 0:
                cs.block_id_flag = r.read_varint()
            elif f == 2 and w == 2:
                cs.validator_address = r.read_bytes()
            elif f == 3 and w == 2:
                cs.timestamp = _decode_time(r.read_bytes())
            elif f == 4 and w == 2:
                cs.signature = r.read_bytes()
            elif f == 5 and w == 2:
                ext = r.read_bytes()
            elif f == 6 and w == 2:
                ext_sig = r.read_bytes()
            else:
                r.skip(w)
        return cls(cs, ext, ext_sig)


@dataclass
class ExtendedCommit:
    """types/block.go ExtendedCommit: commit + vote extensions."""

    height: int = 0
    round: int = 0
    block_id: BlockID = dc_field(default_factory=BlockID)
    extended_signatures: List[ExtendedCommitSig] = dc_field(default_factory=list)

    def size(self) -> int:
        return len(self.extended_signatures)

    def to_commit(self) -> Commit:
        return Commit(
            height=self.height,
            round=self.round,
            block_id=self.block_id,
            signatures=[e.commit_sig for e in self.extended_signatures],
        )

    @classmethod
    def wrap_commit(cls, commit: Commit) -> "ExtendedCommit":
        return cls(
            height=commit.height,
            round=commit.round,
            block_id=commit.block_id,
            extended_signatures=[ExtendedCommitSig(s) for s in commit.signatures],
        )

    def ensure_extensions(self) -> None:
        for e in self.extended_signatures:
            e.ensure_extension()

    def to_proto_bytes(self) -> bytes:
        out = encode_varint_field(1, self.height)
        out += encode_varint_field(2, self.round)
        out += encode_message_field(3, self.block_id.to_proto_bytes())
        for e in self.extended_signatures:
            out += encode_message_field(4, e.to_proto_bytes())
        return out

    @classmethod
    def from_proto_bytes(cls, data: bytes) -> "ExtendedCommit":
        r = Reader(data)
        out = cls()
        for f, w in r.fields():
            if f == 1 and w == 0:
                out.height = r.read_svarint()
            elif f == 2 and w == 0:
                out.round = r.read_svarint()
            elif f == 3 and w == 2:
                out.block_id = BlockID.from_proto_bytes(r.read_bytes())
            elif f == 4 and w == 2:
                out.extended_signatures.append(ExtendedCommitSig.from_proto_bytes(r.read_bytes()))
            else:
                r.skip(w)
        return out


@dataclass
class Vote:
    """types/vote.go:55-66."""

    type: int = 0
    height: int = 0
    round: int = 0
    block_id: BlockID = dc_field(default_factory=BlockID)
    timestamp: Timestamp = GO_ZERO_TIME
    validator_address: bytes = b""
    validator_index: int = 0
    signature: bytes = b""
    extension: bytes = b""
    extension_signature: bytes = b""
    # Pre-verification tags set by the vote pre-verifier
    # (consensus/reactor.py): the (chain_id, pubkey bytes, sign-bytes
    # digest) this vote's signature(s) were verified against in a device
    # batch. verify() honours a tag only when all three match, and
    # re-verifies inline otherwise, so a stale or wrong tag costs only
    # the shortcut, never correctness.
    _pre_verified: Optional[tuple] = dc_field(default=None, compare=False, repr=False)
    _pre_verified_ext: Optional[tuple] = dc_field(default=None, compare=False, repr=False)

    def mark_pre_verified(
        self,
        chain_id: str,
        pub_key_bytes: bytes,
        extension_too: bool = False,
        sign_bytes_digest: Optional[bytes] = None,
        extension_digest: Optional[bytes] = None,
    ) -> None:
        """Record that a batch path already verified this vote.

        The tag carries a digest of the sign-bytes that were verified,
        and :meth:`verify` recomputes it before honouring the tag, so a
        signed field changed after pre-verification sends the vote back
        to a full signature check. A caller that verified specific bytes
        passes their digest; otherwise it is computed here from the
        vote's current content.
        """
        if sign_bytes_digest is None:
            sign_bytes_digest = hashlib.sha256(self.sign_bytes(chain_id)).digest()
        self._pre_verified = (chain_id, pub_key_bytes, sign_bytes_digest)
        if extension_too:
            if extension_digest is None:
                extension_digest = hashlib.sha256(self.extension_sign_bytes(chain_id)).digest()
            self._pre_verified_ext = (chain_id, pub_key_bytes, extension_digest)

    def sign_bytes(self, chain_id: str) -> bytes:
        return vote_sign_bytes(
            chain_id,
            self.type,
            self.height,
            self.round,
            self.block_id.hash,
            self.block_id.part_set_header.total,
            self.block_id.part_set_header.hash,
            self.timestamp,
        )

    def extension_sign_bytes(self, chain_id: str) -> bytes:
        return vote_extension_sign_bytes(chain_id, self.extension, self.height, self.round)

    def commit_sig(self) -> CommitSig:
        """types/vote.go:95-115."""
        if self.block_id.is_complete():
            flag = BLOCK_ID_FLAG_COMMIT
        elif self.block_id.is_nil():
            flag = BLOCK_ID_FLAG_NIL
        else:
            raise ValueError(f"invalid vote BlockID {self.block_id}")
        return CommitSig(flag, self.validator_address, self.timestamp, self.signature)

    def verify(self, chain_id: str, pub_key: PubKey) -> None:
        """types/vote.go Verify: address match + signature over sign-bytes."""
        if pub_key.address() != self.validator_address:
            raise VoteError("invalid validator address")
        sb = self.sign_bytes(chain_id)
        if self._pre_verified == (chain_id, pub_key.bytes(), hashlib.sha256(sb).digest()):
            return  # batch-verified for this key over these exact sign-bytes
        if not pub_key.verify_signature(sb, self.signature):
            raise VoteError("invalid signature")

    def verify_vote_and_extension(self, chain_id: str, pub_key: PubKey) -> None:
        """types/vote.go:258-274: also checks the extension signature of
        a non-nil precommit."""
        self.verify(chain_id, pub_key)
        if self.type == SIGNED_MSG_TYPE_PRECOMMIT and not self.block_id.is_nil():
            self.verify_extension(chain_id, pub_key)

    def verify_extension(self, chain_id: str, pub_key: PubKey) -> None:
        if self.type != SIGNED_MSG_TYPE_PRECOMMIT or self.block_id.is_nil():
            return
        esb = self.extension_sign_bytes(chain_id)
        if self._pre_verified_ext == (chain_id, pub_key.bytes(), hashlib.sha256(esb).digest()):
            return
        if not pub_key.verify_signature(esb, self.extension_signature):
            raise VoteError("invalid extension signature")

    def validate_basic(self) -> None:
        if self.type not in (SIGNED_MSG_TYPE_PREVOTE, SIGNED_MSG_TYPE_PRECOMMIT):
            raise ValueError("invalid Type")
        if self.height < 0:
            raise ValueError("negative Height")
        if self.round < 0:
            raise ValueError("negative Round")
        if not self.block_id.is_nil():
            self.block_id.validate_basic()
            if not self.block_id.is_complete():
                raise ValueError("blockID must be either empty or complete")
        if len(self.validator_address) != ADDRESS_LEN:
            raise ValueError(
                f"expected ValidatorAddress size {ADDRESS_LEN}, got "
                f"{len(self.validator_address)}"
            )
        if self.validator_index < 0:
            raise ValueError("negative ValidatorIndex")
        if not self.signature:
            raise ValueError("signature is missing")
        if len(self.signature) > MAX_SIGNATURE_SIZE:
            raise ValueError("signature is too big")
        if self.type != SIGNED_MSG_TYPE_PRECOMMIT and (self.extension or self.extension_signature):
            raise ValueError("extension only allowed on precommits")
        if len(self.extension) > MAX_VOTE_EXTENSION_SIZE:
            raise ValueError("vote extension is too big")
        if self.extension and not self.extension_signature:
            raise ValueError("vote extension signature absent on vote with extension")
        if len(self.extension_signature) > MAX_SIGNATURE_SIZE:
            raise ValueError("vote extension signature is too big")


class VoteError(ValueError):
    pass


# Header fields 6-14, the hashes and the proposer address, in field order.
_HEADER_HASH_FIELDS = (
    "last_commit_hash",
    "data_hash",
    "validators_hash",
    "next_validators_hash",
    "consensus_hash",
    "app_hash",
    "last_results_hash",
    "evidence_hash",
    "proposer_address",
)


@dataclass
class Header:
    """types/block.go:332-358: the fields, their hash and their checks."""

    version: Consensus = dc_field(default_factory=Consensus)
    chain_id: str = ""
    height: int = 0
    time: Timestamp = GO_ZERO_TIME
    last_block_id: BlockID = dc_field(default_factory=BlockID)
    last_commit_hash: bytes = b""
    data_hash: bytes = b""
    validators_hash: bytes = b""
    next_validators_hash: bytes = b""
    consensus_hash: bytes = b""
    app_hash: bytes = b""
    last_results_hash: bytes = b""
    evidence_hash: bytes = b""
    proposer_address: bytes = b""

    def hash(self) -> bytes:
        """Merkle tree over the 14 encoded fields (types/block.go:447-490);
        empty while the header has no validators hash."""
        if not self.validators_hash:
            return b""
        return merkle.hash_from_byte_slices(
            [
                self.version.to_proto_bytes(),
                cdc_encode_string(self.chain_id),
                cdc_encode_int64(self.height),
                self.time.encode(),
                self.last_block_id.to_proto_bytes(),
                cdc_encode_bytes(self.last_commit_hash),
                cdc_encode_bytes(self.data_hash),
                cdc_encode_bytes(self.validators_hash),
                cdc_encode_bytes(self.next_validators_hash),
                cdc_encode_bytes(self.consensus_hash),
                cdc_encode_bytes(self.app_hash),
                cdc_encode_bytes(self.last_results_hash),
                cdc_encode_bytes(self.evidence_hash),
                cdc_encode_bytes(self.proposer_address),
            ]
        )

    def validate_basic(self) -> None:
        if self.version.block != BLOCK_PROTOCOL:
            raise ValueError(
                f"block protocol is incorrect: got {self.version.block}, want {BLOCK_PROTOCOL}"
            )
        if len(self.chain_id) > MAX_CHAIN_ID_LEN:
            raise ValueError("chainID is too long")
        if self.height < 0:
            raise ValueError("negative Height")
        if self.height == 0:
            raise ValueError("zero Height")
        self.last_block_id.validate_basic()
        for name in (
            "last_commit_hash",
            "data_hash",
            "evidence_hash",
            "validators_hash",
            "next_validators_hash",
            "consensus_hash",
            "last_results_hash",
        ):
            try:
                validate_hash(getattr(self, name))
            except ValueError as e:
                raise ValueError(f"wrong {name}: {e}") from e
        if len(self.proposer_address) != ADDRESS_LEN:
            raise ValueError("invalid ProposerAddress length")

    def to_proto_bytes(self) -> bytes:
        out = encode_message_field(1, self.version.to_proto_bytes())
        out += encode_bytes_field(2, self.chain_id.encode("utf-8"))
        out += encode_varint_field(3, self.height)
        out += _encode_time_field(4, self.time)
        out += encode_message_field(5, self.last_block_id.to_proto_bytes())
        for field_no, name in enumerate(_HEADER_HASH_FIELDS, start=6):
            out += encode_bytes_field(field_no, getattr(self, name))
        return out

    @classmethod
    def from_proto_bytes(cls, data: bytes) -> "Header":
        r = Reader(data)
        out = cls()
        for f, w in r.fields():
            if f == 1 and w == 2:
                out.version = Consensus.from_proto_bytes(r.read_bytes())
            elif f == 2 and w == 2:
                out.chain_id = r.read_bytes().decode("utf-8")
            elif f == 3 and w == 0:
                out.height = r.read_svarint()
            elif f == 4 and w == 2:
                out.time = _decode_time(r.read_bytes())
            elif f == 5 and w == 2:
                out.last_block_id = BlockID.from_proto_bytes(r.read_bytes())
            elif 6 <= f <= 14 and w == 2:
                setattr(out, _HEADER_HASH_FIELDS[f - 6], r.read_bytes())
            else:
                r.skip(w)
        return out


# --- Data / Block -----------------------------------------------------------


def tx_hash(tx: bytes) -> bytes:
    """types/tx.go Tx.Hash: SHA256 of the raw bytes."""
    return hashlib.sha256(tx).digest()


@dataclass
class Data:
    """types/block.go Data: the transactions."""

    txs: List[bytes] = dc_field(default_factory=list)
    _hash: Optional[bytes] = dc_field(default=None, repr=False, compare=False)

    def hash(self) -> bytes:
        """Merkle root over per-tx SHA-256 hashes (types/tx.go Txs.Hash:
        leaf_i = sha256(tx_i), then HashFromByteSlices)."""
        if self._hash is None:
            self._hash = merkle.hash_from_byte_slices([tx_hash(tx) for tx in self.txs])
        return self._hash

    def to_proto_bytes(self) -> bytes:
        # every tx is written, an empty one too (repeated bytes)
        return b"".join(encode_message_field(1, tx) for tx in self.txs)

    @classmethod
    def from_proto_bytes(cls, data: bytes) -> "Data":
        r = Reader(data)
        txs: List[bytes] = []
        for f, w in r.fields():
            if f == 1 and w == 2:
                txs.append(r.read_bytes())
            else:
                r.skip(w)
        return cls(txs)


def _no_evidence(evidence) -> None:
    if evidence:
        raise ValueError(
            "a block that carries evidence is not ported: the evidence decoders and "
            "checks come with the evidence pool (ROADMAP §A item 8c)"
        )


@dataclass
class Block:
    """types/block.go Block = Header + Data + EvidenceList + LastCommit.

    ``evidence`` stays empty in the port: every method that would read
    an evidence item raises (ROADMAP §A item 8c)."""

    header: Header = dc_field(default_factory=Header)
    data: Data = dc_field(default_factory=Data)
    evidence: List[object] = dc_field(default_factory=list)
    last_commit: Optional[Commit] = None
    _hash: Optional[bytes] = dc_field(default=None, repr=False, compare=False)

    def hash(self) -> bytes:
        if self._hash is None:
            self.fill_header()
            self._hash = self.header.hash()
        return self._hash

    def evidence_hash(self) -> bytes:
        _no_evidence(self.evidence)
        return merkle.empty_hash()

    def fill_header(self) -> None:
        """types/block.go:133-148: derive the data-dependent header hashes."""
        if not self.header.last_commit_hash and self.last_commit is not None:
            self.header.last_commit_hash = self.last_commit.hash()
        if not self.header.data_hash:
            self.header.data_hash = self.data.hash()
        if not self.header.evidence_hash:
            self.header.evidence_hash = self.evidence_hash()

    def validate_basic(self) -> None:
        """types/block.go:55-93."""
        self.header.validate_basic()
        if self.last_commit is None:
            raise ValueError("nil LastCommit")
        try:
            self.last_commit.validate_basic()
        except ValueError as e:
            raise ValueError(f"wrong LastCommit: {e}") from e
        if self.header.last_commit_hash != self.last_commit.hash():
            raise ValueError("wrong Header.LastCommitHash")
        if self.header.data_hash != self.data.hash():
            raise ValueError("wrong Header.DataHash")
        if self.header.evidence_hash != self.evidence_hash():
            raise ValueError("wrong Header.EvidenceHash")

    def make_block_id(self, part_set_header: Optional[PartSetHeader] = None) -> BlockID:
        return BlockID(self.hash(), part_set_header or PartSetHeader())

    def to_proto_bytes(self) -> bytes:
        _no_evidence(self.evidence)
        out = encode_message_field(1, self.header.to_proto_bytes())
        out += encode_message_field(2, self.data.to_proto_bytes())
        out += encode_message_field(3, b"")  # the empty EvidenceList
        if self.last_commit is not None:
            out += encode_message_field(4, self.last_commit.to_proto_bytes())
        return out

    @classmethod
    def from_proto_bytes(cls, data: bytes) -> "Block":
        r = Reader(data)
        out = cls()
        for f, w in r.fields():
            if f == 1 and w == 2:
                out.header = Header.from_proto_bytes(r.read_bytes())
            elif f == 2 and w == 2:
                out.data = Data.from_proto_bytes(r.read_bytes())
            elif f == 3 and w == 2:
                er = Reader(r.read_bytes())
                for ef, ew in er.fields():
                    _no_evidence(ef == 1 and ew == 2)
                    er.skip(ew)
            elif f == 4 and w == 2:
                out.last_commit = Commit.from_proto_bytes(r.read_bytes())
            else:
                r.skip(w)
        return out


def make_block(
    height: int,
    txs: List[bytes],
    last_commit: Optional[Commit],
    evidence: Optional[List[object]] = None,
) -> Block:
    """types/block.go MakeBlock."""
    _no_evidence(evidence)
    block = Block(header=Header(height=height), data=Data(txs=list(txs)), last_commit=last_commit)
    block.fill_header()
    return block
