"""FilePV: the file-backed signer with its last-sign-state double-sign
guard.

A copy of ``tendermint_tpu/privval/file_pv.py`` (privval/file.go): a key
file (address, public and private key, type) and a state file (height,
round, step, the last sign-bytes and signature), both in the reference's
JSON and written atomically. The HRS check (file.go:135-170) refuses a
regression; an identical re-sign reuses the stored signature, and a
re-sign that differs only in its timestamp reuses the earlier timestamp
and signature (file.go:485-530), the path of a crash between signing and
the WAL. Signing runs on the host (RFC 8032 Ed25519, deterministic), as
in the reference.
"""

from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass
from typing import Optional, Tuple

from tendermint_tpu_torch.crypto.keys import Ed25519PrivKey, PubKey, privkey_from_type_and_bytes
from tendermint_tpu_torch.encoding.canonical import (
    SIGNED_MSG_TYPE_PRECOMMIT,
    SIGNED_MSG_TYPE_PREVOTE,
    Timestamp,
)
from tendermint_tpu_torch.encoding.proto import Reader
from tendermint_tpu_torch.privval.base import PrivValidator
from tendermint_tpu_torch.types.block import Proposal, Vote

STEP_PROPOSE = 1
STEP_PREVOTE = 2
STEP_PRECOMMIT = 3

_VOTE_STEP = {
    SIGNED_MSG_TYPE_PREVOTE: STEP_PREVOTE,
    SIGNED_MSG_TYPE_PRECOMMIT: STEP_PRECOMMIT,
}


class DoubleSignError(Exception):
    pass


def _atomic_write(path: str, data: bytes) -> None:
    """Write, fsync, then rename, so a crash never leaves a torn file."""
    dir_ = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=dir_)
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


@dataclass
class LastSignState:
    """privval/file.go FilePVLastSignState."""

    height: int = 0
    round: int = 0
    step: int = 0
    signature: bytes = b""
    sign_bytes: bytes = b""

    def check_hrs(self, height: int, round_: int, step: int) -> bool:
        """file.go:135-170: True iff the same HRS (the caller may reuse
        the signature); raises on any regression."""
        if self.height > height:
            raise DoubleSignError(f"height regression. Got {height}, last height {self.height}")
        if self.height == height:
            if self.round > round_:
                raise DoubleSignError(
                    f"round regression at height {height}. Got {round_}, last round {self.round}"
                )
            if self.round == round_:
                if self.step > step:
                    raise DoubleSignError(
                        f"step regression at height {height} round {round_}. "
                        f"Got {step}, last step {self.step}"
                    )
                if self.step == step:
                    if not self.sign_bytes:
                        raise DoubleSignError("no sign_bytes found")
                    if not self.signature:
                        raise RuntimeError("signature is nil but sign_bytes is not")
                    return True
        return False


class FilePV(PrivValidator):
    def __init__(
        self,
        priv_key,
        key_file_path: str,
        state_file_path: str,
        last_sign_state: Optional[LastSignState] = None,
    ):
        self.priv_key = priv_key
        self.key_file_path = key_file_path
        self.state_file_path = state_file_path
        self.last_sign_state = last_sign_state or LastSignState()

    # --- construction -------------------------------------------------------

    @classmethod
    def generate(cls, key_file_path: str, state_file_path: str) -> "FilePV":
        pv = cls(Ed25519PrivKey.generate(), key_file_path, state_file_path)
        pv.save()
        return pv

    @classmethod
    def load_or_generate(cls, key_file_path: str, state_file_path: str) -> "FilePV":
        if os.path.exists(key_file_path):
            return cls.load(key_file_path, state_file_path)
        return cls.generate(key_file_path, state_file_path)

    @classmethod
    def load(cls, key_file_path: str, state_file_path: str) -> "FilePV":
        with open(key_file_path) as f:
            key_doc = json.load(f)
        priv = privkey_from_type_and_bytes(
            key_doc.get("type", "ed25519"), bytes.fromhex(key_doc["priv_key"])
        )
        lss = LastSignState()
        if os.path.exists(state_file_path):
            with open(state_file_path) as f:
                doc = json.load(f)
            lss = LastSignState(
                height=int(doc.get("height", 0)),
                round=int(doc.get("round", 0)),
                step=int(doc.get("step", 0)),
                signature=bytes.fromhex(doc.get("signature", "")),
                sign_bytes=bytes.fromhex(doc.get("signbytes", "")),
            )
        return cls(priv, key_file_path, state_file_path, lss)

    def save(self) -> None:
        key_doc = {
            "address": self.priv_key.pub_key().address().hex().upper(),
            "pub_key": self.priv_key.pub_key().bytes().hex(),
            "priv_key": self.priv_key.bytes().hex(),
            "type": self.priv_key.type,
        }
        _atomic_write(self.key_file_path, json.dumps(key_doc, indent=2).encode())
        self._save_state()

    def _save_state(self) -> None:
        lss = self.last_sign_state
        doc = {
            "height": lss.height,
            "round": lss.round,
            "step": lss.step,
            "signature": lss.signature.hex(),
            "signbytes": lss.sign_bytes.hex(),
        }
        _atomic_write(self.state_file_path, json.dumps(doc, indent=2).encode())

    # --- PrivValidator ------------------------------------------------------

    def get_pub_key(self) -> PubKey:
        return self.priv_key.pub_key()

    def sign_vote(self, chain_id: str, vote: Vote) -> None:
        """privval/file.go:359-432."""
        if vote.type not in _VOTE_STEP:
            raise ValueError(f"unknown vote type {vote.type}")
        step = _VOTE_STEP[vote.type]
        lss = self.last_sign_state
        same_hrs = lss.check_hrs(vote.height, vote.round, step)
        sign_bytes = vote.sign_bytes(chain_id)

        # Extensions are not deterministic: always sign them anew for a
        # non-nil precommit; refuse extension data anywhere else.
        ext_sig = b""
        if vote.type == SIGNED_MSG_TYPE_PRECOMMIT and not vote.block_id.is_nil():
            ext_sig = self.priv_key.sign(vote.extension_sign_bytes(chain_id))
        elif vote.extension:
            raise ValueError(
                "unexpected vote extension - extensions are only allowed in non-nil precommits"
            )

        if same_hrs:
            if sign_bytes == lss.sign_bytes:
                vote.signature = lss.signature
            else:
                ts = _votes_only_differ_by_timestamp(lss.sign_bytes, sign_bytes)
                if ts is None:
                    raise DoubleSignError("conflicting data")
                vote.timestamp = ts
                vote.signature = lss.signature
            vote.extension_signature = ext_sig
            return

        sig = self.priv_key.sign(sign_bytes)
        self._save_signed(vote.height, vote.round, step, sign_bytes, sig)
        vote.signature = sig
        vote.extension_signature = ext_sig

    def sign_proposal(self, chain_id: str, proposal: Proposal) -> None:
        """privval/file.go:434-483."""
        lss = self.last_sign_state
        same_hrs = lss.check_hrs(proposal.height, proposal.round, STEP_PROPOSE)
        sign_bytes = proposal.sign_bytes(chain_id)
        if same_hrs:
            if sign_bytes == lss.sign_bytes:
                proposal.signature = lss.signature
            else:
                ts = _proposals_only_differ_by_timestamp(lss.sign_bytes, sign_bytes)
                if ts is None:
                    raise DoubleSignError("conflicting data")
                proposal.timestamp = ts
                proposal.signature = lss.signature
            return
        sig = self.priv_key.sign(sign_bytes)
        self._save_signed(proposal.height, proposal.round, STEP_PROPOSE, sign_bytes, sig)
        proposal.signature = sig

    def _save_signed(self, height: int, round_: int, step: int, sign_bytes: bytes, sig: bytes) -> None:
        self.last_sign_state = LastSignState(height, round_, step, sig, sign_bytes)
        self._save_state()


# --- timestamp-only differences (file.go:536-583) -----------------------------
#
# Strip the timestamp field from both canonical encodings and compare the
# rest; give back the earlier timestamp if they are the same.


def _strip_canonical_timestamp(sign_bytes: bytes, ts_field: int) -> Tuple[bytes, Timestamp]:
    """The delimited canonical vote or proposal without its timestamp
    field, and that timestamp."""
    r = Reader(sign_bytes)
    r.read_varint()  # the length prefix
    out = bytearray()
    ts = Timestamp(0, 0)
    while not r.eof():
        field_start = r.pos
        field, wire = r.read_tag()
        if field == ts_field and wire == 2:
            tr = Reader(r.read_bytes())
            secs = nanos = 0
            for tf, tw in tr.fields():
                if tf == 1 and tw == 0:
                    secs = tr.read_svarint()
                elif tf == 2 and tw == 0:
                    nanos = tr.read_svarint()
                else:
                    tr.skip(tw)
            ts = Timestamp(secs, nanos)
        else:
            r.skip(wire)
            out += sign_bytes[field_start : r.pos]
    return bytes(out), ts


def _only_differ_by_timestamp(last: bytes, new: bytes, ts_field: int) -> Optional[Timestamp]:
    try:
        last_stripped, last_ts = _strip_canonical_timestamp(last, ts_field)
        new_stripped, _ = _strip_canonical_timestamp(new, ts_field)
    except ValueError:
        return None
    return last_ts if last_stripped == new_stripped else None


def _votes_only_differ_by_timestamp(last: bytes, new: bytes) -> Optional[Timestamp]:
    return _only_differ_by_timestamp(last, new, ts_field=5)


def _proposals_only_differ_by_timestamp(last: bytes, new: bytes) -> Optional[Timestamp]:
    return _only_differ_by_timestamp(last, new, ts_field=6)
