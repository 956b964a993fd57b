"""StateStore: persists State, per-height validator sets, per-height
consensus params, and FinalizeBlock responses (internal/state/store.go).

A copy of ``tendermint_tpu/state/store.py``.

Validator sets are stored sparsely: a full set only at heights where the
set changed (and every `VALSET_CHECKPOINT_INTERVAL`), other heights store
a back-pointer — the reference's ValidatorsInfo scheme.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

from tendermint_tpu_torch.encoding.proto import (
    Reader,
    encode_bytes_field,
    encode_message_field,
    encode_varint_field,
)
from tendermint_tpu_torch.state.state import State
from tendermint_tpu_torch.storage.kv import KVStore, ordered_key
from tendermint_tpu_torch.types.block import BlockID, Consensus, _decode_time, _encode_time_field
from tendermint_tpu_torch.types.params import (
    ConsensusParams,
    consensus_params_from_proto_bytes,
    consensus_params_to_proto_bytes,
)
from tendermint_tpu_torch.types.validator_set import ValidatorSet

VALSET_CHECKPOINT_INTERVAL = 100000  # internal/state/store.go valSetCheckpointInterval

PREFIX_VALIDATORS = 5
PREFIX_CONSENSUS_PARAMS = 6
PREFIX_ABCI_RESPONSES = 7
PREFIX_STATE = 8


def _validators_key(height: int) -> bytes:
    return ordered_key(PREFIX_VALIDATORS, height)


def _params_key(height: int) -> bytes:
    return ordered_key(PREFIX_CONSENSUS_PARAMS, height)


def _abci_responses_key(height: int) -> bytes:
    return ordered_key(PREFIX_ABCI_RESPONSES, height)


def _state_key() -> bytes:
    return bytes([PREFIX_STATE])


def _encode_state(s: State) -> bytes:
    """tendermint.state.State layout (proto/tendermint/state/types.proto):
    chain_id=2, initial_height=14, last_block_height=3, last_block_id=4,
    last_block_time=5, next_validators=6, validators=7, last_validators=8,
    last_height_validators_changed=9, consensus_params=10,
    last_height_consensus_params_changed=11, last_results_hash=12,
    app_hash=13; version.consensus packed in 1."""
    out = encode_message_field(
        1, encode_message_field(1, s.version.to_proto_bytes())
    )
    out += encode_bytes_field(2, s.chain_id.encode())
    out += encode_varint_field(3, s.last_block_height)
    out += encode_message_field(4, s.last_block_id.to_proto_bytes())
    out += _encode_time_field(5, s.last_block_time)
    if s.next_validators is not None and not s.next_validators.is_nil_or_empty():
        out += encode_message_field(6, s.next_validators.to_proto_bytes())
    if s.validators is not None and not s.validators.is_nil_or_empty():
        out += encode_message_field(7, s.validators.to_proto_bytes())
    if s.last_validators is not None and not s.last_validators.is_nil_or_empty():
        out += encode_message_field(8, s.last_validators.to_proto_bytes())
    out += encode_varint_field(9, s.last_height_validators_changed)
    out += encode_message_field(
        10, consensus_params_to_proto_bytes(s.consensus_params)
    )
    out += encode_varint_field(11, s.last_height_consensus_params_changed)
    out += encode_bytes_field(12, s.last_results_hash)
    out += encode_bytes_field(13, s.app_hash)
    out += encode_varint_field(14, s.initial_height)
    return out


def _decode_state(data: bytes) -> State:
    s = State()
    r = Reader(data)
    for f, w in r.fields():
        if f == 1 and w == 2:
            vr = Reader(r.read_bytes())
            for vf, vw in vr.fields():
                if vf == 1 and vw == 2:
                    s.version = Consensus.from_proto_bytes(vr.read_bytes())
                else:
                    vr.skip(vw)
        elif f == 2 and w == 2:
            s.chain_id = r.read_bytes().decode()
        elif f == 3 and w == 0:
            s.last_block_height = r.read_svarint()
        elif f == 4 and w == 2:
            s.last_block_id = BlockID.from_proto_bytes(r.read_bytes())
        elif f == 5 and w == 2:
            s.last_block_time = _decode_time(r.read_bytes())
        elif f == 6 and w == 2:
            s.next_validators = ValidatorSet.from_proto_bytes(r.read_bytes())
        elif f == 7 and w == 2:
            s.validators = ValidatorSet.from_proto_bytes(r.read_bytes())
        elif f == 8 and w == 2:
            s.last_validators = ValidatorSet.from_proto_bytes(r.read_bytes())
        elif f == 9 and w == 0:
            s.last_height_validators_changed = r.read_svarint()
        elif f == 10 and w == 2:
            s.consensus_params = consensus_params_from_proto_bytes(r.read_bytes())
        elif f == 11 and w == 0:
            s.last_height_consensus_params_changed = r.read_svarint()
        elif f == 12 and w == 2:
            s.last_results_hash = r.read_bytes()
        elif f == 13 and w == 2:
            s.app_hash = r.read_bytes()
        elif f == 14 and w == 0:
            s.initial_height = r.read_svarint()
        else:
            r.skip(w)
    if s.last_validators is None:
        s.last_validators = ValidatorSet()
    return s


@dataclass
class ValidatorsInfo:
    """Sparse valset record: full set or back-pointer
    (internal/state/store.go ValidatorsInfo)."""

    last_height_changed: int
    validator_set: Optional[ValidatorSet] = None

    def encode(self) -> bytes:
        out = encode_varint_field(1, self.last_height_changed)
        if self.validator_set is not None:
            out += encode_message_field(
                2, self.validator_set.to_proto_bytes()
            )
        return out

    @classmethod
    def decode(cls, data: bytes) -> "ValidatorsInfo":
        r = Reader(data)
        height = 0
        vset = None
        for f, w in r.fields():
            if f == 1 and w == 0:
                height = r.read_svarint()
            elif f == 2 and w == 2:
                vset = ValidatorSet.from_proto_bytes(r.read_bytes())
            else:
                r.skip(w)
        return cls(height, vset)


class StateStore:
    def __init__(self, db: KVStore):
        self._db = db

    # --- state ---------------------------------------------------------------

    def load(self) -> Optional[State]:
        raw = self._db.get(_state_key())
        return _decode_state(raw) if raw is not None else None

    def save(self, state: State) -> None:
        """store.go Save: state + next-height valset + params."""
        next_height = state.last_block_height + 1
        if state.last_block_height == 0:  # genesis bootstrap
            next_height = state.initial_height
            self._save_validators(
                next_height, next_height, state.validators
            )
        self._save_validators(
            next_height + 1, state.last_height_validators_changed, state.next_validators
        )
        self._save_params(
            next_height,
            state.last_height_consensus_params_changed,
            state.consensus_params,
        )
        self._db.set(_state_key(), _encode_state(state))

    def bootstrap(self, state: State) -> None:
        """store.go Bootstrap (statesync entry): full valset records at
        h (last), h+1 (current), h+2 (next) so commit verification and
        ABCI CommitInfo construction work from the restored height."""
        height = state.last_block_height + 1
        if state.last_validators is not None \
                and not state.last_validators.is_nil_or_empty():
            self._save_validators(height - 1, height - 1, state.last_validators)
        self._save_validators(height, height, state.validators)
        self._save_validators(
            height + 1, height + 1, state.next_validators
        )
        self._save_params(
            height, state.last_height_consensus_params_changed, state.consensus_params
        )
        self._db.set(_state_key(), _encode_state(state))

    # --- validator sets ------------------------------------------------------

    def _save_validators(
        self, height: int, last_height_changed: int, vset: Optional[ValidatorSet]
    ) -> None:
        if vset is None:
            return
        if last_height_changed > height:
            raise ValueError("lastHeightChanged cannot be greater than ValidatorsInfo height")
        # Persist the full set at change heights and checkpoints; pointer otherwise.
        if height == last_height_changed or height % VALSET_CHECKPOINT_INTERVAL == 0:
            info = ValidatorsInfo(last_height_changed, vset)
        else:
            info = ValidatorsInfo(last_height_changed)
        self._db.set(_validators_key(height), info.encode())

    def load_validators(self, height: int) -> ValidatorSet:
        """store.go LoadValidators with pointer-chase + priority replay."""
        raw = self._db.get(_validators_key(height))
        if raw is None:
            raise LookupError(f"no validator set at height {height}")
        info = ValidatorsInfo.decode(raw)
        if info.validator_set is not None:
            return info.validator_set
        raw2 = self._db.get(_validators_key(info.last_height_changed))
        if raw2 is None:
            raise LookupError(
                f"missing checkpoint validator set at height {info.last_height_changed}"
            )
        info2 = ValidatorsInfo.decode(raw2)
        if info2.validator_set is None:
            raise LookupError(
                f"validator pointer at {height} led to another pointer at "
                f"{info.last_height_changed}"
            )
        vset = info2.validator_set.copy()
        # Replay proposer rotation to the requested height (store.go:105-120).
        vset.increment_proposer_priority(height - info.last_height_changed)
        return vset

    # --- consensus params ----------------------------------------------------

    def _save_params(
        self, height: int, last_height_changed: int, params: ConsensusParams
    ) -> None:
        if height == last_height_changed:
            payload = encode_varint_field(1, last_height_changed) + encode_message_field(
                2, consensus_params_to_proto_bytes(params)
            )
        else:
            payload = encode_varint_field(1, last_height_changed)
        self._db.set(_params_key(height), payload)

    def load_consensus_params(self, height: int) -> ConsensusParams:
        raw = self._db.get(_params_key(height))
        if raw is None:
            raise LookupError(f"no consensus params at height {height}")
        last_height_changed, params = self._decode_params_info(raw)
        if params is not None:
            return params
        raw2 = self._db.get(_params_key(last_height_changed))
        if raw2 is None:
            raise LookupError(
                f"missing consensus params at change height {last_height_changed}"
            )
        _, params2 = self._decode_params_info(raw2)
        if params2 is None:
            raise LookupError("consensus params pointer led to another pointer")
        return params2

    @staticmethod
    def _decode_params_info(raw: bytes) -> Tuple[int, Optional[ConsensusParams]]:
        r = Reader(raw)
        height = 0
        params = None
        for f, w in r.fields():
            if f == 1 and w == 0:
                height = r.read_svarint()
            elif f == 2 and w == 2:
                params = consensus_params_from_proto_bytes(r.read_bytes())
            else:
                r.skip(w)
        return height, params

    # --- ABCI responses -------------------------------------------------------

    def save_finalize_block_response(self, height: int, response_bytes: bytes) -> None:
        """Raw proto bytes of the FinalizeBlock response, for replay/indexing
        (store.go SaveFinalizeBlockResponses)."""
        self._db.set(_abci_responses_key(height), response_bytes)

    def load_finalize_block_response(self, height: int) -> Optional[bytes]:
        return self._db.get(_abci_responses_key(height))

    def load_decoded_finalize_block_response(self, height: int):
        """The stored FinalizeBlock response as an abci object, or None —
        the public seam replay/reindex/RPC share (store.go
        LoadFinalizeBlockResponses)."""
        raw = self.load_finalize_block_response(height)
        if raw is None:
            return None
        from tendermint_tpu_torch.state.execution import (
            _unmarshal_finalize_response,
        )

        return _unmarshal_finalize_response(raw)

    def prune_states(self, retain_height: int) -> None:
        """store.go PruneStates: drop valsets/params/responses below height."""
        for prefix, keyfn in (
            (PREFIX_VALIDATORS, _validators_key),
            (PREFIX_CONSENSUS_PARAMS, _params_key),
            (PREFIX_ABCI_RESPONSES, _abci_responses_key),
        ):
            batch = self._db.new_batch()
            for k, _ in self._db.iterator(
                ordered_key(prefix, 0), keyfn(retain_height)
            ):
                batch.delete(k)
            batch.write()
