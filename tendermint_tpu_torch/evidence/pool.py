"""EvidencePool: persist, verify and expire evidence of byzantine behavior.

A copy of ``tendermint_tpu/evidence/pool.py`` (internal/evidence/
pool.go:42-411): pending evidence is kept in a KV store (it survives a
restart), pruned when the consensus params' age limits expire it, handed
to block proposals, marked committed once a block carries it, and filled
from the consensus state machine's conflicting-vote reports.

``EvidencePool(device=)`` is the device a light client attack's commits
are verified on; a duplicate vote's pair rides the shared scheduler
(``evidence/verify.py``). A device error escapes ``add_evidence``,
``check_evidence`` and ``update`` (so it stops a consensus node, as
``consensus/state.py`` says); the consensus buffer drops only evidence
that is invalid or whose validator set is gone.

As in the reference, each item is verified on its own: a block of N
duplicate votes is N two-lane flushes (ROADMAP A-H), and ``verify``
loads the validator set for every item.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Tuple

from tendermint_tpu_torch import resolve_device
from tendermint_tpu_torch.evidence.verify import (
    InvalidEvidenceError,
    verify_duplicate_vote,
    verify_light_client_attack,
)
from tendermint_tpu_torch.state.state import State
from tendermint_tpu_torch.storage.blockstore import BlockStore
from tendermint_tpu_torch.storage.kv import KVStore, MemDB, ordered_key, prefix_end
from tendermint_tpu_torch.types.block import Vote
from tendermint_tpu_torch.types.evidence import (
    DuplicateVoteEvidence,
    Evidence,
    LightClientAttackEvidence,
    evidence_from_proto_bytes,
)
from tendermint_tpu_torch.types.light import SignedHeader

PREFIX_PENDING = 9
PREFIX_COMMITTED = 10


def _pending_key(ev: Evidence) -> bytes:
    return ordered_key(PREFIX_PENDING, ev.height()) + ev.hash()


def _committed_key(ev: Evidence) -> bytes:
    return ordered_key(PREFIX_COMMITTED, ev.height()) + ev.hash()


def _expired(state: State, height: int, ns: int) -> bool:
    """Older than both of the consensus params' age limits."""
    params = state.consensus_params.evidence
    return (
        state.last_block_height - height > params.max_age_num_blocks
        and state.last_block_time.to_unix_ns() - ns > params.max_age_duration * 1e9
    )


class EvidencePool:
    def __init__(
        self,
        db: Optional[KVStore] = None,
        state_store=None,
        block_store: Optional[BlockStore] = None,
        device=None,
    ):
        self.device = resolve_device(device)
        self._db = db if db is not None else MemDB()
        self.state_store = state_store
        self.block_store = block_store
        self._mtx = threading.Lock()
        self.state: Optional[State] = None
        # Conflicting-vote pairs from consensus, held until their height
        # commits (pool.go consensusBuffer: the header at that height must
        # be in the store before the evidence can be verified).
        self._consensus_buffer: List[Tuple[Vote, Vote]] = []

    def set_state(self, state: State) -> None:
        self.state = state

    # --- queries -------------------------------------------------------------

    def pending_evidence(self, max_bytes: int) -> Tuple[List[Evidence], int]:
        """pool.go PendingEvidence: size-capped, in height order."""
        out: List[Evidence] = []
        total = 0
        for _, v in self._db.iterator(ordered_key(PREFIX_PENDING, 0), prefix_end(bytes([PREFIX_PENDING]))):
            if max_bytes >= 0 and total + len(v) > max_bytes:
                break
            out.append(evidence_from_proto_bytes(v))
            total += len(v)
        return out, total

    def is_pending(self, ev: Evidence) -> bool:
        return self._db.has(_pending_key(ev))

    def is_committed(self, ev: Evidence) -> bool:
        return self._db.has(_committed_key(ev))

    # --- ingestion -----------------------------------------------------------

    def add_evidence(self, ev: Evidence) -> None:
        """pool.go AddEvidence: dedupe, verify, persist."""
        with self._mtx:
            if self.is_pending(ev) or self.is_committed(ev):
                return
            self.verify(ev)
            self._db.set(_pending_key(ev), ev.to_proto_bytes())

    def report_conflicting_votes(self, vote_a: Vote, vote_b: Vote) -> None:
        """pool.go ReportConflictingVotes: buffer the pair; ``update``
        builds the evidence once the offending height has committed."""
        with self._mtx:
            self._consensus_buffer.append((vote_a, vote_b))

    def _process_consensus_buffer(self, state: State) -> None:
        """pool.go processConsensusBuffer (on Update): the evidence is
        stamped with ``state.last_block_time``, which its hash covers."""
        with self._mtx:
            buffered, keep = self._consensus_buffer, []
            self._consensus_buffer = []
        for vote_a, vote_b in buffered:
            if vote_a.height > state.last_block_height:
                keep.append((vote_a, vote_b))  # its height has not committed yet
                continue
            try:
                val_set = (
                    self.state_store.load_validators(vote_a.height)
                    if self.state_store is not None
                    else state.validators
                )
                self.add_evidence(DuplicateVoteEvidence.new(vote_a, vote_b, state.last_block_time, val_set))
            except (ValueError, LookupError, InvalidEvidenceError):
                pass
        if keep:
            with self._mtx:
                self._consensus_buffer.extend(keep)

    # --- verification --------------------------------------------------------

    def verify(self, ev: Evidence) -> None:
        """pool.go verify (abridged): the age window, then the checks of
        the evidence's type."""
        if self.state is None:
            raise InvalidEvidenceError("evidence pool has no state")
        state = self.state
        # The age by duration is measured against OUR header time at the
        # evidence height (verify.go:39-60): the evidence's own timestamp
        # is the submitter's and must not gate expiry.
        ev_time = ev.time()
        if self.block_store is not None:
            meta = self.block_store.load_block_meta(ev.height())
            if meta is None:
                raise InvalidEvidenceError(f"don't have block meta at height {ev.height()}")
            ev_time = meta.header.time
        if _expired(state, ev.height(), ev_time.to_unix_ns()):
            raise InvalidEvidenceError(f"evidence from height {ev.height()} is too old")
        if isinstance(ev, DuplicateVoteEvidence):
            val_set = self._validators_at(ev.height())
            verify_duplicate_vote(ev, state.chain_id, val_set)
            # the ABCI fields must match our records (verify.go:120-135)
            _, val = val_set.get_by_address(ev.vote_a.validator_address)
            if ev.validator_power != val.voting_power:
                raise InvalidEvidenceError("validator power mismatch")
            if ev.total_voting_power != val_set.total_voting_power():
                raise InvalidEvidenceError("total voting power mismatch")
        elif isinstance(ev, LightClientAttackEvidence):
            common = self._signed_header_at(ev.common_height)
            trusted = self._signed_header_at(ev.conflicting_block.height)
            if common is None or trusted is None:
                raise InvalidEvidenceError("don't have headers to verify the light client attack")
            common_vals = self._validators_at(ev.common_height)
            verify_light_client_attack(ev, common, trusted, common_vals, device=self.device)
            # the ABCI fields must match our records (verify.go:135-141)
            if ev.total_voting_power != common_vals.total_voting_power():
                raise InvalidEvidenceError(
                    "total voting power from the evidence and our validator set does not match"
                )
            if ev.timestamp != common.header.time:
                raise InvalidEvidenceError("evidence has a different time to the block it is associated with")
        else:
            raise InvalidEvidenceError(f"unknown evidence type {type(ev)}")

    def _validators_at(self, height: int):
        if self.state_store is None:
            raise InvalidEvidenceError("no state store to load validators")
        return self.state_store.load_validators(height)

    def _signed_header_at(self, height: int) -> Optional[SignedHeader]:
        if self.block_store is None:
            return None
        meta = self.block_store.load_block_meta(height)
        commit = self.block_store.load_block_commit(height)
        if meta is None or commit is None:
            return None
        return SignedHeader(header=meta.header, commit=commit)

    # --- consensus hooks -----------------------------------------------------

    def check_evidence(self, evidence: List[Evidence]) -> None:
        """pool.go CheckEvidence: a block's evidence, each item verified
        on its own unless it is pending here; committed evidence refused."""
        seen = set()
        for ev in evidence:
            key = ev.hash()
            if key in seen:
                raise InvalidEvidenceError("duplicate evidence in block")
            seen.add(key)
            if self.is_committed(ev):
                raise InvalidEvidenceError("evidence was already committed")
            if not self.is_pending(ev):
                self.verify(ev)

    def update(self, state: State, block_evidence: List[Evidence]) -> None:
        """pool.go Update: mark the block's evidence committed, prune the
        expired, then build the buffered conflicting votes' evidence now
        that their height is in the store."""
        self.state = state
        with self._mtx:
            for ev in block_evidence:
                self._db.set(_committed_key(ev), b"\x01")
                self._db.delete(_pending_key(ev))
            self._prune_expired(state)
        self._process_consensus_buffer(state)

    def _prune_expired(self, state: State) -> None:
        batch = self._db.new_batch()
        for k, v in self._db.iterator(ordered_key(PREFIX_PENDING, 0), prefix_end(bytes([PREFIX_PENDING]))):
            ev = evidence_from_proto_bytes(v)
            if _expired(state, ev.height(), ev.time().to_unix_ns()):
                batch.delete(k)
        batch.write()
