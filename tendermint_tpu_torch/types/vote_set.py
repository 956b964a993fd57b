"""VoteSet: the 2/3-majority tally of one (height, round, type).

Counterpart of ``tendermint_tpu/types/vote_set.py`` (types/vote_set.go:
56-476): per-validator primary votes, per-block sub-tallies
(``votesByBlock``), conflict tracking for evidence, and peer-claimed
majorities that allow tracking conflicting votes beyond the first.
Thread-safe like the reference (consensus and gossip touch it from
different threads).

A vote the pre-verifier (``consensus/reactor.py``) tagged skips the
inline signature check in ``add_vote``: ``Vote.verify`` honours the tag
only for the exact key and sign-bytes it was issued for. The consensus
state machine reads ``make_extended_commit`` (the seen commit it stores)
and ``vote_set_from_commit`` (its last commit after a restart).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

from tendermint_tpu_torch.encoding.canonical import SIGNED_MSG_TYPE_PRECOMMIT
from tendermint_tpu_torch.libs.bits import BitArray
from tendermint_tpu_torch.types.block import (
    BlockID,
    Commit,
    ExtendedCommit,
    ExtendedCommitSig,
    Vote,
)
from tendermint_tpu_torch.types.validator_set import ValidatorSet


class VoteSetError(ValueError):
    pass


class ConflictingVotesError(Exception):
    """types/vote.go ErrVoteConflictingVotes: evidence material."""

    def __init__(self, vote_a: Vote, vote_b: Vote):
        self.vote_a = vote_a
        self.vote_b = vote_b
        super().__init__(f"conflicting votes from validator {vote_a.validator_address.hex()}")


class NonDeterministicSignatureError(VoteSetError):
    pass


class _BlockVotes:
    """types/vote_set.go:482-512: the tally of one block's votes."""

    __slots__ = ("peer_maj23", "bit_array", "votes", "sum")

    def __init__(self, peer_maj23: bool, num_validators: int):
        self.peer_maj23 = peer_maj23
        self.bit_array = BitArray(num_validators)
        self.votes: List[Optional[Vote]] = [None] * num_validators
        self.sum = 0

    def add_verified_vote(self, vote: Vote, voting_power: int) -> None:
        val_index = vote.validator_index
        if self.votes[val_index] is None:
            self.bit_array.set_index(val_index, True)
            self.votes[val_index] = vote
            self.sum += voting_power

    def get_by_index(self, index: int) -> Optional[Vote]:
        return self.votes[index]


class VoteSet:
    def __init__(
        self,
        chain_id: str,
        height: int,
        round_: int,
        signed_msg_type: int,
        val_set: ValidatorSet,
        extensions_enabled: bool = False,
    ):
        if height == 0:
            raise ValueError("Cannot make VoteSet for height == 0")
        self.chain_id = chain_id
        self.height = height
        self.round = round_
        self.signed_msg_type = signed_msg_type
        self.val_set = val_set
        self.extensions_enabled = extensions_enabled
        self._mtx = threading.Lock()
        self.votes_bit_array = BitArray(len(val_set))
        self.votes: List[Optional[Vote]] = [None] * len(val_set)
        self.sum = 0
        self.maj23: Optional[BlockID] = None
        self.votes_by_block: Dict[bytes, _BlockVotes] = {}
        self.peer_maj23s: Dict[str, BlockID] = {}

    @classmethod
    def extended(
        cls, chain_id: str, height: int, round_: int, signed_msg_type: int, val_set: ValidatorSet
    ) -> "VoteSet":
        """NewExtendedVoteSet: verifies vote extensions on every add."""
        return cls(chain_id, height, round_, signed_msg_type, val_set, True)

    def size(self) -> int:
        return len(self.val_set)

    # --- adding votes -------------------------------------------------------

    def add_vote(self, vote: Optional[Vote]) -> bool:
        """types/vote_set.go:150-258. Returns True if added; raises on an
        invalid or conflicting vote (ConflictingVotesError carries both)."""
        if vote is None:
            raise VoteSetError("nil vote")
        with self._mtx:
            return self._add_vote(vote)

    def _add_vote(self, vote: Vote) -> bool:
        val_index = vote.validator_index
        val_addr = vote.validator_address
        block_key = vote.block_id.key()

        if val_index < 0:
            raise VoteSetError("index < 0: invalid validator index")
        if not val_addr:
            raise VoteSetError("empty address: invalid validator address")
        if vote.height != self.height or vote.round != self.round or vote.type != self.signed_msg_type:
            raise VoteSetError(
                f"expected {self.height}/{self.round}/{self.signed_msg_type}, "
                f"got {vote.height}/{vote.round}/{vote.type}: unexpected step"
            )
        val = self.val_set.get_by_index(val_index)
        if val is None:
            raise VoteSetError(
                f"cannot find validator {val_index} in valSet of size "
                f"{len(self.val_set)}: invalid validator index"
            )
        if val_addr != val.address:
            raise VoteSetError(
                "vote.validator_address does not match address for "
                "vote.validator_index: invalid validator address"
            )

        existing = self._get_vote(val_index, block_key)
        if existing is not None:
            if existing.signature == vote.signature:
                return False  # duplicate
            raise NonDeterministicSignatureError(f"existing vote: {existing}; new vote: {vote}")

        # The signature check (vote_set.go:211-222); a pre-verified vote
        # skips the host verify here.
        if self.extensions_enabled:
            vote.verify_vote_and_extension(self.chain_id, val.pub_key)
        else:
            vote.verify(self.chain_id, val.pub_key)
            if vote.extension or vote.extension_signature:
                raise VoteSetError("unexpected vote extension data present in vote")

        added, conflicting = self._add_verified_vote(vote, block_key, val.voting_power)
        if conflicting is not None:
            raise ConflictingVotesError(conflicting, vote)
        if not added:
            raise RuntimeError("expected to add non-conflicting vote")
        return added

    def _get_vote(self, val_index: int, block_key: bytes) -> Optional[Vote]:
        existing = self.votes[val_index]
        if existing is not None and existing.block_id.key() == block_key:
            return existing
        by_block = self.votes_by_block.get(block_key)
        if by_block is not None:
            return by_block.get_by_index(val_index)
        return None

    def _add_verified_vote(
        self, vote: Vote, block_key: bytes, voting_power: int
    ) -> Tuple[bool, Optional[Vote]]:
        """types/vote_set.go:264-340."""
        val_index = vote.validator_index
        conflicting: Optional[Vote] = None

        existing = self.votes[val_index]
        if existing is not None:
            if existing.block_id == vote.block_id:
                raise RuntimeError("addVerifiedVote does not expect duplicate votes")
            conflicting = existing
            # Replace the primary vote only if this key is the known maj23.
            if self.maj23 is not None and self.maj23.key() == block_key:
                self.votes[val_index] = vote
                self.votes_bit_array.set_index(val_index, True)
        else:
            self.votes[val_index] = vote
            self.votes_bit_array.set_index(val_index, True)
            self.sum += voting_power

        by_block = self.votes_by_block.get(block_key)
        if by_block is not None:
            if conflicting is not None and not by_block.peer_maj23:
                return False, conflicting
        else:
            if conflicting is not None:
                return False, conflicting
            by_block = _BlockVotes(False, len(self.val_set))
            self.votes_by_block[block_key] = by_block

        orig_sum = by_block.sum
        quorum = self.val_set.total_voting_power() * 2 // 3 + 1
        by_block.add_verified_vote(vote, voting_power)

        if orig_sum < quorum <= by_block.sum and self.maj23 is None:
            self.maj23 = vote.block_id
            for i, v in enumerate(by_block.votes):
                if v is not None:
                    self.votes[i] = v
        return True, conflicting

    def set_peer_maj23(self, peer_id: str, block_id: BlockID) -> None:
        """types/vote_set.go:345-388: a peer claims 2/3 on ``block_id``."""
        with self._mtx:
            block_key = block_id.key()
            existing = self.peer_maj23s.get(peer_id)
            if existing is not None:
                if existing == block_id:
                    return
                raise VoteSetError(f"setPeerMaj23: conflicting blockID from peer {peer_id}")
            self.peer_maj23s[peer_id] = block_id
            by_block = self.votes_by_block.get(block_key)
            if by_block is not None:
                by_block.peer_maj23 = True
            else:
                self.votes_by_block[block_key] = _BlockVotes(True, len(self.val_set))

    # --- queries ------------------------------------------------------------

    def bit_array(self) -> BitArray:
        with self._mtx:
            return self.votes_bit_array.copy()

    def bit_array_by_block_id(self, block_id: BlockID) -> Optional[BitArray]:
        with self._mtx:
            by_block = self.votes_by_block.get(block_id.key())
            if by_block is not None:
                return by_block.bit_array.copy()
            return None

    def get_by_index(self, val_index: int) -> Optional[Vote]:
        with self._mtx:
            if not 0 <= val_index < len(self.votes):
                return None
            return self.votes[val_index]

    def get_by_address(self, address: bytes) -> Optional[Vote]:
        with self._mtx:
            val_index, val = self.val_set.get_by_address(address)
            if val is None:
                return None
            return self.votes[val_index]

    def has_two_thirds_majority(self) -> bool:
        with self._mtx:
            return self.maj23 is not None

    def has_two_thirds_any(self) -> bool:
        with self._mtx:
            return self.sum > self.val_set.total_voting_power() * 2 // 3

    def has_all(self) -> bool:
        with self._mtx:
            return self.sum == self.val_set.total_voting_power()

    def two_thirds_majority(self) -> Tuple[BlockID, bool]:
        with self._mtx:
            if self.maj23 is not None:
                return self.maj23, True
            return BlockID(), False

    def vote_list(self) -> List[Vote]:
        with self._mtx:
            return [v for v in self.votes if v is not None]

    # --- commit construction ------------------------------------------------

    def make_extended_commit(self) -> ExtendedCommit:
        """types/vote_set.go:658-690: absent for a validator with no vote
        or a vote for another block."""
        if self.signed_msg_type != SIGNED_MSG_TYPE_PRECOMMIT:
            raise VoteSetError("cannot MakeExtendedCommit unless VoteSet.Type is Precommit")
        with self._mtx:
            if self.maj23 is None:
                raise VoteSetError("cannot MakeExtendedCommit unless a blockhash has +2/3")
            sigs: List[ExtendedCommitSig] = []
            for v in self.votes:
                if v is None:
                    sigs.append(ExtendedCommitSig())
                    continue
                sig = v.extended_commit_sig()
                if sig.commit_sig.is_commit() and v.block_id != self.maj23:
                    sig = ExtendedCommitSig()
                sigs.append(sig)
            return ExtendedCommit(
                height=self.height, round=self.round, block_id=self.maj23, extended_signatures=sigs
            )

    def make_commit(self) -> Commit:
        """The plain commit (a network without extensions)."""
        return self.make_extended_commit().to_commit()


def vote_set_from_commit(chain_id: str, commit: Commit, val_set: ValidatorSet) -> VoteSet:
    """The precommit VoteSet a commit came from (types/vote_set.go
    CommitToVoteSet): the restart path's reconstructLastCommit. Each
    signature is checked inline on the host, as in the reference."""
    vs = VoteSet(chain_id, commit.height, commit.round, SIGNED_MSG_TYPE_PRECOMMIT, val_set)
    for idx, cs in enumerate(commit.signatures):
        if cs.is_absent():
            continue
        if not vs.add_vote(commit.get_vote(idx)):
            raise VoteSetError(f"failed to reconstruct commit vote {idx}")
    return vs
