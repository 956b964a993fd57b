"""Consensus round state types (internal/consensus/types/).

A copy of ``tendermint_tpu/consensus/cstypes.py``: the RoundStep enum,
HeightVoteSet (a prevote and a precommit VoteSet per round, with the
peers' catch-up round limits) and RoundState, the snapshot the state
machine keeps and announces.
"""

from __future__ import annotations

import enum
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from tendermint_tpu_torch.encoding.canonical import (
    SIGNED_MSG_TYPE_PRECOMMIT,
    SIGNED_MSG_TYPE_PREVOTE,
    Timestamp,
)
from tendermint_tpu_torch.types.block import GO_ZERO_TIME, Block, BlockID, Proposal
from tendermint_tpu_torch.types.part_set import PartSet
from tendermint_tpu_torch.types.validator_set import ValidatorSet
from tendermint_tpu_torch.types.vote_set import VoteSet


class RoundStep(enum.IntEnum):
    """internal/consensus/types/round_state.go:12-24."""

    NEW_HEIGHT = 1
    NEW_ROUND = 2
    PROPOSE = 3
    PREVOTE = 4
    PREVOTE_WAIT = 5
    PRECOMMIT = 6
    PRECOMMIT_WAIT = 7
    COMMIT = 8


class GotVoteFromUnwantedRoundError(Exception):
    """height_vote_set.go:21-23: a peer passed its 2 catch-up rounds."""


@dataclass
class RoundVoteSet:
    prevotes: VoteSet
    precommits: VoteSet


class HeightVoteSet:
    """internal/consensus/types/height_vote_set.go:40-220."""

    def __init__(
        self,
        chain_id: str,
        height: int,
        val_set: ValidatorSet,
        extensions_enabled: bool = False,
    ):
        self.chain_id = chain_id
        self.extensions_enabled = extensions_enabled
        self._mtx = threading.Lock()
        self.reset(height, val_set)

    @classmethod
    def extended(cls, chain_id: str, height: int, val_set: ValidatorSet) -> "HeightVoteSet":
        return cls(chain_id, height, val_set, extensions_enabled=True)

    def reset(self, height: int, val_set: ValidatorSet) -> None:
        self.height = height
        self.val_set = val_set
        self.round_vote_sets: Dict[int, RoundVoteSet] = {}
        self.peer_catchup_rounds: Dict[str, List[int]] = {}
        self._add_round(0)
        self.round = 0

    def set_round(self, round_: int) -> None:
        """Create the vote sets up to ``round_`` (height_vote_set.go:97-113)."""
        with self._mtx:
            new_round = self.round - 1
            if self.round != 0 and round_ < new_round:
                raise ValueError("set_round() must increment the round")
            for r in range(max(new_round, 0), round_ + 1):
                if r in self.round_vote_sets:
                    continue  # made already by a peer's catch-up vote
                self._add_round(r)
            self.round = round_

    def _add_round(self, round_: int) -> None:
        if round_ in self.round_vote_sets:
            raise ValueError("add_round() for an existing round")
        prevotes = VoteSet(self.chain_id, self.height, round_, SIGNED_MSG_TYPE_PREVOTE, self.val_set)
        precommits = VoteSet(
            self.chain_id,
            self.height,
            round_,
            SIGNED_MSG_TYPE_PRECOMMIT,
            self.val_set,
            extensions_enabled=self.extensions_enabled,
        )
        self.round_vote_sets[round_] = RoundVoteSet(prevotes, precommits)

    def add_vote(self, vote, peer_id: str = "") -> bool:
        """A duplicate returns False; peer_id "" is this node
        (height_vote_set.go:136-155)."""
        with self._mtx:
            if vote.type not in (SIGNED_MSG_TYPE_PREVOTE, SIGNED_MSG_TYPE_PRECOMMIT):
                return False
            vote_set = self._get_vote_set(vote.round, vote.type)
            if vote_set is None:
                rndz = self.peer_catchup_rounds.get(peer_id, [])
                if len(rndz) < 2:
                    self._add_round(vote.round)
                    vote_set = self._get_vote_set(vote.round, vote.type)
                    self.peer_catchup_rounds[peer_id] = rndz + [vote.round]
                else:
                    raise GotVoteFromUnwantedRoundError(
                        "peer has sent a vote that does not match our round for more than one round"
                    )
            return vote_set.add_vote(vote)

    def prevotes(self, round_: int) -> Optional[VoteSet]:
        with self._mtx:
            return self._get_vote_set(round_, SIGNED_MSG_TYPE_PREVOTE)

    def precommits(self, round_: int) -> Optional[VoteSet]:
        with self._mtx:
            return self._get_vote_set(round_, SIGNED_MSG_TYPE_PRECOMMIT)

    def pol_info(self) -> Tuple[int, BlockID]:
        """The last round with +2/3 prevotes for a block; (-1, nil) if
        none (height_vote_set.go:172-184)."""
        with self._mtx:
            for r in range(self.round, -1, -1):
                rvs = self._get_vote_set(r, SIGNED_MSG_TYPE_PREVOTE)
                if rvs is None:
                    continue
                block_id, ok = rvs.two_thirds_majority()
                if ok:
                    return r, block_id
            return -1, BlockID()

    def _get_vote_set(self, round_: int, vote_type: int) -> Optional[VoteSet]:
        rvs = self.round_vote_sets.get(round_)
        if rvs is None:
            return None
        if vote_type == SIGNED_MSG_TYPE_PREVOTE:
            return rvs.prevotes
        if vote_type == SIGNED_MSG_TYPE_PRECOMMIT:
            return rvs.precommits
        raise ValueError(f"unexpected vote type {vote_type}")

    def set_peer_maj23(self, round_: int, vote_type: int, peer_id: str, block_id: BlockID) -> None:
        with self._mtx:
            if vote_type not in (SIGNED_MSG_TYPE_PREVOTE, SIGNED_MSG_TYPE_PRECOMMIT):
                raise ValueError(f"setPeerMaj23: invalid vote type {vote_type}")
            vote_set = self._get_vote_set(round_, vote_type)
            if vote_set is None:
                return  # a round not known yet
            vote_set.set_peer_maj23(peer_id, block_id)


@dataclass
class RoundState:
    """internal/consensus/types/round_state.go:65-120: the state
    machine's mutable snapshot."""

    height: int = 0
    round: int = 0
    step: RoundStep = RoundStep.NEW_HEIGHT
    start_time: Timestamp = GO_ZERO_TIME
    commit_time: Timestamp = GO_ZERO_TIME
    validators: Optional[ValidatorSet] = None
    proposal: Optional[Proposal] = None
    proposal_receive_time: Timestamp = GO_ZERO_TIME
    proposal_block: Optional[Block] = None
    proposal_block_parts: Optional[PartSet] = None
    locked_round: int = -1
    locked_block: Optional[Block] = None
    locked_block_parts: Optional[PartSet] = None
    valid_round: int = -1
    valid_block: Optional[Block] = None
    valid_block_parts: Optional[PartSet] = None
    votes: Optional[HeightVoteSet] = None
    commit_round: int = -1
    last_commit: Optional[VoteSet] = None
    last_validators: Optional[ValidatorSet] = None
    triggered_timeout_precommit: bool = False

    def height_round_step(self) -> str:
        return f"{self.height}/{self.round}/{int(self.step)}"
