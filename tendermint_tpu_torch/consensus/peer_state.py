"""Per-peer consensus bookkeeping driving targeted gossip.

A copy of ``tendermint_tpu/consensus/peer_state.py``.

The reactor keeps one PeerState per connected peer recording what that
peer provably has — its round step, which proposal block parts, which
votes (by validator index) — learned from NewRoundStep/HasVote/
VoteSetBits announcements and from the messages the peer itself sends.
Gossip routines consult it to send only what the peer is missing
(internal/consensus/peer_state.go; PeerRoundState in
internal/consensus/types/peer_round_state.go).
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

from tendermint_tpu_torch.libs.bits import BitArray
from tendermint_tpu_torch.types.part_set import PartSetHeader

# (height, round, signed-msg-type) -> which validator indices the peer has
VoteKey = Tuple[int, int, int]


class PeerState:
    def __init__(self, peer_id: str):
        self.peer_id = peer_id
        self._mtx = threading.RLock()
        self.height = 0
        self.round = -1
        self.step = 0
        self.last_commit_round = -1
        self.has_proposal = False
        self.parts: Optional[BitArray] = None  # for (height, round)
        self.parts_header: Optional[PartSetHeader] = None
        self.votes: Dict[VoteKey, BitArray] = {}
        # Catch-up bookkeeping: which parts/commit-sigs of the decided
        # block at the peer's (lagging) height we already sent it.
        self.catchup_height = 0
        self.catchup_parts: Optional[BitArray] = None
        self.catchup_commit: Optional[BitArray] = None

    # --- updates from announcements ------------------------------------------

    def apply_new_round_step(
        self, height: int, round_: int, step: int, last_commit_round: int
    ) -> None:
        with self._mtx:
            new_round = (self.height, self.round) != (height, round_)
            if new_round:
                self.has_proposal = False
                self.parts = None
                self.parts_header = None
            if height != self.height:
                self.catchup_height = 0
                self.catchup_parts = None
                self.catchup_commit = None
                # Drop vote bookkeeping for heights the peer moved past.
                self.votes = {
                    k: v for k, v in self.votes.items() if k[0] >= height - 1
                }
            self.height, self.round, self.step = height, round_, step
            self.last_commit_round = last_commit_round

    def set_has_proposal(self, height: int, round_: int) -> None:
        with self._mtx:
            if (height, round_) == (self.height, self.round):
                self.has_proposal = True

    def init_parts(self, height: int, round_: int, header: PartSetHeader) -> None:
        with self._mtx:
            if (height, round_) != (self.height, self.round):
                return
            if self.parts_header is None or self.parts_header != header:
                self.parts_header = header
                self.parts = BitArray(header.total)

    def set_has_part(self, height: int, round_: int, index: int) -> None:
        with self._mtx:
            if (height, round_) != (self.height, self.round):
                return
            if self.parts is not None:
                self.parts.set_index(index, True)

    def set_has_vote(
        self, height: int, round_: int, type_: int, index: int, nvals: int = 0
    ) -> None:
        with self._mtx:
            key = (height, round_, type_)
            ba = self.votes.get(key)
            if ba is None:
                ba = BitArray(max(nvals, index + 1))
                self.votes[key] = ba
            elif index >= ba.size():
                grown = BitArray(index + 1)
                for i in range(ba.size()):
                    if ba.get_index(i):
                        grown.set_index(i, True)
                ba = grown
                self.votes[key] = ba
            ba.set_index(index, True)

    def apply_vote_set_bits(
        self, height: int, round_: int, type_: int, bits: BitArray
    ) -> None:
        with self._mtx:
            key = (height, round_, type_)
            cur = self.votes.get(key)
            self.votes[key] = bits.copy() if cur is None else cur.or_(bits)

    # --- queries for the gossip routines --------------------------------------

    def snapshot(self) -> Tuple[int, int, int, int]:
        with self._mtx:
            return self.height, self.round, self.step, self.last_commit_round

    def vote_bits(self, height: int, round_: int, type_: int) -> Optional[BitArray]:
        with self._mtx:
            ba = self.votes.get((height, round_, type_))
            return ba.copy() if ba is not None else None

    def pick_missing_vote(
        self, height: int, round_: int, type_: int, ours: BitArray
    ) -> Optional[int]:
        """Lowest validator index we can send: set in ours, unknown for
        the peer."""
        with self._mtx:
            theirs = self.votes.get((height, round_, type_))
            for i in range(ours.size()):
                if ours.get_index(i) and (theirs is None or not theirs.get_index(i)):
                    return i
            return None

    def pick_missing_part(self, ours: BitArray) -> Optional[int]:
        with self._mtx:
            if self.parts is None:
                return None
            for i in range(ours.size()):
                if ours.get_index(i) and not self.parts.get_index(i):
                    return i
            return None

    @staticmethod
    def _grow(ba: Optional[BitArray], bits: int) -> BitArray:
        if ba is None or ba.size() < bits:
            grown = BitArray(bits)
            if ba is not None:
                for i in range(ba.size()):
                    if ba.get_index(i):
                        grown.set_index(i, True)
            return grown
        return ba

    def ensure_catchup(self, height: int, n_parts: int, n_vals: int) -> None:
        """Sizes may grow across calls: the commit for the peer's height
        only appears once the next block lands (n_vals starts 0)."""
        with self._mtx:
            if self.catchup_height != height:
                self.catchup_height = height
                self.catchup_parts = None
                self.catchup_commit = None
            self.catchup_parts = self._grow(self.catchup_parts, n_parts)
            self.catchup_commit = self._grow(self.catchup_commit, n_vals)
