"""PrivValidator interface (types/priv_validator.go:28); a copy of
``tendermint_tpu/privval/base.py``."""

from __future__ import annotations

from tendermint_tpu_torch.crypto.keys import PubKey
from tendermint_tpu_torch.types.block import Proposal, Vote


class PrivValidator:
    def get_pub_key(self) -> PubKey:
        raise NotImplementedError

    def sign_vote(self, chain_id: str, vote: Vote) -> None:
        """Sets vote.signature (and the extension signature of a non-nil
        precommit); raises on a double-sign risk."""
        raise NotImplementedError

    def sign_proposal(self, chain_id: str, proposal: Proposal) -> None:
        raise NotImplementedError
