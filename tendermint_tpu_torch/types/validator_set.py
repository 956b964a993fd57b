"""ValidatorSet: the subset of ``tendermint_tpu/types/validator_set.py``
that commit verification, the light client and the vote set use.

Validators are kept in the canonical order (voting power descending,
address ascending; types/validator.go:745-760), so a commit's signature
``i`` belongs to ``validators[i]`` exactly as in the reference.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from tendermint_tpu_torch.crypto import merkle
from tendermint_tpu_torch.types.validator import Validator

INT64_MAX = 2**63 - 1
MAX_TOTAL_VOTING_POWER = INT64_MAX // 8  # validator_set.go:25


class ValidatorSet:
    def __init__(self, validators: List[Validator]):
        if not validators:
            raise ValueError("validator set is nil or empty")
        addrs = [v.address for v in validators]
        if len(set(addrs)) != len(addrs):
            raise ValueError("duplicate validator address")
        for v in validators:
            if not 0 < v.voting_power <= MAX_TOTAL_VOTING_POWER:
                raise ValueError(f"invalid voting power {v.voting_power}")
        self.validators: List[Validator] = sorted(
            validators, key=lambda v: (-v.voting_power, v.address)
        )
        self._total_voting_power = sum(v.voting_power for v in self.validators)
        if self._total_voting_power > MAX_TOTAL_VOTING_POWER:
            raise ValueError(f"total voting power exceeds {MAX_TOTAL_VOTING_POWER}")

    def __len__(self) -> int:
        return len(self.validators)

    def total_voting_power(self) -> int:
        return self._total_voting_power

    def hash(self) -> bytes:
        """Merkle root of SimpleValidator leaves (validator_set.go:344-350)."""
        return merkle.hash_from_byte_slices([v.bytes() for v in self.validators])

    def validate_basic(self) -> None:
        if not self.validators:
            raise ValueError("validator set is nil or empty")
        for v in self.validators:
            v.validate_basic()
        self.get_proposer().validate_basic()

    def get_by_address(self, address: bytes) -> Tuple[int, Optional[Validator]]:
        for i, v in enumerate(self.validators):
            if v.address == address:
                return i, v
        return -1, None

    def get_by_index(self, index: int) -> Optional[Validator]:
        if 0 <= index < len(self.validators):
            return self.validators[index]
        return None

    def get_proposer(self) -> Validator:
        """The proposer of a newly built set.

        NewValidatorSet gives every validator the same starting priority,
        shifts it to zero and increments once (validator_set.go:60-80,
        116-138); the highest priority is then the highest voting power,
        ties to the lower address — the first validator in canonical
        order.
        """
        return self.validators[0]
