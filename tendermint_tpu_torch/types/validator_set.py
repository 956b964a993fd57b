"""ValidatorSet: the subset of ``tendermint_tpu/types/validator_set.py``
that commit verification, the light client and the vote set use.

A set built from validators is kept in the canonical order (voting power
descending, address ascending; types/validator.go:745-760), so a
commit's signature ``i`` belongs to ``validators[i]`` exactly as in the
reference, and carries the proposer priorities that NewValidatorSet
gives it (validator_set.go:60-80). A set restored from the wire
(:meth:`ValidatorSet.from_proto_bytes`, :meth:`ValidatorSet.restore`)
keeps its order, priorities and proposer as they came. Proposer rotation
(``increment_proposer_priority`` over rounds) and the change-set
algorithm are not ported.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from tendermint_tpu_torch.crypto import merkle
from tendermint_tpu_torch.encoding.proto import Reader, encode_message_field
from tendermint_tpu_torch.types.validator import Validator

INT64_MAX = 2**63 - 1
MAX_TOTAL_VOTING_POWER = INT64_MAX // 8  # validator_set.go:25


class ValidatorSet:
    def __init__(self, validators: List[Validator]):
        """NewValidatorSet over new validators.

        Every validator of a new set starts at the same priority, which
        the shift by the average takes to 0; the single
        ``increment_proposer_priority(1)`` then adds each validator's
        power and takes the total from the highest, ties to the lower
        address, which becomes the proposer (validator_set.go:60-80,
        116-138, 447-470). That is the first validator in canonical
        order. The given validators are copied, their priorities
        ignored, as the change-set algorithm copies and resets them.
        """
        if not validators:
            raise ValueError("validator set is nil or empty")
        addrs = [v.address for v in validators]
        if len(set(addrs)) != len(addrs):
            raise ValueError("duplicate validator address")
        for v in validators:
            if not 0 < v.voting_power <= MAX_TOTAL_VOTING_POWER:
                raise ValueError(f"invalid voting power {v.voting_power}")
        self.validators: List[Validator] = sorted(
            (v.copy() for v in validators), key=lambda v: (-v.voting_power, v.address)
        )
        self._total_voting_power = sum(v.voting_power for v in self.validators)
        if self._total_voting_power > MAX_TOTAL_VOTING_POWER:
            raise ValueError(f"total voting power exceeds {MAX_TOTAL_VOTING_POWER}")
        for v in self.validators:
            v.proposer_priority = v.voting_power
        self.proposer: Optional[Validator] = self.validators[0]
        self.proposer.proposer_priority -= self._total_voting_power

    @classmethod
    def restore(
        cls, validators: List[Validator], proposer: Optional[Validator] = None
    ) -> "ValidatorSet":
        """The set as it stands: the validators in the given order with
        their priorities, as ValidatorSetFromProto and the reference's
        RPC provider restore it, with no change-set algorithm. Without
        ``proposer`` the proposer is the highest priority."""
        if not validators:
            raise ValueError("validator set is nil or empty")
        total = 0
        for v in validators:
            total += v.voting_power
            if total > MAX_TOTAL_VOTING_POWER:
                raise ValueError(f"total voting power exceeds {MAX_TOTAL_VOTING_POWER}")
        vals = cls.__new__(cls)
        vals.validators = list(validators)
        vals._total_voting_power = total
        vals.proposer = proposer
        return vals

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
        """The proposer: set when the set was built or decoded, else the
        validator of the highest priority, ties to the lower address
        (validator_set.go findProposer)."""
        if self.proposer is None:
            proposer = None
            for v in self.validators:
                proposer = v.compare_proposer_priority(proposer)
            self.proposer = proposer
        return self.proposer

    def to_proto_bytes(self) -> bytes:
        """tendermint.types.ValidatorSet {validators=1, proposer=2,
        total_voting_power=3}. TotalVotingPower is written as 0, so it is
        omitted (validator_set.go ToProto)."""
        if not self.validators:
            return b""
        if self.proposer is None:
            raise ValueError("nil validator set proposer")
        out = b"".join(encode_message_field(1, v.to_proto_bytes()) for v in self.validators)
        return out + encode_message_field(2, self.proposer.to_proto_bytes())

    @classmethod
    def from_proto_bytes(cls, data: bytes) -> "ValidatorSet":
        """validator_set.go ValidatorSetFromProto: the fields restored as
        they are, priorities kept, then ``validate_basic``."""
        r = Reader(data)
        validators: List[Validator] = []
        proposer: Optional[Validator] = None
        for f, w in r.fields():
            if f == 1 and w == 2:
                validators.append(Validator.from_proto_bytes(r.read_bytes()))
            elif f == 2 and w == 2:
                proposer = Validator.from_proto_bytes(r.read_bytes())
            elif f == 3 and w == 0:
                r.read_svarint()
            else:
                r.skip(w)
        if proposer is None:
            raise ValueError("nil validator set proposer")
        vals = cls.restore(validators, proposer)
        vals.validate_basic()
        return vals
