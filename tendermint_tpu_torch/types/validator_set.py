"""ValidatorSet: a weighted set with proposer rotation.

A copy of ``tendermint_tpu/types/validator_set.py`` (types/validator_set.go):
the canonical order (voting power descending, address ascending;
types/validator.go:745-760), so a commit's signature ``i`` belongs to
``validators[i]`` exactly as in the reference; proposer selection by
priority increment, rescale and shift by the average (consensus-critical
integer arithmetic with int64 clipping and Go's division, SURVEY.md
"hard parts"); and the ABCI change-set update. A set built from
validators runs the change-set algorithm on an empty set and then one
increment (NewValidatorSet, validator_set.go:60-80). A set restored from
the wire (:meth:`ValidatorSet.from_proto_bytes`,
:meth:`ValidatorSet.restore`) keeps its order, priorities and proposer
as they came. The ``verify_commit*`` methods delegate to
:mod:`tendermint_tpu_torch.types.validation` with ``device=``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from tendermint_tpu_torch.crypto import merkle
from tendermint_tpu_torch.encoding.proto import Reader, encode_message_field
from tendermint_tpu_torch.types.validator import Validator

INT64_MAX = 2**63 - 1
INT64_MIN = -(2**63)
MAX_TOTAL_VOTING_POWER = INT64_MAX // 8  # validator_set.go:25
PRIORITY_WINDOW_SIZE_FACTOR = 2  # validator_set.go:30


def safe_add_clip(a: int, b: int) -> int:
    """int64 addition clipped at the bounds (libs/math safe ops)."""
    return max(INT64_MIN, min(INT64_MAX, a + b))


def safe_sub_clip(a: int, b: int) -> int:
    return max(INT64_MIN, min(INT64_MAX, a - b))


def go_div(a: int, b: int) -> int:
    """Go int64 division: truncation toward zero (Python's // floors)."""
    q = abs(a) // abs(b)
    return -q if (a < 0) != (b < 0) else q


def _by_voting_power(v: Validator):
    return (-v.voting_power, v.address)


def _by_address(v: Validator):
    return v.address


class TotalVotingPowerOverflowError(ValueError):
    pass


class ValidatorSet:
    def __init__(self, validators: Optional[List[Validator]] = None):
        """NewValidatorSet: the change-set algorithm on an empty set, then
        one priority increment (validator_set.go:60-80). The validators
        are copied; their priorities are reset by the algorithm."""
        self.validators: List[Validator] = []
        self.proposer: Optional[Validator] = None
        self._total_voting_power: Optional[int] = None
        if validators:
            self._update_with_change_set([v.copy() for v in validators], allow_deletes=False)
            self.increment_proposer_priority(1)

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
        vals = cls()
        vals.validators = list(validators)
        vals.proposer = proposer
        vals._update_total_voting_power()
        return vals

    # --- basic accessors ---------------------------------------------------

    def __len__(self) -> int:
        return len(self.validators)

    def is_nil_or_empty(self) -> bool:
        return not self.validators

    def has_address(self, address: bytes) -> bool:
        return any(v.address == address for v in self.validators)

    def get_by_address(self, address: bytes) -> Tuple[int, Optional[Validator]]:
        for i, v in enumerate(self.validators):
            if v.address == address:
                return i, v
        return -1, None

    def get_by_index(self, index: int) -> Optional[Validator]:
        if 0 <= index < len(self.validators):
            return self.validators[index]
        return None

    def total_voting_power(self) -> int:
        if self._total_voting_power is None:
            self._update_total_voting_power()
        return self._total_voting_power

    def _update_total_voting_power(self) -> None:
        total = 0
        for v in self.validators:
            total = safe_add_clip(total, v.voting_power)
            if total > MAX_TOTAL_VOTING_POWER:
                raise TotalVotingPowerOverflowError(
                    f"total voting power exceeds {MAX_TOTAL_VOTING_POWER}"
                )
        self._total_voting_power = total

    def copy(self) -> "ValidatorSet":
        out = ValidatorSet()
        out.validators = [v.copy() for v in self.validators]
        out.proposer = self.proposer
        out._total_voting_power = self._total_voting_power
        return out

    def hash(self) -> bytes:
        """Merkle root of SimpleValidator leaves (validator_set.go:344-350)."""
        return merkle.hash_from_byte_slices([v.bytes() for v in self.validators])

    def validate_basic(self) -> None:
        if self.is_nil_or_empty():
            raise ValueError("validator set is nil or empty")
        for v in self.validators:
            v.validate_basic()
        self.get_proposer().validate_basic()

    # --- proposer selection ------------------------------------------------

    def get_proposer(self) -> Validator:
        """The proposer: set by the last increment or decoded, else the
        validator of the highest priority, ties to the lower address
        (validator_set.go findProposer)."""
        if not self.validators:
            raise ValueError("empty validator set")
        if self.proposer is None:
            self.proposer = self._find_proposer()
        return self.proposer

    def _find_proposer(self) -> Validator:
        proposer: Optional[Validator] = None
        for v in self.validators:
            proposer = v.compare_proposer_priority(proposer)
        return proposer

    def increment_proposer_priority(self, times: int) -> None:
        """validator_set.go:116-138."""
        if self.is_nil_or_empty():
            raise ValueError("empty validator set")
        if times <= 0:
            raise ValueError("cannot call with non-positive times")
        self.rescale_priorities(PRIORITY_WINDOW_SIZE_FACTOR * self.total_voting_power())
        self._shift_by_avg_proposer_priority()
        proposer = None
        for _ in range(times):
            proposer = self._increment_proposer_priority()
        self.proposer = proposer

    def _increment_proposer_priority(self) -> Validator:
        for v in self.validators:
            v.proposer_priority = safe_add_clip(v.proposer_priority, v.voting_power)
        mostest = self._find_proposer()
        mostest.proposer_priority = safe_sub_clip(mostest.proposer_priority, self.total_voting_power())
        return mostest

    def rescale_priorities(self, diff_max: int) -> None:
        """Cap the max-min priority spread at diff_max (validator_set.go:143-164)."""
        if self.is_nil_or_empty():
            raise ValueError("empty validator set")
        if diff_max <= 0:
            return
        diff = self._compute_max_min_priority_diff()
        ratio = (diff + diff_max - 1) // diff_max
        if diff > diff_max:
            for v in self.validators:
                v.proposer_priority = go_div(v.proposer_priority, ratio)

    def _compute_max_min_priority_diff(self) -> int:
        prios = [v.proposer_priority for v in self.validators]
        return abs(max(prios) - min(prios))

    def _compute_avg_proposer_priority(self) -> int:
        # Go divides a big.Int with Euclidean Div: for a positive count
        # that is Python's floor division.
        return sum(v.proposer_priority for v in self.validators) // len(self.validators)

    def _shift_by_avg_proposer_priority(self) -> None:
        avg = self._compute_avg_proposer_priority()
        for v in self.validators:
            v.proposer_priority = safe_sub_clip(v.proposer_priority, avg)

    # --- change-set updates ------------------------------------------------

    def update_with_change_set(self, changes: List[Validator]) -> None:
        self._update_with_change_set([c.copy() for c in changes], allow_deletes=True)

    def _update_with_change_set(self, changes: List[Validator], allow_deletes: bool) -> None:
        """validator_set.go:577-640."""
        if not changes:
            return
        updates, deletes = _process_changes(changes)
        if not allow_deletes and deletes:
            raise ValueError("cannot process validators with voting power 0")
        num_new = sum(1 for u in updates if not self.has_address(u.address))
        if num_new == 0 and len(self.validators) == len(deletes):
            raise ValueError("applying the validator changes would result in empty set")
        removed_power = self._verify_removals(deletes)
        tvp_after_updates_before_removals = self._verify_updates(updates, removed_power)
        _compute_new_priorities(updates, self, tvp_after_updates_before_removals)
        self._apply_updates(updates)
        self._apply_removals(deletes)
        self._total_voting_power = None
        self._update_total_voting_power()
        self.rescale_priorities(PRIORITY_WINDOW_SIZE_FACTOR * self.total_voting_power())
        self._shift_by_avg_proposer_priority()
        self.validators.sort(key=_by_voting_power)

    def _verify_updates(self, updates: List[Validator], removed_power: int) -> int:
        def delta(update: Validator) -> int:
            _, val = self.get_by_address(update.address)
            return update.voting_power - val.voting_power if val is not None else update.voting_power

        tvp_after_removals = self.total_voting_power() - removed_power
        for upd in sorted(updates, key=delta):
            tvp_after_removals += delta(upd)
            if tvp_after_removals > MAX_TOTAL_VOTING_POWER:
                raise TotalVotingPowerOverflowError(
                    f"total voting power exceeds {MAX_TOTAL_VOTING_POWER}"
                )
        return tvp_after_removals + removed_power

    def _verify_removals(self, deletes: List[Validator]) -> int:
        removed = 0
        for d in deletes:
            _, val = self.get_by_address(d.address)
            if val is None:
                raise ValueError(f"failed to find validator {d.address.hex()} to remove")
            removed += val.voting_power
        if len(deletes) > len(self.validators):
            raise ValueError("more deletes than validators")
        return removed

    def _apply_updates(self, updates: List[Validator]) -> None:
        existing = sorted(self.validators, key=_by_address)
        merged: List[Validator] = []
        i = j = 0
        while i < len(existing) and j < len(updates):
            if existing[i].address < updates[j].address:
                merged.append(existing[i])
                i += 1
            else:
                merged.append(updates[j])
                if existing[i].address == updates[j].address:
                    i += 1
                j += 1
        merged.extend(existing[i:])
        merged.extend(updates[j:])
        self.validators = merged

    def _apply_removals(self, deletes: List[Validator]) -> None:
        if deletes:
            gone = {d.address for d in deletes}
            self.validators = [v for v in self.validators if v.address not in gone]

    # --- proto -------------------------------------------------------------

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

    # --- commit verification (types/validation.py) -------------------------

    def verify_commit(self, chain_id: str, block_id, height: int, commit, device=None) -> None:
        from tendermint_tpu_torch.types import validation

        validation.verify_commit(chain_id, self, block_id, height, commit, device=device)

    def verify_commit_light(self, chain_id: str, block_id, height: int, commit, device=None) -> None:
        from tendermint_tpu_torch.types import validation

        validation.verify_commit_light(chain_id, self, block_id, height, commit, device=device)

    def verify_commit_light_trusting(self, chain_id: str, commit, trust_level, device=None) -> None:
        from tendermint_tpu_torch.types import validation

        validation.verify_commit_light_trusting(chain_id, self, commit, trust_level, device=device)


def _process_changes(changes: List[Validator]) -> Tuple[List[Validator], List[Validator]]:
    """Sort by address, split updates and removals, reject duplicates and
    bad powers (validator_set.go:369-409)."""
    updates: List[Validator] = []
    removals: List[Validator] = []
    prev_addr: Optional[bytes] = None
    for c in sorted(changes, key=_by_address):
        if c.address == prev_addr:
            raise ValueError(f"duplicate entry {c.address.hex()} in changes")
        if c.voting_power < 0:
            raise ValueError("voting power can't be negative")
        if c.voting_power > MAX_TOTAL_VOTING_POWER:
            raise ValueError(f"voting power can't be higher than {MAX_TOTAL_VOTING_POWER}")
        (removals if c.voting_power == 0 else updates).append(c)
        prev_addr = c.address
    return updates, removals


def _compute_new_priorities(
    updates: List[Validator], vals: ValidatorSet, updated_total_voting_power: int
) -> None:
    """A new validator starts at -1.125 times the total power; an updated
    one keeps its priority (validator_set.go:447-470)."""
    for u in updates:
        _, val = vals.get_by_address(u.address)
        if val is None:
            u.proposer_priority = -(updated_total_voting_power + (updated_total_voting_power >> 3))
        else:
            u.proposer_priority = val.proposer_priority
