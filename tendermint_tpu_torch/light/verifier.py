"""Stateless light-client verification (light/verifier.go).

Counterpart of ``tendermint_tpu/light/verifier.py``; its commit checks
run under the light class of a verifyd remote. Both the adjacent and the non-adjacent (skipping)
paths end in batched commit verification (types/validation.py), so a
walk over a header chain rides the card's batch verifier. Every entry
point takes ``device=`` (``None`` is
:data:`tendermint_tpu_torch.DEFAULT_DEVICE`) and passes it down.
"""

from __future__ import annotations

from tendermint_tpu_torch import resolve_device
from tendermint_tpu_torch.encoding.canonical import Timestamp
from tendermint_tpu_torch.types.block import Header
from tendermint_tpu_torch.types.light import SignedHeader
from tendermint_tpu_torch.types.validation import (
    Fraction,
    NotEnoughVotingPowerError,
    verify_commit_light,
    verify_commit_light_trusting,
)
from tendermint_tpu_torch.types.validator_set import ValidatorSet
from tendermint_tpu_torch.verifyd.client import classify
from tendermint_tpu_torch.verifyd.protocol import CLASS_LIGHT

DEFAULT_TRUST_LEVEL = Fraction(1, 3)


class InvalidHeaderError(ValueError):
    pass


class HeaderExpiredError(ValueError):
    pass


class NewValSetCantBeTrustedError(ValueError):
    """< trustLevel of the trusted valset signed the new header."""


def validate_trust_level(lvl: Fraction) -> None:
    """light/verifier.go:176-186: trustLevel in [1/3, 1)."""
    if (
        lvl.numerator * 3 < lvl.denominator
        or lvl.numerator >= lvl.denominator
        or lvl.denominator == 0
    ):
        raise ValueError(f"trustLevel must be within [1/3, 1], given {lvl}")


def header_expired(h: SignedHeader, trusting_period: float, now: Timestamp) -> bool:
    """light/verifier.go:189-192."""
    expiration_ns = h.header.time.to_unix_ns() + int(trusting_period * 1e9)
    return expiration_ns <= now.to_unix_ns()


def _check_required_header_fields(h: SignedHeader) -> None:
    if h.header is None:
        raise InvalidHeaderError("missing header")
    if not h.header.chain_id or h.header.height == 0 or not h.header.next_validators_hash:
        raise InvalidHeaderError("trusted header missing required fields")


def _verify_new_header_and_vals(
    untrusted: SignedHeader,
    untrusted_vals: ValidatorSet,
    trusted: SignedHeader,
    now: Timestamp,
    max_clock_drift: float,
) -> None:
    """light/verifier.go:236-292."""
    untrusted.validate_basic(trusted.chain_id)
    if untrusted.header.height <= trusted.header.height:
        raise InvalidHeaderError(
            f"expected new header height {untrusted.header.height} to be greater "
            f"than one of old header {trusted.header.height}"
        )
    if untrusted.header.time.to_unix_ns() <= trusted.header.time.to_unix_ns():
        raise InvalidHeaderError("expected new header time to be after old header time")
    if untrusted.header.time.to_unix_ns() >= now.to_unix_ns() + int(max_clock_drift * 1e9):
        raise InvalidHeaderError("new header has a time from the future")
    if untrusted.header.validators_hash != untrusted_vals.hash():
        raise InvalidHeaderError(
            "expected new header validators to match those that were supplied"
        )


def verify_non_adjacent(
    trusted_header: SignedHeader,
    trusted_vals: ValidatorSet,
    untrusted_header: SignedHeader,
    untrusted_vals: ValidatorSet,
    trusting_period: float,
    now: Timestamp,
    max_clock_drift: float,
    trust_level: Fraction = DEFAULT_TRUST_LEVEL,
    device=None,
) -> None:
    """light/verifier.go:33-91: trustLevel of the old set + 2/3 of the new."""
    device = resolve_device(device)
    _check_required_header_fields(trusted_header)
    if untrusted_header.height == trusted_header.height + 1:
        raise InvalidHeaderError("headers must be non adjacent in height")
    validate_trust_level(trust_level)
    # The trusted header's age gates verification (verifier.go:47): an
    # expired trust root must not anchor new updates.
    if header_expired(trusted_header, trusting_period, now):
        raise HeaderExpiredError("old header has expired")
    _verify_new_header_and_vals(
        untrusted_header, untrusted_vals, trusted_header, now, max_clock_drift
    )
    # light-client class for a verifyd remote (outermost wins over
    # validation's blocksync)
    with classify(CLASS_LIGHT):
        try:
            verify_commit_light_trusting(
                trusted_header.chain_id, trusted_vals, untrusted_header.commit, trust_level,
                device=device,
            )
        except NotEnoughVotingPowerError as e:
            raise NewValSetCantBeTrustedError(str(e)) from e
        except ValueError as e:
            raise InvalidHeaderError(str(e)) from e
        try:
            verify_commit_light(
                trusted_header.chain_id,
                untrusted_vals,
                untrusted_header.commit.block_id,
                untrusted_header.height,
                untrusted_header.commit,
                device=device,
            )
        except ValueError as e:
            raise InvalidHeaderError(str(e)) from e


def verify_adjacent(
    trusted_header: SignedHeader,
    untrusted_header: SignedHeader,
    untrusted_vals: ValidatorSet,
    trusting_period: float,
    now: Timestamp,
    max_clock_drift: float,
    device=None,
) -> None:
    """light/verifier.go:106-152: valhash chain link + 2/3 of the new set."""
    device = resolve_device(device)
    _check_required_header_fields(trusted_header)
    if untrusted_header.height != trusted_header.height + 1:
        raise InvalidHeaderError("headers must be adjacent in height")
    # trusted-header expiry, as above (verifier.go:116)
    if header_expired(trusted_header, trusting_period, now):
        raise HeaderExpiredError("old header has expired")
    _verify_new_header_and_vals(
        untrusted_header, untrusted_vals, trusted_header, now, max_clock_drift
    )
    if untrusted_header.header.validators_hash != trusted_header.header.next_validators_hash:
        raise InvalidHeaderError(
            "expected old header's next validators to match those from new header"
        )
    with classify(CLASS_LIGHT):
        try:
            verify_commit_light(
                trusted_header.chain_id,
                untrusted_vals,
                untrusted_header.commit.block_id,
                untrusted_header.height,
                untrusted_header.commit,
                device=device,
            )
        except ValueError as e:
            raise InvalidHeaderError(str(e)) from e


def verify(
    trusted_header: SignedHeader,
    trusted_vals: ValidatorSet,
    untrusted_header: SignedHeader,
    untrusted_vals: ValidatorSet,
    trusting_period: float,
    now: Timestamp,
    max_clock_drift: float,
    trust_level: Fraction = DEFAULT_TRUST_LEVEL,
    device=None,
) -> None:
    """light/verifier.go:158-174."""
    if untrusted_header.height != trusted_header.height + 1:
        verify_non_adjacent(
            trusted_header, trusted_vals, untrusted_header, untrusted_vals,
            trusting_period, now, max_clock_drift, trust_level, device=device,
        )
    else:
        verify_adjacent(
            trusted_header, untrusted_header, untrusted_vals,
            trusting_period, now, max_clock_drift, device=device,
        )


def verify_backwards(untrusted_header: Header, trusted_header: Header) -> None:
    """light/verifier.go:195-233: hash-chain link going backwards."""
    untrusted_header.validate_basic()
    if untrusted_header.chain_id != trusted_header.chain_id:
        raise InvalidHeaderError("new header belongs to a different chain")
    if untrusted_header.time.to_unix_ns() >= trusted_header.time.to_unix_ns():
        raise InvalidHeaderError("expected older header time to be before new header time")
    if untrusted_header.hash() != trusted_header.last_block_id.hash:
        raise InvalidHeaderError("older header hash does not match trusted header's last block")
