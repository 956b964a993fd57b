"""Commit verification: the framework's crypto hot path.

Mirrors ``tendermint_tpu/types/validation.py`` (types/validation.go):
ignore/count predicates per entry point, tally-then-verify, batch
dispatch above a threshold with single-verify fallback, and
first-bad-signature attribution on batch failure
(validation.go:244-251). ``verify_commit`` and ``verify_commit_light``
look signatures up by index; ``verify_commit_light_trusting``, which
checks a commit against another height's set, looks them up by address
and rejects a double vote. The batch goes to
:class:`~tendermint_tpu_torch.crypto.batch.MultiBatchVerifier`, one
sub-batch per key type (ed25519, sr25519), so one commit is verified by
the CUDA kernels in a few chunked launches; a key type without batch
support sends the commit to single verification. ``verify_commit`` and
``verify_commit_light`` run in a ``verify_commit`` span tagged
``height``, ``round`` and ``sigs`` (the light one also ``mode="light"``),
and classify their work for a verifyd remote (``verifyd/client.py``
``classify``, the outermost wins): consensus for ``verify_commit``,
blocksync for ``verify_commit_light``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

from tendermint_tpu_torch import resolve_device
from tendermint_tpu_torch.crypto import batch as crypto_batch
from tendermint_tpu_torch.libs import tracing
from tendermint_tpu_torch.verifyd.client import classify
from tendermint_tpu_torch.verifyd.protocol import CLASS_BLOCKSYNC, CLASS_CONSENSUS
from tendermint_tpu_torch.types.block import (
    BLOCK_ID_FLAG_ABSENT,
    BLOCK_ID_FLAG_COMMIT,
    BlockID,
    Commit,
    CommitSig,
)
from tendermint_tpu_torch.types.validator_set import ValidatorSet

BATCH_VERIFY_THRESHOLD = 2  # validation.go:12
INT64_MAX = 2**63 - 1


class Fraction(NamedTuple):
    """libs/math Fraction: unsigned numerator/denominator."""

    numerator: int
    denominator: int


def _safe_mul(a: int, b: int) -> tuple:
    """libs/math SafeMul: (result, overflowed) for int64."""
    r = a * b
    if r > INT64_MAX or r < -(2**63):
        return 0, True
    return r, False


class NotEnoughVotingPowerError(Exception):
    def __init__(self, got: int, needed: int):
        self.got = got
        self.needed = needed
        super().__init__(
            f"invalid commit -- insufficient voting power: got {got}, needed more than {needed}"
        )


class InvalidCommitError(ValueError):
    pass


def _should_batch_verify(vals: ValidatorSet, commit: Commit) -> bool:
    """validation.go:14-16."""
    return len(commit.signatures) >= BATCH_VERIFY_THRESHOLD and (
        crypto_batch.supports_batch_verifier(vals.get_proposer().pub_key)
    )


def verify_commit(
    chain_id: str,
    vals: ValidatorSet,
    block_id: BlockID,
    height: int,
    commit: Commit,
    device=None,
) -> None:
    """validation.go:28-54: +2/3 signed; checks ALL signatures."""
    dev = resolve_device(device)
    with classify(CLASS_CONSENSUS), tracing.span("verify_commit", height=height, round=commit.round,
                                                   sigs=len(commit.signatures)):
        _verify_basic_vals_and_commit(vals, commit, height, block_id)
        needed = vals.total_voting_power() * 2 // 3
        ignore = lambda c: c.block_id_flag == BLOCK_ID_FLAG_ABSENT
        count = lambda c: c.block_id_flag == BLOCK_ID_FLAG_COMMIT
        verify = _verify_commit_batch if _should_batch_verify(vals, commit) else _verify_commit_single
        verify(chain_id, vals, commit, needed, ignore, count, True, True, dev)


def verify_commit_light(
    chain_id: str,
    vals: ValidatorSet,
    block_id: BlockID,
    height: int,
    commit: Commit,
    device=None,
) -> None:
    """validation.go:58-87: light-client/blocksync variant; stops at +2/3."""
    dev = resolve_device(device)
    with classify(CLASS_BLOCKSYNC), tracing.span("verify_commit", mode="light", height=height,
                                                   round=commit.round, sigs=len(commit.signatures)):
        _verify_basic_vals_and_commit(vals, commit, height, block_id)
        needed = vals.total_voting_power() * 2 // 3
        ignore = lambda c: c.block_id_flag != BLOCK_ID_FLAG_COMMIT
        count = lambda c: True
        verify = _verify_commit_batch if _should_batch_verify(vals, commit) else _verify_commit_single
        verify(chain_id, vals, commit, needed, ignore, count, False, True, dev)


def verify_commit_light_trusting(
    chain_id: str,
    vals: ValidatorSet,
    commit: Commit,
    trust_level: Fraction,
    device=None,
) -> None:
    """validation.go:89-135: ``trust_level`` of a different set signed;
    signatures are looked up by address and a double vote is an error."""
    dev = resolve_device(device)
    if vals is None:
        raise InvalidCommitError("nil validator set")
    if trust_level.denominator == 0:
        raise InvalidCommitError("trustLevel has zero Denominator")
    if commit is None:
        raise InvalidCommitError("nil commit")
    total_mul, overflow = _safe_mul(vals.total_voting_power(), trust_level.numerator)
    if overflow:
        raise InvalidCommitError("int64 overflow while calculating voting power needed")
    needed = total_mul // trust_level.denominator
    ignore = lambda c: c.block_id_flag != BLOCK_ID_FLAG_COMMIT
    count = lambda c: True
    verify = _verify_commit_batch if _should_batch_verify(vals, commit) else _verify_commit_single
    verify(chain_id, vals, commit, needed, ignore, count, False, False, dev)


def _lookup(vals: ValidatorSet, commit_sig: CommitSig, idx: int, look_up_by_index: bool, seen: dict):
    """The validator of signature ``idx``: by index, or by address
    (None for a validator not in ``vals``; a second signature of one
    validator raises), validation.go:188-200."""
    if look_up_by_index:
        return vals.validators[idx]
    val_idx, val = vals.get_by_address(commit_sig.validator_address)
    if val is None:
        return None
    if val_idx in seen:
        raise InvalidCommitError(
            f"double vote from validator {val_idx} ({seen[val_idx]} and {idx})"
        )
    seen[val_idx] = idx
    return val


def _verify_commit_batch(
    chain_id: str,
    vals: ValidatorSet,
    commit: Commit,
    voting_power_needed: int,
    ignore_sig: Callable[[CommitSig], bool],
    count_sig: Callable[[CommitSig], bool],
    count_all_signatures: bool,
    look_up_by_index: bool,
    device,
) -> None:
    """validation.go:151-258.

    As in the JAX package, a mixed ed25519 + sr25519 commit sub-batches
    per key type instead of failing the reference's single-type
    verifier."""
    tallied = 0
    seen = {}
    batch_sig_idxs = []
    # Make this set's keys eligible for the precompute cache: the next
    # commit from the same validators skips its table builds.
    crypto_batch.note_validator_set(vals)
    # A mixed set sub-batches per key type (BASELINE config 5); a key
    # without batch support raises on add -> single verification.
    bv = crypto_batch.MultiBatchVerifier(device=device)
    for idx, commit_sig in enumerate(commit.signatures):
        if ignore_sig(commit_sig):
            continue
        val = _lookup(vals, commit_sig, idx, look_up_by_index, seen)
        if val is None:
            continue
        try:
            bv.add(val.pub_key, commit.vote_sign_bytes(chain_id, idx), commit_sig.signature)
        except ValueError:
            return _verify_commit_single(
                chain_id, vals, commit, voting_power_needed, ignore_sig,
                count_sig, count_all_signatures, look_up_by_index, device,
            )
        batch_sig_idxs.append(idx)
        if count_sig(commit_sig):
            tallied += val.voting_power
        if not count_all_signatures and tallied > voting_power_needed:
            break
    if tallied <= voting_power_needed:
        raise NotEnoughVotingPowerError(got=tallied, needed=voting_power_needed)
    ok, valid_sigs = bv.verify()
    if ok:
        return
    for i, sig_ok in enumerate(valid_sigs):
        if not sig_ok:
            idx = batch_sig_idxs[i]
            sig = commit.signatures[idx]
            raise InvalidCommitError(
                f"wrong signature (#{idx}): {sig.signature.hex().upper()}"
            )
    raise InvalidCommitError("BUG: batch verification failed with no invalid signatures")


def _verify_commit_single(
    chain_id: str,
    vals: ValidatorSet,
    commit: Commit,
    voting_power_needed: int,
    ignore_sig: Callable[[CommitSig], bool],
    count_sig: Callable[[CommitSig], bool],
    count_all_signatures: bool,
    look_up_by_index: bool,
    device,
) -> None:
    """validation.go:262-330: one host verification per signature."""
    tallied = 0
    seen = {}
    for idx, commit_sig in enumerate(commit.signatures):
        if ignore_sig(commit_sig):
            continue
        val = _lookup(vals, commit_sig, idx, look_up_by_index, seen)
        if val is None:
            continue
        vote_sign_bytes = commit.vote_sign_bytes(chain_id, idx)
        if not val.pub_key.verify_signature(vote_sign_bytes, commit_sig.signature):
            raise InvalidCommitError(
                f"wrong signature (#{idx}): {commit_sig.signature.hex().upper()}"
            )
        if count_sig(commit_sig):
            tallied += val.voting_power
        if not count_all_signatures and tallied > voting_power_needed:
            return
    if tallied <= voting_power_needed:
        raise NotEnoughVotingPowerError(got=tallied, needed=voting_power_needed)


def _verify_basic_vals_and_commit(
    vals: Optional[ValidatorSet],
    commit: Optional[Commit],
    height: int,
    block_id: BlockID,
) -> None:
    """validation.go:334-356."""
    if vals is None:
        raise InvalidCommitError("nil validator set")
    if commit is None:
        raise InvalidCommitError("nil commit")
    if len(vals) != len(commit.signatures):
        raise InvalidCommitError(
            f"invalid commit -- wrong set size: {len(vals)} vs "
            f"{len(commit.signatures)}"
        )
    if height != commit.height:
        raise InvalidCommitError(
            f"invalid commit -- wrong height: {height} vs {commit.height}"
        )
    if block_id != commit.block_id:
        raise InvalidCommitError(
            f"invalid commit -- wrong block ID: want {block_id}, got {commit.block_id}"
        )
