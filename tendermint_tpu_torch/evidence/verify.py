"""Evidence verification (internal/evidence/verify.go).

A copy of ``tendermint_tpu/evidence/verify.py``. Both checks end in
signature verification against historical validator sets: a duplicate
vote's two ed25519 signatures go through the shared scheduler
(``crypto.batch.get_shared_scheduler``), a light client attack's commits
through ``verify_commit_light_trusting`` and ``verify_commit_light`` on
``device``.

One divergence from the reference (ROADMAP §C): its ``_verify_pair``
catches every ``RuntimeError`` of the scheduler and answers on the host,
so a device fault, a refused batch or a flush that failed closed reads
as a host verdict or as "invalid signature". Here the host answers only
when ``device_policy.shared.host_fallback`` is set, and those answers
are counted (``count_fallback("ed25519", 2)``); a lane whose flush failed
closed raises its handle's ``error``. Other key types verify inline on
the host, as in the reference.
"""

from __future__ import annotations

from tendermint_tpu_torch.crypto.keys import ED25519_KEY_TYPE
from tendermint_tpu_torch.light.verifier import DEFAULT_TRUST_LEVEL
from tendermint_tpu_torch.types.evidence import DuplicateVoteEvidence, LightClientAttackEvidence
from tendermint_tpu_torch.types.light import SignedHeader
from tendermint_tpu_torch.types.validation import verify_commit_light, verify_commit_light_trusting
from tendermint_tpu_torch.types.validator_set import ValidatorSet


class InvalidEvidenceError(ValueError):
    pass


def verify_duplicate_vote(e: DuplicateVoteEvidence, chain_id: str, val_set: ValidatorSet) -> None:
    """internal/evidence/verify.go:203-256."""
    _, val = val_set.get_by_address(e.vote_a.validator_address)
    if val is None:
        raise InvalidEvidenceError(
            f"address {e.vote_a.validator_address.hex()} was not a validator at height {e.height()}"
        )
    pub_key = val.pub_key
    if e.vote_a.height != e.vote_b.height or e.vote_a.round != e.vote_b.round or e.vote_a.type != e.vote_b.type:
        raise InvalidEvidenceError("h/r/s does not match")
    if e.vote_a.validator_address != e.vote_b.validator_address:
        raise InvalidEvidenceError("validator addresses do not match")
    if e.vote_a.block_id == e.vote_b.block_id:
        raise InvalidEvidenceError("block IDs are the same - not a real duplicate vote")
    if pub_key.address() != e.vote_a.validator_address:
        raise InvalidEvidenceError("address doesn't match pubkey")
    ok_a, ok_b = _verify_pair(
        pub_key,
        e.vote_a.sign_bytes(chain_id),
        e.vote_a.signature,
        e.vote_b.sign_bytes(chain_id),
        e.vote_b.signature,
    )
    if not ok_a:
        raise InvalidEvidenceError("verifying VoteA: invalid signature")
    if not ok_b:
        raise InvalidEvidenceError("verifying VoteB: invalid signature")


def _verify_pair(pub_key, msg_a, sig_a, msg_b, sig_b):
    """Both votes' signatures: an ed25519 pair through the shared
    scheduler (submitted together, so one flush covers both), any other
    key type inline on the host."""
    if pub_key.type == ED25519_KEY_TYPE:
        from tendermint_tpu_torch.crypto.batch import get_shared_scheduler
        from tendermint_tpu_torch.ops import device_policy

        sched = get_shared_scheduler()
        pk = pub_key.bytes()
        try:
            ha = sched.submit(pk, msg_a, sig_a)
            hb = sched.submit(pk, msg_b, sig_b)
        except RuntimeError:  # the scheduler stopped, or its queue is full
            health = device_policy.shared
            if not health.host_fallback:
                raise
            health.count_fallback("ed25519", 2)
        else:
            oks = sched.wait(ha), sched.wait(hb)
            for h in (ha, hb):
                if h.error is not None:
                    raise h.error
            return oks
    return pub_key.verify_signature(msg_a, sig_a), pub_key.verify_signature(msg_b, sig_b)


def verify_light_client_attack(
    e: LightClientAttackEvidence,
    common_header: SignedHeader,
    trusted_header: SignedHeader,
    common_vals: ValidatorSet,
    device=None,
) -> None:
    """internal/evidence/verify.go:160-196; the commits are verified on
    ``device``."""
    if common_header.height != e.conflicting_block.height:
        # a lunatic attack: one trusting jump from the common header
        try:
            verify_commit_light_trusting(
                trusted_header.chain_id,
                common_vals,
                e.conflicting_block.signed_header.commit,
                DEFAULT_TRUST_LEVEL,
                device=device,
            )
        except ValueError as err:
            raise InvalidEvidenceError(f"skipping verification of conflicting block failed: {err}") from err
    elif e.conflicting_header_is_invalid(trusted_header.header):
        raise InvalidEvidenceError(
            "common height is the same as conflicting block height so expected "
            "the conflicting block to be correctly derived yet it wasn't"
        )
    try:
        verify_commit_light(
            trusted_header.chain_id,
            e.conflicting_block.validator_set,
            e.conflicting_block.signed_header.commit.block_id,
            e.conflicting_block.height,
            e.conflicting_block.signed_header.commit,
            device=device,
        )
    except ValueError as err:
        raise InvalidEvidenceError(f"invalid commit from conflicting block: {err}") from err
    if e.conflicting_block.height > trusted_header.height:
        if e.conflicting_block.signed_header.header.time.to_unix_ns() > trusted_header.header.time.to_unix_ns():
            raise InvalidEvidenceError("conflicting block doesn't violate monotonically increasing time")
    elif trusted_header.hash() == e.conflicting_block.hash():
        raise InvalidEvidenceError("trusted header hash matches the evidence's conflicting header hash")
