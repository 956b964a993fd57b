"""Multi-commit pipelined batch verification (blocksync catch-up).

Counterpart of ``tendermint_tpu/parallel/pipeline.py``. The reference's
blocksync loop verifies one commit per block
(internal/blocksync/reactor.go:538-650, VerifyCommitLight at :582);
here a window of commits is flattened into one batch, so every
signature of every block rides the same chunked kernel launches, and
the verdicts are sliced back per block.

Semantics per block match ``verify_commit_light``: ignore non-commit
signatures, stop adding once the tallied power exceeds 2/3, every
included signature must verify, and the tally must exceed 2/3.

Divergence from the reference: its pipeline hands every key to the
ed25519 verifier, so a valid commit of a mixed ed25519 + sr25519 set, or
one with a secp256k1 key, fails there. The port routes each lane by its
key type through one
:class:`~tendermint_tpu_torch.crypto.batch.MultiBatchVerifier` for the
window, one sub-batch a type, and answers a secp256k1 lane by its key's
host check.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from tendermint_tpu_torch import resolve_device
from tendermint_tpu_torch.crypto import batch as crypto_batch
from tendermint_tpu_torch.types.block import BLOCK_ID_FLAG_COMMIT, BlockID, Commit
from tendermint_tpu_torch.types.validation import (
    InvalidCommitError,
    NotEnoughVotingPowerError,
    _verify_basic_vals_and_commit,
)
from tendermint_tpu_torch.types.validator_set import ValidatorSet


@dataclass
class CommitTask:
    """One block's commit to verify: (chain_id, vals, block_id, height, commit)."""

    chain_id: str
    vals: ValidatorSet
    block_id: BlockID
    height: int
    commit: Commit


@dataclass
class CommitVerdict:
    ok: bool
    error: Optional[Exception] = None


def verify_commits_pipelined(
    tasks: Sequence[CommitTask],
    mesh=None,
    use_device: Optional[bool] = None,
    device=None,
) -> List[CommitVerdict]:
    """Batch-verify a window of commits; one verdict per task.

    A failed block names its first bad signature (validation.go:244-251
    semantics, per block). ``use_device=False`` is the caller asking for
    the host: each lane is answered by its key type's host check.
    """
    if mesh is not None:
        raise NotImplementedError(
            "verify_commits_pipelined: mesh is not ported yet (ROADMAP.md A item 10, multi-GPU)"
        )
    dev = resolve_device(device)
    verdicts: List[Optional[CommitVerdict]] = [None] * len(tasks)
    # Lanes of the window: (public key, sign-bytes, signature).
    lanes: List[Tuple[object, bytes, bytes]] = []
    # Per task: (first lane, the signature indices of its lanes).
    spans: List[Optional[Tuple[int, List[int]]]] = [None] * len(tasks)

    for t_i, task in enumerate(tasks):
        try:
            _verify_basic_vals_and_commit(task.vals, task.commit, task.height, task.block_id)
        except InvalidCommitError as e:
            verdicts[t_i] = CommitVerdict(False, e)
            continue
        # Eligibility for the precompute cache; a blocksync window reuses
        # one validator set across most of its blocks.
        crypto_batch.note_validator_set(task.vals)
        needed = task.vals.total_voting_power() * 2 // 3
        start = len(lanes)
        sig_idxs: List[int] = []
        tallied = 0
        for idx, cs in enumerate(task.commit.signatures):
            if cs.block_id_flag != BLOCK_ID_FLAG_COMMIT:
                continue  # light: ignore everything not for the block
            val = task.vals.validators[idx]
            lanes.append((val.pub_key, task.commit.vote_sign_bytes(task.chain_id, idx), cs.signature))
            sig_idxs.append(idx)
            tallied += val.voting_power
            if tallied > needed:
                break
        if tallied <= needed:
            verdicts[t_i] = CommitVerdict(False, NotEnoughVotingPowerError(got=tallied, needed=needed))
            del lanes[start:]  # drop this task's lanes from the window
            continue
        spans[t_i] = (start, sig_idxs)

    oks = _verify_lanes(lanes, use_device, dev)
    for t_i, span in enumerate(spans):
        if span is None:
            continue
        start, sig_idxs = span
        bad = next((j for j in range(len(sig_idxs)) if not oks[start + j]), None)
        if bad is None:
            verdicts[t_i] = CommitVerdict(True)
        else:
            sig = tasks[t_i].commit.signatures[sig_idxs[bad]]
            verdicts[t_i] = CommitVerdict(
                False,
                InvalidCommitError(
                    f"wrong signature (#{sig_idxs[bad]}): {sig.signature.hex().upper()}"
                ),
            )
    return verdicts


def _verify_lanes(lanes, use_device: Optional[bool], device) -> List[bool]:
    """One verdict a lane: the host check of each key's type when
    ``use_device`` is False, else one batch, sub-batched per key type. A
    lane of a key type with no batch verifier (secp256k1) is answered by
    its key's host check, as ``verify_commit`` answers such a commit
    (the reference's pipeline sends it to the ed25519 verifier, which
    fails the window). A lane its key type's batch verifier refuses (a
    malformed signature) is false, as the reference's ``verify_batch``
    answers it."""
    if use_device is False:
        return [pk.verify_signature(msg, sig) for pk, msg, sig in lanes]
    oks = [False] * len(lanes)
    added: List[int] = []
    bv = crypto_batch.MultiBatchVerifier(device=device)
    for i, (pk, msg, sig) in enumerate(lanes):
        if not crypto_batch.supports_batch_verifier(pk):
            oks[i] = pk.verify_signature(msg, sig)
            continue
        try:
            bv.add(pk, msg, sig)
        except ValueError:
            continue
        added.append(i)
    if added:
        for i, ok in zip(added, bv.verify()[1]):
            oks[i] = ok
    return oks
