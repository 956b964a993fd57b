"""One-super-batch bisection rounds for the light client.

Counterpart of ``tendermint_tpu/light/batch.py``. The sequential
skipping loop costs one ``verify_commit_light_trusting`` +
``verify_commit_light`` round-trip per pivot, each its own device
launch. This module turns a whole bisection round into ONE scheduler
super-batch: every candidate of the pivot ladder is *planned* on the
host into raw ed25519 lanes, the union of all lanes goes to the
process-wide ``VerifyScheduler`` in one atomic ``submit_many``, and the
verdicts are folded back into per-candidate accept / bisect / error
outcomes on the host. The group is submitted with ``one_flush=True``,
so the scheduler does not cut it at its ``max_batch``: the round is one
flush and one ``verify_batch`` call on the card, whatever its size.

Parity contract: a candidate's outcome is EXACTLY what
``verifier.verify`` gives: the same exception types and messages, the
same precedence (trusting tally before trusting signatures before the
full 2/3 check, ``NotEnoughVotingPowerError`` from the full check
raised as it is, ``InvalidCommitError`` surfacing as
``InvalidHeaderError``). A candidate the planner cannot express byte for
byte (non-ed25519 keys, sub-threshold commits, malformed entries) is
resolved by the sequential verifier instead. That is the reference's
policy, not a device fallback; :func:`stats` counts it
(``sequential``).

The super-batch runs where the scheduler's ``verify_fn`` runs: the
shared scheduler's runs on the package's device, resolved at flush
time, so with the shared scheduler ``device=`` must name that device
(anything else raises ``ValueError``). ``device=`` is also where the
sequential verifier runs.

A flush that failed closed (the verifier raised and no host fallback
answered) is not read as bad signatures: the round raises the
verifier's exception, as the sequential ``verifier.verify`` does.
A verdict wait that runs out still fails closed, as in the reference.

The reference's ``batching_enabled`` and its environment knob
(``TENDERMINT_TPU_LIGHT_BATCH``) are left out: the light client
(``light/client.py``) takes ``bisect_batching=`` instead.
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional, Tuple

from tendermint_tpu_torch import resolve_device
from tendermint_tpu_torch.crypto import batch as crypto_batch
from tendermint_tpu_torch.crypto.keys import ED25519_KEY_TYPE
from tendermint_tpu_torch.libs import tracing
from tendermint_tpu_torch.light import verifier
from tendermint_tpu_torch.types.block import BLOCK_ID_FLAG_COMMIT
from tendermint_tpu_torch.types.validation import (
    BATCH_VERIFY_THRESHOLD,
    Fraction,
    InvalidCommitError,
    NotEnoughVotingPowerError,
    _safe_mul,
    _verify_basic_vals_and_commit,
)
from tendermint_tpu_torch.verifyd.protocol import CLASS_LIGHT

# outcome kinds
OK = "ok"
BISECT = "bisect"  # NewValSetCantBeTrusted: descend to a deeper pivot
ERROR = "error"  # hard failure: propagate to the caller

DEFAULT_WAIT = 30.0  # verdict wait for one super-batch

_stats_mtx = threading.Lock()
_STATS_ZERO = {
    "rounds": 0,  # evaluate_candidates calls
    "candidates": 0,
    "super_batches": 0,  # rounds that submitted lanes (one submit_many each)
    "lanes": 0,  # lanes submitted, before the scheduler's coalescing
    "decided_on_host": 0,  # outcomes the plan settled before any lane ran
    "sequential": 0,  # candidates the planner could not express
    "timed_out": 0,  # super-batches whose verdict wait ran out (all False)
    "failed_closed": 0,  # super-batches whose flush raised: the round raised
}
_stats = dict(_STATS_ZERO)  # guarded-by: _stats_mtx


def stats() -> dict:
    """The module's counters since the last :func:`reset_stats`."""
    with _stats_mtx:
        return dict(_stats)


def reset_stats() -> None:
    with _stats_mtx:
        _stats.update(_STATS_ZERO)


def _count(**deltas: int) -> None:
    with _stats_mtx:
        for k, v in deltas.items():
            _stats[k] += v


class Outcome:
    """Per-candidate verdict of one evaluated ladder."""

    __slots__ = ("kind", "error")

    def __init__(self, kind: str, error: Optional[BaseException] = None):
        self.kind = kind
        self.error = error


class _SigStep:
    """Deferred check over a contiguous lane slice: the first False
    verdict becomes the sequential path's exact wrong-signature error."""

    __slots__ = ("start", "idxs", "commit")

    def __init__(self, start: int, idxs: List[int], commit):
        self.start = start
        self.idxs = idxs
        self.commit = commit


class _RaiseStep:
    """Deferred exception: raised only if every earlier step passed
    (mirrors the sequential check order)."""

    __slots__ = ("error",)

    def __init__(self, error: BaseException):
        self.error = error


class _Plan:
    __slots__ = ("cand", "steps", "outcome", "fallback", "lanes")

    def __init__(self, cand):
        self.cand = cand
        self.steps: list = []
        self.outcome: Optional[Outcome] = None  # decided before any lane runs
        self.fallback = False  # punt this candidate to verifier.verify
        self.lanes: List[Tuple[bytes, bytes, bytes]] = []


def _plannable(vals) -> bool:
    """Every signer must be a well-formed ed25519 key for raw scheduler
    lanes; anything else goes through the sequential verifier (which has
    the multi-key-type sub-batching)."""
    for v in vals.validators:
        pk = v.pub_key
        if pk is None or pk.type != ED25519_KEY_TYPE or len(pk.bytes()) != 32:
            return False
    return True


def _plan_candidate(
    chain_id: str,
    base,
    cand,
    trusting_period: float,
    now,
    max_clock_drift: float,
    trust_level: Fraction,
) -> _Plan:
    """Host-side dry run of ``verifier.verify(base, cand)``: do every
    non-signature check now, emit the signature work as lanes."""
    plan = _Plan(cand)
    sh_t, vals_t = base.signed_header, base.validator_set
    sh_u, vals_u = cand.signed_header, cand.validator_set
    adjacent = sh_u.header.height == sh_t.header.height + 1

    # --- header-shape prechecks (verifier.go:33-60 / 106-130 order) ---------
    try:
        verifier._check_required_header_fields(sh_t)
        if not adjacent:
            verifier.validate_trust_level(trust_level)
        if verifier.header_expired(sh_t, trusting_period, now):
            raise verifier.HeaderExpiredError("old header has expired")
        verifier._verify_new_header_and_vals(
            sh_u, vals_u, sh_t, now, max_clock_drift
        )
        if adjacent and (
            sh_u.header.validators_hash != sh_t.header.next_validators_hash
        ):
            raise verifier.InvalidHeaderError(
                "expected old header's next validators to match those from "
                "new header"
            )
    except Exception as e:
        plan.outcome = Outcome(ERROR, e)
        return plan

    commit = sh_u.commit
    if (
        commit is None
        or vals_t is None
        or vals_u is None
        or len(commit.signatures) < BATCH_VERIFY_THRESHOLD
        or not _plannable(vals_t)
        or not _plannable(vals_u)
        or any(
            cs.signature is not None and len(cs.signature) != 64
            for cs in commit.signatures
            if cs.block_id_flag == BLOCK_ID_FLAG_COMMIT
        )
    ):
        plan.fallback = True
        return plan

    # --- trusting check (verify_commit_light_trusting, batch path) ----------
    if not adjacent:
        try:
            if trust_level.denominator == 0:
                raise InvalidCommitError("trustLevel has zero Denominator")
            total_mul, overflow = _safe_mul(
                vals_t.total_voting_power(), trust_level.numerator
            )
            if overflow:
                raise InvalidCommitError(
                    "int64 overflow while calculating voting power needed"
                )
            needed = total_mul // trust_level.denominator
            crypto_batch.note_validator_set(vals_t)
            tallied = 0
            seen: dict = {}
            lanes: List[Tuple[bytes, bytes, bytes]] = []
            idxs: List[int] = []
            for idx, cs in enumerate(commit.signatures):
                if cs.block_id_flag != BLOCK_ID_FLAG_COMMIT:
                    continue
                val_idx, val = vals_t.get_by_address(cs.validator_address)
                if val is None:
                    continue
                if val_idx in seen:
                    raise InvalidCommitError(
                        f"double vote from validator {val_idx} "
                        f"({seen[val_idx]} and {idx})"
                    )
                seen[val_idx] = idx
                lanes.append(
                    (
                        val.pub_key.bytes(),
                        commit.vote_sign_bytes(chain_id, idx),
                        cs.signature,
                    )
                )
                idxs.append(idx)
                tallied += val.voting_power
                if tallied > needed:
                    break
            if tallied <= needed:
                e = NotEnoughVotingPowerError(got=tallied, needed=needed)
                plan.outcome = Outcome(
                    BISECT, verifier.NewValSetCantBeTrustedError(str(e))
                )
                return plan
            plan.steps.append(_SigStep(len(plan.lanes), idxs, commit))
            plan.lanes.extend(lanes)
        except InvalidCommitError as e:
            # verify_non_adjacent wraps the ValueError family
            plan.outcome = Outcome(ERROR, verifier.InvalidHeaderError(str(e)))
            return plan

    # --- full 2/3 check (verify_commit_light, batch path) --------------------
    try:
        _verify_basic_vals_and_commit(
            vals_u, commit, sh_u.header.height, commit.block_id
        )
        needed2 = vals_u.total_voting_power() * 2 // 3
        crypto_batch.note_validator_set(vals_u)
        tallied2 = 0
        lanes2: List[Tuple[bytes, bytes, bytes]] = []
        idxs2: List[int] = []
        for idx, cs in enumerate(commit.signatures):
            if cs.block_id_flag != BLOCK_ID_FLAG_COMMIT:
                continue
            val = vals_u.validators[idx]
            lanes2.append(
                (
                    val.pub_key.bytes(),
                    commit.vote_sign_bytes(chain_id, idx),
                    cs.signature,
                )
            )
            idxs2.append(idx)
            tallied2 += val.voting_power
            if tallied2 > needed2:
                break
        if tallied2 <= needed2:
            # NotEnoughVotingPowerError is not a ValueError: it escapes
            # verify_non_adjacent RAW (only after earlier steps pass)
            plan.steps.append(
                _RaiseStep(NotEnoughVotingPowerError(got=tallied2, needed=needed2))
            )
        else:
            plan.steps.append(_SigStep(len(plan.lanes), idxs2, commit))
            plan.lanes.extend(lanes2)
    except InvalidCommitError as e:
        plan.steps.append(_RaiseStep(verifier.InvalidHeaderError(str(e))))
    return plan


def _resolve(plan: _Plan, verdicts: List[bool], base_off: int) -> Outcome:
    if plan.outcome is not None:
        return plan.outcome
    for step in plan.steps:
        if isinstance(step, _RaiseStep):
            return Outcome(ERROR, step.error)
        for rel, idx in enumerate(step.idxs):
            if not verdicts[base_off + step.start + rel]:
                sig = step.commit.signatures[idx]
                e = InvalidCommitError(
                    f"wrong signature (#{idx}): {sig.signature.hex().upper()}"
                )
                return Outcome(ERROR, verifier.InvalidHeaderError(str(e)))
    return Outcome(OK)


def _resolve_sequential(
    chain_id, base, cand, trusting_period, now, max_clock_drift, trust_level, device=None
) -> Outcome:
    try:
        verifier.verify(
            base.signed_header,
            base.validator_set,
            cand.signed_header,
            cand.validator_set,
            trusting_period,
            now,
            max_clock_drift,
            trust_level,
            device=device,
        )
        return Outcome(OK)
    except verifier.NewValSetCantBeTrustedError as e:
        return Outcome(BISECT, e)
    except Exception as e:
        return Outcome(ERROR, e)


def check_shared_device(device) -> None:
    """Raise ``ValueError`` unless ``device`` is the package's device,
    the one the shared scheduler verifies on."""
    device, shared = resolve_device(device), resolve_device(None)
    if (device.type, device.index or 0) != (shared.type, shared.index or 0):
        raise ValueError(
            f"the shared scheduler verifies on the package's device "
            f"{shared}, not {device}; pass a scheduler for {device}"
        )


def evaluate_candidates(
    chain_id: str,
    base,
    candidates: list,
    trusting_period: float,
    now,
    max_clock_drift: float,
    trust_level: Fraction,
    scheduler=None,
    timeout: float = DEFAULT_WAIT,
    device=None,
) -> List[Outcome]:
    """Verify every candidate against ``base`` with at most ONE
    scheduler super-batch, returning outcomes aligned with
    ``candidates``. Candidates the planner cannot express go to the
    sequential verifier one by one, on ``device`` (default: the
    package's).

    Raises the verifier's exception when the super-batch's flush failed
    closed (:func:`stats` counts it in ``failed_closed``). A verdict wait
    that runs out fails closed: every lane of the round reads False,
    which looks like bad signatures; :func:`stats` counts such a round
    in ``timed_out``."""
    device = resolve_device(device)
    if scheduler is None:
        check_shared_device(device)
    plans = [
        _plan_candidate(
            chain_id, base, c, trusting_period, now, max_clock_drift,
            trust_level,
        )
        for c in candidates
    ]
    lanes: List[Tuple[bytes, bytes, bytes]] = []
    offsets: List[int] = []
    for p in plans:
        offsets.append(len(lanes))
        lanes.extend(p.lanes)
    verdicts: List[bool] = []
    timed_out = False
    if lanes:
        sched = scheduler
        if sched is None:
            sched = crypto_batch.get_shared_scheduler()
        with tracing.span(
            "light_super_batch", lanes=len(lanes), candidates=len(candidates)
        ):
            # flush_by=now: the whole round is already assembled — pull
            # the accumulator's deadline to "immediately" so the batch
            # ships without waiting out max_delay
            entries = sched.submit_many(
                lanes,
                priority=CLASS_LIGHT,
                flush_by=time.monotonic(),
                tag="light-bisect",
                one_flush=True,
            )
            verdicts = sched.wait_many(entries, timeout=timeout)
            timed_out = not all(e.done.is_set() for e in entries)
        error = next((e.error for e in entries if e.error is not None), None)
        if error is not None:
            _count(rounds=1, candidates=len(candidates), super_batches=1,
                   lanes=len(lanes), failed_closed=1)
            raise error
    out: List[Outcome] = []
    for p, off in zip(plans, offsets):
        if p.fallback:
            out.append(
                _resolve_sequential(
                    chain_id, base, p.cand, trusting_period, now,
                    max_clock_drift, trust_level, device,
                )
            )
        else:
            out.append(_resolve(p, verdicts, off))
    _count(
        rounds=1,
        candidates=len(candidates),
        super_batches=1 if lanes else 0,
        lanes=len(lanes),
        decided_on_host=sum(p.outcome is not None for p in plans),
        sequential=sum(p.fallback for p in plans),
        timed_out=1 if timed_out else 0,
    )
    return out
