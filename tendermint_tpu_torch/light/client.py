"""Light client with trusted store, bisection, and fork detection.

Counterpart of ``tendermint_tpu/light/client.py`` (light/client.go):
trust options anchor the first block (height + hash from a
social-consensus source); ``verify_light_block_at_height`` then walks
forward sequentially or by skipping (bisection against the trust level),
or backwards through the hash chain. After verification the new block is
cross-checked against the witness providers (light/detector.go); a
conflicting header yields LightClientAttackEvidence reported to every
provider.

The skipping walk runs one ``light/batch.py`` round a bisection step
(``bisect_batching=True``, the default, as the reference's default): the
whole pivot ladder of a round is one scheduler super-batch. With
``bisect_batching=False`` it is the reference's one-verify-per-pivot
loop. The reference's environment knob for the choice
(``TENDERMINT_TPU_LIGHT_BATCH``) has no counterpart.

Every verification runs on ``device`` (default: the package's,
:data:`tendermint_tpu_torch.DEFAULT_DEVICE`); with batching on, the
rounds ride the shared scheduler, which verifies on the package's
device, so ``device`` must be that one (the constructor raises
``ValueError`` otherwise). A device error or a round whose
flush failed closed propagates out of
:meth:`LightClient.verify_light_block_at_height` as it is: it is never
read as an invalid header or a bad witness.
"""

from __future__ import annotations

import time as _time
from dataclasses import dataclass
from typing import Callable, List, Optional

from tendermint_tpu_torch.encoding.canonical import Timestamp
from tendermint_tpu_torch.libs import tracing
from tendermint_tpu_torch.libs.metrics import LightMetrics
from tendermint_tpu_torch.light import batch as light_batch
from tendermint_tpu_torch.light import verifier
from tendermint_tpu_torch.light.provider import (
    HeightTooHighError,
    LightBlockNotFoundError,
    Provider,
    ProviderError,
)
from tendermint_tpu_torch.light.store import LightStore
from tendermint_tpu_torch.types.evidence import LightClientAttackEvidence
from tendermint_tpu_torch.types.light import LightBlock
from tendermint_tpu_torch.types.validation import Fraction, verify_commit_light_trusting

DEFAULT_PRUNING_SIZE = 1000
DEFAULT_MAX_CLOCK_DRIFT = 10.0  # seconds


class LightClientError(Exception):
    pass


class DivergedHeaderError(LightClientError):
    """A witness returned a conflicting verified header."""

    def __init__(self, evidence: LightClientAttackEvidence, witness_index: int):
        self.evidence = evidence
        self.witness_index = witness_index
        super().__init__("conflicting headers detected: light client attack")


@dataclass
class TrustOptions:
    """light.TrustOptions: period + (height, hash) root of trust."""

    period: float  # trusting period, seconds
    height: int
    hash: bytes

    def validate(self) -> None:
        if self.period <= 0:
            raise ValueError("negative or zero trusting period")
        if self.height <= 0:
            raise ValueError("negative or zero height")
        if len(self.hash) != 32:
            raise ValueError(f"expected hash size 32, got {len(self.hash)}")


class LightClient:
    def __init__(
        self,
        chain_id: str,
        trust_options: TrustOptions,
        primary: Provider,
        witnesses: List[Provider],
        store: Optional[LightStore] = None,
        trust_level: Fraction = verifier.DEFAULT_TRUST_LEVEL,
        max_clock_drift: float = DEFAULT_MAX_CLOCK_DRIFT,
        sequential: bool = False,
        pruning_size: int = DEFAULT_PRUNING_SIZE,
        now: Optional[Callable[[], Timestamp]] = None,
        bisect_batching: bool = True,
        metrics: Optional[LightMetrics] = None,
        device=None,
    ):
        trust_options.validate()
        verifier.validate_trust_level(trust_level)
        if bisect_batching and device is not None:
            light_batch.check_shared_device(device)
        self.chain_id = chain_id
        self.trusting_period = trust_options.period
        self.trust_level = trust_level
        self.max_clock_drift = max_clock_drift
        self.primary = primary
        self.witnesses = list(witnesses)
        self.store = store or LightStore()
        self.sequential = sequential
        self.pruning_size = pruning_size
        self.bisect_batching = bisect_batching
        self.metrics = metrics or LightMetrics.nop()
        self.device = device
        self._now = now or (lambda: Timestamp.from_unix_ns(_time.time_ns()))
        self._initialize(trust_options)

    # --- initialization ------------------------------------------------------

    def _initialize(self, opts: TrustOptions) -> None:
        """light/client.go initializeWithTrustOptions: fetch the anchor
        block from the primary, check hash + self-consistency."""
        existing = self.store.light_block(opts.height)
        if existing is not None and existing.hash() == opts.hash:
            return
        lb = self.primary.light_block(opts.height)
        if lb.hash() != opts.hash:
            raise LightClientError(
                f"expected header's hash {opts.hash.hex()}, but got "
                f"{lb.hash().hex()}"
            )
        lb.validate_basic(self.chain_id)
        # 1/3+ of the valset must have signed (2/3 of the *previous* set
        # cannot be checked without trusting more).
        verify_commit_light_trusting(
            self.chain_id, lb.validator_set, lb.signed_header.commit, Fraction(1, 3),
            device=self.device,
        )
        self.store.save_light_block(lb)

    # --- public API ----------------------------------------------------------

    def trusted_light_block(self, height: int) -> Optional[LightBlock]:
        return self.store.light_block(height)

    def latest_trusted(self) -> Optional[LightBlock]:
        return self.store.latest_light_block()

    def update(self, now: Optional[Timestamp] = None) -> Optional[LightBlock]:
        """Verify the primary's latest block (client.go Update)."""
        latest = self.primary.light_block(0)
        trusted = self.store.latest_light_block()
        if trusted is not None and latest.height <= trusted.height:
            return None
        return self.verify_light_block_at_height(latest.height, now)

    def verify_light_block_at_height(
        self, height: int, now: Optional[Timestamp] = None
    ) -> LightBlock:
        """client.go VerifyLightBlockAtHeight:413."""
        if height <= 0:
            raise ValueError("height must be positive")
        now = now or self._now()
        existing = self.store.light_block(height)
        if existing is not None:
            return existing
        latest = self.store.latest_light_block()
        if latest is None:
            raise LightClientError("no trusted state; initialize first")
        if height < latest.height:
            return self._backwards(latest, height)
        target = self._fetch_from_primary(height)
        self.verify_header(target, now)
        return target

    def verify_header(self, new_block: LightBlock, now: Timestamp) -> None:
        """client.go VerifyHeader: forward verification + detector."""
        trusted = self.store.latest_light_block()
        if trusted is None:
            raise LightClientError("no trusted state")
        if new_block.height <= trusted.height:
            raise LightClientError(
                f"height {new_block.height} is not above trusted "
                f"{trusted.height}"
            )
        new_block.validate_basic(self.chain_id)
        if self.sequential:
            self._verify_sequential(trusted, new_block, now)
        elif self.bisect_batching:
            self._verify_skipping_batched(trusted, new_block, now)
        else:
            self._verify_skipping_sequential(trusted, new_block, now)
        self._detect_divergence(new_block, now)
        self.store.save_light_block(new_block)
        if self.store.size() > self.pruning_size:
            self.store.prune(self.pruning_size)

    # --- verification strategies ---------------------------------------------

    def _verify_sequential(
        self, trusted: LightBlock, new_block: LightBlock, now: Timestamp
    ) -> None:
        """client.go verifySequential:554: fetch every header in between."""
        current = trusted
        for h in range(trusted.height + 1, new_block.height + 1):
            interim = (
                new_block if h == new_block.height else self._fetch_from_primary(h)
            )
            verifier.verify_adjacent(
                current.signed_header,
                interim.signed_header,
                interim.validator_set,
                self.trusting_period,
                now,
                self.max_clock_drift,
                device=self.device,
            )
            if h != new_block.height:
                self.store.save_light_block(interim)
            current = interim

    def _verify_skipping_batched(
        self, trusted: LightBlock, new_block: LightBlock, now: Timestamp
    ) -> None:
        """client.go verifySkipping:647, one round a bisection step.

        Each round plans the full descending pivot ladder [target, mid,
        mid-of-mid, ...] down to base+1, verifies every candidate in ONE
        super-batch, then accepts the first (shallowest) candidate that
        verifies: exactly the candidate the sequential descent would
        have accepted. A hard error surfaces at the first candidate the
        sequential walk would have visited; verdicts of deeper
        candidates are ignored past that point."""
        pivots = {}  # height -> prefetched pivot, reused across rounds
        base = trusted
        rounds = 0
        try:
            while True:
                candidates = [new_block]
                # the exception owed if evaluation descends off the ladder:
                # a pivot fetch/validate failure, or "cannot split further"
                ladder_stop: Optional[Exception] = None
                while ladder_stop is None:
                    pivot_height = (base.height + candidates[-1].height) // 2
                    if pivot_height in (base.height, candidates[-1].height):
                        ladder_stop = LightClientError(
                            "bisection failed: cannot split further"
                        )
                        break
                    pivot = pivots.get(pivot_height)
                    if pivot is None:
                        try:
                            pivot = self._fetch_from_primary(pivot_height)
                            pivot.validate_basic(self.chain_id)
                        except Exception as exc:
                            ladder_stop = exc
                            break
                        pivots[pivot_height] = pivot
                    candidates.append(pivot)
                rounds += 1
                with tracing.span(
                    "light_round",
                    round=rounds,
                    base=base.height,
                    target=new_block.height,
                    candidates=len(candidates),
                ):
                    outcomes = light_batch.evaluate_candidates(
                        self.chain_id,
                        base,
                        candidates,
                        self.trusting_period,
                        now,
                        self.max_clock_drift,
                        self.trust_level,
                        device=self.device,
                    )
                accepted = None
                for cand, out in zip(candidates, outcomes):
                    if out.kind == light_batch.OK:
                        accepted = cand
                        break
                    if out.kind == light_batch.BISECT:
                        continue
                    raise out.error
                if accepted is None:
                    # every candidate needs a deeper pivot and there is none
                    raise ladder_stop
                if accepted.height == new_block.height:
                    return
                base = accepted
                self.store.save_light_block(accepted)
        finally:
            self.metrics.bisection_rounds.observe(rounds)

    def _verify_skipping_sequential(
        self, trusted: LightBlock, new_block: LightBlock, now: Timestamp
    ) -> None:
        """client.go verifySkipping:647, one ``verifier.verify`` a pivot."""
        verification_trace = [trusted]
        current = new_block
        while True:
            base = verification_trace[-1]
            try:
                verifier.verify(
                    base.signed_header,
                    base.validator_set,
                    current.signed_header,
                    current.validator_set,
                    self.trusting_period,
                    now,
                    self.max_clock_drift,
                    self.trust_level,
                    device=self.device,
                )
            except verifier.NewValSetCantBeTrustedError:
                # Not enough trusted power: bisect to the midpoint.
                pivot_height = (base.height + current.height) // 2
                if pivot_height in (base.height, current.height):
                    raise LightClientError(
                        "bisection failed: cannot split further"
                    )
                pivot = self._fetch_from_primary(pivot_height)
                pivot.validate_basic(self.chain_id)
                current = pivot
                continue
            # Verified against base.
            if current.height == new_block.height:
                return
            verification_trace.append(current)
            self.store.save_light_block(current)
            current = new_block

    def _backwards(self, trusted: LightBlock, height: int) -> LightBlock:
        """client.go backwards:722: follow LastBlockID hashes down."""
        current = trusted
        for h in range(trusted.height - 1, height - 1, -1):
            interim = self._fetch_from_primary(h)
            verifier.verify_backwards(interim.signed_header.header, current.signed_header.header)
            self.store.save_light_block(interim)
            current = interim
        return current

    # --- detector (light/detector.go) ----------------------------------------

    def _detect_divergence(self, new_block: LightBlock, now: Timestamp) -> None:
        """detector.go:28-120: ask every witness for the same height; a
        conflicting header is an attack only if the witness's block itself
        verifies against our trust root. An unverifiable witness is just a
        bad witness and is dropped (detector.go examineConflictingHeader).
        With batching on, every conflicting witness block is verified in
        one round."""
        if not self.witnesses:
            return
        trusted = self.store.light_block_before(new_block.height)
        bad_witnesses = []
        conflicts = []  # (witness index, witness, block, basic_ok)
        for i, witness in enumerate(list(self.witnesses)):
            try:
                w_block = witness.light_block(new_block.height)
            except (LightBlockNotFoundError, HeightTooHighError, ProviderError):
                continue
            if w_block.hash() == new_block.hash():
                continue
            # Verify the witness block against the trusted root before
            # treating the conflict as evidence: garbage from a faulty
            # witness must not stop the client or spawn bogus evidence.
            try:
                w_block.validate_basic(self.chain_id)
            except (ValueError, verifier.InvalidHeaderError):
                conflicts.append((i, witness, w_block, False))
                continue
            conflicts.append((i, witness, w_block, True))
        outcomes = {}
        to_verify = [c for c in conflicts if c[3] and trusted is not None]
        if to_verify:
            if self.bisect_batching:
                evaluated = light_batch.evaluate_candidates(
                    self.chain_id,
                    trusted,
                    [c[2] for c in to_verify],
                    self.trusting_period,
                    now,
                    self.max_clock_drift,
                    self.trust_level,
                    device=self.device,
                )
            else:
                evaluated = [
                    light_batch._resolve_sequential(
                        self.chain_id, trusted, c[2], self.trusting_period,
                        now, self.max_clock_drift, self.trust_level, self.device,
                    )
                    for c in to_verify
                ]
            for c, out in zip(to_verify, evaluated):
                outcomes[c[0]] = out
        for i, witness, w_block, basic_ok in conflicts:
            out = outcomes.get(i)
            if not basic_ok:
                bad_witnesses.append(witness)
                continue
            if out is not None and out.kind != light_batch.OK:
                err = out.error
                if isinstance(err, (ValueError, verifier.InvalidHeaderError)):
                    # includes NewValSetCantBeTrusted: an unverifiable
                    # witness is just a bad witness, not an attack
                    bad_witnesses.append(witness)
                    continue
                raise err  # e.g. NotEnoughVotingPowerError, or a device error
            # Conflict verified on both sides: a real light-client attack
            # (detector.go:122-215 abridged: common height = latest trusted
            # below the conflict).
            common = self.store.light_block_before(new_block.height)
            ev = LightClientAttackEvidence(
                conflicting_block=w_block,
                common_height=common.height if common else new_block.height - 1,
                total_voting_power=(
                    common.validator_set.total_voting_power() if common else 0
                ),
                timestamp=common.signed_header.header.time
                if common
                else new_block.signed_header.header.time,
            )
            for p in [self.primary] + self.witnesses:
                if p is not witness:
                    try:
                        p.report_evidence(ev)
                    except ProviderError:
                        pass  # best effort, as in the reference
            raise DivergedHeaderError(ev, i)
        for w in bad_witnesses:
            self.witnesses.remove(w)

    # --- provider plumbing ----------------------------------------------------

    def _fetch_from_primary(self, height: int) -> LightBlock:
        lb = self.primary.light_block(height)
        if lb.height != height:
            raise LightClientError(
                f"primary returned height {lb.height}, wanted {height}"
            )
        return lb
