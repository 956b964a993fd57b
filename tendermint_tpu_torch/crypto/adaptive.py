"""SLO-driven adaptive batching: the scheduler's feedback controller.

Counterpart of ``tendermint_tpu/crypto/adaptive.py``, whole but for
its environment knob (``dyn_batch_default``): a scheduler runs the
controller only when it is built with ``dyn_batch=True``.

- :class:`BatchCostModel` — a per-batch-bucket EWMA of what a flush of
  ``n`` lanes costs (batch residency and device seconds), fed from the
  scheduler's flush path (the site the ``on_flush`` observer fires
  from). Buckets are powers of two, like the engines' padding buckets.
- :class:`DynBatchController` — votes *grow* while the predicted
  marginal device cost of a bigger batch is cheap against the tightest
  in-flight ``flush_by`` slack, and *shrink* when the caller-observed
  queue wait (``note_queue_wait``) says queueing dominates the resolved
  flush deadline. Votes become steps only after ``votes_needed``
  consecutive same-direction votes and a ``dwell`` clock (hysteresis on
  every step), and the scale is clamped to ``[scale_min, scale_max]``.

The controller never mutates the scheduler's static config: it owns one
*scale* multiplier and the scheduler resolves ``(max_batch, max_delay)``
through :meth:`DynBatchController.limits` each accumulator iteration.
Without ``dyn_batch=True`` no controller is built at all, so the flush
boundaries are those of the static path.

Controller state is written by dispatch workers and read by the
accumulator and stats callers, so every mutable field rides ``_mtx``.
The clock is injectable, so hysteresis is testable without sleeping.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional

# hard floors/ceilings on the scale multiplier: the controller may
# shrink the static batch to a quarter or grow it 4x, never past.
SCALE_MIN = 0.25
SCALE_MAX = 4.0
# the delay knob grows with the batch knob but is capped tighter — a
# growing flush deadline adds latency for everyone, so it never more
# than doubles the configured max_delay.
DELAY_SCALE_MAX = 2.0

GROW_STEP = 1.25
SHRINK_STEP = 0.8
VOTES_NEEDED = 3  # consecutive same-direction votes per step
STEP_DWELL = 0.25  # seconds between steps (the hysteresis clock)

# grow only while the predicted marginal device cost of the next batch
# bucket fits in this fraction of the tightest in-flight flush_by
# slack — the rest of the slack stays as headroom for the device
# kernel's own variance.
GROW_SLACK_FRACTION = 0.5
# shrink when the caller-observed queue wait exceeds this fraction of
# the resolved flush deadline: lanes are spending deadline-class time
# queueing before they even reach the accumulator.
SHRINK_WAIT_FRACTION = 0.5

EWMA_ALPHA = 0.3
MIN_BUCKET_SAMPLES = 3  # no predictions from a cold bucket


def _bucket(lanes: int) -> int:
    """Power-of-two bucket index: 1 lane -> 0, 2-3 -> 1, 4-7 -> 2..."""
    return max(0, int(lanes).bit_length() - 1)


class BatchCostModel:
    """Per-(batch-bucket) EWMA of flush cost, fed from the flush path.

    One model per scheduler — and verifyd runs one scheduler per
    algorithm, so the buckets are naturally per-(algo, size) as the
    device engines compile them.
    """

    def __init__(self, alpha: float = EWMA_ALPHA):
        self._mtx = threading.Lock()
        self.alpha = alpha
        self._residency: Dict[int, float] = {}  # bucket -> EWMA seconds  # guarded-by: _mtx
        self._device: Dict[int, float] = {}  # bucket -> EWMA seconds  # guarded-by: _mtx
        self._samples: Dict[int, int] = {}  # bucket -> observations  # guarded-by: _mtx

    def observe(self, lanes: int, residency_s: float, device_s: float) -> None:
        """Fold one flush into the bucket EWMAs."""
        if lanes <= 0:
            return
        b = _bucket(lanes)
        with self._mtx:
            n = self._samples.get(b, 0)
            if n == 0:
                self._residency[b] = residency_s
                self._device[b] = device_s
            else:
                a = self.alpha
                self._residency[b] += a * (residency_s - self._residency[b])
                self._device[b] += a * (device_s - self._device[b])
            self._samples[b] = n + 1

    def device_cost(self, lanes: int) -> Optional[float]:
        """Predicted device seconds for a batch of ``lanes``, or None
        while the model is cold. Exact bucket when warm; otherwise a
        linear per-lane extrapolation from the nearest warm bucket
        below (conservative: ignores launch-cost amortisation, so it
        over-estimates big batches rather than under)."""
        b = _bucket(max(1, lanes))
        with self._mtx:
            if self._samples.get(b, 0) >= MIN_BUCKET_SAMPLES:
                return self._device[b]
            for lower in range(b - 1, -1, -1):
                if self._samples.get(lower, 0) >= MIN_BUCKET_SAMPLES:
                    return self._device[lower] * (2.0 ** (b - lower))
        return None

    def marginal_device_cost(self, lanes: int) -> Optional[float]:
        """Predicted *extra* device seconds from growing a batch of
        ``lanes`` into the next bucket — the grow-vote input. Measured
        difference when both buckets are warm; the linear extrapolation
        otherwise."""
        here = self.device_cost(lanes)
        if here is None:
            return None
        up = self.device_cost(max(1, lanes) * 2)
        if up is None:
            return here  # linear guess: doubling doubles
        return max(0.0, up - here)

    def residency_cost(self, lanes: int) -> Optional[float]:
        """EWMA batch residency for the bucket, or None while cold."""
        b = _bucket(max(1, lanes))
        with self._mtx:
            if self._samples.get(b, 0) >= MIN_BUCKET_SAMPLES:
                return self._residency[b]
        return None

    def snapshot(self) -> dict:
        with self._mtx:
            return {
                str(1 << b): {
                    "residency_s": round(self._residency[b], 6),
                    "device_s": round(self._device[b], 6),
                    "samples": self._samples[b],
                }
                for b in sorted(self._samples)
            }


class DynBatchController:
    """Deadline-aware dynamic batching: scale votes with hysteresis.

    The controller is deliberately *stateless about the scheduler's
    config*: it owns one ``scale`` multiplier and :meth:`limits`
    resolves the effective knobs from whatever static config the
    scheduler holds at that instant. Shared across threads (dispatch
    workers feed it, the accumulator reads it), hence the lock.
    """

    def __init__(
        self,
        clock: Callable[[], float] = time.monotonic,
        *,
        scale_min: float = SCALE_MIN,
        scale_max: float = SCALE_MAX,
        votes_needed: int = VOTES_NEEDED,
        dwell: float = STEP_DWELL,
        model: Optional[BatchCostModel] = None,
    ):
        self._clock = clock
        self._mtx = threading.Lock()
        self.model = model if model is not None else BatchCostModel()
        self.scale_min = scale_min
        self.scale_max = scale_max
        self.votes_needed = max(1, votes_needed)
        self.dwell = dwell
        self.scale = 1.0  # guarded-by: _mtx
        self.steps_up = 0  # guarded-by: _mtx
        self.steps_down = 0  # guarded-by: _mtx
        self._grow_votes = 0  # guarded-by: _mtx
        self._shrink_votes = 0  # guarded-by: _mtx
        # allow the first step as soon as the votes line up
        self._last_step = self._clock() - dwell  # guarded-by: _mtx
        self._wire_wait = 0.0  # EWMA of caller-observed queue wait  # guarded-by: _mtx
        self._wire_wait_n = 0  # guarded-by: _mtx

    # --- resolution ----------------------------------------------------------

    def limits(self, static_batch: int, static_delay: float):
        """Resolve (max_batch, max_delay) from the static config: the
        scheduler calls this every accumulator iteration, so a step
        takes effect on the very next flush decision."""
        with self._mtx:
            s = self.scale
        max_batch = max(1, int(static_batch * s))
        max_delay = static_delay * min(s, DELAY_SCALE_MAX)
        if s < 1.0:
            max_delay = max(max_delay, static_delay * self.scale_min)
        return max_batch, max_delay

    # --- signals -------------------------------------------------------------

    def note_queue_wait(self, seconds: float) -> None:
        """Caller-observed queue wait (verifyd's wire_wait stage): the
        shrink signal. EWMA so one slow connection doesn't thrash."""
        if seconds < 0:
            return
        with self._mtx:
            if self._wire_wait_n == 0:
                self._wire_wait = seconds
            else:
                self._wire_wait += EWMA_ALPHA * (seconds - self._wire_wait)
            self._wire_wait_n += 1

    def observe_flush(
        self,
        lanes: int,
        residency_s: float,
        device_s: float,
        slack_s: Optional[float],
        static_delay: float,
    ) -> None:
        """One flush happened: feed the cost model and cast a vote.

        ``slack_s`` is the tightest ``flush_by`` headroom in the batch
        at dispatch time (None when no lane carried a wire deadline —
        then the configured flush deadline is the only latency
        obligation and stands in for slack).
        """
        self.model.observe(lanes, residency_s, device_s)
        marginal = self.model.marginal_device_cost(lanes)
        with self._mtx:
            now = self._clock()
            resolved_delay = static_delay * min(self.scale, DELAY_SCALE_MAX)
            slack = slack_s if slack_s is not None else static_delay
            vote = 0
            if (
                self._wire_wait_n
                and self._wire_wait > SHRINK_WAIT_FRACTION * resolved_delay
            ) or slack < 0:
                # queueing dominates (or the wire deadline was already
                # blown at dispatch): smaller, more frequent flushes
                vote = -1
            elif (
                marginal is not None
                and slack > 0
                and marginal <= GROW_SLACK_FRACTION * slack
                and self.scale < self.scale_max
            ):
                vote = 1
            if vote > 0:
                self._grow_votes += 1
                self._shrink_votes = 0
            elif vote < 0:
                self._shrink_votes += 1
                self._grow_votes = 0
            else:
                # a neutral observation breaks both streaks — that is
                # the hysteresis: only sustained evidence moves the knob
                self._grow_votes = 0
                self._shrink_votes = 0
            if now - self._last_step < self.dwell:
                return
            if self._grow_votes >= self.votes_needed:
                self.scale = min(self.scale_max, self.scale * GROW_STEP)
                self.steps_up += 1
                self._grow_votes = 0
                self._last_step = now
            elif self._shrink_votes >= self.votes_needed:
                self.scale = max(self.scale_min, self.scale * SHRINK_STEP)
                self.steps_down += 1
                self._shrink_votes = 0
                self._last_step = now

    # --- observability -------------------------------------------------------

    def snapshot(self) -> dict:
        """Locked snapshot for stats()/banner/bench fragments."""
        with self._mtx:
            return {
                "scale": round(self.scale, 4),
                "steps_up": self.steps_up,
                "steps_down": self.steps_down,
                "grow_votes": self._grow_votes,
                "shrink_votes": self._shrink_votes,
                "wire_wait_ewma_s": round(self._wire_wait, 6),
                "cost_model": self.model.snapshot(),
            }
