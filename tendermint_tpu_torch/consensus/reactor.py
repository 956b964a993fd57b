"""Scheduler-batched signature pre-verification for the vote channel.

The ``VotePreverifier`` of ``tendermint_tpu/consensus/reactor.py``
(``:116-330``): a peer's vote goes through the shared scheduler
(``crypto/batch.py`` ``get_shared_scheduler``) to the device engine, is
tagged ``Vote.mark_pre_verified`` when its batch verdict is good, and is
then forwarded to the consensus state, whose ``VoteSet.add_vote`` skips
the inline verify for a tagged vote. In a node it runs in front of
``consensus/state.py``'s ``ConsensusState``, and reads only the slice of
it that :class:`ConsensusView` documents. The rest of the reactor
(gossip, peer state, the wire) needs ``p2p.router`` and comes with it
(ROADMAP §A item 8d).

Two divergences from the reference:

- **The warm-up reaches the device.** The reference probes with 16
  submissions of one pad lane; the scheduler coalesces them into one
  lane, and a flush under ``DEVICE_THRESHOLD`` lanes is answered on the
  host, so its warm-up never touches the device. The port probes with
  ``DEVICE_THRESHOLD`` distinct valid lanes (:func:`warmup_lanes`),
  submitted together, so the flush reaches ``verify_batch`` and a
  kernel. Each probe signs fresh messages, so the verdict cache cannot
  answer a re-warm either.
- **A failed warm-up is visible.** The reference swallows the
  exception; the port keeps it in ``warmup_error`` (the pre-verifier
  stays cold and every vote takes the inline path, as there).
"""

from __future__ import annotations

import hashlib
import itertools
import queue
import threading
import time
from typing import List, Optional, Protocol, Tuple

from tendermint_tpu_torch.crypto import batch as crypto_batch
from tendermint_tpu_torch.crypto.keys import ED25519_KEY_TYPE
from tendermint_tpu_torch.encoding.canonical import SIGNED_MSG_TYPE_PRECOMMIT
from tendermint_tpu_torch.types.block import Vote
from tendermint_tpu_torch.types.validator_set import ValidatorSet


class RoundStateView(Protocol):
    """``ConsensusState.rs``: the round state the pre-verifier reads."""

    height: int  # the height the state machine is at
    validators: Optional[ValidatorSet]  # that height's validator set


class ChainStateView(Protocol):
    """``ConsensusState.state``: the committed chain state."""

    chain_id: str


class ConsensusView(Protocol):
    """The slice of ``ConsensusState`` the pre-verifier reads: the round
    state's height and validators (to resolve a vote's signer), the
    chain id (for sign-bytes), and ``add_vote_from_peer``, which hands a
    vote to the state machine (a ``VoteSet.add_vote`` behind it)."""

    rs: RoundStateView
    state: ChainStateView

    def add_vote_from_peer(self, vote: Vote, peer_id: str) -> None: ...


# The key of the warm-up probes: made from a fixed seed, so every process
# signs the same lanes for the same probe number.
WARMUP_SEED = hashlib.sha256(b"tendermint_tpu_torch vote pre-verifier warm-up").digest()
_WARMUP_KEY: Optional[Tuple[bytes, bytes]] = None
_WARMUP_KEY_LOCK = threading.Lock()
_PROBES = itertools.count()


def warmup_lanes(probe: int) -> List[Tuple[bytes, bytes, bytes]]:
    """``DEVICE_THRESHOLD`` distinct valid (pubkey, msg, sig) lanes for
    warm-up probe number ``probe``: the key of :data:`WARMUP_SEED` signs
    messages of one length that name the probe and the lane."""
    from tendermint_tpu_torch.crypto import ed25519_ref

    global _WARMUP_KEY
    with _WARMUP_KEY_LOCK:
        if _WARMUP_KEY is None:
            _WARMUP_KEY = ed25519_ref.keypair_from_seed(WARMUP_SEED)
        priv, pub = _WARMUP_KEY
    msgs = [b"vote-preverify-warmup/%016d/%04d" % (probe, i) for i in range(crypto_batch.DEVICE_THRESHOLD)]
    return [(pub, m, ed25519_ref.sign(priv, m)) for m in msgs]


class VotePreverifier:
    """Scheduler-batched signature pre-verification for the vote channel.

    Peer votes arrive on the reactor's vote-channel thread while the
    single-threaded state loop consumes them one at a time. This stage
    submits each vote's signature (and its extension signature) to the
    shared accumulate-with-deadline scheduler and forwards the vote to
    the state machine once its batch flushed, marked pre-verified so
    ``VoteSet.add_vote`` (and its extension check) skip the inline
    verify. Reference seam: types/vote_set.go:211-222,
    types/validation.go:12-16.

    An optimization, never a gate: a vote whose validator cannot be
    resolved (a height transition race, a catch-up vote), whose key type
    is not batched, or whose batch verdict is negative is forwarded
    UNMARKED and re-verified inline by the state loop, so a racy
    validator-set read can never drop a valid vote. The single forwarder
    thread keeps batched votes in order (passthrough votes may overtake
    queued ones; consensus tolerates reordering).
    """

    QUEUE_MAX = 4096
    # Per-vote verdict deadline, anchored at enqueue time: when a flush
    # wedges, every queued vote fails open about together after one
    # deadline, instead of a full wait per vote.
    WAIT_DEADLINE = 5.0
    # Consecutive verdict-deadline misses before the pre-verifier goes
    # cold again (stops feeding a wedged device) and re-probes.
    MISS_LIMIT = 4
    # How long a warm-up probe waits for its verdicts (a cold process
    # builds the kernels first).
    WARMUP_TIMEOUT = 120.0

    def __init__(self, cs: ConsensusView):
        self.cs = cs
        self._q: "queue.Queue" = queue.Queue(maxsize=self.QUEUE_MAX)
        self._stop_flag = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # Until a warm-up probe round-trips, votes pass straight through
        # to the inline path: a cold engine must never add latency to
        # consensus.
        self._warm = threading.Event()
        self._rewarming = threading.Lock()
        self._warmup_finished = threading.Event()
        self._deadline_misses = 0  # consecutive; device likely wedged
        self._count_mtx = threading.Lock()
        # how many votes went through the batch path vs the inline one
        self.batched = 0  # guarded-by: _count_mtx
        self.passthrough = 0  # guarded-by: _count_mtx
        # the last warm-up's exception (None after a probe that passed)
        self.warmup_error: Optional[BaseException] = None
        self.warmups = 0  # probes started

    def start(self) -> None:
        self._stop_flag.clear()
        self._thread = threading.Thread(target=self._forward_loop, name="vote-preverify", daemon=True)
        self._thread.start()
        threading.Thread(target=self._warmup, name="vote-preverify-warmup", daemon=True).start()

    def queue_depth(self) -> int:
        """Votes submitted and not yet forwarded. Past ``QUEUE_MAX`` a
        vote takes the inline path; a caller that can hold its peers
        back (a blocked receive) reads this."""
        return self._q.qsize()

    def wait_warmup(self, timeout: Optional[float] = None) -> bool:
        """Block until the first warm-up probe finished, passed or not;
        returns whether the pre-verifier is warm."""
        self._warmup_finished.wait(timeout)
        return self._warm.is_set()

    def _count(self, batched: int = 0, passthrough: int = 0) -> None:
        with self._count_mtx:
            self.batched += batched
            self.passthrough += passthrough

    def _warmup(self) -> None:
        """Warm the batch engine off the hot path and flip ``_warm`` only
        once a known-good probe round-trips. Also the re-warm probe after
        a cold flip: one attempt at a time.

        The probe takes the path a flood takes: ``DEVICE_THRESHOLD``
        distinct lanes submitted together are one flush of that many
        lanes, which ``tiered_verify_ed25519`` sends to ``verify_batch``
        and the kernel (module note)."""
        if not self._rewarming.acquire(blocking=False):
            return
        try:
            self.warmups += 1
            lanes = warmup_lanes(next(_PROBES))
            sched = crypto_batch.get_shared_scheduler()
            oks = sched.wait_many(sched.submit_many(lanes), timeout=self.WARMUP_TIMEOUT)
            if not all(oks):
                raise RuntimeError(
                    f"vote pre-verifier warm-up: {oks.count(False)} of {len(oks)} valid probe "
                    f"lanes not verified within {self.WARMUP_TIMEOUT} s (the flush failed closed "
                    "or timed out)"
                )
            self.warmup_error = None
            self._deadline_misses = 0
            self._warm.set()
        except Exception as exc:
            # The engine is unusable: stay cold (the inline path serves)
            # and keep the reason.
            self.warmup_error = exc
        finally:
            self._rewarming.release()
            self._warmup_finished.set()

    def stop(self) -> None:
        self._stop_flag.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None
        # Discard stragglers: the state loop is already stopped at
        # shutdown (forwarding could block forever), and undelivered
        # votes are simply gossiped again.
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break

    def _resolve_pub_key(self, vote: Vote):
        """The expected signer of this vote, or None when it cannot be
        resolved without the state lock (the state loop's inline verify,
        which holds it, then decides)."""
        rs = self.cs.rs
        if vote.height != rs.height or rs.validators is None:
            return None
        val = rs.validators.get_by_index(vote.validator_index)
        if val is None or val.pub_key.address() != vote.validator_address:
            return None
        return val.pub_key

    def submit(self, vote: Vote, peer_id: str) -> None:
        pub_key = self._resolve_pub_key(vote)
        if not self._warm.is_set() or pub_key is None or pub_key.type != ED25519_KEY_TYPE:
            self._count(passthrough=1)
            self.cs.add_vote_from_peer(vote, peer_id)
            return
        chain_id = self.cs.state.chain_id
        if self._q.full():
            # Backpressure: do not pay a scheduler submission for a vote
            # that cannot be queued.
            self._count(passthrough=1)
            self.cs.add_vote_from_peer(vote, peer_id)
            return
        try:
            sched = crypto_batch.get_shared_scheduler()
            sb = vote.sign_bytes(chain_id)
            # Digest of the exact bytes handed to the scheduler: the tag
            # is honoured only when verify() recomputes the same digest.
            sb_digest = hashlib.sha256(sb).digest()
            handle = sched.submit(pub_key.bytes(), sb, vote.signature)
            ext_handle = None
            ext_digest = None
            if (
                vote.type == SIGNED_MSG_TYPE_PRECOMMIT
                and not vote.block_id.is_nil()
                and vote.extension_signature
            ):
                esb = vote.extension_sign_bytes(chain_id)
                ext_digest = hashlib.sha256(esb).digest()
                ext_handle = sched.submit(pub_key.bytes(), esb, vote.extension_signature)
            self._q.put_nowait(
                (vote, peer_id, pub_key, handle, ext_handle, time.monotonic(), sb_digest, ext_digest)
            )
        except (RuntimeError, queue.Full):
            # scheduler stopped or backpressure: the inline path takes over
            self._count(passthrough=1)
            self.cs.add_vote_from_peer(vote, peer_id)

    def _forward_loop(self) -> None:
        while not self._stop_flag.is_set():
            try:
                (vote, peer_id, pub_key, handle, ext_handle, t_enq, sb_digest,
                 ext_digest) = self._q.get(timeout=0.1)
            except queue.Empty:
                continue
            sched = crypto_batch.get_shared_scheduler()
            deadline = t_enq + self.WAIT_DEADLINE
            ok = sched.wait(handle, timeout=max(0.0, deadline - time.monotonic()))
            ext_ok = (
                sched.wait(ext_handle, timeout=max(0.0, deadline - time.monotonic()))
                if ext_handle is not None
                else None
            )
            if ok:
                self._count(batched=1)
                self._deadline_misses = 0
                vote.mark_pre_verified(
                    self.cs.state.chain_id,
                    pub_key.bytes(),
                    extension_too=bool(ext_ok),
                    sign_bytes_digest=sb_digest,
                    extension_digest=ext_digest,
                )
            else:
                self._count(passthrough=1)
                # A verdict (the flush ran, the signature is bad) or a
                # deadline miss (the flush never returned: device wedged)?
                if not handle.done.is_set():
                    self._deadline_misses += 1
                    if self._deadline_misses >= self.MISS_LIMIT:
                        self._warm.clear()
                        # Tell the shared health machine the device path
                        # wedged, so other callers stop feeding it too.
                        from tendermint_tpu_torch.ops.device_policy import (
                            DeviceStallError,
                            shared as device_health,
                        )

                        device_health.record_failure(
                            DeviceStallError(
                                "vote pre-verify flush missed its deadline "
                                f"{self.MISS_LIMIT}x in a row"
                            )
                        )
                        threading.Thread(
                            target=self._warmup, name="vote-preverify-rewarm", daemon=True
                        ).start()
            self.cs.add_vote_from_peer(vote, peer_id)
