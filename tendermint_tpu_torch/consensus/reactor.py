"""Consensus reactor: targeted per-peer gossip of proposals, parts, votes,
and the scheduler-batched signature pre-verification of the vote channel.

A copy of ``tendermint_tpu/consensus/reactor.py``. The reactor keeps
internal/consensus/reactor.go's channel layout -- State(0x20),
Data(0x21), Vote(0x22), VoteSetBits(0x23) (reactor.go:78-81) -- and its
gossip discipline: one gossip routine per peer consults that peer's
PeerState and sends only what the peer is missing (gossipDataRoutine
reactor.go:501, gossipVotesRoutine reactor.go:736), with block-part +
commit catch-up for peers on older heights (gossipDataForCatchup
reactor.go:437). Peers announce state via NewRoundStep, HasVote, and
periodic VoteSetBits; everything a peer sends also updates its
PeerState, so re-sends converge to zero once a peer is caught up. Wire
format per message: 1 tag byte + payload (struct-packed fields, proto
payloads for types), the reference's byte for byte.

A peer's vote goes through the ``VotePreverifier`` (``:116-330`` there):
through the shared scheduler (``crypto/batch.py``
``get_shared_scheduler``) to the device engine, tagged
``Vote.mark_pre_verified`` when its batch verdict is good, and then
forwarded to the consensus state, whose ``VoteSet.add_vote`` skips the
inline verify for a tagged vote. It reads only the slice of
``ConsensusState`` that :class:`ConsensusView` documents.

Four divergences from the reference:

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
- **Catch-up parts wait for the peer's commit step.** The reference's
  ``_gossip_catchup`` sends a lagging peer the stored block's parts at
  once and marks them sent; a peer without +2/3 precommits for that
  height has no part set yet, drops them, and is never sent them again,
  so a node that leaves block sync a height or more behind can stall
  there (gossipDataForCatchup sends a part only once the peer's
  ProposalBlockPartSetHeader matches the stored block's). The port
  sends the commit's votes first and the parts once the peer announces
  ``RoundStep.COMMIT`` for that height.
- **A device error stops the reactor.** The reference's channel loops
  drop every exception of a handler (``:673-681``). The port's drop
  malformed peer input as before (decode errors, ``ValueError``,
  ``LookupError``, ``struct.error``, anything else a handler raises)
  but not the errors of :data:`~tendermint_tpu_torch.consensus.state.DEVICE_ERRORS`:
  the first is kept in :attr:`ConsensusReactor.error`, handed to
  ``on_error`` (a node's ``Node._fail``), and the reactor stops.
"""

from __future__ import annotations

import hashlib
import itertools
import queue
import struct
import threading
import time
from typing import Callable, Dict, List, Optional, Protocol, Tuple

from tendermint_tpu_torch.consensus.cstypes import RoundStep
from tendermint_tpu_torch.consensus.peer_state import PeerState
from tendermint_tpu_torch.consensus.state import DEVICE_ERRORS, Broadcaster
from tendermint_tpu_torch.crypto import batch as crypto_batch
from tendermint_tpu_torch.crypto.keys import ED25519_KEY_TYPE
from tendermint_tpu_torch.encoding.canonical import (
    SIGNED_MSG_TYPE_PRECOMMIT,
    SIGNED_MSG_TYPE_PREVOTE,
)
from tendermint_tpu_torch.libs.bits import BitArray
from tendermint_tpu_torch.p2p.router import Channel, Envelope, Router
from tendermint_tpu_torch.types.block import Proposal, Vote
from tendermint_tpu_torch.types.part_set import Part
from tendermint_tpu_torch.types.validator_set import ValidatorSet

STATE_CHANNEL = 0x20
DATA_CHANNEL = 0x21
VOTE_CHANNEL = 0x22
VOTE_SET_BITS_CHANNEL = 0x23

TAG_NEW_ROUND_STEP = 1
TAG_PROPOSAL = 2
TAG_BLOCK_PART = 3
TAG_VOTE = 4
TAG_HAS_VOTE = 5
TAG_VOTE_SET_BITS = 6

# How long gossip routines sleep when a peer needs nothing
# (peerGossipSleepDuration reactor.go:119 is 100ms; smaller here because
# test networks run sub-second rounds).
GOSSIP_SLEEP = 0.02
# Votes sent per gossip iteration when a peer is behind on votes.
VOTES_PER_ITER = 8
# Interval between VoteSetBits announcements of our own vote bitmaps.
BITS_INTERVAL = 0.5
# Upper bound on wire-supplied validator indices / bit-array sizes; a
# peer claiming more validators than this is lying (the reference bounds
# set size via MaxTotalVotingPower, validator_set.go:18-25).
MAX_WIRE_VALIDATORS = 65536


def encode_new_round_step(height: int, round_: int, step: int, last_commit_round: int) -> bytes:
    return bytes([TAG_NEW_ROUND_STEP]) + struct.pack(">qiii", height, round_, step, last_commit_round)


def encode_proposal(p: Proposal) -> bytes:
    return bytes([TAG_PROPOSAL]) + p.to_proto_bytes()


def encode_block_part(height: int, round_: int, part: Part) -> bytes:
    return bytes([TAG_BLOCK_PART]) + struct.pack(">qi", height, round_) + part.to_proto_bytes()


def encode_vote(v: Vote) -> bytes:
    return bytes([TAG_VOTE]) + v.to_proto_bytes()


def encode_has_vote(height: int, round_: int, type_: int, index: int) -> bytes:
    return bytes([TAG_HAS_VOTE]) + struct.pack(">qibi", height, round_, type_, index)


def encode_vote_set_bits(height: int, round_: int, type_: int, bits: BitArray) -> bytes:
    return (
        bytes([TAG_VOTE_SET_BITS])
        + struct.pack(">qibi", height, round_, type_, bits.size())
        + bytes(bits._elems)
    )


def decode_vote_set_bits(payload: bytes):
    """Returns (height, round, type, bits) or None for malformed/hostile
    input (oversized nbits would allocate unboundedly; a short payload
    would leave the BitArray's backing storage inconsistent)."""
    height, round_, type_, nbits = struct.unpack_from(">qibi", payload)
    if nbits < 0 or nbits > MAX_WIRE_VALIDATORS:
        return None
    ba = BitArray(nbits)
    body = payload[struct.calcsize(">qibi") :]
    if len(body) != len(ba._elems):
        return None
    ba._elems[:] = body
    return height, round_, type_, ba


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


class ConsensusReactor(Broadcaster):
    """The consensus state machine's peer: its four channels, per-peer
    gossip and catch-up, the announce loop, and the vote pre-verifier
    behind the vote channel. It is the state machine's ``Broadcaster``
    (``cs.broadcaster = self``, ``:367`` there)."""

    def __init__(self, cs, router: Router, on_error: Optional[Callable[[BaseException], None]] = None):
        self.cs = cs
        self.router = router
        self.state_ch = router.open_channel(STATE_CHANNEL)
        self.data_ch = router.open_channel(DATA_CHANNEL)
        self.vote_ch = router.open_channel(VOTE_CHANNEL)
        self.vote_bits_ch = router.open_channel(VOTE_SET_BITS_CHANNEL)
        cs.broadcaster = self
        self.preverifier = VotePreverifier(cs)
        self.on_error = on_error
        # The device error that stopped the reactor (module note).
        self.error: Optional[BaseException] = None
        self._stop_flag = threading.Event()
        self._threads: List[threading.Thread] = []
        self._peers: Dict[str, PeerState] = {}
        self._gossip_threads: Dict[str, threading.Thread] = {}
        self._peers_mtx = threading.Lock()

    def start(self) -> None:
        self._stop_flag.clear()
        self.preverifier.start()
        for ch, handler in (
            (self.state_ch, self._handle_state),
            (self.data_ch, self._handle_data),
            (self.vote_ch, self._handle_vote),
            (self.vote_bits_ch, self._handle_vote_bits),
        ):
            self._spawn(self._recv_loop, ch, handler)
        self._spawn(self._peer_lifecycle_loop)
        self._spawn(self._announce_loop)

    def _spawn(self, fn, *args) -> None:
        t = threading.Thread(target=fn, args=args, daemon=True)
        t.start()
        self._threads.append(t)

    def stop(self) -> None:
        self._stop_flag.set()
        # Join the channel handlers FIRST: a vote-channel thread still in
        # _handle_vote must not enqueue into a preverifier being drained.
        for t in self._threads:
            if t is not threading.current_thread():
                t.join(timeout=2)
        self.preverifier.stop()
        self._threads.clear()
        with self._peers_mtx:
            gossipers = list(self._gossip_threads.values())
            self._gossip_threads.clear()
            self._peers.clear()
        for t in gossipers:
            if t is not threading.current_thread():
                t.join(timeout=2)

    def _fail(self, exc: BaseException) -> None:
        """Keep the first device error, stop every loop, tell the node."""
        if self.error is None:
            self.error = exc
        self._stop_flag.set()
        if self.on_error is not None:
            self.on_error(exc)

    # --- peer lifecycle -------------------------------------------------------

    def _peer_lifecycle_loop(self) -> None:
        """Track router connections; one gossip routine per live peer
        (the reference subscribes to PeerUpdates, reactor.go:392)."""
        while not self._stop_flag.is_set():
            try:
                connected = set(self.router.connected_peers())
                with self._peers_mtx:
                    for pid in connected:
                        if pid not in self._gossip_threads:
                            ps = self._peers.get(pid) or PeerState(pid)
                            self._peers[pid] = ps
                            t = threading.Thread(
                                target=self._gossip_routine, args=(ps,), daemon=True, name=f"cs-gossip-{pid[:8]}"
                            )
                            self._gossip_threads[pid] = t
                            t.start()
                    for pid in list(self._gossip_threads):
                        if pid not in connected:
                            del self._gossip_threads[pid]
                            self._peers.pop(pid, None)
            except Exception:
                pass
            self._stop_flag.wait(0.1)

    def _peer(self, peer_id: str) -> PeerState:
        with self._peers_mtx:
            ps = self._peers.get(peer_id)
            if ps is None:
                ps = PeerState(peer_id)
                self._peers[peer_id] = ps
            return ps

    # --- outbound (Broadcaster) ----------------------------------------------

    def broadcast_proposal(self, proposal: Proposal) -> None:
        self.data_ch.broadcast(encode_proposal(proposal))

    def broadcast_block_part(self, height: int, round_: int, part: Part) -> None:
        self.data_ch.broadcast(encode_block_part(height, round_, part))

    def broadcast_vote(self, vote: Vote) -> None:
        # The SM announces HasVote separately when the vote lands in a set.
        self.vote_ch.broadcast(encode_vote(vote))

    def broadcast_has_vote(self, height: int, round_: int, type_: int, index: int) -> None:
        self.state_ch.broadcast(encode_has_vote(height, round_, type_, index))

    def broadcast_new_round_step(self, rs) -> None:
        lcr = rs.last_commit.round if rs.last_commit is not None else -1
        self.state_ch.broadcast(encode_new_round_step(rs.height, rs.round, int(rs.step), lcr))

    # --- periodic announcements ----------------------------------------------

    def _announce_loop(self) -> None:
        """Broadcast NewRoundStep + our vote bitmaps periodically so late
        joiners and message-drop victims re-converge (the role of the
        reference's VoteSetMaj23/VoteSetBits query cycle, reactor.go:808)."""
        while not self._stop_flag.is_set():
            try:
                rs = self.cs.rs
                if rs.votes is not None:
                    self.broadcast_new_round_step(rs)
                    for type_, vs in (
                        (SIGNED_MSG_TYPE_PREVOTE, rs.votes.prevotes(rs.round)),
                        (SIGNED_MSG_TYPE_PRECOMMIT, rs.votes.precommits(rs.round)),
                    ):
                        if vs is not None:
                            bits = encode_vote_set_bits(rs.height, rs.round, type_, vs.bit_array())
                            self.vote_bits_ch.broadcast(bits)
            except Exception:
                pass
            self._stop_flag.wait(BITS_INTERVAL)

    # --- per-peer gossip ------------------------------------------------------

    def _gossip_routine(self, ps: PeerState) -> None:
        """reactor.go gossipDataRoutine+gossipVotesRoutine merged: each
        iteration sends the peer at most one part and a few votes."""
        while not self._stop_flag.is_set():
            with self._peers_mtx:
                if self._gossip_threads.get(ps.peer_id) is not threading.current_thread():
                    return  # unsubscribed
            try:
                sent = self._gossip_once(ps)
            except Exception:
                sent = False
            if not sent:
                self._stop_flag.wait(GOSSIP_SLEEP)

    def _gossip_once(self, ps: PeerState) -> bool:
        rs = self.cs.rs
        p_height, p_round, p_step, p_lcr = ps.snapshot()
        if p_height == 0:
            return False  # no NewRoundStep from the peer yet
        if p_height == rs.height:
            return self._gossip_same_height(ps, rs, p_round)
        if p_height < rs.height:
            return self._gossip_catchup(ps, p_height, p_round, p_step, p_lcr)
        return False  # peer ahead: blocksync pulls us forward, not gossip

    def _gossip_same_height(self, ps: PeerState, rs, p_round: int) -> bool:
        sent = False
        # Proposal + parts for the peer's current round (reactor.go:501).
        if p_round == rs.round and rs.proposal is not None and not ps.has_proposal:
            self.data_ch.send(Envelope(DATA_CHANNEL, encode_proposal(rs.proposal), to_peer=ps.peer_id))
            ps.set_has_proposal(rs.height, rs.round)
            sent = True
        parts = rs.proposal_block_parts
        if p_round == rs.round and parts is not None:
            ps.init_parts(rs.height, rs.round, parts.header())
            idx = ps.pick_missing_part(parts.parts_bit_array)
            if idx is not None:
                part = parts.get_part(idx)
                if part is not None:
                    self.data_ch.send(
                        Envelope(DATA_CHANNEL, encode_block_part(rs.height, rs.round, part), to_peer=ps.peer_id)
                    )
                    ps.set_has_part(rs.height, rs.round, idx)
                    sent = True
        # Votes: peer's round first, then our round, then POL round
        # (gossipVotesForHeight reactor.go:640-700).
        if rs.votes is not None:
            rounds = []
            for r in (p_round, rs.round, rs.valid_round):
                if r >= 0 and r not in rounds:
                    rounds.append(r)
            for r in rounds:
                for type_, vs in (
                    (SIGNED_MSG_TYPE_PREVOTE, rs.votes.prevotes(r)),
                    (SIGNED_MSG_TYPE_PRECOMMIT, rs.votes.precommits(r)),
                ):
                    if vs is None:
                        continue
                    if self._send_missing_votes(ps, vs, rs.height, r, type_):
                        sent = True
        return sent

    def _send_missing_votes(self, ps, vote_set, height, round_, type_) -> bool:
        ours = vote_set.bit_array()
        sent = False
        for _ in range(VOTES_PER_ITER):
            idx = ps.pick_missing_vote(height, round_, type_, ours)
            if idx is None:
                break
            vote = vote_set.get_by_index(idx)
            if vote is None:
                break
            self.vote_ch.send(Envelope(VOTE_CHANNEL, encode_vote(vote), to_peer=ps.peer_id))
            ps.set_has_vote(height, round_, type_, idx, ours.size())
            sent = True
        return sent

    def _gossip_catchup(self, ps: PeerState, p_height, p_round, p_step, p_lcr) -> bool:
        """Peer is on an older height: serve the decided block's parts and
        its commit from the store (gossipDataForCatchup reactor.go:437)."""
        store = self.cs.block_store
        if p_height < store.base():
            return False
        meta = store.load_block_meta(p_height)
        # With vote extensions enabled the peer REQUIRES extensions on
        # every non-nil precommit, so when an extended commit is stored
        # it is the ONLY source served -- its round/absence bookkeeping
        # can legitimately differ from the canonical commit (written by
        # the h+1 proposer), and mixing indices between the two would
        # serve wrong-round or unsigned votes that the peer rejects
        # while we mark them sent.
        ext_commit = store.load_block_extended_commit(p_height)
        commit = None
        if ext_commit is None:
            commit = store.load_block_commit(p_height)
            if commit is None:
                # The canonical commit for p_height is only stored once
                # block p_height+1 lands; until then the seen commit
                # covers it (reference serves rs.LastCommit to height-1
                # peers, reactor.go:736).
                seen = store.load_seen_commit()
                if seen is not None and seen.height == p_height:
                    commit = seen
        if meta is None:
            return False
        n_parts = meta.block_id.part_set_header.total
        if ext_commit is not None:
            n_sigs = ext_commit.size()
        else:
            n_sigs = commit.size() if commit is not None else 0
        ps.ensure_catchup(p_height, n_parts, n_sigs)
        sent = False
        # One part per iteration, preferring whatever the peer lacks, once
        # the peer is in its commit step (module note): before it has +2/3
        # precommits it has no part set for the block and drops the part.
        theirs = ps.parts if ps.parts is not None else BitArray(0)
        for i in range(n_parts if p_step == RoundStep.COMMIT else 0):
            if ps.catchup_parts.get_index(i) or theirs.get_index(i):
                continue
            part = store.load_block_part(p_height, i)
            if part is None:
                break
            self.data_ch.send(Envelope(DATA_CHANNEL, encode_block_part(p_height, p_round, part), to_peer=ps.peer_id))
            ps.catchup_parts.set_index(i, True)
            sent = True
            break
        # Commit precommits let the lagging peer finish its round
        # (reactor.go:736 LastCommit case). One source drives the whole
        # loop: the extended commit when stored, the canonical/seen
        # commit otherwise.
        if ext_commit is not None or commit is not None:
            budget = VOTES_PER_ITER
            for i in range(n_sigs):
                if budget == 0:
                    break
                if ps.catchup_commit.get_index(i):
                    continue
                if ext_commit is not None:
                    if not ext_commit.extended_signatures[i].commit_sig.signature:
                        ps.catchup_commit.set_index(i, True)
                        continue
                    vote = ext_commit.get_extended_vote(i)
                else:
                    if not commit.signatures[i].signature:
                        ps.catchup_commit.set_index(i, True)
                        continue
                    vote = commit.get_vote(i)
                self.vote_ch.send(Envelope(VOTE_CHANNEL, encode_vote(vote), to_peer=ps.peer_id))
                ps.catchup_commit.set_index(i, True)
                ps.set_has_vote(vote.height, vote.round, vote.type, i, n_sigs)
                sent = True
                budget -= 1
        return sent

    # --- inbound --------------------------------------------------------------

    def _recv_loop(self, ch: Channel, handler) -> None:
        while not self._stop_flag.is_set():
            env = ch.receive(timeout=0.2)
            if env is None:
                continue
            try:
                handler(env)
            except DEVICE_ERRORS as exc:
                self._fail(exc)
                return
            except Exception:
                pass  # malformed peer input must not kill the reactor

    def _handle_state(self, env: Envelope) -> None:
        if not env.message:
            return
        tag = env.message[0]
        if tag == TAG_NEW_ROUND_STEP:
            height, round_, step, lcr = struct.unpack_from(">qiii", env.message, 1)
            self._peer(env.from_peer).apply_new_round_step(height, round_, step, lcr)
        elif tag == TAG_HAS_VOTE:
            height, round_, type_, index = struct.unpack_from(">qibi", env.message, 1)
            if 0 <= index < MAX_WIRE_VALIDATORS:
                self._peer(env.from_peer).set_has_vote(height, round_, type_, index)

    def _handle_data(self, env: Envelope) -> None:
        if not env.message:
            return
        tag = env.message[0]
        if tag == TAG_PROPOSAL:
            proposal = Proposal.from_proto_bytes(env.message[1:])
            ps = self._peer(env.from_peer)
            ps.set_has_proposal(proposal.height, proposal.round)
            self.cs.add_proposal_from_peer(proposal, env.from_peer)
        elif tag == TAG_BLOCK_PART:
            height, round_ = struct.unpack_from(">qi", env.message, 1)
            part = Part.from_proto_bytes(env.message[13:])
            self._peer(env.from_peer).set_has_part(height, round_, part.index)
            self.cs.add_block_part_from_peer(height, round_, part, env.from_peer)

    def _handle_vote(self, env: Envelope) -> None:
        if not env.message or env.message[0] != TAG_VOTE:
            return
        vote = Vote.from_proto_bytes(env.message[1:])
        if not (0 <= vote.validator_index < MAX_WIRE_VALIDATORS):
            return
        self._peer(env.from_peer).set_has_vote(vote.height, vote.round, vote.type, vote.validator_index)
        # Batch the signature check on the device before the state loop
        # sees the vote (fail-open: see VotePreverifier).
        self.preverifier.submit(vote, env.from_peer)

    def _handle_vote_bits(self, env: Envelope) -> None:
        if not env.message or env.message[0] != TAG_VOTE_SET_BITS:
            return
        decoded = decode_vote_set_bits(env.message[1:])
        if decoded is None:
            return
        height, round_, type_, bits = decoded
        self._peer(env.from_peer).apply_vote_set_bits(height, round_, type_, bits)
