"""The BFT consensus state machine (internal/consensus/state.go).

A copy of ``tendermint_tpu/consensus/state.py``. One receive routine
drains a queue of peer messages, one of its own messages and one of
timeouts; every input is written to the WAL before it is handled (its
own messages fsync'd, state.go:956-970). Round transitions follow the
reference's enterX graph:

    NewHeight -> NewRound -> Propose -> Prevote -> [PrevoteWait]
              -> Precommit -> [PrecommitWait] -> Commit -> NewHeight

Gossip goes out through a ``Broadcaster``; peers' votes come in through
``add_vote_from_peer``, in a node behind ``consensus/reactor.py``'s
``VotePreverifier``, which batch-verifies them on the card first. The
block's LastCommit is verified by ``BlockExecutor.validate_block``
(``verify_commit`` on the executor's device) at prevote and at commit;
the state machine takes no device of its own.

One divergence from the reference: **a device error stops the node.**
The reference drops every exception of a peer message's handler
(``_receive_routine``, ``_try_add_vote``, ``_sign_add_vote``,
``_catchup_replay``), so a device failure inside ``validate_block`` or
``apply_block`` leaves the node stalled at its height with nothing to
say why (Go panics in finalizeCommit). The port keeps those catches for
what they are for (malformed peer input, a conflicting vote, a signer
that refuses) and lets every error in :data:`DEVICE_ERRORS` escape: the
receive routine keeps it in :attr:`ConsensusState.error`, stops, and
``stop()`` raises it; in ``start()``'s WAL replay it escapes ``start()``.
``InvalidBlockError`` and ``InvalidCommitError`` stay ``ValueError``\\ s,
so a bad block still draws a nil prevote.

The state machine publishes NewRound, NewRoundStep, CompleteProposal
and Vote onto :attr:`ConsensusState.event_bus` (``eventbus.py``) when a
node sets one, as the reference does; its ``_publish_event`` drops any
error of a publish, the port's lets it escape (a publish cannot fail
for a slow subscriber: a full subscription drops the message). A
conflicting vote goes to the executor's evidence pool when
it has ``report_conflicting_votes`` (``evidence/pool.py`` has; the
executor's default no-op pool has not), as in the reference.
"""

from __future__ import annotations

import queue
import threading
import time as _time
from typing import Callable, Optional

from tendermint_tpu_torch import eventbus as eb
from tendermint_tpu_torch.consensus import cstypes
from tendermint_tpu_torch.consensus.cstypes import HeightVoteSet, RoundStep
from tendermint_tpu_torch.consensus.ticker import TimeoutTicker
from tendermint_tpu_torch.consensus.wal import (
    WAL,
    BlockPartInfo,
    EndHeightMessage,
    MsgInfo,
    NilWAL,
    TimeoutInfo,
)
from tendermint_tpu_torch.encoding.canonical import (
    SIGNED_MSG_TYPE_PRECOMMIT,
    SIGNED_MSG_TYPE_PREVOTE,
    Timestamp,
)
from tendermint_tpu_torch.libs import tracing
from tendermint_tpu_torch.libs.log import NOP_LOGGER
from tendermint_tpu_torch.libs.metrics import ConsensusMetrics
from tendermint_tpu_torch.ops._build import CudaError, KernelBuildError
from tendermint_tpu_torch.ops.device_policy import DeviceRefused, DeviceStallError
from tendermint_tpu_torch.ops.fault_injection import DeviceFault
from tendermint_tpu_torch.privval.base import PrivValidator
from tendermint_tpu_torch.state.execution import BlockExecutor
from tendermint_tpu_torch.state.state import State as SMState
from tendermint_tpu_torch.storage.blockstore import BlockStore
from tendermint_tpu_torch.types.block import (
    BLOCK_ID_FLAG_COMMIT,
    BLOCK_PART_SIZE_BYTES,
    Block,
    BlockID,
    ExtendedCommit,
    PartSetHeader,
    Proposal,
    Vote,
)
from tendermint_tpu_torch.types.part_set import Part, PartSet
from tendermint_tpu_torch.types.vote_set import ConflictingVotesError, vote_set_from_commit

# The errors of the device path: a kernel that does not build or launch,
# a batch the health machine refuses, a wedged flush, an injected fault.
# None of them is a peer's fault, so no handler drops them.
DEVICE_ERRORS = (CudaError, KernelBuildError, DeviceRefused, DeviceStallError, DeviceFault)


class DoubleSigningRiskError(RuntimeError):
    """state.go ErrSignatureFoundInPastBlocks: this key signed a recent
    commit, so joining consensus now risks equivocation."""


class Broadcaster:
    """The outbound gossip seam (the consensus reactor implements it)."""

    def broadcast_proposal(self, proposal: Proposal) -> None: ...

    def broadcast_block_part(self, height: int, round_: int, part: Part) -> None: ...

    def broadcast_vote(self, vote: Vote) -> None: ...

    def broadcast_has_vote(self, height: int, round_: int, type_: int, index: int) -> None: ...

    def broadcast_new_round_step(self, rs) -> None: ...


class ConsensusState:
    """internal/consensus/state.go State."""

    def __init__(
        self,
        sm_state: SMState,
        block_exec: BlockExecutor,
        block_store: BlockStore,
        priv_validator: Optional[PrivValidator] = None,
        wal: Optional[WAL] = None,
        broadcaster: Optional[Broadcaster] = None,
        now: Optional[Callable[[], Timestamp]] = None,
        on_committed: Optional[Callable[[int], None]] = None,
        metrics=None,
        logger=None,
        double_sign_check_height: int = 0,
    ):
        self.block_exec = block_exec
        self.block_store = block_store
        self.priv_validator = priv_validator
        self.priv_pub_key = priv_validator.get_pub_key() if priv_validator else None
        self.wal = wal or NilWAL()
        self._wal_is_real = not isinstance(self.wal, NilWAL)
        self.broadcaster = broadcaster or Broadcaster()
        self._now = now or (lambda: Timestamp.from_unix_ns(_time.time_ns()))
        self.on_committed = on_committed
        self.metrics = metrics or ConsensusMetrics.nop()
        self.logger = (logger or NOP_LOGGER).with_fields(module="consensus")
        self._last_commit_walltime: Optional[float] = None
        # The double-signing lookback (config.go:961
        # double-sign-check-height; 0 disables it).
        self.double_sign_check_height = double_sign_check_height
        self._ds_cleared_height: Optional[int] = None
        # The error that stopped the receive routine (a device error, or
        # anything else that escaped a handler); stop() raises it, and
        # on_error (a node's ``Node._fail``) hears of it when it happens.
        self.error: Optional[BaseException] = None
        self.on_error: Optional[Callable[[BaseException], None]] = None
        self.event_bus = None  # set by the node (node.go wires the event bus)

        self.rs = cstypes.RoundState()
        self.state = SMState()  # set by _update_to_state

        self.peer_queue: "queue.Queue" = queue.Queue(maxsize=1000)
        self.internal_queue: "queue.Queue" = queue.Queue(maxsize=1000)
        self.timeout_queue: "queue.Queue" = queue.Queue(maxsize=100)
        self.ticker = TimeoutTicker(self.timeout_queue.put)

        self._thread: Optional[threading.Thread] = None
        self._stop_flag = threading.Event()
        self._mtx = threading.RLock()
        self.decide_proposal = self._default_decide_proposal  # the tests' seam

        self._reconstruct_and_update(sm_state)

    # --- lifecycle ----------------------------------------------------------

    def _reconstruct_and_update(self, sm_state: SMState) -> None:
        if sm_state.last_block_height > 0 and sm_state.last_block_height >= sm_state.initial_height:
            seen = self.block_store.load_seen_commit()
            if seen is None or seen.height != sm_state.last_block_height:
                raise RuntimeError(
                    f"failed to reconstruct last commit; seen commit missing "
                    f"for height {sm_state.last_block_height}"
                )
            self.rs.last_commit = vote_set_from_commit(sm_state.chain_id, seen, sm_state.last_validators)
        self._update_to_state(sm_state)

    def start(self) -> None:
        """OnStart (state.go:399): the WAL, its replay, the double-sign
        check, the receive routine, round 0. A device error of the
        replay escapes."""
        self.wal.start()
        self._catchup_replay()
        self.check_double_signing_risk()
        self._stop_flag.clear()
        self._thread = threading.Thread(target=self._receive_routine, name="consensus-receive", daemon=True)
        self._thread.start()
        self._schedule_round_0()

    def check_double_signing_risk(self, height: Optional[int] = None) -> None:
        """state.go checkDoubleSigningRisk:2663: look back
        ``double_sign_check_height`` blocks for a commit signature of
        this key, and refuse to join consensus if one is there. 0
        disables it; a height already cleared is not scanned again."""
        if height is None:
            height = self.rs.height
        if (
            self.priv_validator is None
            or self.priv_pub_key is None
            or self.double_sign_check_height <= 0
            or height <= 0
            or self._ds_cleared_height == height
        ):
            return
        val_addr = self.priv_pub_key.address()
        lookback = min(self.double_sign_check_height, height)
        for i in range(1, lookback):
            commit = self.block_store.load_block_commit(height - i)
            if commit is None:
                commit = self.block_store.load_seen_commit()
                if commit is None or commit.height != height - i:
                    continue
            for sig_idx, s in enumerate(commit.signatures):
                if s.block_id_flag == BLOCK_ID_FLAG_COMMIT and s.validator_address == val_addr:
                    raise DoubleSigningRiskError(
                        f"signature from this validator's key found {i} block(s) back "
                        f"(height {height - i}, sig #{sig_idx}); refusing to join consensus"
                    )
        self._ds_cleared_height = height

    def stop(self) -> None:
        """Stop the routine and the WAL; raise the error that stopped the
        routine, if one did."""
        self._stop_flag.set()
        self.ticker.stop()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        self.wal.stop()
        if self.error is not None:
            raise self.error

    # --- external inputs ----------------------------------------------------

    def add_vote_from_peer(self, vote: Vote, peer_id: str) -> None:
        self.peer_queue.put(MsgInfo(vote, peer_id))

    def add_proposal_from_peer(self, proposal: Proposal, peer_id: str) -> None:
        self.peer_queue.put(MsgInfo(proposal, peer_id))

    def add_block_part_from_peer(self, height: int, round_: int, part: Part, peer_id: str) -> None:
        self.peer_queue.put(MsgInfo(BlockPartInfo(height, round_, part), peer_id))

    def _send_internal(self, msg_info: MsgInfo) -> None:
        self.internal_queue.put(msg_info)

    # --- the single-threaded loop -------------------------------------------

    def _receive_routine(self) -> None:
        """state.go:888-991: WAL before handling, own messages fsync'd.
        Timeouts are drained every turn, so peer traffic cannot starve
        the rounds (Go's select is fair across its channels). An error
        that escapes a handler stops the routine and is kept."""
        try:
            while not self._stop_flag.is_set():
                if not self._receive_once():
                    _time.sleep(0.002)
        except BaseException as exc:
            self.error = exc
            self._stop_flag.set()
            self.ticker.stop()
            self.logger.error("consensus stopped", err=repr(exc))
            if self.on_error is not None:
                self.on_error(exc)

    def _receive_once(self) -> bool:
        processed = False
        # Timeouts first: rare, cheap and what liveness hangs on.
        try:
            while True:
                ti = self.timeout_queue.get_nowait()
                with self._mtx:
                    self.wal.write(ti)
                    if self._wal_is_real:
                        self.metrics.wal_writes.inc()
                    self._handle_timeout(ti)
                processed = True
        except queue.Empty:
            pass
        try:
            mi = self.internal_queue.get_nowait()
            with self._mtx:
                self.wal.write_sync(mi)  # fsync own messages (state.go:964)
                if self._wal_is_real:
                    self.metrics.wal_writes.inc()
                self._handle_msg(mi)
            processed = True
        except queue.Empty:
            pass
        if not processed:
            try:
                mi = self.peer_queue.get_nowait()
                with self._mtx:
                    self.wal.write(mi)
                    if self._wal_is_real:
                        self.metrics.wal_writes.inc()
                    # Malformed peer input never kills the loop (state.go
                    # handleMsg logs and goes on); a device error does.
                    try:
                        self._handle_msg(mi)
                    except DEVICE_ERRORS:
                        raise
                    except Exception:
                        pass
                processed = True
            except queue.Empty:
                pass
        return processed

    def _handle_msg(self, mi: MsgInfo) -> None:
        msg = mi.msg
        if isinstance(msg, Proposal):
            self._set_proposal(msg, self._now())
        elif isinstance(msg, BlockPartInfo):
            added = self._add_proposal_block_part(msg, mi.peer_id)
            if added and self.rs.proposal_block_parts.is_complete():
                self._handle_complete_proposal()
        elif isinstance(msg, Vote):
            self._try_add_vote(msg, mi.peer_id)
        else:
            raise TypeError(f"unknown msg type {type(msg)}")

    def _handle_timeout(self, ti: TimeoutInfo) -> None:
        """state.go:1035-1090: the stale filter and the dispatch."""
        rs = self.rs
        if ti.height != rs.height or ti.round < rs.round or (ti.round == rs.round and ti.step < rs.step):
            return
        if ti.step == RoundStep.NEW_HEIGHT:
            self._enter_new_round(ti.height, 0)
        elif ti.step == RoundStep.NEW_ROUND:
            self._enter_propose(ti.height, 0)
        elif ti.step == RoundStep.PROPOSE:
            self._enter_prevote(ti.height, ti.round)
        elif ti.step == RoundStep.PREVOTE_WAIT:
            self._enter_precommit(ti.height, ti.round)
        elif ti.step == RoundStep.PRECOMMIT_WAIT:
            self._enter_precommit(ti.height, ti.round)
            self._enter_new_round(ti.height, ti.round + 1)

    # --- state update -------------------------------------------------------

    def _update_to_state(self, sm_state: SMState) -> None:
        """state.go updateToState."""
        rs = self.rs
        if not self.state.is_empty() and sm_state.last_block_height <= self.state.last_block_height:
            self._new_step()
            return

        if sm_state.last_block_height == 0:
            rs.last_commit = None
        elif rs.commit_round > -1 and rs.votes is not None:
            precommits = rs.votes.precommits(rs.commit_round)
            if precommits is None or not precommits.has_two_thirds_majority():
                raise RuntimeError("wanted to form a commit, but precommits didn't have 2/3+")
            rs.last_commit = precommits

        height = sm_state.last_block_height + 1
        if height == 1:
            height = sm_state.initial_height

        rs.height = height
        rs.round = 0
        rs.step = RoundStep.NEW_HEIGHT
        commit_base = (
            rs.commit_time
            if rs.commit_time.to_unix_ns() and rs.commit_time != cstypes.GO_ZERO_TIME
            else self._now()
        )
        rs.start_time = Timestamp.from_unix_ns(
            commit_base.to_unix_ns() + int(sm_state.consensus_params.timeout.commit * 1e9)
        )
        rs.validators = sm_state.validators
        rs.proposal = None
        rs.proposal_receive_time = cstypes.GO_ZERO_TIME
        rs.proposal_block = None
        rs.proposal_block_parts = None
        rs.locked_round = -1
        rs.locked_block = None
        rs.locked_block_parts = None
        rs.valid_round = -1
        rs.valid_block = None
        rs.valid_block_parts = None
        if sm_state.consensus_params.abci.vote_extensions_enabled(height):
            rs.votes = HeightVoteSet.extended(sm_state.chain_id, height, sm_state.validators)
        else:
            rs.votes = HeightVoteSet(sm_state.chain_id, height, sm_state.validators)
        rs.commit_round = -1
        rs.last_validators = sm_state.last_validators
        rs.triggered_timeout_precommit = False
        self.state = sm_state
        self._new_step()

    def _new_step(self) -> None:
        self.broadcaster.broadcast_new_round_step(self.rs)
        self._publish_event(
            "publish_event_new_round_step",
            lambda: eb.EventDataRoundState(height=self.rs.height, round=self.rs.round, step=self.rs.step.name),
        )

    def _publish_event(self, publisher: str, build) -> None:
        """Fire a consensus event onto the node's bus (state.go fires
        NewRound, NewRoundStep, CompleteProposal and Vote through its event
        bus). The bus is optional: tests drive the state machine without a
        node."""
        bus = self.event_bus
        if bus is not None:
            getattr(bus, publisher)(build())

    def _schedule_round_0(self) -> None:
        delay = max(0.0, (self.rs.start_time.to_unix_ns() - self._now().to_unix_ns()) / 1e9)
        self.ticker.schedule_timeout(delay, self.rs.height, 0, RoundStep.NEW_HEIGHT)

    # --- round transitions ---------------------------------------------------

    def _enter_new_round(self, height: int, round_: int) -> None:
        """state.go:1178-1253."""
        rs = self.rs
        if rs.height != height or round_ < rs.round or (rs.round == round_ and rs.step != RoundStep.NEW_HEIGHT):
            return
        validators = rs.validators
        if rs.round < round_:
            validators = validators.copy()
            validators.increment_proposer_priority(round_ - rs.round)
        rs.round = round_
        rs.step = RoundStep.NEW_ROUND
        rs.validators = validators
        if round_ != 0:
            rs.proposal = None
            rs.proposal_receive_time = cstypes.GO_ZERO_TIME
            rs.proposal_block = None
            rs.proposal_block_parts = None
        rs.votes.set_round(round_ + 1)  # track the next round for round skipping
        rs.triggered_timeout_precommit = False
        self.metrics.height.set(height)
        self.metrics.rounds.set(round_)
        self.metrics.validators.set(len(validators.validators))
        self.logger.with_fields(height=height, round=round_).debug("entering new round")
        tracing.instant("new_round", height=height, round=round_)
        self._publish_event(
            "publish_event_new_round",
            lambda: eb.EventDataNewRound(
                height=height, round=round_, step=rs.step.name, proposer_address=validators.get_proposer().address
            ),
        )
        self._enter_propose(height, round_)

    def _enter_propose(self, height: int, round_: int) -> None:
        """state.go:1273-1351."""
        rs = self.rs
        if rs.height != height or round_ < rs.round or (rs.round == round_ and rs.step >= RoundStep.PROPOSE):
            return
        self.logger.with_fields(height=height, round=round_).debug("entering propose step")
        with tracing.span("propose", step="propose", height=height, round=round_):
            try:
                # Schedule the prevote-on-timeout before anything slow.
                self.ticker.schedule_timeout(
                    self.state.consensus_params.timeout.propose_timeout(round_),
                    height,
                    round_,
                    RoundStep.PROPOSE,
                )
                if self.priv_validator is None or self.priv_pub_key is None:
                    return
                addr = self.priv_pub_key.address()
                if not rs.validators.has_address(addr):
                    return
                if self._is_proposer(addr):
                    self.decide_proposal(height, round_)
            finally:
                rs.round = round_
                rs.step = RoundStep.PROPOSE
                self._new_step()
                if self._is_proposal_complete():
                    self._enter_prevote(height, rs.round)

    def _is_proposer(self, address: bytes) -> bool:
        return self.rs.validators.get_proposer().address == address

    def _default_decide_proposal(self, height: int, round_: int) -> None:
        """state.go:1353-1409."""
        rs = self.rs
        if rs.valid_block is not None:
            block, block_parts = rs.valid_block, rs.valid_block_parts
        else:
            block = self._create_proposal_block()
            if block is None:
                return
            block_parts = PartSet.from_data(block.to_proto_bytes(), BLOCK_PART_SIZE_BYTES)
        self.wal.flush_and_sync()
        prop_block_id = BlockID(block.hash(), block_parts.header())
        proposal = Proposal(
            height=height,
            round=round_,
            pol_round=rs.valid_round,
            block_id=prop_block_id,
            timestamp=block.header.time,
        )
        try:
            self.priv_validator.sign_proposal(self.state.chain_id, proposal)
        except DEVICE_ERRORS:
            raise
        except Exception:
            return
        self._send_internal(MsgInfo(proposal, ""))
        for i in range(block_parts.total):
            self._send_internal(MsgInfo(BlockPartInfo(rs.height, rs.round, block_parts.get_part(i)), ""))
        self.broadcaster.broadcast_proposal(proposal)
        for i in range(block_parts.total):
            self.broadcaster.broadcast_block_part(rs.height, rs.round, block_parts.get_part(i))

    def _create_proposal_block(self) -> Optional[Block]:
        """state.go:1428-1477."""
        rs = self.rs
        if rs.height == self.state.initial_height:
            last_ext_commit = ExtendedCommit()
        elif rs.last_commit is not None and rs.last_commit.has_two_thirds_majority():
            last_ext_commit = rs.last_commit.make_extended_commit()
        else:
            return None
        proposer_addr = self.priv_pub_key.address()
        return self.block_exec.create_proposal_block(rs.height, self.state, last_ext_commit, proposer_addr)

    def _is_proposal_complete(self) -> bool:
        rs = self.rs
        if rs.proposal is None or rs.proposal_block is None:
            return False
        if rs.proposal.pol_round < 0:
            return True
        prevotes = rs.votes.prevotes(rs.proposal.pol_round)
        return prevotes is not None and prevotes.has_two_thirds_majority()

    def _enter_prevote(self, height: int, round_: int) -> None:
        """state.go:1478-1510."""
        rs = self.rs
        if rs.height != height or round_ < rs.round or (rs.round == round_ and rs.step >= RoundStep.PREVOTE):
            return
        self.logger.with_fields(height=height, round=round_).debug("entering prevote step")
        with tracing.span("prevote", step="prevote", height=height, round=round_):
            self._do_prevote(height, round_)
            rs.round = round_
            rs.step = RoundStep.PREVOTE
            self._new_step()

    def _proposal_is_timely(self) -> bool:
        """PBTS (``tendermint_tpu/consensus/state.py:567-574``): the proposal's
        timestamp against its receive time, within the round's precision
        and message delay."""
        rs = self.rs
        sp = self.state.consensus_params.synchrony.in_round(rs.round)
        ts = rs.proposal.timestamp.to_unix_ns()
        recv = rs.proposal_receive_time.to_unix_ns()
        lhs = ts - int(sp.precision * 1e9)
        rhs = ts + int(sp.message_delay * 1e9) + int(sp.precision * 1e9)
        return lhs <= recv <= rhs

    def _do_prevote(self, height: int, round_: int) -> None:
        """state.go defaultDoPrevote:1512-1645, with the PBTS checks. A
        block that fails ``validate_block`` (a ``ValueError``) draws a
        nil prevote; a device error escapes."""
        rs = self.rs
        if rs.proposal_block is None or rs.proposal is None:
            self._sign_add_vote(SIGNED_MSG_TYPE_PREVOTE, b"", PartSetHeader())
            return
        if rs.proposal.timestamp != rs.proposal_block.header.time:
            self._sign_add_vote(SIGNED_MSG_TYPE_PREVOTE, b"", PartSetHeader())
            return
        if rs.proposal.pol_round == -1 and rs.locked_round == -1 and not self._proposal_is_timely():
            self._sign_add_vote(SIGNED_MSG_TYPE_PREVOTE, b"", PartSetHeader())
            return
        try:
            self.block_exec.validate_block(self.state, rs.proposal_block)
        except ValueError:
            self._sign_add_vote(SIGNED_MSG_TYPE_PREVOTE, b"", PartSetHeader())
            return
        if not self.block_exec.process_proposal(rs.proposal_block, self.state):
            self._sign_add_vote(SIGNED_MSG_TYPE_PREVOTE, b"", PartSetHeader())
            return

        if rs.proposal.pol_round == -1:
            if rs.locked_round == -1 or (
                rs.locked_block is not None and rs.proposal_block.hash() == rs.locked_block.hash()
            ):
                self._sign_add_vote(
                    SIGNED_MSG_TYPE_PREVOTE, rs.proposal_block.hash(), rs.proposal_block_parts.header()
                )
                return
        else:
            prevotes = rs.votes.prevotes(rs.proposal.pol_round)
            if prevotes is not None:
                block_id, ok = prevotes.two_thirds_majority()
                if ok and rs.proposal_block.hash() == block_id.hash and 0 <= rs.proposal.pol_round < rs.round:
                    if rs.locked_round <= rs.proposal.pol_round or (
                        rs.locked_block is not None and rs.proposal_block.hash() == rs.locked_block.hash()
                    ):
                        self._sign_add_vote(
                            SIGNED_MSG_TYPE_PREVOTE,
                            rs.proposal_block.hash(),
                            rs.proposal_block_parts.header(),
                        )
                        return
        self._sign_add_vote(SIGNED_MSG_TYPE_PREVOTE, b"", PartSetHeader())

    def _enter_prevote_wait(self, height: int, round_: int) -> None:
        rs = self.rs
        if rs.height != height or round_ < rs.round or (rs.round == round_ and rs.step >= RoundStep.PREVOTE_WAIT):
            return
        rs.round = round_
        rs.step = RoundStep.PREVOTE_WAIT
        self._new_step()
        self.ticker.schedule_timeout(
            self.state.consensus_params.timeout.vote_timeout(round_), height, round_, RoundStep.PREVOTE_WAIT
        )

    def _enter_precommit(self, height: int, round_: int) -> None:
        """state.go:1682-1798."""
        rs = self.rs
        if rs.height != height or round_ < rs.round or (rs.round == round_ and rs.step >= RoundStep.PRECOMMIT):
            return
        self.logger.with_fields(height=height, round=round_).debug("entering precommit step")
        with tracing.span("precommit", step="precommit", height=height, round=round_):
            try:
                prevotes = rs.votes.prevotes(round_)
                block_id, ok = prevotes.two_thirds_majority() if prevotes else (BlockID(), False)
                if not ok or block_id.is_nil():
                    self._sign_add_vote(SIGNED_MSG_TYPE_PRECOMMIT, b"", PartSetHeader())
                    return
                if rs.proposal is None or rs.proposal_block is None:
                    self._sign_add_vote(SIGNED_MSG_TYPE_PRECOMMIT, b"", PartSetHeader())
                    return
                if rs.proposal.timestamp != rs.proposal_block.header.time:
                    self._sign_add_vote(SIGNED_MSG_TYPE_PRECOMMIT, b"", PartSetHeader())
                    return
                if rs.locked_block is not None and rs.locked_block.hash() == block_id.hash:
                    rs.locked_round = round_
                    self._sign_add_vote(SIGNED_MSG_TYPE_PRECOMMIT, block_id.hash, block_id.part_set_header)
                    return
                if rs.proposal_block.hash() == block_id.hash:
                    self.block_exec.validate_block(self.state, rs.proposal_block)
                    rs.locked_round = round_
                    rs.locked_block = rs.proposal_block
                    rs.locked_block_parts = rs.proposal_block_parts
                    self._sign_add_vote(SIGNED_MSG_TYPE_PRECOMMIT, block_id.hash, block_id.part_set_header)
                    return
                # A polka for a block we do not have: fetch it, precommit nil.
                if rs.proposal_block_parts is None or not rs.proposal_block_parts.has_header(
                    block_id.part_set_header
                ):
                    rs.proposal_block = None
                    rs.proposal_block_parts = PartSet(block_id.part_set_header)
                self._sign_add_vote(SIGNED_MSG_TYPE_PRECOMMIT, b"", PartSetHeader())
            finally:
                rs.round = round_
                rs.step = RoundStep.PRECOMMIT
                self._new_step()

    def _enter_precommit_wait(self, height: int, round_: int) -> None:
        rs = self.rs
        if rs.height != height or round_ < rs.round or (round_ == rs.round and rs.triggered_timeout_precommit):
            return
        rs.triggered_timeout_precommit = True
        self._new_step()
        self.ticker.schedule_timeout(
            self.state.consensus_params.timeout.vote_timeout(round_), height, round_, RoundStep.PRECOMMIT_WAIT
        )

    def _enter_commit(self, height: int, commit_round: int) -> None:
        """state.go:1837-1902."""
        rs = self.rs
        if rs.height != height or rs.step >= RoundStep.COMMIT:
            return
        self.logger.with_fields(height=height, round=commit_round).debug("entering commit step")
        with tracing.span("commit", step="commit", height=height, round=commit_round):
            try:
                precommits = rs.votes.precommits(commit_round)
                block_id, ok = precommits.two_thirds_majority()
                if not ok:
                    raise RuntimeError("enterCommit expects +2/3 precommits")
                if rs.locked_block is not None and rs.locked_block.hash() == block_id.hash:
                    rs.proposal_block = rs.locked_block
                    rs.proposal_block_parts = rs.locked_block_parts
                if rs.proposal_block is None or rs.proposal_block.hash() != block_id.hash:
                    if rs.proposal_block_parts is None or not rs.proposal_block_parts.has_header(
                        block_id.part_set_header
                    ):
                        rs.proposal_block = None
                        rs.proposal_block_parts = PartSet(block_id.part_set_header)
            finally:
                rs.step = RoundStep.COMMIT
                rs.commit_round = commit_round
                rs.commit_time = self._now()
                self._new_step()
                self._try_finalize_commit(height)

    def _try_finalize_commit(self, height: int) -> None:
        rs = self.rs
        precommits = rs.votes.precommits(rs.commit_round)
        block_id, ok = precommits.two_thirds_majority()
        if not ok or block_id.is_nil():
            return
        if rs.proposal_block is None or rs.proposal_block.hash() != block_id.hash:
            return
        self._finalize_commit(height)

    def _finalize_commit(self, height: int) -> None:
        """state.go:1931-2040: validate, save, the end-height marker,
        apply, the next height."""
        rs = self.rs
        if rs.height != height or rs.step != RoundStep.COMMIT:
            return
        precommits = rs.votes.precommits(rs.commit_round)
        block_id, ok = precommits.two_thirds_majority()
        block, block_parts = rs.proposal_block, rs.proposal_block_parts
        if not ok:
            raise RuntimeError("cannot finalize commit; no 2/3 majority")
        if not block_parts.has_header(block_id.part_set_header):
            raise RuntimeError("expected ProposalBlockParts header to match commit")
        if block.hash() != block_id.hash:
            raise RuntimeError("cannot finalize commit; block hash mismatch")
        self.block_exec.validate_block(self.state, block)

        if self.block_store.height() < block.header.height:
            seen_ec = precommits.make_extended_commit()
            if self.state.consensus_params.abci.vote_extensions_enabled(block.header.height):
                self.block_store.save_block_with_extended_commit(block, block_parts, seen_ec)
            else:
                self.block_store.save_block(block, block_parts, seen_ec.to_commit())

        # The WAL's end-height marker after the block is stored.
        self.wal.write_sync(EndHeightMessage(height))

        state_copy = self.state.copy()
        state_copy = self.block_exec.apply_block(state_copy, BlockID(block.hash(), block_parts.header()), block)
        self._update_to_state(state_copy)

        now_wall = _time.monotonic()
        if self._last_commit_walltime is not None:
            self.metrics.block_interval_seconds.observe(now_wall - self._last_commit_walltime)
        self._last_commit_walltime = now_wall
        self.metrics.num_txs.set(len(block.data.txs))
        # the part set holds the encoded block: no second encode under
        # the consensus lock just to measure it
        self.metrics.block_size_bytes.set(block_parts.byte_size)
        self.metrics.total_txs.inc(len(block.data.txs))
        n_absent = sum(1 for cs in block.last_commit.signatures if cs.is_absent()) if block.last_commit else 0
        self.metrics.missing_validators.set(n_absent)
        self.logger.with_fields(height=height, round=rs.commit_round).info(
            "committed block", hash=block.hash(), txs=len(block.data.txs)
        )

        if self.priv_validator is not None:
            self.priv_pub_key = self.priv_validator.get_pub_key()
        if self.on_committed is not None:
            self.on_committed(height)
        self._schedule_round_0()

    # --- proposal, part and vote ingestion ------------------------------------

    def _set_proposal(self, proposal: Proposal, recv_time: Timestamp) -> None:
        """state.go defaultSetProposal:2130-2175."""
        rs = self.rs
        if rs.proposal is not None or proposal is None:
            return
        if proposal.height != rs.height or proposal.round != rs.round:
            return
        if proposal.pol_round < -1 or (0 <= proposal.pol_round and proposal.pol_round >= proposal.round):
            raise ValueError("invalid proposal POL round")
        proposer = rs.validators.get_proposer()
        if not proposer.pub_key.verify_signature(proposal.sign_bytes(self.state.chain_id), proposal.signature):
            raise ValueError("invalid proposal signature")
        rs.proposal = proposal
        rs.proposal_receive_time = recv_time
        if rs.proposal_block_parts is None:
            rs.proposal_block_parts = PartSet(proposal.block_id.part_set_header)

    def _add_proposal_block_part(self, msg: BlockPartInfo, peer_id: str) -> bool:
        """state.go:2179-2254."""
        rs = self.rs
        if rs.height != msg.height:
            return False
        if rs.proposal_block_parts is None:
            return False
        added = rs.proposal_block_parts.add_part(msg.part)
        if not added:
            return False
        if rs.proposal_block_parts.byte_size > self.state.consensus_params.block.max_bytes:
            raise ValueError("total size of proposal block parts exceeds max block bytes")
        if rs.proposal_block_parts.is_complete():
            rs.proposal_block = Block.from_proto_bytes(rs.proposal_block_parts.get_reader())
        return added

    def _handle_complete_proposal(self) -> None:
        """state.go handleCompleteProposal:2255-2287."""
        rs = self.rs
        self._publish_event(
            "publish_event_complete_proposal",
            lambda: eb.EventDataCompleteProposal(
                height=rs.height, round=rs.round, step=rs.step.name,
                block_id=rs.proposal.block_id if rs.proposal else None,
            ),
        )
        prevotes = rs.votes.prevotes(rs.round)
        block_id, has_maj = prevotes.two_thirds_majority() if prevotes else (BlockID(), False)
        if has_maj and not block_id.is_nil() and rs.valid_round < rs.round:
            if rs.proposal_block.hash() == block_id.hash:
                rs.valid_round = rs.round
                rs.valid_block = rs.proposal_block
                rs.valid_block_parts = rs.proposal_block_parts
        if rs.step <= RoundStep.PROPOSE and self._is_proposal_complete():
            self._enter_prevote(rs.height, rs.round)
            if has_maj:
                self._enter_precommit(rs.height, rs.round)
        elif rs.step == RoundStep.COMMIT:
            self._try_finalize_commit(rs.height)

    def _try_add_vote(self, vote: Vote, peer_id: str) -> bool:
        """state.go tryAddVote:2289 and addVote:2333: a bad or conflicting
        vote is dropped; a device error (from a commit this vote
        completed) escapes."""
        try:
            return self._add_vote(vote, peer_id)
        except ConflictingVotesError as e:
            if self.priv_pub_key is not None and vote.validator_address == self.priv_pub_key.address():
                return False
            pool = getattr(self.block_exec, "evidence_pool", None)
            if pool is not None and hasattr(pool, "report_conflicting_votes"):
                pool.report_conflicting_votes(e.vote_a, e.vote_b)
            return False
        except DEVICE_ERRORS:
            raise
        except Exception:
            return False

    def _add_vote(self, vote: Vote, peer_id: str) -> bool:
        rs = self.rs

        # A precommit for the previous height while in the NewHeight step.
        if vote.height + 1 == rs.height and vote.type == SIGNED_MSG_TYPE_PRECOMMIT:
            if rs.step != RoundStep.NEW_HEIGHT:
                return False
            if rs.last_commit is None:
                return False
            added = rs.last_commit.add_vote(vote)
            if added:
                self.broadcaster.broadcast_has_vote(vote.height, vote.round, vote.type, vote.validator_index)
            if added and self.state.consensus_params.timeout.bypass_commit_timeout and rs.last_commit.has_all():
                self._enter_new_round(rs.height, 0)
            return added

        if vote.height != rs.height:
            return False

        if self.state.consensus_params.abci.vote_extensions_enabled(rs.height):
            my_addr = self.priv_pub_key.address() if self.priv_pub_key else b""
            if (
                vote.type == SIGNED_MSG_TYPE_PRECOMMIT
                and not vote.block_id.is_nil()
                and vote.validator_address != my_addr
            ):
                val = self.state.validators.get_by_index(vote.validator_index)
                vote.verify_extension(self.state.chain_id, val.pub_key)
                self.block_exec.verify_vote_extension(vote)
        else:
            vote.strip_extension()

        height = rs.height
        added = rs.votes.add_vote(vote, peer_id)
        if not added:
            return False
        # Tell the peers, so their peer state marks us as having it.
        self.broadcaster.broadcast_has_vote(vote.height, vote.round, vote.type, vote.validator_index)
        self._publish_event("publish_event_vote", lambda: eb.EventDataVote(vote=vote))

        if vote.type == SIGNED_MSG_TYPE_PREVOTE:
            prevotes = rs.votes.prevotes(vote.round)
            block_id, ok = prevotes.two_thirds_majority()
            if ok and not block_id.is_nil():
                if rs.valid_round < vote.round and vote.round == rs.round:
                    if rs.proposal_block is not None and rs.proposal_block.hash() == block_id.hash:
                        rs.valid_round = vote.round
                        rs.valid_block = rs.proposal_block
                        rs.valid_block_parts = rs.proposal_block_parts
                    else:
                        rs.proposal_block = None
                    if rs.proposal_block_parts is None or not rs.proposal_block_parts.has_header(
                        block_id.part_set_header
                    ):
                        rs.proposal_block_parts = PartSet(block_id.part_set_header)
            if rs.round < vote.round and prevotes.has_two_thirds_any():
                self._enter_new_round(height, vote.round)
            elif rs.round == vote.round and rs.step >= RoundStep.PREVOTE:
                block_id, ok = prevotes.two_thirds_majority()
                if ok and (self._is_proposal_complete() or block_id.is_nil()):
                    self._enter_precommit(height, vote.round)
                elif prevotes.has_two_thirds_any():
                    self._enter_prevote_wait(height, vote.round)
            elif rs.proposal is not None and 0 <= rs.proposal.pol_round == vote.round:
                if self._is_proposal_complete():
                    self._enter_prevote(height, rs.round)
        elif vote.type == SIGNED_MSG_TYPE_PRECOMMIT:
            precommits = rs.votes.precommits(vote.round)
            block_id, ok = precommits.two_thirds_majority()
            if ok:
                self._enter_new_round(height, vote.round)
                self._enter_precommit(height, vote.round)
                if not block_id.is_nil():
                    self._enter_commit(height, vote.round)
                    if self.state.consensus_params.timeout.bypass_commit_timeout and precommits.has_all():
                        self._enter_new_round(rs.height, 0)
                else:
                    self._enter_precommit_wait(height, vote.round)
            elif rs.round <= vote.round and precommits.has_two_thirds_any():
                self._enter_new_round(height, vote.round)
                self._enter_precommit_wait(height, vote.round)
        return True

    # --- vote signing --------------------------------------------------------

    def _sign_vote(self, msg_type: int, hash_: bytes, header: PartSetHeader) -> Optional[Vote]:
        """state.go signVote:2540-2620: the app's extension on a non-nil
        precommit when extensions are on."""
        self.wal.flush_and_sync()
        if self.priv_pub_key is None:
            return None
        addr = self.priv_pub_key.address()
        val_idx, _ = self.rs.validators.get_by_address(addr)
        if val_idx < 0:
            return None
        rs = self.rs
        vote = Vote(
            type=msg_type,
            height=rs.height,
            round=rs.round,
            block_id=BlockID(hash_, header),
            timestamp=self._vote_time(),
            validator_address=addr,
            validator_index=val_idx,
        )
        ext_enabled = self.state.consensus_params.abci.vote_extensions_enabled(rs.height)
        if msg_type == SIGNED_MSG_TYPE_PRECOMMIT and hash_ and ext_enabled:
            vote.extension = self.block_exec.extend_vote(vote)
        self.priv_validator.sign_vote(self.state.chain_id, vote)
        if not ext_enabled:
            vote.strip_extension()
        return vote

    def _vote_time(self) -> Timestamp:
        return self._now()

    def _sign_add_vote(self, msg_type: int, hash_: bytes, header: PartSetHeader) -> Optional[Vote]:
        if self.priv_validator is None or self.priv_pub_key is None:
            return None
        if not self.rs.validators.has_address(self.priv_pub_key.address()):
            return None
        try:
            vote = self._sign_vote(msg_type, hash_, header)
        except DEVICE_ERRORS:
            raise
        except Exception:
            return None  # the signer refused (a double-sign risk)
        if vote is None:
            return None
        self._send_internal(MsgInfo(vote, ""))
        self.broadcaster.broadcast_vote(vote)
        return vote

    # --- WAL replay ----------------------------------------------------------

    def _catchup_replay(self) -> None:
        """replay.go catchupReplay:97-180: replay the WAL's messages of
        the current height, after the last end-height marker. A bad
        message is skipped; a device error escapes ``start()``."""
        height = self.rs.height
        offset = self.wal.search_for_end_height(height - 1)
        if offset is None and height > self.state.initial_height:
            pruned_from = getattr(self.wal, "first_offset", lambda: 0)()
            if pruned_from > 0:
                # Rotation pruned the marker away: replaying from the
                # retention horizon would feed older heights' messages
                # in. Fatal, as in the reference.
                raise RuntimeError(
                    f"WAL end-height marker for {height - 1} was pruned "
                    f"(retention starts at offset {pruned_from}); cannot "
                    "safely replay — restore from a snapshot or state sync"
                )
            offset = 0
        start = offset or 0
        for _, msg in self.wal.iter_messages(start):
            if isinstance(msg, EndHeightMessage):
                continue
            if isinstance(msg, MsgInfo):
                with self._mtx:
                    try:
                        self._handle_msg(msg)
                    except DEVICE_ERRORS:
                        raise
                    except Exception:
                        pass
            elif isinstance(msg, TimeoutInfo):
                with self._mtx:
                    self._handle_timeout(msg)
