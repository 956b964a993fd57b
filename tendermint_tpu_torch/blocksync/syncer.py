"""The block-sync apply loop with pipelined verification on the card.

A copy of ``tendermint_tpu/blocksync/syncer.py``. The reference node
applies one block per iteration: peek (first, second),
VerifyCommitLight(first <- second.LastCommit), validate, save, apply
(internal/blocksync/reactor.go:538-650). Here the loop peeks a WINDOW of
consecutive blocks and verifies all their commits in one batch
(``parallel/pipeline.py``, on ``device``) before applying them in order,
each validated (``BlockExecutor.validate_block``: the header checks and
the whole LastCommit, past the window's +2/3 prefix) before it is saved
and applied, as reactor.go does. A bad verdict or a block that fails
validation re-requests both heights of the pair and bans the peer that
sent them (``syncer.py:136-138``). The reference's syncer saves the block
first and lets a validation error escape ``step()`` (ROADMAP §C).
``mesh=`` raises, as the pipeline's does (ROADMAP §A item 10).

:meth:`BlockSyncer.start` runs :meth:`step` on a thread of its own until
the pool is caught up, then calls ``on_caught_up`` with the state (the
node's switch to consensus); ``blocksync/reactor.py`` feeds the pool
from peers. One divergence: the reference's thread ends silently when
``step()`` raises (``syncer.py:80-87``), so a node that already left its
grace period stays in block sync for good; the port's keeps the error in
:attr:`BlockSyncer.error` and hands it to ``on_error`` (a node's
``Node._fail``) before the thread ends.
"""

from __future__ import annotations

import threading
import time as _time
from typing import Callable, List, Optional

from tendermint_tpu_torch import resolve_device
from tendermint_tpu_torch.blocksync.pool import BlockPool
from tendermint_tpu_torch.parallel.pipeline import CommitTask, verify_commits_pipelined
from tendermint_tpu_torch.state.execution import BlockExecutor
from tendermint_tpu_torch.state.state import State
from tendermint_tpu_torch.storage.blockstore import BlockStore
from tendermint_tpu_torch.types.block import BLOCK_PART_SIZE_BYTES, BlockID
from tendermint_tpu_torch.types.part_set import PartSet
from tendermint_tpu_torch.types.validation import NotEnoughVotingPowerError

DEFAULT_VERIFY_WINDOW = 16


class PeerTransport:
    """What the syncer needs from the network: ask a peer for a block;
    delivery comes back via pool.add_block (the reactor wires this)."""

    def request_block(self, peer_id: str, height: int) -> None:
        raise NotImplementedError


class BlockSyncer:
    def __init__(
        self,
        state: State,
        block_exec: BlockExecutor,
        block_store: BlockStore,
        transport: PeerTransport,
        pool: Optional[BlockPool] = None,
        verify_window: int = DEFAULT_VERIFY_WINDOW,
        mesh=None,
        device=None,
        on_caught_up: Optional[Callable[[State], None]] = None,
        on_error: Optional[Callable[[BaseException], None]] = None,
    ):
        if mesh is not None:
            raise NotImplementedError(
                "BlockSyncer: mesh is not ported yet (ROADMAP.md A item 10, multi-GPU)"
            )
        self.device = resolve_device(device)
        self.state = state
        self.block_exec = block_exec
        self.block_store = block_store
        self.transport = transport
        self.pool = pool or BlockPool(max(block_store.height() + 1, state.initial_height))
        self.verify_window = verify_window
        self.on_caught_up = on_caught_up
        self.on_error = on_error
        # The error that ended the thread (module note).
        self.error: Optional[BaseException] = None
        self._stop_flag = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # --- driving -------------------------------------------------------------

    def start(self) -> None:
        self._stop_flag.clear()
        self._thread = threading.Thread(target=self._run, name="blocksync", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop_flag.set()
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=10)
        self._thread = None

    def _run(self) -> None:
        try:
            while not self._stop_flag.is_set():
                self.step()
                if self.pool.is_caught_up() and self.pool.num_pending() == 0:
                    if self.on_caught_up is not None:
                        self.on_caught_up(self.state)
                    return
                _time.sleep(0.002)
        except BaseException as exc:
            self.error = exc
            if self.on_error is not None:
                self.on_error(exc)

    def step(self) -> int:
        """One scheduling + apply pass; returns blocks applied."""
        for height, peer_id in self.pool.make_requests():
            self.transport.request_block(peer_id, height)
        self.pool.check_timeouts()
        return self._apply_ready_blocks()

    def _apply_ready_blocks(self) -> int:
        """Peek a window, batch-verify every (block_i <- block_{i+1}.LastCommit)
        pair in ONE call, then apply the verified prefix."""
        window = self.pool.peek_blocks(self.verify_window + 1)
        if len(window) < 2:
            return 0
        # One set covers the window only while validators_hash is stable;
        # it is cut at the first change (that block is verified next pass,
        # with the state after the apply, as the reference's serial loop
        # would).
        vals = self.state.validators
        stable_hash = window[0].header.validators_hash
        tasks: List[CommitTask] = []
        part_sets: List[PartSet] = []
        for first, second in zip(window, window[1:]):
            if first.header.validators_hash != stable_hash:
                break
            parts = PartSet.from_data(first.to_proto_bytes(), BLOCK_PART_SIZE_BYTES)
            part_sets.append(parts)
            tasks.append(
                CommitTask(
                    chain_id=self.state.chain_id,
                    vals=vals,
                    block_id=BlockID(first.hash(), parts.header()),
                    height=first.header.height,
                    commit=second.last_commit,
                )
            )
            if len(tasks) >= self.verify_window:
                break
        if not tasks:
            return 0
        verdicts = verify_commits_pipelined(tasks, device=self.device)
        applied = 0
        for (first, second), task, parts, verdict in zip(
            zip(window, window[1:]), tasks, part_sets, verdicts
        ):
            ok = verdict.ok
            if ok:
                try:
                    self.block_exec.validate_block(self.state, first)
                except (ValueError, NotEnoughVotingPowerError):
                    ok = False
            if not ok:
                self.pool.redo_request(first.header.height)
                self.pool.redo_request(second.header.height)
                break
            self.block_store.save_block(first, parts, second.last_commit)
            self.state = self.block_exec.apply_block(self.state, task.block_id, first)
            self.pool.pop_request()
            applied += 1
        return applied
