"""Handshaker: reconcile app height with the stores at startup.

A copy of ``tendermint_tpu/consensus/replay.py``.

On restart the ABCI app may be behind the block store (in-process app
lost its memory; out-of-process app crashed at a different height).
The handshake queries Info, runs InitChain if the app is at genesis,
then replays stored blocks into the app until its height matches the
store — the recovery half of crash-durability, paired with the
consensus WAL (internal/consensus/replay.go:204-550 ReplayBlocks).

Replayed heights below the store tip go through FinalizeBlock+Commit
only (the state transitions were already validated when first applied);
if the state itself trails the store by one (crash between SaveBlock
and ApplyBlock), the final block goes through the full
BlockExecutor.apply_block to restore state too (replay.go:470-519).
"""

from __future__ import annotations

from tendermint_tpu_torch.abci import types as abci
from tendermint_tpu_torch.abci.client import AbciClient
from tendermint_tpu_torch.crypto import merkle
from tendermint_tpu_torch.state.execution import (
    BlockExecutor,
    _evidence_to_abci,
    _unmarshal_finalize_response,
    _validate_validator_updates,
)
from tendermint_tpu_torch.state.state import State
from tendermint_tpu_torch.state.store import StateStore
from tendermint_tpu_torch.storage.blockstore import BlockStore
from tendermint_tpu_torch.types.genesis import GenesisDoc


class HandshakeError(RuntimeError):
    pass


class Handshaker:
    def __init__(
        self,
        state_store: StateStore,
        block_store: BlockStore,
        block_exec: BlockExecutor,
        genesis: GenesisDoc,
    ):
        self.state_store = state_store
        self.block_store = block_store
        self.block_exec = block_exec
        self.genesis = genesis
        self.n_blocks_replayed = 0

    def handshake(self, app: AbciClient, state: State) -> State:
        """Info → (InitChain) → replay; returns the possibly-updated state."""
        info = app.info(abci.RequestInfo())
        app_height = info.last_block_height
        app_hash = info.last_block_app_hash
        store_height = self.block_store.height()
        state_height = state.last_block_height

        if app_height < 0:
            raise HandshakeError(f"app reported negative height {app_height}")
        if app_height > store_height:
            raise HandshakeError(
                f"app height {app_height} ahead of block store {store_height}; "
                "the app's state was not rolled back with the node's"
            )
        if store_height == 0:
            return state  # fresh chain: node assembly runs InitChain

        if app_height == 0:
            # replay.go:316-341: app lost everything; re-run InitChain so it
            # has genesis validators/params before the block replay.
            res = app.init_chain(
                abci.RequestInitChain(
                    time=self.genesis.genesis_time,
                    chain_id=self.genesis.chain_id,
                    consensus_params=self.genesis.consensus_params,
                    validators=[],
                    app_state_bytes=self.genesis.app_state,
                    initial_height=self.genesis.initial_height,
                )
            )
            if res.app_hash:
                app_hash = res.app_hash

        if app_height == store_height and state_height == store_height - 1:
            # Crash between the app's Commit and state_store.save: the app
            # already holds the tip, so rebuild the state transition from
            # the persisted FinalizeBlock response without re-executing
            # (replay.go:470-501, the "app is ahead of state" case).
            state = self._update_state_from_stored_response(state, store_height)
            self.n_blocks_replayed += 1
            state_height = state.last_block_height

        for h in range(app_height + 1, store_height + 1):
            block = self.block_store.load_block(h)
            if block is None:
                raise HandshakeError(f"block at height {h} missing from store")
            if h == store_height and state_height == store_height - 1:
                # Crash landed between SaveBlock and ApplyBlock: the tip
                # needs the full state transition (replay.go:505-519).
                meta = self.block_store.load_block_meta(h)
                state = self.block_exec.apply_block(state, meta.block_id, block)
                app_hash = state.app_hash
            else:
                app_hash = self._replay_block(app, state, block)
            self.n_blocks_replayed += 1

        if state_height == store_height and app_hash != state.app_hash:
            raise HandshakeError(
                f"app hash after replay {app_hash.hex()} != state app hash "
                f"{state.app_hash.hex()} at height {store_height}"
            )
        return state

    def _update_state_from_stored_response(self, state: State, height: int) -> State:
        """Rebuild state at `height` from the persisted FinalizeBlock
        response (saved before the app's Commit in apply_block, so it is
        durable whenever the app holds the block)."""
        raw = self.state_store.load_finalize_block_response(height)
        if raw is None:
            raise HandshakeError(
                f"app is at height {height} but no stored FinalizeBlock "
                "response exists to rebuild the state"
            )
        fres = _unmarshal_finalize_response(raw)
        meta = self.block_store.load_block_meta(height)
        block = self.block_store.load_block(height)
        if meta is None or block is None:
            raise HandshakeError(f"block at height {height} missing from store")
        validator_updates = _validate_validator_updates(
            fres.validator_updates, state.consensus_params
        )
        results_hash = merkle.hash_from_byte_slices(
            [r.deterministic_bytes() for r in fres.tx_results]
        )
        new_state = state.update(
            meta.block_id,
            block.header,
            results_hash,
            fres.consensus_param_updates,
            validator_updates,
        )
        new_state.app_hash = fres.app_hash
        self.state_store.save(new_state)
        return new_state

    def _replay_block(self, app: AbciClient, state: State, block) -> bytes:
        """FinalizeBlock + Commit only — no validation, no state update
        (the height was fully validated when first committed)."""
        fres = app.finalize_block(
            abci.RequestFinalizeBlock(
                hash=block.hash(),
                height=block.header.height,
                time=block.header.time,
                txs=list(block.data.txs),
                decided_last_commit=self.block_exec._build_last_commit_info(
                    block, state
                ),
                misbehavior=_evidence_to_abci(block.evidence),
                proposer_address=block.header.proposer_address,
                next_validators_hash=block.header.next_validators_hash,
            )
        )
        app.commit()
        return fres.app_hash
