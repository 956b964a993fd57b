"""Rollback: reconstruct and persist the state one height back.

A copy of ``tendermint_tpu/state/rollback.py``.

The operator escape hatch for an app-hash divergence: roll the
consensus state from height H to H-1 so the block at H is re-processed
(internal/state/rollback.go:109). The rolled-back state is rebuilt from
the stores — validator sets and consensus params from the state store's
per-height records, AppHash/LastResultsHash from block H's header
(header.AppHash is the app state AFTER height H-1, exactly what state
H-1 carries).

``hard=True`` additionally deletes block H from the block store so a
restarted node re-runs consensus for H instead of replaying the stored
block into the app.
"""

from __future__ import annotations

from typing import Tuple

from tendermint_tpu_torch.state.state import State
from tendermint_tpu_torch.state.store import StateStore
from tendermint_tpu_torch.storage.blockstore import BlockStore


def rollback_state(
    state_store: StateStore, block_store: BlockStore, hard: bool = False
) -> Tuple[int, bytes]:
    """Roll the latest state back one height; returns (height, app_hash)
    of the state now current. Raises if there is nothing to roll back to."""
    invalid_state = state_store.load()
    if invalid_state is None or invalid_state.is_empty():
        raise ValueError("no state found to roll back")
    height = invalid_state.last_block_height
    if height <= invalid_state.initial_height:
        raise ValueError(f"cannot roll back from initial height {height}")
    if block_store.height() != height:
        raise ValueError(
            f"block store height {block_store.height()} != state height "
            f"{height}; cannot roll back"
        )

    rollback_meta = block_store.load_block_meta(height)
    if rollback_meta is None:
        raise ValueError(f"block at height {height} not found")
    prev_meta = block_store.load_block_meta(height - 1)
    if prev_meta is None:
        raise ValueError(f"block at height {height - 1} not found")
    header = rollback_meta.header

    validators = state_store.load_validators(height)
    next_validators = state_store.load_validators(height + 1)
    last_validators = state_store.load_validators(height - 1)
    params = state_store.load_consensus_params(height)

    vals_changed = invalid_state.last_height_validators_changed
    if vals_changed > height:
        vals_changed = height
    params_changed = invalid_state.last_height_consensus_params_changed
    if params_changed > height:
        params_changed = height

    rolled = State(
        version=invalid_state.version,
        chain_id=invalid_state.chain_id,
        initial_height=invalid_state.initial_height,
        last_block_height=height - 1,
        last_block_id=header.last_block_id,
        last_block_time=prev_meta.header.time,
        next_validators=next_validators,
        validators=validators,
        last_validators=last_validators,
        last_height_validators_changed=vals_changed,
        consensus_params=params,
        last_height_consensus_params_changed=params_changed,
        last_results_hash=header.last_results_hash,
        app_hash=header.app_hash,
    )
    state_store.save(rolled)
    if hard:
        block_store.delete_latest_block()
    return rolled.last_block_height, rolled.app_hash
