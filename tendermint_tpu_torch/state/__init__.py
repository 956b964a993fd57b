"""Deterministic chain state and block execution; counterpart of
:mod:`tendermint_tpu.state` (reference: internal/state/), without the
rollback."""

from tendermint_tpu_torch.state.state import State, state_from_genesis
from tendermint_tpu_torch.state.store import StateStore

__all__ = ["State", "StateStore", "state_from_genesis"]
