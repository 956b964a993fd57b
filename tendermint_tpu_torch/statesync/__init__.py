"""State sync: bootstrap a fresh node from an application snapshot
(reference: internal/statesync/ — reactor, syncer, state provider);
counterpart of :mod:`tendermint_tpu.statesync`."""

from tendermint_tpu_torch.statesync.reactor import StateSyncReactor
from tendermint_tpu_torch.statesync.syncer import StateSyncConfig, StateSyncer

__all__ = ["StateSyncReactor", "StateSyncer", "StateSyncConfig"]
