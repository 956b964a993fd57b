"""Key-value storage; counterpart of :mod:`tendermint_tpu.storage`,
reduced to the store seam and the in-memory store the light store uses."""
