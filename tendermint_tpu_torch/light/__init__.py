"""Light-client verification; counterpart of :mod:`tendermint_tpu.light`,
reduced to the stateless verifier."""
