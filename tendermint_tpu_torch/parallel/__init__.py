"""Multi-commit verification; counterpart of
:mod:`tendermint_tpu.parallel`, reduced to the single-device pipeline."""
