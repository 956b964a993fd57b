"""Commit and header types and commit verification; counterpart of
:mod:`tendermint_tpu.types`, reduced to what ``verify_commit``, the
blocksync pipeline and the light-client verifier read."""
