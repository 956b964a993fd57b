"""Commit types and commit verification; counterpart of
:mod:`tendermint_tpu.types`, reduced to what ``verify_commit`` reads."""
