"""Consensus ingest; counterpart of :mod:`tendermint_tpu.consensus`,
reduced to the vote pre-verifier."""
