"""Verify service; counterpart of :mod:`tendermint_tpu.verifyd`, reduced
to the priority classes of its protocol."""
