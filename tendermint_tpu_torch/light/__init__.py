"""Light-client verification; counterpart of :mod:`tendermint_tpu.light`,
reduced to the stateless verifier and the one-super-batch bisection
round (``light/batch.py``)."""
