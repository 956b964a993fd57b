"""Library helpers; counterpart of :mod:`tendermint_tpu.libs`, reduced to
the bit array of the vote set and the span tracer of the scheduler."""
