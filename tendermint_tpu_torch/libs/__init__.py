"""Library helpers; counterpart of :mod:`tendermint_tpu.libs`, reduced to
the bit array of the vote set, the span tracer, the metrics registry,
the logger, and the gRPC transport and event loop of the verify
service."""
