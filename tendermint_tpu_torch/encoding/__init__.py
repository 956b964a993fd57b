"""Canonical wire encoding for vote sign-bytes (protobuf wire format,
hand-rolled); counterpart of :mod:`tendermint_tpu.encoding`."""
