"""JSON-RPC serving; counterpart of :mod:`tendermint_tpu.rpc`, reduced to
the threaded HTTP server and the JSON encodings the light-client serving
tier (``light/lightd.py``) answers with."""
