"""JSON-RPC serving; counterpart of :mod:`tendermint_tpu.rpc`: the
threaded HTTP server with its websocket sessions, a node's route table
(``core.py``), the JSON encodings and the HTTP client."""
