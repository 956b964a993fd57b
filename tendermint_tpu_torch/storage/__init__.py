"""Key-value storage and the block store; counterpart of
:mod:`tendermint_tpu.storage`, reduced to the store seam, the in-memory
store and the block store (the file-backed stores are ROADMAP §A item
8f)."""
