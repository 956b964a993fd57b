"""The consensus state machine and its vote ingest; counterpart of
:mod:`tendermint_tpu.consensus`, without the gossip reactor and its peer
state (they need ``p2p.router``, ROADMAP §A item 8d)."""
