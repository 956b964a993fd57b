"""The consensus state machine, its gossip reactor and its vote ingest;
counterpart of :mod:`tendermint_tpu.consensus`."""
