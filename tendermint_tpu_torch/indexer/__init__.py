"""The tx and block event index and its sinks; counterpart of
:mod:`tendermint_tpu.indexer`."""

from tendermint_tpu_torch.indexer.kv import KVIndexer, TxResult

__all__ = ["KVIndexer", "TxResult"]
