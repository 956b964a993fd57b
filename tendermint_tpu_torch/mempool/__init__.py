"""The priority mempool and its gossip reactor (internal/mempool/)."""

from tendermint_tpu_torch.mempool.cache import LRUTxCache
from tendermint_tpu_torch.mempool.mempool import MempoolConfig, TxMempool

__all__ = ["LRUTxCache", "MempoolConfig", "TxMempool"]
