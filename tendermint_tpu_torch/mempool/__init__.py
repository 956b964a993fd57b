"""The priority mempool (internal/mempool/); the mempool reactor needs
``p2p`` and is not ported."""

from tendermint_tpu_torch.mempool.cache import LRUTxCache
from tendermint_tpu_torch.mempool.mempool import MempoolConfig, TxMempool

__all__ = ["LRUTxCache", "MempoolConfig", "TxMempool"]
