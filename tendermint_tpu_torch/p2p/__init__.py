"""P2P networking (reference: internal/p2p/); counterpart of
:mod:`tendermint_tpu.p2p`: the encrypted, multiplexed TCP control plane
and its in-memory twin. The card verifies signatures; consensus traffic
stays on sockets."""

from tendermint_tpu_torch.p2p.key import NodeID, NodeKey

__all__ = ["NodeID", "NodeKey"]
