"""Node assembly (reference: node/); counterpart of
:mod:`tendermint_tpu.node`."""

from tendermint_tpu_torch.node.node import Node, NodeConfig

__all__ = ["Node", "NodeConfig"]
