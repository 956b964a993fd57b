"""Seed-only node: PEX address gossip with no chain services.

A copy of ``tendermint_tpu/node/seed.py``.

node/seed.go analog: a seed accepts inbound peers, hands out known
addresses over the PEX channel, crawls for new ones, and runs no
consensus, mempool, blocksync, or RPC. Operators point fresh nodes'
persistent/bootstrap peers at it to discover the network.
"""

from __future__ import annotations

import os
import threading
from typing import List, Optional

from tendermint_tpu_torch.libs.log import Logger
from tendermint_tpu_torch.p2p.key import NodeKey
from tendermint_tpu_torch.p2p.peermanager import PeerAddress, PeerManager
from tendermint_tpu_torch.p2p.pex import PexReactor
from tendermint_tpu_torch.p2p.router import Router
from tendermint_tpu_torch.p2p.transport import NodeInfo, TCPTransport


class SeedNode:
    """Minimal assembly: transport + router + peer manager + PEX
    (node/seed.go makeSeedNode)."""

    def __init__(
        self,
        home: str,
        chain_id: str,
        listen_addr: str = "127.0.0.1:0",
        bootstrap_peers: Optional[List[str]] = None,
        moniker: str = "seed",
        max_connections: int = 64,
        log_level: str = "none",
    ):
        if home:
            os.makedirs(home, exist_ok=True)
            self.node_key = NodeKey.load_or_gen(
                os.path.join(home, "node_key.json")
            )
        else:
            self.node_key = NodeKey.generate()
        self.logger = Logger(level=log_level or "none", moniker=moniker)
        self.transport = TCPTransport(self.node_key)
        self.transport.listen(listen_addr)
        self.node_info = NodeInfo(
            node_id=self.node_key.node_id,
            network=chain_id,
            moniker=moniker,
            listen_addr=self.transport.listen_addr,
        )
        self.peer_manager = PeerManager(
            self.node_key.node_id, max_connected=max_connections
        )
        for peer in bootstrap_peers or []:
            # PeerAddress.parse raises on malformed entries — a typo'd
            # bootstrap peer must fail startup, not leave a silent seed
            # with an empty address book
            self.peer_manager.add_address(PeerAddress.parse(peer))
        self.router = Router(
            self.node_info,
            self.peer_manager,
            self.transport,
            logger=self.logger,
        )
        self.pex_reactor = PexReactor(self.peer_manager, self.router)
        self._started = False

    @property
    def listen_addr(self) -> str:
        return self.transport.listen_addr

    def start(self) -> None:
        self.router.start()
        self.pex_reactor.start()
        self._started = True
        self.logger.info(
            "seed node started",
            node_id=self.node_key.node_id,
            addr=self.listen_addr,
        )

    def stop(self) -> None:
        if not self._started:
            return
        self.pex_reactor.stop()
        self.router.stop()
        self.transport.close()
        self._started = False

    def connected_peers(self) -> List[str]:
        return list(self.router.connected_peers())

    def known_addresses(self) -> int:
        return self.peer_manager.num_addresses()
