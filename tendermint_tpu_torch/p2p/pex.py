"""PEX (peer exchange) reactor: channel 0x00 (internal/p2p/pex/reactor.go).

A copy of ``tendermint_tpu/p2p/pex.py``.

Periodically asks connected peers for addresses and feeds responses into
the peer manager's address book. Wire: tag byte + JSON address list.
"""

from __future__ import annotations

import json
import threading

from tendermint_tpu_torch.p2p.peermanager import PeerAddress, PeerManager
from tendermint_tpu_torch.p2p.router import Channel, Envelope, Router

PEX_CHANNEL = 0x00

TAG_PEX_REQUEST = 1
TAG_PEX_RESPONSE = 2

REQUEST_INTERVAL = 2.0
MAX_ADDRESSES = 100


class PexReactor:
    def __init__(self, peer_manager: PeerManager, router: Router):
        self.peer_manager = peer_manager
        self.channel = router.open_channel(PEX_CHANNEL)
        self._stop_flag = threading.Event()
        self._threads = []

    def start(self) -> None:
        self._stop_flag.clear()
        for fn in (self._recv_loop, self._request_loop):
            t = threading.Thread(target=fn, daemon=True)
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        self._stop_flag.set()
        for t in self._threads:
            t.join(timeout=2)
        self._threads.clear()

    def _request_loop(self) -> None:
        while not self._stop_flag.is_set():
            self.channel.broadcast(bytes([TAG_PEX_REQUEST]))
            self._stop_flag.wait(REQUEST_INTERVAL)

    def _recv_loop(self) -> None:
        while not self._stop_flag.is_set():
            env = self.channel.receive(timeout=0.2)
            if env is None:
                continue
            try:
                self._handle(env)
            except Exception:
                pass

    def _handle(self, env: Envelope) -> None:
        tag = env.message[0]
        if tag == TAG_PEX_REQUEST:
            addresses = [
                str(a) for a in self.peer_manager.sample_addresses(MAX_ADDRESSES)
            ]
            self.channel.send(
                Envelope(
                    PEX_CHANNEL,
                    bytes([TAG_PEX_RESPONSE]) + json.dumps(addresses).encode(),
                    to_peer=env.from_peer,
                )
            )
        elif tag == TAG_PEX_RESPONSE:
            for s in json.loads(env.message[1:].decode())[:MAX_ADDRESSES]:
                try:
                    self.peer_manager.add_address(PeerAddress.parse(s))
                except ValueError:
                    pass
