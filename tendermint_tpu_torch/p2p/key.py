"""Node identity (types/node_key.go, types/node_id.go).

A copy of ``tendermint_tpu/p2p/key.py`` over the port's
``crypto/keys.py``. NodeID = hex(first 20 bytes of SHA256(pubkey)): the
address of the node's ed25519 identity key, which authenticates
transport handshakes. The JSON file is the reference's
(``{"priv_key": hex of the 64-byte key}``), so either package reads the
other's.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

from tendermint_tpu_torch.crypto.keys import Ed25519PrivKey, PubKey

NodeID = str  # 40 hex chars


def node_id_from_pubkey(pub: PubKey) -> NodeID:
    return pub.address().hex()


def validate_node_id(node_id: NodeID) -> None:
    if len(node_id) != 40:
        raise ValueError(f"invalid node ID length {len(node_id)}")
    int(node_id, 16)  # raises on non-hex


@dataclass
class NodeKey:
    """types/node_key.go: persistent p2p identity."""

    priv_key: Ed25519PrivKey

    @property
    def node_id(self) -> NodeID:
        return node_id_from_pubkey(self.priv_key.pub_key())

    @property
    def pub_key(self) -> PubKey:
        return self.priv_key.pub_key()

    @classmethod
    def generate(cls) -> "NodeKey":
        return cls(Ed25519PrivKey.generate())

    @classmethod
    def load_or_gen(cls, path: str) -> "NodeKey":
        if os.path.exists(path):
            with open(path) as f:
                doc = json.load(f)
            return cls(Ed25519PrivKey(bytes.fromhex(doc["priv_key"])))
        nk = cls.generate()
        with open(path, "w") as f:
            json.dump({"priv_key": nk.priv_key.bytes().hex()}, f)
        return nk
