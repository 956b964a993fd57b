"""E2E testnet manifests (test/e2e/pkg/manifest.go analog).

A copy of ``tendermint_tpu/e2e/manifest.py``: the same parser, checks
and knobs, so a manifest means the same to either package's runner.

A manifest is a TOML document: one ``[testnet]`` table plus a
``[node.<name>]`` table per node::

    [testnet]
    chain_id = "ci"
    load_tx_per_sec = 5

    [node.validator0]

    [node.validator1]
    perturb = ["kill", "pause"]

    [node.full0]
    mode = "full"
    start_at = 5          # join late (exercises block sync)
    db_backend = "filedb"

Node options mirror the reference manifest knobs that apply here:
mode (validator|full), start_at, db_backend, perturb list
(kill|pause|restart|disconnect — disconnect drives the node's gated
unsafe_disconnect_peers route), proxy_app (kvstore|persistent_kvstore,
or "tcp"/"grpc" for an out-of-process app the runner spawns behind the
matching ABCI transport), and privval ("file", or "remote"/"grpc" for
an out-of-process signer — socket flavor dials the node, grpc flavor
serves and the node dials).
"""

from __future__ import annotations

import tomllib
from dataclasses import dataclass, field
from typing import Dict, List

VALID_MODES = ("validator", "full")
VALID_PERTURBATIONS = ("kill", "pause", "restart", "disconnect")
VALID_PROXY_APPS = ("kvstore", "persistent_kvstore", "tcp", "grpc")


@dataclass
class NodeManifest:
    name: str
    mode: str = "validator"
    start_at: int = 0  # 0 = from genesis
    db_backend: str = "filedb"
    proxy_app: str = "kvstore"
    privval: str = "file"
    perturb: List[str] = field(default_factory=list)
    # State-sync join (late nodes only): snapshot restore + backfill
    # instead of block-syncing the whole gap; the runner resolves the
    # light-client trust anchor from a running node at join time.
    statesync: bool = False
    # Snapshot cadence of this node's app (providers need > 0).
    snapshot_interval: int = 0

    def validate(self) -> None:
        if self.mode not in VALID_MODES:
            raise ValueError(f"node {self.name}: invalid mode {self.mode!r}")
        for p in self.perturb:
            if p not in VALID_PERTURBATIONS:
                raise ValueError(
                    f"node {self.name}: invalid perturbation {p!r} "
                    f"(valid: {VALID_PERTURBATIONS})"
                )
        if self.start_at < 0:
            raise ValueError(f"node {self.name}: negative start_at")
        if self.proxy_app not in VALID_PROXY_APPS:
            raise ValueError(
                f"node {self.name}: invalid proxy_app {self.proxy_app!r} "
                f"(valid: {VALID_PROXY_APPS})"
            )
        if self.statesync and self.start_at <= 0:
            raise ValueError(
                f"node {self.name}: statesync requires start_at > 0 "
                "(a running chain to snapshot from)"
            )
        if self.snapshot_interval < 0:
            raise ValueError(f"node {self.name}: negative snapshot_interval")
        if self.privval not in ("file", "remote", "grpc"):
            raise ValueError(
                f"node {self.name}: invalid privval {self.privval!r} "
                "(valid: file | remote | grpc)"
            )


@dataclass
class Manifest:
    chain_id: str = "e2e-net"
    initial_height: int = 1
    load_tx_per_sec: float = 2.0
    wait_heights: int = 6  # heights to advance during the wait stage
    nodes: Dict[str, NodeManifest] = field(default_factory=dict)

    @classmethod
    def parse(cls, text: str) -> "Manifest":
        doc = tomllib.loads(text)
        tn = doc.get("testnet", {})
        m = cls(
            chain_id=tn.get("chain_id", "e2e-net"),
            initial_height=int(tn.get("initial_height", 1)),
            load_tx_per_sec=float(tn.get("load_tx_per_sec", 2.0)),
            wait_heights=int(tn.get("wait_heights", 6)),
        )
        for name, spec in doc.get("node", {}).items():
            nm = NodeManifest(name=name)
            for key in (
                "mode",
                "start_at",
                "db_backend",
                "proxy_app",
                "privval",
                "perturb",
                "statesync",
                "snapshot_interval",
            ):
                if key in spec:
                    setattr(nm, key, spec[key])
            nm.validate()
            m.nodes[name] = nm
        if not m.nodes:
            raise ValueError("manifest has no nodes")
        if not any(n.mode == "validator" for n in m.nodes.values()):
            raise ValueError("manifest needs at least one validator")
        if any(n.statesync for n in m.nodes.values()) and not any(
            n.snapshot_interval > 0 for n in m.nodes.values()
        ):
            raise ValueError(
                "a statesync node requires some node with "
                "snapshot_interval > 0 (nothing would serve snapshots)"
            )
        return m

    @classmethod
    def load(cls, path: str) -> "Manifest":
        with open(path, "rb") as fh:
            return cls.parse(fh.read().decode())
