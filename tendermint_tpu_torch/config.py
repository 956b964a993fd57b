"""Typed node configuration with TOML persistence.

A copy of ``tendermint_tpu/config.py`` over the port's own
``MempoolConfig``, ``StateSyncConfig`` and ``NodeConfig``. The
operator-facing analog of the reference's single Config struct tree
(config/config.go:62-1182) and its TOML template (config/toml.go):
``Config.load``/``save`` round-trip ``<home>/config/config.toml``, and
``to_node_config()`` produces the runtime NodeConfig the node assembly
consumes. Reading uses the stdlib ``tomllib``; writing uses a small
emitter covering the value types the config needs (str/bool/int/float/
str-list).

The file's schema is the JAX package's key for key, so a
``config.toml`` written by either package loads in the other. Where the
JAX package lets an empty value defer to an environment variable
(``base.trace``, ``ops.verify_remote``, ``ops.resident_tables``,
``ops.verify_shm``), the port reads no environment: an empty value keeps
the port's default (the tracer off, local verification, the resident
store's and the shm ingress's ``"auto"``). ``ops.mesh_devices`` stays in
the file, but the port runs on one card until ROADMAP §A item 10:
``to_node_config`` refuses a value above 1 (0 and 1 both mean the one
card).

Sections mirror the reference file: [base] (top-level keys), [p2p],
[rpc], [mempool], [statesync], [privval]. Consensus timeouts are NOT
here — they live on-chain in ConsensusParams (types/params.go:91), which
genesis carries.
"""

from __future__ import annotations

import os
import tomllib
from dataclasses import dataclass, field as dc_field, fields
from typing import List

from tendermint_tpu_torch.mempool.mempool import MempoolConfig
from tendermint_tpu_torch.node.node import NodeConfig
from tendermint_tpu_torch.statesync.syncer import StateSyncConfig

DEFAULT_CONFIG_DIR = "config"
DEFAULT_DATA_DIR = "data"
DEFAULT_CONFIG_FILE = "config.toml"
DEFAULT_GENESIS_FILE = "genesis.json"
DEFAULT_NODE_KEY_FILE = "node_key.json"
DEFAULT_PRIVVAL_KEY_FILE = "priv_validator_key.json"
DEFAULT_PRIVVAL_STATE_FILE = "priv_validator_state.json"


@dataclass
class BaseConfig:
    """config/config.go BaseConfig (condensed)."""

    moniker: str = "tpu-node"
    log_level: str = "info"  # debug/info/warn/error/none
    # "full" runs the complete node; "seed" runs PEX-only address gossip
    # (node/seed.go; reference config Mode).
    mode: str = "full"
    # ABCI application: "kvstore" (in-process), "persistent_kvstore"
    # (filedb-backed, in-process), or "tcp://host:port" for an
    # out-of-process socket app (config.go ProxyApp).
    proxy_app: str = "kvstore"
    db_backend: str = "filedb"
    blocksync: bool = True
    wal_enabled: bool = True
    # Snapshot cadence of the BUILT-IN kvstore apps (state-sync
    # providers); out-of-process apps configure their own.
    app_snapshot_interval: int = 0
    # Verify-pipeline span tracing (libs/tracing): "" keeps the tracer
    # off, "ring" keeps a bounded in-memory ring served at
    # GET /debug/traces, any other value is a Chrome-trace JSON path
    # flushed at process exit.
    trace: str = ""


@dataclass
class P2PConfig:
    """config/config.go P2PConfig (condensed)."""

    laddr: str = "127.0.0.1:26656"
    persistent_peers: List[str] = dc_field(default_factory=list)
    max_connections: int = 16
    send_rate: int = 5120000  # bytes/sec per peer (config.go SendRate)
    recv_rate: int = 5120000
    # Per-peer send-queue discipline: fifo | priority | simple-priority
    # (router.go:216-238 QueueType).
    queue_type: str = "fifo"


@dataclass
class RPCConfig:
    """config/config.go RPCConfig (condensed)."""

    laddr: str = "127.0.0.1:26657"
    # Register unsafe operator routes (config.go Unsafe; routes.go
    # AddUnsafeRoutes): disconnect etc. Off by default.
    unsafe: bool = False


@dataclass
class PrivValidatorConfig:
    """config/config.go PrivValidatorConfig: empty laddr = local FilePV."""

    laddr: str = ""
    connect_timeout: float = 60.0  # wait for the signer to dial in


@dataclass
class ConsensusConfig:
    """config/config.go ConsensusConfig (condensed — timeouts live
    on-chain in ConsensusParams; this holds node-local knobs)."""

    # Refuse to join consensus if our key signed a commit within the
    # last N blocks (config.go:961 DoubleSignCheckHeight; 0 = off).
    double_sign_check_height: int = 0


@dataclass
class OpsConfig:
    """Accelerator operations knobs (no reference analog — the
    reference has no device boundary)."""

    # "host:port" of a verifyd verification daemon: device-worthy
    # signature batches are verified over the wire instead of on the
    # local card. Empty = local verification.
    verify_remote: str = ""
    # Tenant/chain namespace this node's remote verification traffic
    # rides under (multi-tenant verifyd: per-tenant admission budgets,
    # resident-table quotas, metrics). Empty = the default tenant.
    verify_tenant: str = ""
    # Devices the verify engine may span. 0 and 1 both mean the one
    # card; more is refused until the multi-GPU engine (ROADMAP §A
    # item 10).
    mesh_devices: int = 0
    # Device-resident precompute table store (ops/resident.py): "auto"
    # (on for CUDA), "on", or "off". Empty keeps the store's default.
    resident_tables: str = ""
    # Shared-memory slab-ring transport to a co-located verifyd
    # (verifyd/shm.py): "auto" (negotiate when server and node share a
    # host), "on", or "off" (pure TCP). Empty keeps "auto".
    verify_shm: str = ""


@dataclass
class IndexerConfig:
    enabled: bool = True
    # Event sinks: kv | null | sql (reference indexer sink list,
    # config.go TxIndexConfig.Indexer; "sql" is the psql schema over
    # sqlite3 — see indexer/sink.py).
    sinks: List[str] = dc_field(default_factory=lambda: ["kv"])


@dataclass
class Config:
    home: str = ""
    base: BaseConfig = dc_field(default_factory=BaseConfig)
    p2p: P2PConfig = dc_field(default_factory=P2PConfig)
    rpc: RPCConfig = dc_field(default_factory=RPCConfig)
    mempool: MempoolConfig = dc_field(default_factory=MempoolConfig)
    statesync: StateSyncConfig = dc_field(default_factory=StateSyncConfig)
    privval: PrivValidatorConfig = dc_field(default_factory=PrivValidatorConfig)
    consensus: ConsensusConfig = dc_field(default_factory=ConsensusConfig)
    indexer: IndexerConfig = dc_field(default_factory=IndexerConfig)
    ops: OpsConfig = dc_field(default_factory=OpsConfig)

    # --- derived paths ------------------------------------------------------

    def config_dir(self) -> str:
        return os.path.join(self.home, DEFAULT_CONFIG_DIR)

    def data_dir(self) -> str:
        return os.path.join(self.home, DEFAULT_DATA_DIR)

    def config_file(self) -> str:
        return os.path.join(self.config_dir(), DEFAULT_CONFIG_FILE)

    def genesis_file(self) -> str:
        return os.path.join(self.config_dir(), DEFAULT_GENESIS_FILE)

    def node_key_file(self) -> str:
        return os.path.join(self.config_dir(), DEFAULT_NODE_KEY_FILE)

    def privval_key_file(self) -> str:
        return os.path.join(self.config_dir(), DEFAULT_PRIVVAL_KEY_FILE)

    def privval_state_file(self) -> str:
        return os.path.join(self.data_dir(), DEFAULT_PRIVVAL_STATE_FILE)

    # --- conversion ---------------------------------------------------------

    def to_node_config(self, chain_id: str = "") -> NodeConfig:
        if self.ops.mesh_devices > 1:
            raise ValueError(
                f"[ops] mesh_devices = {self.ops.mesh_devices}: the port runs on one card "
                "until the multi-GPU engine (ROADMAP item 10); use 0 or 1"
            )
        return NodeConfig(
            home=self.home,
            chain_id=chain_id,
            listen_addr=self.p2p.laddr,
            persistent_peers=list(self.p2p.persistent_peers),
            mempool=self.mempool,
            blocksync=self.base.blocksync,
            wal_enabled=self.base.wal_enabled,
            max_connections=self.p2p.max_connections,
            moniker=self.base.moniker,
            rpc_laddr=self.rpc.laddr,
            rpc_unsafe=self.rpc.unsafe,
            tx_index=self.indexer.enabled,
            tx_index_sinks=list(self.indexer.sinks),
            db_backend=self.base.db_backend,
            statesync=self.statesync if self.statesync.enabled else None,
            priv_validator_laddr=self.privval.laddr,
            signer_connect_timeout=self.privval.connect_timeout,
            log_level=self.base.log_level,
            p2p_send_rate=self.p2p.send_rate,
            p2p_recv_rate=self.p2p.recv_rate,
            p2p_queue_type=self.p2p.queue_type,
            double_sign_check_height=self.consensus.double_sign_check_height,
            trace=self.base.trace,
            verify_remote=self.ops.verify_remote,
            verify_tenant=self.ops.verify_tenant,
            resident_tables=self.ops.resident_tables,
            verify_shm=self.ops.verify_shm,
        )

    # --- TOML ---------------------------------------------------------------

    _SECTIONS = (
        "base", "p2p", "rpc", "mempool", "statesync", "privval",
        "consensus", "indexer", "ops",
    )

    def to_toml(self) -> str:
        out = [
            "# tendermint_tpu node configuration",
            "# (config/toml.go analog; consensus timeouts live in genesis"
            " consensus_params)",
            "",
        ]
        for section in self._SECTIONS:
            obj = getattr(self, section)
            out.append(f"[{section}]")
            for f in fields(obj):
                out.append(f"{f.name} = {_emit(getattr(obj, f.name))}")
            out.append("")
        return "\n".join(out)

    @classmethod
    def from_toml(cls, text: str, home: str = "") -> "Config":
        doc = tomllib.loads(text)
        cfg = cls(home=home)
        for section in cls._SECTIONS:
            data = doc.get(section)
            if not isinstance(data, dict):
                continue
            obj = getattr(cfg, section)
            for f in fields(obj):
                if f.name in data:
                    value = data[f.name]
                    # bytes fields are emitted as hex (see _emit); key the
                    # reverse conversion on the field's current type, not
                    # its name, so every bytes field round-trips
                    if isinstance(getattr(obj, f.name), bytes) and isinstance(value, str):
                        value = bytes.fromhex(value)
                    setattr(obj, f.name, value)
        return cfg

    def save(self) -> None:
        os.makedirs(self.config_dir(), exist_ok=True)
        with open(self.config_file(), "w") as fh:
            fh.write(self.to_toml())

    @classmethod
    def load(cls, home: str) -> "Config":
        path = os.path.join(home, DEFAULT_CONFIG_DIR, DEFAULT_CONFIG_FILE)
        with open(path, "rb") as fh:
            text = fh.read().decode()
        return cls.from_toml(text, home=home)


def _emit(value) -> str:
    """Emit one TOML value (the subset our config uses)."""
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, (int, float)):
        return repr(value)
    if isinstance(value, bytes):
        return f'"{value.hex()}"'
    if isinstance(value, str):
        escaped = value.replace("\\", "\\\\").replace('"', '\\"')
        return f'"{escaped}"'
    if isinstance(value, (list, tuple)):
        return "[" + ", ".join(_emit(v) for v in value) + "]"
    raise TypeError(f"cannot emit TOML for {type(value).__name__}")
