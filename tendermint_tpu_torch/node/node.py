"""Node: the container that wires every component.

A copy of ``tendermint_tpu/node/node.py``, cut to what the port serves.
It mirrors node/node.go makeNode (node.go:121-400) and its OnStart order
(node.go:403-519): stores -> genesis/state -> ABCI client -> mempool /
evidence -> executor -> (restart: the ABCI handshake) -> consensus ->
router + reactors -> (state sync) -> block sync until caught up, then
consensus. ``device=`` goes to the ``BlockExecutor``, the
``BlockSyncer``, the ``StateSyncer`` and the ``EvidencePool``; as every
entry point of the port, it defaults to
:data:`tendermint_tpu_torch.DEFAULT_DEVICE` (the card).

The stores (state, blocks, evidence, the kv index) open through
``storage.open_db`` with ``db_backend`` (``memdb``, or ``filedb``,
``filedb-c``, ``filedb-py`` under ``home/data``, the SQL sink's file
beside them). A node whose state store holds a state restarts from it:
the ``Handshaker`` (``consensus/replay.py``) replays the stored blocks
into the app. Every node serves state sync (``statesync/``); a fresh
one with ``statesync`` on restores a snapshot first. The validator may
sign through a remote signer: ``priv_validator_laddr`` ``tcp://`` or
``unix://`` (the node listens, ``privval/remote.py``) or ``grpc://``
(the node dials, ``privval/grpc.py``). The app may run in another
process behind the socket or gRPC client (``abci/``).

The node publishes onto an event bus (``eventbus.py``): the consensus
state machine's round events, and for every applied block
(:meth:`Node._fire_events`, the executor's ``event_publisher``)
NewBlock, NewBlockHeader, one Tx event a tx and the validator-set
updates. With ``tx_index`` (the default) the block is first indexed, in
the same call, by the configured sinks (``indexer/sink.py``: ``kv``,
``null``, ``sql`` over stdlib ``sqlite3`` in memory). With
``rpc_laddr`` the node serves the reference's routes
(``rpc/core.py``, the unsafe set with ``rpc_unsafe``) and websocket
subscriptions over ``rpc/server.py``, on its event loop as the
reference's nodes do. ``verify_remote`` sends the device-worthy batches
to a verifyd, over the shared-memory ingress when it shares the host
(``verify_shm``).

Cut from this node, each refused rather than ignored (ROADMAP §A): the
verify mesh (item 10); the autotuner (item 9). ``config.py`` reads a
node's ``config.toml`` into a :class:`NodeConfig`, and ``python -m
tendermint_tpu_torch start`` builds the node from it.

One divergence, with the reactors' and the syncers': the reference
hides a device error in seven places (four reactors' loops, the block
syncer's thread, the state-sync thread, which block-syncs from genesis
instead, and ``Node.stop``). In the port the first error of
:data:`~tendermint_tpu_torch.consensus.state.DEVICE_ERRORS` that a
reactor or the state sync meets, any error that ends the block syncer's
thread or the consensus receive routine, is kept in :attr:`Node.failed`
(the reference's field, ``node.go:148``) by :meth:`Node._fail`; the
component that met it stops; and :meth:`Node.stop` releases everything
and then raises it. A device error in the restart's handshake (its
re-applied tip verifies the tip's LastCommit) is kept in
:attr:`Node.failed` too, and raised by the constructor once the stores
are closed.
"""

from __future__ import annotations

import os
import sqlite3
import threading
import weakref
import time as _time
from dataclasses import dataclass, field as dc_field
from typing import List, Optional

from tendermint_tpu_torch import eventbus as events_mod
from tendermint_tpu_torch import resolve_device
from tendermint_tpu_torch.abci import types as abci_types
from tendermint_tpu_torch.abci.client import AbciClient
from tendermint_tpu_torch.blocksync.reactor import BlockSyncReactor
from tendermint_tpu_torch.blocksync.syncer import BlockSyncer
from tendermint_tpu_torch.blocksync.pool import BlockPool
from tendermint_tpu_torch.consensus.reactor import ConsensusReactor
from tendermint_tpu_torch.consensus.replay import Handshaker
from tendermint_tpu_torch.consensus.state import DEVICE_ERRORS, ConsensusState
from tendermint_tpu_torch.consensus.wal import WAL, NilWAL
from tendermint_tpu_torch.evidence.pool import EvidencePool
from tendermint_tpu_torch.evidence.reactor import EvidenceReactor
from tendermint_tpu_torch.indexer.kv import KVIndexer
from tendermint_tpu_torch.indexer.sink import KVEventSink, MultiSink, NullEventSink, SQLEventSink
from tendermint_tpu_torch.libs.log import Logger
from tendermint_tpu_torch.libs.metrics import (
    ConsensusMetrics,
    MempoolMetrics,
    OpsMetrics,
    P2PMetrics,
    Registry,
    StateMetrics,
)
from tendermint_tpu_torch.mempool.mempool import MempoolConfig, TxMempool
from tendermint_tpu_torch.mempool.reactor import MempoolReactor
from tendermint_tpu_torch.p2p.key import NodeKey
from tendermint_tpu_torch.p2p.mconn import MConnConfig
from tendermint_tpu_torch.p2p.peermanager import PeerAddress, PeerManager
from tendermint_tpu_torch.p2p.pex import PexReactor
from tendermint_tpu_torch.p2p.router import Router
from tendermint_tpu_torch.p2p.transport import MemoryNetwork, NodeInfo, TCPTransport, Transport
from tendermint_tpu_torch.privval import FilePV
from tendermint_tpu_torch.privval.base import PrivValidator
from tendermint_tpu_torch.rpc.core import Environment
from tendermint_tpu_torch.rpc.server import RPCServer
from tendermint_tpu_torch.state import StateStore, state_from_genesis
from tendermint_tpu_torch.state.execution import BlockExecutor
from tendermint_tpu_torch.statesync import StateSyncConfig, StateSyncReactor, StateSyncer
from tendermint_tpu_torch.statesync.syncer import StateSyncFatalError
from tendermint_tpu_torch.storage import open_db
from tendermint_tpu_torch.storage.blockstore import BlockStore
from tendermint_tpu_torch.types.genesis import GenesisDoc
from tendermint_tpu_torch.types.validator_set import ValidatorSet

# How long a syncing node waits for a peer taller than itself before it
# starts consensus anyway (node.go:626).
BLOCKSYNC_GRACE_S = 2.0


@dataclass
class NodeConfig:
    """config/config.go condensed: the knobs the node assembly needs.

    The reference's fields, less those of the features the port has not
    yet, each with the ROADMAP §A item that brings it: ``mesh_devices``:
    item 10. No field reads an environment variable."""

    home: str = ""
    chain_id: str = ""
    listen_addr: str = "127.0.0.1:0"
    persistent_peers: List[str] = dc_field(default_factory=list)
    mempool: MempoolConfig = dc_field(default_factory=MempoolConfig)
    blocksync: bool = True
    wal_enabled: bool = True
    max_connections: int = 16
    moniker: str = "tpu-node"
    rpc_laddr: str = ""  # "host:port" enables the RPC server ("" = off)
    rpc_unsafe: bool = False  # register unsafe operator routes
    tx_index: bool = True
    # Event sinks (indexer/sink.py): any of "kv", "null", "sql"
    # (reference internal/state/indexer/sink/; all configured sinks
    # receive every block, indexer_service.go).
    tx_index_sinks: List[str] = dc_field(default_factory=lambda: ["kv"])
    # tm-db backend selection (config/db.go:29): "memdb", "filedb",
    # "filedb-c" or "filedb-py". A file backend requires `home` (data
    # lands in <home>/data/*.fdb).
    db_backend: str = "memdb"
    # Remote signer (config PrivValidator.ListenAddr, node/node.go:186):
    # tcp://... or unix://... makes the node listen here for an
    # out-of-process signer; grpc://host:port makes it dial a gRPC signer.
    priv_validator_laddr: str = ""
    # How long node construction waits for the signer.
    signer_connect_timeout: float = 60.0
    # Structured logging level: debug/info/warn/error/none (libs/log).
    log_level: str = "none"
    # Per-peer connection rate limits (config.go P2P SendRate/RecvRate).
    p2p_send_rate: int = 5120000
    p2p_recv_rate: int = 5120000
    # Per-peer send-queue discipline (router.go:216-238).
    p2p_queue_type: str = "fifo"
    # Refuse to join consensus if our key signed a commit within the
    # last N blocks (config.go:961 double-sign-check-height; 0 = off).
    double_sign_check_height: int = 0
    # State sync (config/config.go StateSyncConfig): None disables.
    statesync: Optional[StateSyncConfig] = None
    # Span tracing (libs/tracing.py): "" leaves the tracer as it is,
    # else "off", "ring" or a Chrome-trace JSON path.
    trace: str = ""
    # A verifyd daemon ("host:port") that takes the device-worthy
    # signature batches ("" = local verification), and the tenant this
    # node's traffic is filed under there.
    verify_remote: str = ""
    verify_tenant: str = ""
    # The resident table store (ops/resident.py): "auto" | "on" | "off",
    # "" leaves it as it is.
    resident_tables: str = ""
    # The shared-memory slab-ring transport to a co-located verifyd
    # (verifyd/shm.py): "auto" | "on" | "off", set process-wide; ""
    # leaves the mode as it is, which is "auto" unless set.
    verify_shm: str = ""


class Node:
    def __init__(
        self,
        config: NodeConfig,
        genesis: GenesisDoc,
        app_client: AbciClient,
        priv_validator: Optional[PrivValidator] = None,
        node_key: Optional[NodeKey] = None,
        transport: Optional[Transport] = None,
        memory_network: Optional[MemoryNetwork] = None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.config = config
        self.genesis = genesis
        self.app = app_client

        # --- identity (node.go:85-103) --------------------------------------
        if node_key is None:
            if config.home:
                os.makedirs(config.home, exist_ok=True)
                node_key = NodeKey.load_or_gen(os.path.join(config.home, "node_key.json"))
            else:
                node_key = NodeKey.generate()
        self.node_key = node_key
        # The fatal error of a background routine (module note).
        self.failed: Optional[BaseException] = None
        self._fail_mtx = threading.Lock()
        self._signer_endpoint = None
        self._owned_signer = None  # the gRPC signer client the node closes
        if priv_validator is None and config.priv_validator_laddr.startswith("grpc://"):
            # gRPC remote signer (privval/grpc/client.go): the node dials
            # the signer's server, the inverse of the socket flavor below,
            # with the grace the socket flavor's wait gives.
            from tendermint_tpu_torch.privval.grpc import GrpcSignerClient

            host, _, port = config.priv_validator_laddr[len("grpc://"):].rpartition(":")
            priv_validator = GrpcSignerClient(host or "127.0.0.1", int(port), genesis.chain_id)
            deadline = _time.monotonic() + config.signer_connect_timeout
            while True:
                try:
                    priv_validator.get_pub_key()
                    break
                except (ConnectionError, OSError):
                    if _time.monotonic() >= deadline:
                        raise
                    _time.sleep(0.5)
            self._owned_signer = priv_validator
        if priv_validator is None and config.priv_validator_laddr:
            # Remote signer (node/node.go:186 createPrivval -> signer
            # listener): listen here, wait for the signer to dial in.
            from tendermint_tpu_torch.privval.remote import SignerClient, SignerListenerEndpoint

            self._signer_endpoint = SignerListenerEndpoint(config.priv_validator_laddr, node_priv=None)
            self._signer_endpoint.start()
            # a construction that fails later frees the listener with the
            # half-built node
            weakref.finalize(self, self._signer_endpoint.close)
            self._signer_endpoint.wait_for_connection(config.signer_connect_timeout)
            priv_validator = SignerClient(self._signer_endpoint, genesis.chain_id)
        if priv_validator is None and config.home:
            priv_validator = FilePV.load_or_generate(
                os.path.join(config.home, "priv_validator_key.json"),
                os.path.join(config.home, "priv_validator_state.json"),
            )
        self.priv_validator = priv_validator

        # --- stores + state (node.go:136-156, initDBs) ------------------------
        db_dir = os.path.join(config.home, "data") if config.home else ""
        self._dbs = [open_db(config.db_backend, db_dir, n) for n in ("state", "blockstore")]
        try:
            self._assemble(config, genesis, app_client, transport, memory_network, db_dir)
        except BaseException:
            # a construction that fails frees the stores' files and locks,
            # so that a retry on the same home can open them
            self._close_stores()
            raise

    def _assemble(self, config, genesis, app_client, transport, memory_network, db_dir) -> None:
        """The rest of the construction, over the stores just opened."""
        self.state_store = StateStore(self._dbs[0])
        self.block_store = BlockStore(self._dbs[1])
        stored = self.state_store.load()
        if stored is None:
            self.sm_state = state_from_genesis(genesis)
            app_client.start()
            init = app_client.init_chain(
                abci_types.RequestInitChain(
                    time=genesis.genesis_time,
                    chain_id=genesis.chain_id,
                    consensus_params=genesis.consensus_params,
                    validators=[],
                    app_state_bytes=genesis.app_state,
                    initial_height=genesis.initial_height,
                )
            )
            if init.app_hash:
                self.sm_state.app_hash = init.app_hash
            if init.validators:
                vals = [vu.to_validator() for vu in init.validators]
                self.sm_state.validators = ValidatorSet(vals)
                self.sm_state.next_validators = ValidatorSet(vals)
                self.sm_state.next_validators.increment_proposer_priority(1)
            self.state_store.save(self.sm_state)
        else:
            self.sm_state = stored
            app_client.start()

        # --- event bus + indexer (node.go:158-184) ---------------------------
        # Indexing is synchronous inside _fire_events rather than through a
        # pubsub subscription: subscriptions are bounded queues that drop
        # under backpressure (fine for RPC subscribers, lossy for an
        # index). The reference's indexer subscription is lossless and
        # blocks the publisher for the same reason (indexer_service.go).
        self.event_bus = events_mod.EventBus()
        self.indexer: Optional[KVIndexer] = None
        self.event_sink: Optional[MultiSink] = None
        if config.tx_index:
            sinks = []
            # dedupe after normalizing the alias ("psql" == "sql"): a
            # duplicate must not open the same store twice
            normalized = ["sql" if s == "psql" else s for s in (config.tx_index_sinks or ["kv"])]
            for sink_name in dict.fromkeys(normalized):
                if sink_name == "kv":
                    idx_db = open_db(config.db_backend, db_dir, "tx_index")
                    self._dbs.append(idx_db)
                    self.indexer = KVIndexer(idx_db)
                    sinks.append(KVEventSink(self.indexer))
                elif sink_name == "null":
                    sinks.append(NullEventSink())
                elif sink_name == "sql":
                    # the psql schema over stdlib sqlite3, in a file beside
                    # the stores (in memory for a memdb node without a home)
                    sql_path = ":memory:"
                    if db_dir and config.db_backend != "memdb":
                        os.makedirs(db_dir, exist_ok=True)
                        sql_path = os.path.join(db_dir, "tx_events.sqlite")
                    conn = sqlite3.connect(sql_path, check_same_thread=False)
                    sinks.append(SQLEventSink(conn, genesis.chain_id))
                else:
                    raise ValueError(f"unknown indexer sink {sink_name!r} (kv|null|sql)")
            if sinks:
                self.event_sink = MultiSink(sinks)

        # --- observability (node.go:158-184 metrics, libs/log) ----------------
        from tendermint_tpu_torch import ops as _ops
        from tendermint_tpu_torch.libs import tracing as _tracing
        from tendermint_tpu_torch.ops import introspect as _introspect
        from tendermint_tpu_torch.ops import resident as _resident

        self.metrics_registry = Registry()
        self.logger = Logger(level=config.log_level or "none", moniker=config.moniker)
        consensus_metrics = ConsensusMetrics(self.metrics_registry)
        mempool_metrics = MempoolMetrics(self.metrics_registry)
        self.p2p_metrics = P2PMetrics(self.metrics_registry)
        state_metrics = StateMetrics(self.metrics_registry)
        ops_metrics = OpsMetrics(self.metrics_registry)
        # The process-wide units of the verify path, mirrored into this
        # node's registry (the last node built wins, as in the
        # reference): the health machine, both caches, the resident store,
        # the challenge hash, the byte ledger; and the kernel profiler
        # installed as the tracer's profile sink.
        if config.resident_tables:
            # "auto" follows the device, as the store does unless forced
            _resident.configure(None if config.resident_tables == "auto" else config.resident_tables)
        _ops.bind_metrics(ops_metrics)
        _introspect.install()
        if config.trace:
            _tracing.configure(config.trace)
        _tracing.tracer.set_metrics_observer(
            _tracing.metrics_observer(ops=ops_metrics, consensus=consensus_metrics)
        )
        if config.verify_remote:
            from tendermint_tpu_torch.verifyd import client as _vclient

            _vclient.set_remote_addr(config.verify_remote)
            if config.verify_tenant:
                _vclient.set_remote_tenant(config.verify_tenant)
        # the remote's transport mode, process-wide, so the cached client
        # attaches to the slab ring (or refuses it) accordingly
        if config.verify_shm:
            from tendermint_tpu_torch.verifyd import shm as _vshm

            _vshm.set_shm_mode(config.verify_shm)

        # --- pools + executor (node.go:258-297) ------------------------------
        self.mempool = TxMempool(config.mempool, app_client, metrics=mempool_metrics)
        ev_db = open_db(config.db_backend, db_dir, "evidence")
        self._dbs.append(ev_db)
        self.evidence_pool = EvidencePool(ev_db, self.state_store, self.block_store, device=self.device)
        self.evidence_pool.set_state(self.sm_state)
        self.block_exec = BlockExecutor(
            self.state_store,
            app_client,
            self.block_store,
            mempool=self.mempool,
            evidence_pool=self.evidence_pool,
            event_publisher=self._fire_events,
            metrics=state_metrics,
            device=self.device,
        )

        # --- ABCI handshake (node.go:422 -> replay.go:204-550) ----------------
        # On restart, replay stored blocks into the app until its height
        # matches the store; a tip the state trails goes through
        # apply_block, which verifies its LastCommit on the device.
        self.handshaker: Optional[Handshaker] = None
        if stored is not None:
            self.handshaker = Handshaker(self.state_store, self.block_store, self.block_exec, genesis)
            try:
                self.sm_state = self.handshaker.handshake(app_client, self.sm_state)
            except DEVICE_ERRORS as exc:
                self._fail(exc)
                raise
            self.evidence_pool.set_state(self.sm_state)

        # --- p2p (node.go:206-256) -------------------------------------------
        if transport is None:
            if memory_network is not None:
                transport = memory_network.transport(config.listen_addr)
            else:
                transport = TCPTransport(
                    self.node_key,
                    mconn_config=MConnConfig(send_rate=config.p2p_send_rate, recv_rate=config.p2p_recv_rate),
                )
                transport.listen(config.listen_addr)
        self.transport = transport
        self.node_info = NodeInfo(
            node_id=self.node_key.node_id,
            network=genesis.chain_id,
            moniker=config.moniker,
            listen_addr=getattr(transport, "listen_addr", config.listen_addr),
        )
        self.peer_manager = PeerManager(self.node_key.node_id, max_connected=config.max_connections)
        self.router = Router(
            self.node_info,
            self.peer_manager,
            transport,
            metrics=self.p2p_metrics,
            logger=self.logger,
            queue_type=config.p2p_queue_type,
        )

        # --- consensus (node.go:297-325) -------------------------------------
        if config.wal_enabled and config.home:
            wal: WAL = WAL(os.path.join(config.home, "cs.wal"))
        else:
            wal = NilWAL()
        self.consensus = ConsensusState(
            self.sm_state,
            self.block_exec,
            self.block_store,
            priv_validator=self.priv_validator,
            wal=wal,
            metrics=consensus_metrics,
            logger=self.logger,
            double_sign_check_height=config.double_sign_check_height,
        )
        self.consensus.on_error = self._fail
        self.consensus.event_bus = self.event_bus
        self.consensus_reactor = ConsensusReactor(self.consensus, self.router, on_error=self._fail)
        self.mempool_reactor = MempoolReactor(self.mempool, self.router)
        self.evidence_reactor = EvidenceReactor(self.evidence_pool, self.router, on_error=self._fail)

        # --- blocksync (node.go:327-356) -------------------------------------
        self._caught_up_event = threading.Event()
        self.syncer: Optional[BlockSyncer] = None
        if config.blocksync:
            self.syncer = BlockSyncer(
                self.sm_state,
                self.block_exec,
                self.block_store,
                transport=None,
                device=self.device,
                on_caught_up=self._switch_to_consensus,
                on_error=self._fail,
            )
        self.blocksync_reactor = BlockSyncReactor(self.syncer, self.block_store, self.router, on_error=self._fail)
        self.pex_reactor = PexReactor(self.peer_manager, self.router)

        # --- statesync (node.go:358-388) -------------------------------------
        # The reactor always runs (every node serves snapshots and light
        # blocks); the syncer only on a fresh node with statesync on.
        self.statesync_reactor = StateSyncReactor(
            self.router, app_client, self.block_store, self.state_store, on_error=self._fail
        )
        self.statesyncer: Optional[StateSyncer] = None
        self.statesync_error: Optional[BaseException] = None
        if config.statesync is not None and config.statesync.enabled and self.sm_state.last_block_height == 0:
            self.statesyncer = StateSyncer(
                self.statesync_reactor,
                app_client,
                self.state_store,
                self.block_store,
                genesis,
                config.statesync,
                device=self.device,
            )

        # --- RPC (node.go:512, internal/rpc/core) ----------------------------
        self.rpc_server: Optional[RPCServer] = None
        if config.rpc_laddr:
            host, _, port = config.rpc_laddr.rpartition(":")
            self.rpc_env = Environment(
                node_info=self.node_info,
                genesis=self.genesis,
                block_store=self.block_store,
                state_store=self.state_store,
                consensus=self.consensus,
                mempool=self.mempool,
                evidence_pool=self.evidence_pool,
                app_client=self.app,
                event_bus=self.event_bus,
                indexer=self.indexer,
                peer_manager=self.peer_manager,
                get_state=lambda: self.consensus.state,
                is_syncing=lambda: not self._caught_up_event.is_set(),
                consensus_reactor=self.consensus_reactor,
                router=self.router,
                mempool_reactor=self.mempool_reactor,
                unsafe=config.rpc_unsafe,
            )
            self.rpc_server = RPCServer(
                self.rpc_env.routes(),
                host=host or "127.0.0.1",
                port=int(port),
                metrics_registry=self.metrics_registry,
                event_bus=self.event_bus,
            )
        self._started = False

    # --- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        """OnStart ordering (node.go:403-519, :543-573 in the reference)."""
        self.failed = None
        # Double-sign risk check FIRST (state.go:2663 via OnStart:472):
        # the common restart case must fail the whole node start, not a
        # background sync thread later.
        self.consensus.check_double_signing_risk()
        self.router.start()
        self.pex_reactor.start()
        self.evidence_reactor.start()
        self.mempool_reactor.start()
        self.consensus_reactor.start()
        self.statesync_reactor.start()
        self.blocksync_reactor.start(start_syncer=self.statesyncer is None)
        for peer in self.config.persistent_peers:
            self.peer_manager.add_address(PeerAddress.parse(peer), persistent=True)
        if self.statesyncer is not None:
            threading.Thread(target=self._statesync_then_blocksync, daemon=True).start()
        elif self.syncer is None:
            self._switch_to_consensus(self.sm_state)
        else:
            # If there's nothing to sync from within a grace period, start
            # consensus anyway (single node / all peers at same height).
            threading.Thread(target=self._blocksync_grace, daemon=True).start()
        if self.rpc_server is not None:
            self.rpc_server.start()
        self._started = True

    def _statesync_then_blocksync(self) -> None:
        """node.go:358-388: snapshot restore, then block sync from the
        restored height, then consensus. A failure before the restore
        falls back to block sync from the current state; a failure after
        it halts the node's sync (the app holds restored state); a device
        error fails the node (module note)."""
        try:
            state = self.statesyncer.sync()
            self.event_bus.publish_event_state_sync_status(
                events_mod.EventDataStateSyncStatus(complete=True, height=state.last_block_height)
            )
            self.sm_state = state
            self.evidence_pool.set_state(state)
            if self.syncer is not None:
                self.syncer.state = state
                self.syncer.pool = BlockPool(state.last_block_height + 1)
        except DEVICE_ERRORS as exc:
            self.statesync_error = exc
            self._fail(exc)
            return
        except StateSyncFatalError as exc:
            # The app already holds restored state: block-syncing from
            # genesis on top of it would produce wrong app hashes.
            self.statesync_error = exc
            self.event_bus.publish_event_state_sync_status(
                events_mod.EventDataStateSyncStatus(complete=False, height=0)
            )
            self.logger.error("state sync failed fatally; node halted", err=str(exc))
            return
        except Exception as exc:
            # Before the restore (no snapshots, a bad anchor, no peers, a
            # peer's malformed light block): the app is untouched, so a
            # full block sync from the current state is sound.
            self.statesync_error = exc
            self.event_bus.publish_event_state_sync_status(
                events_mod.EventDataStateSyncStatus(complete=False, height=0)
            )
            self.logger.error("state sync failed; falling back to block sync", err=str(exc))
        if self.syncer is None:
            self._switch_to_consensus(self.sm_state)
            return
        self.blocksync_reactor.start_syncing()
        self._blocksync_grace()

    def _blocksync_grace(self) -> None:
        deadline = _time.monotonic() + BLOCKSYNC_GRACE_S
        while _time.monotonic() < deadline:
            if self._caught_up_event.is_set():
                return
            if self.syncer.pool.max_peer_height() > self.block_store.height():
                return  # real sync in progress; on_caught_up will fire
            _time.sleep(0.1)
        if not self._caught_up_event.is_set():
            self._switch_to_consensus(self.syncer.state)

    def _switch_to_consensus(self, state) -> None:
        """blocksync reactor.go:507-529 SwitchToConsensus."""
        if self._caught_up_event.is_set():
            return
        self._caught_up_event.set()
        if self.syncer is not None:
            self.syncer.stop()
            state = self.syncer.state  # adopt the synced state
        if self.syncer is not None or state.last_block_height > self.consensus.state.last_block_height:
            self.consensus._reconstruct_and_update(state)
        self.event_bus.publish_event_block_sync_status(
            events_mod.EventDataBlockSyncStatus(complete=True, height=state.last_block_height)
        )
        try:
            self.consensus.start()
        except Exception as exc:
            # Refusals after a sync (our signatures found in blocks we
            # just synced) happen on a background thread; record them so
            # the operator loop can exit instead of running a zombie
            # node that never joins consensus.
            self._fail(exc)
            self.logger.error("consensus refused to start", err=str(exc))

    def _fail(self, exc: BaseException) -> None:
        """Keep the first fatal error of a background routine."""
        with self._fail_mtx:
            if self.failed is None:
                self.failed = exc
                self.logger.error("node failed", err=repr(exc))

    def stop(self) -> None:
        """Stop every routine and release the router; then raise
        :attr:`failed`, or the error that stopped the consensus receive
        routine (module note)."""
        if self.rpc_server is not None:
            self.rpc_server.stop()
        cs_error: Optional[BaseException] = None
        try:
            self.consensus.stop()
        except BaseException as exc:
            cs_error = exc
        for r in (
            self.blocksync_reactor,
            self.statesync_reactor,
            self.consensus_reactor,
            self.mempool_reactor,
            self.evidence_reactor,
            self.pex_reactor,
        ):
            r.stop()
        self.router.stop()
        if self._signer_endpoint is not None:
            self._signer_endpoint.close()
        if self._owned_signer is not None:
            self._owned_signer.close()
        if self.event_sink is not None:
            self.event_sink.close()
        self._close_stores()
        self._started = False
        if cs_error is not None:
            self._fail(cs_error)
        if self.failed is not None:
            raise self.failed

    def _close_stores(self) -> None:
        dbs, self._dbs = self._dbs, []
        for db in dbs:
            db.close()

    def _fire_events(self, block, block_id, fres, validator_updates) -> None:
        """execution.go:600-648 fireEvents: index the block, then publish
        NewBlock, its header, one event a tx, and the validator-set
        updates onto the bus."""
        if self.event_sink is not None:
            self.event_sink.index_finalized_block(block.header.height, block.data.txs, fres)
        bus = self.event_bus
        bus.publish_event_new_block(
            events_mod.EventDataNewBlock(block=block, block_id=block_id, result_finalize_block=fres)
        )
        bus.publish_event_new_block_header(
            events_mod.EventDataNewBlockHeader(header=block.header, num_txs=len(block.data.txs))
        )
        txs = list(block.data.txs)
        for i, r in enumerate(fres.tx_results):
            if i >= len(txs):
                break
            bus.publish_event_tx(events_mod.EventDataTx(height=block.header.height, index=i, tx=txs[i], result=r))
        if validator_updates:
            bus.publish_event_validator_set_updates(
                events_mod.EventDataValidatorSetUpdates(validator_updates=list(validator_updates))
            )

    # --- convenience ---------------------------------------------------------

    @property
    def caught_up(self) -> bool:
        """Whether the node left block sync for consensus."""
        return self._caught_up_event.is_set()

    @property
    def height(self) -> int:
        return self.block_store.height()

    def submit_tx(self, tx: bytes) -> None:
        """Local tx submission: CheckTx + gossip (the RPC broadcast path)."""
        self.mempool_reactor.check_and_broadcast_tx(tx)
