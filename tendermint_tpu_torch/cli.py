"""Operator command line: ``python -m tendermint_tpu_torch <command>``.

The counterpart of ``tendermint_tpu/cli.py`` (cmd/tendermint, main.go:29-61).
Commands:

  init            scaffold a home dir (config.toml, genesis, keys)
  start           run a node (or a PEX-only seed with mode="seed")
  testnet         generate N localhost validator home dirs
  show-node-id    print the p2p identity
  show-validator  print the validator pubkey JSON
  unsafe-reset-all  wipe chain data, keep keys (reset privval state)
  rollback        roll state back one height (rollback.go)
  inspect         chain state of a STOPPED node (JSON, or --serve RPC)
  replay          re-sync the ABCI app from the block store (Handshaker)
  light           light-client RPC proxy verified from a trust anchor
  lightd          the light-client serving tier
  verifyd         run the shared verification daemon (owns the card)
  debug dump      diagnostic tarball from a RUNNING node
  wal2json        decode a consensus WAL to JSON records
  abci            drive an ABCI socket app (info/echo/query/check-tx)
  compact-db      drop dead filedb records (node stopped)
  key-migrate     re-encode every store into another backend/engine dir
  reindex-event   rebuild the tx/block index from stored blocks
  confix          migrate config.toml to the current schema

Every command takes ``--home`` before the command's name (default
``~/.tendermint_tpu_torch``, so that a port node and a JAX node on one
machine do not share a home unless told to; ``TMHOME`` is not read). A
home is the JAX package's layout byte for byte: either package's
``init`` writes one the other starts.

``start`` and ``replay`` verify on ``--device`` (default CUDA, as every
entry point of the port): it sets :data:`tendermint_tpu_torch.DEFAULT_DEVICE`
before the node is built. Without a card and without ``--device cpu``
they exit 1 with ``resolve_device``'s error; they never move to the CPU
on their own. ``start`` runs until SIGINT or SIGTERM and then exits 0;
an error that fails the node (``Node.failed``, a device error among
them) prints ``error: ...`` and exits 1. Its last line, ``kernel
launches {...}``, counts the process's launches by kernel wrapper.

``verifyd`` serves batched signature verification over gRPC and, for
co-located clients, over the shared-memory ingress (``--shm``). With
``--shard-id``/``--shards`` it serves as one shard of a federation
(``verifyd/federation.py``), and its ``/debug/memstats`` grows the
fleet roll-up. It prints the reference's banner line, then, with
``--metrics``, a line naming the HTTP listener that serves ``/metrics``
and ``/debug/memstats`` (``rpc/server.py``), and runs until SIGTERM or
SIGINT; the flight recorder (``libs/flightrec.py``) is installed after
its signal handlers, so a SIGTERM dumps the ring first. ``verifyd
stats`` prints the fleet roll-up of ``--shards`` (else ``--listen``) and
exits. Left out of the reference's subcommand: ``--mesh``.

``light`` runs a light-client RPC proxy (``light/proxy.py``) and
``lightd`` the serving tier (``light/lightd.py``), both over
``HTTPProvider``s of a full node's RPC (a port or a reference node);
each verifies on ``--device`` (default CUDA), prints the reference's
banner line and runs until SIGTERM or SIGINT. A client that bisects in
rounds rides the shared scheduler, which verifies on the package's
device, so the flag sets that. ``lightd`` serves on the event loop with
``--workers`` handler threads and installs the flight recorder, as the
reference does.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
import sys
import time
from typing import Dict, List, Optional

from tendermint_tpu_torch.config import Config

DEFAULT_HOME = os.path.expanduser("~/.tendermint_tpu_torch")


def _load_cfg(args) -> Config:
    return Config.load(args.home)


def _use_device(args):
    """``--device`` as the package's device, resolved: raises
    ``RuntimeError`` for CUDA on a machine without it."""
    import tendermint_tpu_torch

    if getattr(args, "device", None):
        tendermint_tpu_torch.DEFAULT_DEVICE = args.device
    return tendermint_tpu_torch.resolve_device()


# --- init -------------------------------------------------------------------


def cmd_init(args) -> int:
    """commands/init.go: config + genesis + node key + privval key."""
    from tendermint_tpu_torch.encoding.canonical import Timestamp
    from tendermint_tpu_torch.p2p.key import NodeKey
    from tendermint_tpu_torch.privval import FilePV
    from tendermint_tpu_torch.types.genesis import GenesisDoc, GenesisValidator

    cfg = Config(home=args.home)
    if os.path.exists(cfg.config_file()) and not args.force:
        print(f"found existing config at {cfg.config_file()}", file=sys.stderr)
        return 1
    os.makedirs(cfg.config_dir(), exist_ok=True)
    os.makedirs(cfg.data_dir(), exist_ok=True)
    cfg.save()

    NodeKey.load_or_gen(cfg.node_key_file())
    pv = FilePV.load_or_generate(cfg.privval_key_file(), cfg.privval_state_file())

    if not os.path.exists(cfg.genesis_file()):
        chain_id = args.chain_id or f"test-chain-{os.urandom(3).hex()}"
        doc = GenesisDoc(
            chain_id=chain_id,
            genesis_time=Timestamp.from_unix_ns(time.time_ns()),
            validators=[GenesisValidator(pub_key=pv.get_pub_key(), power=10)],
        )
        doc.save_as(cfg.genesis_file())
    print(f"initialized node home at {args.home}")
    return 0


# --- start ------------------------------------------------------------------


def _make_app_client(cfg: Config):
    """internal/proxy ClientFactory: choose the ABCI transport from the
    proxy_app string (client.go:26-66)."""
    from tendermint_tpu_torch.abci.client import LocalClient
    from tendermint_tpu_torch.abci.kvstore import KVStoreApplication

    spec = cfg.base.proxy_app
    snap = cfg.base.app_snapshot_interval
    if spec == "kvstore":
        return LocalClient(KVStoreApplication(snapshot_interval=snap))
    if spec == "persistent_kvstore":
        from tendermint_tpu_torch.storage import open_db

        os.makedirs(cfg.data_dir(), exist_ok=True)
        return LocalClient(KVStoreApplication(db=open_db("filedb", cfg.data_dir(), "app"), snapshot_interval=snap))
    if spec.startswith("tcp://"):
        from tendermint_tpu_torch.abci.socket_client import SocketClient

        host, _, port = spec[6:].rpartition(":")
        return SocketClient(host or "127.0.0.1", int(port))
    if spec.startswith("grpc://"):
        from tendermint_tpu_torch.abci.grpc_client import GrpcClient

        host, _, port = spec[7:].rpartition(":")
        return GrpcClient(host or "127.0.0.1", int(port))
    raise ValueError(
        f"unknown proxy_app {spec!r} (kvstore | persistent_kvstore | tcp://host:port | grpc://host:port)"
    )


def _build_node(cfg: Config):
    from tendermint_tpu_torch.node import Node
    from tendermint_tpu_torch.p2p.key import NodeKey
    from tendermint_tpu_torch.privval import FilePV
    from tendermint_tpu_torch.types.genesis import GenesisDoc

    genesis = GenesisDoc.from_file(cfg.genesis_file())
    node_cfg = cfg.to_node_config(chain_id=genesis.chain_id)
    node_key = NodeKey.load_or_gen(cfg.node_key_file())
    priv_val = None
    if not cfg.privval.laddr:
        priv_val = FilePV.load_or_generate(cfg.privval_key_file(), cfg.privval_state_file())
    return Node(node_cfg, genesis, _make_app_client(cfg), priv_validator=priv_val, node_key=node_key)


def _run_seed(cfg: Config) -> int:
    """Seed-only mode: PEX address gossip, no chain services."""
    from tendermint_tpu_torch.node.seed import SeedNode
    from tendermint_tpu_torch.types.genesis import GenesisDoc

    genesis = GenesisDoc.from_file(cfg.genesis_file())
    seed = SeedNode(
        home=cfg.config_dir(),
        chain_id=genesis.chain_id,
        listen_addr=cfg.p2p.laddr,
        bootstrap_peers=cfg.p2p.persistent_peers,
        moniker=cfg.base.moniker,
        max_connections=cfg.p2p.max_connections,
        log_level=cfg.base.log_level,
    )
    stop: List[int] = []
    signal.signal(signal.SIGINT, lambda *_: stop.append(1))
    signal.signal(signal.SIGTERM, lambda *_: stop.append(1))
    seed.start()
    print(f"seed {seed.node_key.node_id} started (p2p {seed.listen_addr})", flush=True)
    try:
        while not stop:
            time.sleep(0.2)
    finally:
        seed.stop()
    return 0


def cmd_start(args) -> int:
    """commands/run_node.go: assemble and run until SIGINT/SIGTERM (exit
    0); a failed node prints its error and exits 1."""
    cfg = _load_cfg(args)
    if getattr(args, "trace", ""):
        cfg.base.trace = args.trace
    if cfg.base.mode not in ("full", "seed"):
        print(f"error: [base] mode must be 'full' or 'seed', got {cfg.base.mode!r}", file=sys.stderr)
        return 1
    if cfg.base.mode == "seed":
        return _run_seed(cfg)
    device = _use_device(args)

    def _stop(_sig, _frm):
        # raising interrupts even blocking calls (accept() in the signer
        # wait, handshake replay) instead of waiting for them to finish
        raise KeyboardInterrupt

    signal.signal(signal.SIGINT, _stop)
    signal.signal(signal.SIGTERM, _stop)
    node = None
    rc = 0
    try:
        node = _build_node(cfg)
        node.start()
        verify_banner = ""
        if cfg.ops.verify_remote:
            from tendermint_tpu_torch.verifyd.client import remote_transport

            verify_banner = f", verify {cfg.ops.verify_remote} via {remote_transport() or 'tcp'}"
        print(f"node {node.node_key.node_id} started "
              f"(p2p {cfg.p2p.laddr}, rpc {cfg.rpc.laddr}{verify_banner}, device {device})", flush=True)
        last_height = -1
        while True:
            time.sleep(0.2)
            if node.failed is not None:
                print(f"error: {node.failed}", file=sys.stderr, flush=True)
                rc = 1
                break
            if node.height != last_height:
                last_height = node.height
                print(f"height={last_height}", flush=True)
    except KeyboardInterrupt:
        pass
    finally:
        # a second signal must not abort the shutdown mid-way
        signal.signal(signal.SIGINT, signal.SIG_IGN)
        signal.signal(signal.SIGTERM, signal.SIG_IGN)
        if node is not None:
            try:
                node.stop()  # raises what failed the node
            except Exception as exc:
                if rc == 0:
                    print(f"error: {exc}", file=sys.stderr, flush=True)
                rc = 1
        from tendermint_tpu_torch.crypto.batch import shutdown_shared_scheduler

        shutdown_shared_scheduler()
        if node is not None:
            # the process's kernel launches, by wrapper: /metrics counts
            # dispatches and first launches by engine, not by kernel
            from tendermint_tpu_torch.ops import cuda_hash, cuda_verify

            launches = {**cuda_verify.LAUNCHES, **cuda_hash.LAUNCHES}
            print(f"kernel launches {json.dumps(launches, sort_keys=True)}", flush=True)
    return rc


# --- testnet ----------------------------------------------------------------


def cmd_testnet(args) -> int:
    """commands/testnet.go: N validator home dirs wired as a localhost
    mesh with a shared genesis."""
    from tendermint_tpu_torch.encoding.canonical import Timestamp
    from tendermint_tpu_torch.p2p.key import NodeKey
    from tendermint_tpu_torch.privval import FilePV
    from tendermint_tpu_torch.types.genesis import GenesisDoc, GenesisValidator

    n = args.validators
    homes = [os.path.join(args.output_dir, f"node{i}") for i in range(n)]
    pvs: List = []
    node_keys: List = []
    cfgs: List[Config] = []
    for i, home in enumerate(homes):
        cfg = Config(home=home)
        cfg.base.moniker = f"node{i}"
        cfg.p2p.laddr = f"127.0.0.1:{args.starting_port + 2 * i}"
        cfg.rpc.laddr = f"127.0.0.1:{args.starting_port + 2 * i + 1}"
        os.makedirs(cfg.config_dir(), exist_ok=True)
        os.makedirs(cfg.data_dir(), exist_ok=True)
        node_keys.append(NodeKey.load_or_gen(cfg.node_key_file()))
        pvs.append(FilePV.load_or_generate(cfg.privval_key_file(), cfg.privval_state_file()))
        cfgs.append(cfg)

    chain_id = args.chain_id or f"testnet-{os.urandom(3).hex()}"
    doc = GenesisDoc(
        chain_id=chain_id,
        genesis_time=Timestamp.from_unix_ns(time.time_ns()),
        validators=[GenesisValidator(pub_key=pv.get_pub_key(), power=10) for pv in pvs],
    )
    peers = [f"{node_keys[i].node_id}@{cfgs[i].p2p.laddr}" for i in range(n)]
    for i, cfg in enumerate(cfgs):
        cfg.p2p.persistent_peers = [p for j, p in enumerate(peers) if j != i]
        cfg.save()
        doc.save_as(cfg.genesis_file())
    print(f"wrote {n} node homes under {args.output_dir} (chain {chain_id})")
    return 0


# --- key/identity inspection ------------------------------------------------


def cmd_show_node_id(args) -> int:
    from tendermint_tpu_torch.p2p.key import NodeKey

    cfg = Config(home=args.home)
    print(NodeKey.load_or_gen(cfg.node_key_file()).node_id)
    return 0


def cmd_show_validator(args) -> int:
    import base64

    from tendermint_tpu_torch.privval import FilePV

    cfg = Config(home=args.home)
    pv = FilePV.load(cfg.privval_key_file(), cfg.privval_state_file())
    pub = pv.get_pub_key()
    print(json.dumps({"type": pub.type, "value": base64.b64encode(pub.bytes()).decode()}))
    return 0


# --- data-dir surgery -------------------------------------------------------


def cmd_unsafe_reset_all(args) -> int:
    """commands/reset.go: wipe <home>/data, keep keys, reset sign-state."""
    from tendermint_tpu_torch.privval import FilePV

    cfg = Config(home=args.home)
    if os.path.isdir(cfg.data_dir()):
        shutil.rmtree(cfg.data_dir())
    os.makedirs(cfg.data_dir(), exist_ok=True)
    # fresh privval sign-state (file.go ResetFilePV): without the data dir
    # the old one is gone already; recreate a zeroed state file
    if os.path.exists(cfg.privval_key_file()):
        FilePV.load_or_generate(cfg.privval_key_file(), cfg.privval_state_file())
    print(f"reset chain data in {cfg.data_dir()}")
    return 0


def _open_stores(cfg: Config):
    from tendermint_tpu_torch.state import StateStore
    from tendermint_tpu_torch.storage import open_db
    from tendermint_tpu_torch.storage.blockstore import BlockStore

    db_backend = cfg.base.db_backend
    state_db = open_db(db_backend, cfg.data_dir(), "state")
    block_db = open_db(db_backend, cfg.data_dir(), "blockstore")
    return StateStore(state_db), BlockStore(block_db)


def _close_stores(state_store, block_store) -> None:
    state_store._db.close()
    block_store._db.close()


def cmd_rollback(args) -> int:
    """commands/rollback.go → internal/state/rollback.go."""
    from tendermint_tpu_torch.state.rollback import rollback_state

    cfg = _load_cfg(args)
    state_store, block_store = _open_stores(cfg)
    try:
        height, app_hash = rollback_state(state_store, block_store, hard=args.hard)
    finally:
        _close_stores(state_store, block_store)
    print(f"rolled back state to height {height}, app hash {app_hash.hex()}")
    return 0


def cmd_inspect(args) -> int:
    """commands/inspect.go: read-only view over a STOPPED node's data.
    Default prints a JSON summary; --serve starts the reference's
    inspect RPC server (internal/inspect/inspect.go:31) so operators can
    run block/commit/validators/tx_search queries against the stores
    without booting consensus."""
    cfg = _load_cfg(args)
    if getattr(args, "serve", ""):
        return _inspect_serve(cfg, args.serve)
    state_store, block_store = _open_stores(cfg)
    try:
        state = state_store.load()
        out = {"latest_block_height": block_store.height(), "base_height": block_store.base()}
        if state is not None and not state.is_empty():
            out.update({
                "state_height": state.last_block_height,
                "app_hash": state.app_hash.hex(),
                "chain_id": state.chain_id,
                "validators": [{"address": v.address.hex(), "power": v.voting_power}
                               for v in state.validators.validators],
            })
    finally:
        _close_stores(state_store, block_store)
    print(json.dumps(out, indent=2))
    return 0


# the reference's read-only route set (internal/inspect/rpc)
_INSPECT_ROUTES = (
    "health", "blockchain", "genesis", "genesis_chunked", "block", "block_by_hash", "block_results", "commit",
    "header", "header_by_hash", "validators", "consensus_params", "tx", "tx_search", "block_search",
)


def _inspect_serve(cfg: Config, laddr: str) -> int:
    """Read-only RPC over the stores: the route table is the normal
    Environment's, restricted to handlers that need no live services."""
    from tendermint_tpu_torch.indexer import KVIndexer
    from tendermint_tpu_torch.rpc.core import Environment
    from tendermint_tpu_torch.rpc.server import RPCServer
    from tendermint_tpu_torch.storage import db_exists, open_db
    from tendermint_tpu_torch.types.genesis import GenesisDoc

    genesis = GenesisDoc.from_file(cfg.genesis_file())
    state_store, block_store = _open_stores(cfg)
    idx_db = None
    indexer = None
    if db_exists(cfg.base.db_backend, cfg.data_dir(), "tx_index"):
        idx_db = open_db(cfg.base.db_backend, cfg.data_dir(), "tx_index")
        indexer = KVIndexer(idx_db)
    state = state_store.load()
    env = Environment(genesis=genesis, block_store=block_store, state_store=state_store, indexer=indexer,
                      get_state=lambda: state, is_syncing=lambda: False)
    read_only = {name: fn for name, fn in env.routes().items() if name in _INSPECT_ROUTES}
    host, _, port = laddr.rpartition(":")
    server = RPCServer(read_only, host=host or "127.0.0.1", port=int(port))
    stop: List[int] = []
    signal.signal(signal.SIGINT, lambda *_: stop.append(1))
    signal.signal(signal.SIGTERM, lambda *_: stop.append(1))
    server.start()
    print(f"inspect server on {server.url} (read-only)", flush=True)
    try:
        while not stop:
            time.sleep(0.2)
    finally:
        server.stop()
        _close_stores(state_store, block_store)
        if idx_db is not None:
            idx_db.close()
    return 0


def cmd_replay(args) -> int:
    """commands/replay.go: hand the stored chain back to the app via the
    Handshaker (replay.go:204-550); a re-applied tip verifies on
    ``--device``."""
    from tendermint_tpu_torch.consensus.replay import Handshaker
    from tendermint_tpu_torch.state import state_from_genesis
    from tendermint_tpu_torch.state.execution import BlockExecutor
    from tendermint_tpu_torch.types.genesis import GenesisDoc

    cfg = _load_cfg(args)
    device = _use_device(args)
    genesis = GenesisDoc.from_file(cfg.genesis_file())
    state_store, block_store = _open_stores(cfg)
    try:
        state = state_store.load()
        if state is None or state.is_empty():
            state = state_from_genesis(genesis)
        app = _make_app_client(cfg)
        app.start()
        try:
            block_exec = BlockExecutor(state_store, app, block_store, device=device)
            hs = Handshaker(state_store, block_store, block_exec, genesis)
            hs.handshake(app, state)
        finally:
            app.stop()
    finally:
        _close_stores(state_store, block_store)
    print(f"replayed {hs.n_blocks_replayed} blocks into the app")
    return 0


def cmd_debug_dump(args) -> int:
    """commands/debug/dump.go: collect a diagnostic bundle from a RUNNING
    node — status, consensus dump, net info, metrics — plus the home's
    config and WAL files, into one tar.gz."""
    import io
    import tarfile
    import urllib.request

    from tendermint_tpu_torch.rpc.client import HTTPClient

    client = HTTPClient(args.rpc)
    bundle: Dict[str, bytes] = {}
    for method in ("status", "dump_consensus_state", "consensus_state", "net_info", "num_unconfirmed_txs"):
        try:
            bundle[f"{method}.json"] = json.dumps(client.call(method), indent=2).encode()
        except Exception as e:
            bundle[f"{method}.err"] = str(e).encode()
    try:
        with urllib.request.urlopen(f"{args.rpc.rstrip('/')}/metrics", timeout=5) as resp:
            bundle["metrics.prom"] = resp.read()
    except Exception as e:
        bundle["metrics.err"] = str(e).encode()

    home_files = []
    if args.home and os.path.isdir(args.home):
        cfg = Config(home=args.home)
        home_files = [p for p in (cfg.config_file(), cfg.genesis_file()) if os.path.exists(p)]
        wal_dir = os.path.dirname(os.path.join(args.home, "cs.wal"))
        if os.path.isdir(wal_dir):
            home_files += [os.path.join(wal_dir, n) for n in sorted(os.listdir(wal_dir)) if n.startswith("cs.wal")]

    out_path = args.output
    with tarfile.open(out_path, "w:gz") as tar:
        for name, data in sorted(bundle.items()):
            info = tarfile.TarInfo(f"dump/{name}")
            info.size = len(data)
            tar.addfile(info, io.BytesIO(data))
        for path in home_files:
            tar.add(path, arcname=f"dump/home/{os.path.basename(path)}")
    print(f"wrote debug dump to {out_path} ({len(bundle)} rpc docs, {len(home_files)} home files)")
    return 0


def cmd_confix(args) -> int:
    """internal/libs/confix analog: migrate a config.toml written by an
    older version to the current schema — keys the current schema lacks
    are dropped, missing keys gain defaults, known keys keep their
    values. Prints a report; --dry-run skips the rewrite."""
    import tomllib

    cfg_path = Config(home=args.home).config_file()
    with open(cfg_path, "rb") as fh:
        old_doc = tomllib.load(fh)
    cfg = Config.load(args.home)  # tolerant load: unknown keys ignored
    new_doc = tomllib.loads(cfg.to_toml())

    def _keys(doc):
        out = set()
        for section, table in doc.items():
            if isinstance(table, dict):
                out.update(f"{section}.{k}" for k in table)
            else:
                out.add(section)
        return out

    old_keys, new_keys = _keys(old_doc), _keys(new_doc)
    dropped = sorted(old_keys - new_keys)
    added = sorted(new_keys - old_keys)
    for key in dropped:
        print(f"  - {key} (unknown to this version; dropped)")
    for key in added:
        print(f"  + {key} (new; default applied)")
    if not dropped and not added:
        print("config already matches the current schema")
        return 0
    if getattr(args, "dry_run", False):
        print("dry run: config not rewritten")
        return 0
    backup = cfg_path + ".bak"
    shutil.copyfile(cfg_path, backup)
    cfg.save()
    print(f"rewrote {cfg_path} (backup at {backup})")
    return 0


def cmd_reindex_event(args) -> int:
    """commands/reindex_event.go analog: rebuild the tx/block event index
    from stored blocks plus the persisted FinalizeBlock responses —
    recovers search after enabling tx_index late or losing the index db.
    Run on a STOPPED node."""
    import sqlite3

    from tendermint_tpu_torch.indexer import KVIndexer
    from tendermint_tpu_torch.indexer.sink import KVEventSink, MultiSink, SQLEventSink
    from tendermint_tpu_torch.storage import db_exists, open_db

    cfg = _load_cfg(args)
    if db_exists(cfg.base.db_backend, cfg.data_dir(), "tx_index"):
        # Rebuild from scratch: merging into a stale index would keep
        # phantom records for blocks discarded by rollback. The probe
        # open proves no node holds the db before we delete it.
        open_db(cfg.base.db_backend, cfg.data_dir(), "tx_index").close()
        for f in os.listdir(cfg.data_dir()):
            if f.startswith("tx_index"):
                os.unlink(os.path.join(cfg.data_dir(), f))
    state_store, block_store = _open_stores(cfg)
    # Rebuild EVERY configured sink, not just kv — the live node and the
    # offline rebuild share the sink entry point so they cannot diverge.
    sink_names = ["sql" if s == "psql" else s for s in (cfg.indexer.sinks or ["kv"])]
    sinks = []
    idx_db = None
    try:
        if "kv" in sink_names:
            idx_db = open_db(cfg.base.db_backend, cfg.data_dir(), "tx_index")
            sinks.append(KVEventSink(KVIndexer(idx_db)))
        if "sql" in sink_names:
            sql_path = os.path.join(cfg.data_dir(), "tx_events.sqlite")
            if os.path.exists(sql_path):
                os.unlink(sql_path)  # rebuild from scratch, as with kv
            chain_id = ""
            try:
                from tendermint_tpu_torch.types.genesis import GenesisDoc

                chain_id = GenesisDoc.from_file(cfg.genesis_file()).chain_id
            except Exception:
                pass
            sinks.append(SQLEventSink(sqlite3.connect(sql_path), chain_id or "unknown"))
        sink = MultiSink(sinks)
        base = max(block_store.base(), 1)
        indexed_blocks = indexed_txs = skipped = 0
        for h in range(base, block_store.height() + 1):
            block = block_store.load_block(h)
            fres = state_store.load_decoded_finalize_block_response(h)
            if block is None or fres is None:
                skipped += 1
                continue
            # same single entry point the live node writes through, so the
            # rebuilt index is byte-identical to what the node would produce
            sink.index_finalized_block(h, block.data.txs, fres)
            indexed_blocks += 1
            indexed_txs += min(len(fres.tx_results), len(block.data.txs))
        sink.close()
    finally:
        if idx_db is not None:
            idx_db.close()
        _close_stores(state_store, block_store)
    print(f"reindexed {indexed_blocks} blocks, {indexed_txs} txs "
          f"({skipped} heights skipped: block or responses pruned)")
    return 0


def _fdb_names(data: str) -> List[str]:
    if not os.path.isdir(data):
        raise FileNotFoundError(data)
    return sorted(f[: -len(".fdb")] for f in os.listdir(data) if f.endswith(".fdb"))


def cmd_key_migrate(args) -> int:
    """scripts/keymigrate (cmd/tendermint/main.go:29-61 key-migrate):
    re-encode every store into a (possibly different) backend — the
    file engines, the C++ one or the Python one. Run on a STOPPED
    node."""
    from tendermint_tpu_torch.storage import open_db

    data = Config(home=args.home).data_dir()
    names = _fdb_names(data)
    if not names:
        print(f"no databases to migrate in {data}")
        return 0
    out_dir = args.out or (data.rstrip(os.sep) + "-migrated")
    if os.path.abspath(out_dir) == os.path.abspath(data):
        print("error: --out must differ from the data dir", file=sys.stderr)
        return 1
    if os.path.isdir(out_dir) and os.listdir(out_dir):
        # Merging into a stale snapshot would silently keep records the
        # source has since deleted — a corrupt "migration".
        print(f"error: output dir {out_dir} is not empty; remove it or pass a fresh --out", file=sys.stderr)
        return 1
    os.makedirs(out_dir, exist_ok=True)
    for name in names:
        src = open_db("filedb", data, name)
        dst = open_db(args.to_backend, out_dir, name)
        n = 0
        batch = dst.new_batch()
        for k, v in src.iterator():
            batch.set(k, v)
            n += 1
            if n % 10000 == 0:
                batch.write()
                batch = dst.new_batch()
        batch.write()
        src.close()
        dst.close()
        print(f"{name}: migrated {n} keys -> {args.to_backend} in {out_dir}")
    return 0


def cmd_compact_db(args) -> int:
    """commands/compact.go analog: rewrite every filedb in <home>/data
    dropping dead (overwritten/deleted) records. Run on a STOPPED node."""
    from tendermint_tpu_torch.storage import open_db

    data = Config(home=args.home).data_dir()
    names = _fdb_names(data)
    if not names:
        print(f"no filedb databases in {data}")
        return 0
    for name in names:
        path = os.path.join(data, name + ".fdb")
        before = os.path.getsize(path)
        db = open_db("filedb", data, name)
        db.compact()
        db.close()
        after = os.path.getsize(path)
        print(f"{name}.fdb: {before} -> {after} bytes ({(1 - after / before) * 100 if before else 0:.0f}% reclaimed)")
    return 0


def cmd_wal2json(args) -> int:
    """scripts/wal2json analog: decode a consensus WAL (all rotated
    chunks) to one JSON document per record on stdout."""
    import dataclasses

    from tendermint_tpu_torch.consensus import wal as walmod

    if not os.path.exists(args.wal):
        # an empty group and a typo'd path look identical to the reader;
        # distinguish them here (main() maps this to a clean error)
        raise FileNotFoundError(args.wal)
    for offset, msg in walmod.WAL(args.wal).iter_messages():
        doc: Dict[str, object] = {"offset": offset, "type": type(msg).__name__}
        if dataclasses.is_dataclass(msg):
            for f in dataclasses.fields(msg):
                v = getattr(msg, f.name)
                if isinstance(v, bytes):
                    v = v.hex()
                elif dataclasses.is_dataclass(v) or hasattr(v, "__dict__"):
                    v = repr(v)
                doc[f.name] = v
        else:
            doc["repr"] = repr(msg)
        print(json.dumps(doc, default=repr))
    return 0


def cmd_abci(args) -> int:
    """abci/cmd/abci-cli analog: drive an ABCI socket app manually."""
    import base64

    from tendermint_tpu_torch.abci import types as abci
    from tendermint_tpu_torch.abci.socket_client import SocketClient

    host, _, port = args.addr.replace("tcp://", "").rpartition(":")
    client = SocketClient(host or "127.0.0.1", int(port))
    client.start()
    try:
        if args.abci_cmd == "info":
            r = client.info(abci.RequestInfo())
            print(json.dumps({"data": r.data, "version": r.version, "app_version": r.app_version,
                              "last_block_height": r.last_block_height,
                              "last_block_app_hash": r.last_block_app_hash.hex()}))
        elif args.abci_cmd == "echo":
            print(client.echo(args.message))
        elif args.abci_cmd == "query":
            r = client.query(abci.RequestQuery(data=args.data.encode(), path=args.path or ""))
            print(json.dumps({"code": r.code, "key": base64.b64encode(r.key).decode(),
                              "value": base64.b64encode(r.value).decode(), "log": r.log, "height": r.height}))
        elif args.abci_cmd == "check-tx":
            r = client.check_tx(abci.RequestCheckTx(tx=args.tx.encode(), type=abci.CHECK_TX_TYPE_NEW))
            print(json.dumps({"code": r.code, "codespace": r.codespace}))
    finally:
        client.stop()
    return 0


# --- verifyd, light, lightd -------------------------------------------------


def _verifyd_stats(args) -> int:
    """``verifyd stats``: poll every shard's STATS_PATH snapshot and print
    the fleet roll-up: a row a shard and the owner-wise aggregate, under
    the ledger's owner labels."""
    from tendermint_tpu_torch.verifyd.federation import FederationClient

    shards = [a.strip() for a in (args.shards or "").split(",") if a.strip()]
    if not shards:
        shards = [args.listen]
    fed = FederationClient(shards)
    try:
        rows = fed.memstats_rows(timeout=2.0)
        if not rows:
            print("verifyd stats: no shard reachable", flush=True)
            return 1
        print(f"{'shard':<8} {'addr':<22} {'served':>8} {'misroute':>9} "
              f"{'pinned':>7} {'host_B':>10} {'device_B':>10}")
        agg_owner: dict = {}
        agg = {"served": 0, "misroutes": 0, "pinned": 0, "host": 0}
        for label in sorted(rows):
            row = rows[label]
            dev = row.get("device_bytes") or {}
            dev_total = sum(int(v) for v in dev.values())
            for owner, n in dev.items():
                agg_owner[owner] = agg_owner.get(owner, 0) + int(n)
            served = int(row.get("requests_served", 0))
            mis = int(row.get("misroutes", 0))
            pinned = int(row.get("pinned_keys", 0))
            host_b = int(row.get("host_staged_bytes", 0))
            agg["served"] += served
            agg["misroutes"] += mis
            agg["pinned"] += pinned
            agg["host"] += host_b
            print(f"{label:<8} {row.get('addr', ''):<22} {served:>8} "
                  f"{mis:>9} {pinned:>7} {host_b:>10} {dev_total:>10}")
        print(f"{'fleet':<8} {'(aggregate)':<22} {agg['served']:>8} "
              f"{agg['misroutes']:>9} {agg['pinned']:>7} {agg['host']:>10} "
              f"{sum(agg_owner.values()):>10}")
        for owner in sorted(agg_owner):
            print(f"  {owner}: {agg_owner[owner]} bytes (fleet)")
        tenants = fed.fleet_tenants()
        for label in sorted(tenants):
            ts = tenants[label]
            print(f"  tenant {label}: p99={ts['p99_ms']}ms "
                  f"slo={ts['slo_ms'] or 'none'} "
                  f"slo_sheds={ts['slo_sheds']} lanes={ts['lanes']}")
        sys.stdout.flush()
        return 0
    finally:
        fed.close()


def cmd_verifyd(args) -> int:
    """Run the verification service until SIGTERM or SIGINT, or, with
    the ``stats`` action, print the fleet roll-up."""
    from tendermint_tpu_torch.libs import flightrec, tracing
    from tendermint_tpu_torch.libs.metrics import EvloopMetrics, Registry, VerifydMetrics
    from tendermint_tpu_torch.ops import introspect
    from tendermint_tpu_torch.verifyd.server import VerifydServer

    if args.action == "stats":
        return _verifyd_stats(args)
    if args.trace:
        tracing.configure(args.trace)
    tenant_slos = {}
    for spec in args.tenant_slo:
        name, sep, ms = spec.partition("=")
        if not sep or not name or not ms.isdigit():
            print(f"bad --tenant-slo {spec!r} (want TENANT=MS)", flush=True)
            return 2
        tenant_slos[name] = int(ms)
    host, _, port = args.listen.rpartition(":")
    reg = Registry()
    server = VerifydServer(
        host=host or "127.0.0.1",
        port=int(port),
        max_batch=args.max_batch,
        max_delay=args.max_delay,
        admission_cap=args.admission_cap,
        max_pending=args.max_pending,
        continuous=args.continuous == "on",
        pipeline_depth=args.pipeline_depth,
        tenant_cap=args.tenant_cap,
        tenant_pin_quota=args.tenant_pin_quota,
        max_tenants=args.max_tenants,
        metrics=VerifydMetrics(reg),
        evloop_metrics=EvloopMetrics(reg),
        shm=args.shm,
        dyn_batch=args.dyn_batch == "on",
        tenant_slos=tenant_slos,
        shard_id=args.shard_id,
        device=args.device,
    )
    metrics_server = None
    if args.metrics:
        from tendermint_tpu_torch.rpc.server import RPCServer

        mhost, _, mport = args.metrics.rpartition(":")
        metrics_server = RPCServer({}, host=mhost or "127.0.0.1", port=int(mport), metrics_registry=reg)
    stop: List[int] = []
    signal.signal(signal.SIGINT, lambda *_: stop.append(1))
    signal.signal(signal.SIGTERM, lambda *_: stop.append(1))
    # installed after the daemon's own handlers, so a SIGTERM dumps the
    # flight recorder's ring first and then chains into the stop
    flightrec.install()
    # the kernel profiler and the device-byte ledger answer
    # GET /debug/memstats on the metrics listener
    introspect.install()
    introspect.set_shard_identity(args.shard_id)
    # a federated daemon's memstats grow a fleet section: each shard's
    # ledger rows polled from the shard list, cached for 2 s so polling
    # memstats is not a gossip storm
    fleet_fed = None
    if args.shards:
        from tendermint_tpu_torch.verifyd.federation import FederationClient

        fleet_fed = FederationClient([a.strip() for a in args.shards.split(",") if a.strip()])
        fleet_cache = {"t": -10.0, "rows": {}}

        def _fleet_rows():
            now = time.monotonic()
            if now - fleet_cache["t"] >= 2.0:
                fleet_cache["t"] = now
                fleet_cache["rows"] = fleet_fed.memstats_rows(timeout=1.0)
            return fleet_cache["rows"]

        introspect.set_fleet_provider(_fleet_rows)
    server.start()
    if metrics_server is not None:
        metrics_server.start()
    try:
        shost, sport = server.address
        knobs = server.stats().get("scheduler") or {}
        print(
            f"verifyd serving on {shost}:{sport} "
            f"(max_batch={knobs.get('max_batch', server.max_batch)}, "
            f"max_delay={knobs.get('max_delay', args.max_delay)}s, "
            f"admission_cap={args.admission_cap}, "
            f"continuous={server.scheduler.continuous}, "
            f"pipeline_depth={knobs.get('pipeline_depth', args.pipeline_depth)}, "
            f"dyn_batch={'on' if server.dyn_batch else 'off'}, "
            f"tenant_slos={sorted(tenant_slos) if tenant_slos else 'none'}, "
            f"tenant_cap={args.tenant_cap}, "
            f"shm={server.shm_socket_path or 'off'}, "
            f"shard={args.shard_id if args.shard_id >= 0 else 'standalone'}"
            f"{'/' + str(len(args.shards.split(','))) if args.shards else ''})",
            flush=True,
        )
        if metrics_server is not None:
            mh, mp = metrics_server.address
            print(f"verifyd metrics on {mh}:{mp} (device={server.device})", flush=True)
        while not stop:
            time.sleep(0.1)
    finally:
        if metrics_server is not None:
            metrics_server.stop()
        server.stop()
        if fleet_fed is not None:
            introspect.set_fleet_provider(None)
            fleet_fed.close()
        introspect.set_shard_identity(-1)
        introspect.uninstall()
    return 0


def _light_client(args, metrics=None, retrying=False):
    """The ``LightClient`` of ``light`` and ``lightd`` over
    ``HTTPProvider``s, on ``--device``."""
    import tendermint_tpu_torch
    from tendermint_tpu_torch.light.client import LightClient, TrustOptions
    from tendermint_tpu_torch.light.provider import HTTPProvider, RetryingProvider

    if args.device:
        tendermint_tpu_torch.DEFAULT_DEVICE = args.device

    def provider(url):
        p = HTTPProvider(args.chain_id, url)
        return RetryingProvider(p) if retrying else p

    return LightClient(
        chain_id=args.chain_id,
        trust_options=TrustOptions(
            period=args.trust_period, height=args.trust_height, hash=bytes.fromhex(args.trust_hash)
        ),
        primary=provider(args.primary),
        witnesses=[provider(w) for w in (args.witness or [])],
        sequential=getattr(args, "sequential", False),
        metrics=metrics,
    )


def _serve_until_signalled(server, banner: str, flight: bool = False) -> int:
    stop: List[int] = []
    signal.signal(signal.SIGINT, lambda *_: stop.append(1))
    signal.signal(signal.SIGTERM, lambda *_: stop.append(1))
    if flight:
        # after the handlers above: a SIGTERM dumps the ring, then stops
        from tendermint_tpu_torch.libs import flightrec

        flightrec.install()
    server.start()
    print(banner.format(url=server.url), flush=True)
    try:
        while not stop:
            time.sleep(0.2)
    finally:
        server.stop()
    return 0


def cmd_light(args) -> int:
    """commands/light.go: run a light-client RPC proxy verified against a
    primary full node with optional witnesses."""
    from tendermint_tpu_torch.light.proxy import LightProxy

    proxy = LightProxy(_light_client(args), args.primary, laddr=args.laddr)
    return _serve_until_signalled(proxy, f"light proxy for {args.chain_id} on {{url}}")


def cmd_lightd(args) -> int:
    """Run the light-client serving tier (light/lightd.py): a LightClient
    with a verified-header cache, serving ``light_header`` and
    ``light_status``; the Prometheus registry (cache traffic, serve
    latency) is exposed on the same listener at GET /metrics."""
    from tendermint_tpu_torch.libs import tracing
    from tendermint_tpu_torch.libs.metrics import EvloopMetrics, LightMetrics, Registry
    from tendermint_tpu_torch.light.lightd import LightServer

    if args.trace:
        tracing.configure(args.trace)
    reg = Registry()
    light_metrics = LightMetrics(reg)
    client = _light_client(args, metrics=light_metrics, retrying=True)
    host, _, port = args.listen.rpartition(":")
    server = LightServer(client, host=host or "127.0.0.1", port=int(port or 0),
                         cache_capacity=args.cache_capacity, metrics=light_metrics, registry=reg,
                         evloop_metrics=EvloopMetrics(reg), workers=args.workers)
    return _serve_until_signalled(
        server, f"lightd for {args.chain_id} on {{url}} (cache_capacity={args.cache_capacity})",
        flight=True,
    )


def _add_trust_arguments(p) -> None:
    p.add_argument("primary", help="primary full node RPC url")
    p.add_argument("--chain-id", required=True)
    p.add_argument("--trust-height", type=int, required=True)
    p.add_argument("--trust-hash", required=True, help="hex header hash")
    p.add_argument("--trust-period", type=float, default=14 * 86400.0)
    p.add_argument("--witness", action="append", default=[])
    _add_device_argument(p, "the verifications")


def _add_device_argument(p, what: str) -> None:
    p.add_argument("--device", default=None, help=f"device {what} run on: cuda (the default) or cpu")


def _add_node_parsers(sub) -> None:
    """The node commands and the stopped-home tools (the reference's
    parsers, ``--device`` added where the card verifies)."""
    p = sub.add_parser("init", help="scaffold config/genesis/keys")
    p.add_argument("--chain-id", default="")
    p.add_argument("--force", action="store_true")
    p.set_defaults(fn=cmd_init)

    p = sub.add_parser("start", help="run the node")
    p.add_argument("--trace", default="",
                   help="span tracing: off | ring (serve at /debug/traces) | "
                   "<path> (write Chrome-trace JSON at exit); overrides the config")
    _add_device_argument(p, "the node's verifications")
    p.set_defaults(fn=cmd_start)

    p = sub.add_parser("testnet", help="generate localhost testnet homes")
    p.add_argument("--validators", "-v", type=int, default=4)
    p.add_argument("--output-dir", "-o", default="./testnet")
    p.add_argument("--chain-id", default="")
    p.add_argument("--starting-port", type=int, default=26656)
    p.set_defaults(fn=cmd_testnet)

    sub.add_parser("show-node-id", help="print p2p identity").set_defaults(fn=cmd_show_node_id)
    sub.add_parser("show-validator", help="print validator pubkey").set_defaults(fn=cmd_show_validator)
    sub.add_parser("unsafe-reset-all", help="wipe chain data, keep keys").set_defaults(fn=cmd_unsafe_reset_all)

    p = sub.add_parser("rollback", help="roll state back one height")
    p.add_argument("--hard", action="store_true", help="also delete the block")
    p.set_defaults(fn=cmd_rollback)

    p = sub.add_parser("inspect", help="dump stored chain state (node stopped)")
    p.add_argument("--serve", default="", metavar="HOST:PORT",
                   help="serve a read-only RPC over the stores instead of printing")
    p.set_defaults(fn=cmd_inspect)

    p = sub.add_parser("replay", help="replay stored blocks into the app")
    _add_device_argument(p, "a re-applied block's verifications")
    p.set_defaults(fn=cmd_replay)

    p = sub.add_parser("debug", help="collect diagnostics from a running node")
    dsub = p.add_subparsers(dest="debug_cmd", required=True)
    d = dsub.add_parser("dump", help="status+consensus+metrics+WAL tarball")
    d.add_argument("--rpc", default="http://127.0.0.1:26657")
    d.add_argument("--output", "-o", default="tm-debug-dump.tgz")
    d.set_defaults(fn=cmd_debug_dump)

    sub.add_parser("compact-db", help="compact filedb databases (node stopped)").set_defaults(fn=cmd_compact_db)

    p = sub.add_parser("key-migrate", help="re-encode every store into another backend/engine dir")
    p.add_argument("--to-backend", default="filedb-c", choices=["filedb", "filedb-c", "filedb-py"])
    p.add_argument("--out", default="", help="output data dir (must differ)")
    p.set_defaults(fn=cmd_key_migrate)

    sub.add_parser("reindex-event",
                   help="rebuild the tx/block event index from stored blocks").set_defaults(fn=cmd_reindex_event)

    p = sub.add_parser("confix", help="migrate config.toml to the current schema")
    p.add_argument("--dry-run", action="store_true")
    p.set_defaults(fn=cmd_confix)

    p = sub.add_parser("wal2json", help="decode a consensus WAL to JSON")
    p.add_argument("wal", help="path to the WAL head file")
    p.set_defaults(fn=cmd_wal2json)

    p = sub.add_parser("abci", help="drive an ABCI socket app manually")
    asub = p.add_subparsers(dest="abci_cmd", required=True)
    for name, positional in (("info", None), ("echo", "message"), ("query", "data"), ("check-tx", "tx")):
        a = asub.add_parser(name)
        if positional:
            a.add_argument(positional)
        if name == "query":
            a.add_argument("--path", default="")
        a.add_argument("--addr", default="tcp://127.0.0.1:26658")
        a.set_defaults(fn=cmd_abci)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="tendermint_tpu_torch",
                                     description="BFT state-machine-replication node on the card")
    parser.add_argument("--home", default=DEFAULT_HOME, help="node home directory")
    sub = parser.add_subparsers(dest="command", required=True)
    _add_node_parsers(sub)
    p = sub.add_parser("verifyd", help="run the shared verification daemon")
    p.add_argument("action", nargs="?", choices=("serve", "stats"), default="serve",
                   help="serve (default) runs the daemon; stats prints a fleet roll-up "
                   "(per-shard rows and their aggregate) from --shards, else --listen")
    p.add_argument("--listen", default="127.0.0.1:26670", metavar="HOST:PORT",
                   help="gRPC listen address (port 0 picks a free one)")
    p.add_argument("--shard-id", type=int, default=-1,
                   help="this daemon's federation shard ordinal (stamped on every "
                   "response; -1 = standalone)")
    p.add_argument("--shards", default="", metavar="HOST:PORT,HOST:PORT,...",
                   help="the federation's shard list: a serving daemon polls it for the "
                   "/debug/memstats fleet roll-up, and `verifyd stats` prints it")
    _add_device_argument(p, "the kernels")
    p.add_argument("--max-batch", type=int, default=None,
                   help="flush when this many lanes are pending (default: 256)")
    p.add_argument("--max-delay", type=float, default=0.002,
                   help="max seconds the oldest lane waits before a flush")
    p.add_argument("--admission-cap", type=int, default=1024,
                   help="pending-lane ceiling before light/rpc load is shed")
    p.add_argument("--max-pending", type=int, default=4096,
                   help="hard pending-lane cap for ALL classes")
    p.add_argument("--continuous", choices=("on", "off"), default="on",
                   help="continuous batching (dispatch pipeline); off restores "
                   "the flush-barrier path")
    p.add_argument("--pipeline-depth", type=int, default=2,
                   help="dispatches outstanding at once under continuous batching")
    p.add_argument("--tenant-cap", type=int, default=512,
                   help="outstanding sheddable lanes one tenant may hold")
    p.add_argument("--tenant-pin-quota", type=int, default=256,
                   help="resident-table pins one tenant may hold (ops/resident.py)")
    p.add_argument("--max-tenants", type=int, default=16,
                   help="distinct tenant metric/budget buckets; overflow shares one")
    p.add_argument("--shm", choices=("auto", "on", "off"), default="auto",
                   help="zero-copy shared-memory ingress for co-located callers "
                   "(verifyd/shm.py); off is TCP only")
    p.add_argument("--dyn-batch", choices=("on", "off"), default="on",
                   help="deadline-aware dynamic batching (crypto/adaptive.py); off "
                   "pins the static max-batch/max-delay config")
    p.add_argument("--tenant-slo", action="append", default=[], metavar="TENANT=MS",
                   help="declare a tenant's p99 latency target in ms (repeatable)")
    p.add_argument("--metrics", default="", metavar="HOST:PORT",
                   help="serve /metrics and /debug/memstats here")
    p.add_argument("--trace", default="", help="span tracing: off | ring | <chrome-trace path>")
    p.set_defaults(fn=cmd_verifyd)

    p = sub.add_parser("light", help="run a light-client RPC proxy")
    _add_trust_arguments(p)
    p.add_argument("--laddr", default="127.0.0.1:0")
    p.add_argument("--sequential", action="store_true")
    p.set_defaults(fn=cmd_light)

    p = sub.add_parser("lightd", help="run the light-client serving tier")
    _add_trust_arguments(p)
    p.add_argument("--listen", default="127.0.0.1:26671", metavar="HOST:PORT",
                   help="JSON-RPC listen address (also serves /metrics)")
    p.add_argument("--cache-capacity", type=int, default=10_000,
                   help="verified-header cache size (LRU entries)")
    p.add_argument("--workers", type=int, default=None,
                   help="event-loop worker threads (default: the event loop's)")
    p.add_argument("--trace", default="", help="span tracing: off | ring | <chrome-trace path>")
    p.set_defaults(fn=cmd_lightd)
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return args.fn(args)
    except FileNotFoundError as e:
        print(f"error: {e} (run `init` first?)", file=sys.stderr)
        return 1
    except BrokenPipeError:
        return 0  # stdout consumer (e.g. `head`) closed early
    except (ValueError, OSError, RuntimeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    except Exception as e:
        # operator-facing failures from deeper layers (a remote signer
        # never dialing in, a corrupt WAL under wal2json) should read as
        # errors, not tracebacks
        from tendermint_tpu_torch.consensus.wal import WALCorruptionError
        from tendermint_tpu_torch.privval.remote import RemoteSignerError

        if isinstance(e, (RemoteSignerError, WALCorruptionError)):
            print(f"error: {e}", file=sys.stderr)
            return 1
        raise


if __name__ == "__main__":
    sys.exit(main())
