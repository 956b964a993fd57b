"""RPC route handlers bound to a node Environment.

A copy of ``tendermint_tpu/rpc/core.py``, whole, with one repair: a tx
that ``broadcast_tx_sync``, ``_async`` or ``_commit`` admits is gossiped
through the node's mempool reactor (``mempool_reactor=``), as Go's
reactor gossips every tx its mempool holds. The reference only admits
it, so on a network the tx waits until the node it was sent to proposes.
It mirrors internal/rpc/core: the ``Environment`` struct holds handles to
every service (routes.go:28-80, env.go), and each handler is a thin
adapter from JSON params to those services. Route names and response
shapes follow the reference; int64s are strings, hashes hex, tx bytes
base64 (see rpc/encoding.py).
"""

from __future__ import annotations

import base64
import hashlib
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from tendermint_tpu_torch import eventbus as eb
from tendermint_tpu_torch.abci import types as abci
from tendermint_tpu_torch.crypto import merkle
from tendermint_tpu_torch.libs.pubsub import Query, QueryError
from tendermint_tpu_torch.rpc import encoding as enc
from tendermint_tpu_torch.rpc.server import INTERNAL_ERROR, INVALID_PARAMS, RPCError
from tendermint_tpu_torch.state.execution import _unmarshal_finalize_response
from tendermint_tpu_torch.types.block import tx_hash as _tx_hash
from tendermint_tpu_torch.types.evidence import evidence_from_proto_bytes


def _to_bytes_param(v: Any) -> bytes:
    """'0x'-prefixed hex or base64 (the reference URI convention: hex
    MUST carry the 0x prefix so e.g. a 64-char tx hash is never
    mis-parsed as base64 — rpc/jsonrpc/server http_uri_handler)."""
    if isinstance(v, bytes):
        return v
    if isinstance(v, str):
        if v.startswith("0x") or v.startswith("0X"):
            try:
                return bytes.fromhex(v[2:])
            except ValueError:
                raise RPCError(INVALID_PARAMS, f"invalid hex param: {v!r}")
        try:
            return base64.b64decode(v, validate=True)
        except Exception:
            raise RPCError(INVALID_PARAMS, f"cannot decode bytes param: {v!r}")
    raise RPCError(INVALID_PARAMS, f"cannot decode bytes param: {v!r}")


class Environment:
    """Service handles for RPC handlers (internal/rpc/core/env.go)."""

    def __init__(
        self,
        *,
        node_info=None,
        genesis=None,
        block_store=None,
        state_store=None,
        consensus=None,
        mempool=None,
        evidence_pool=None,
        app_client=None,
        event_bus: Optional[eb.EventBus] = None,
        indexer=None,
        peer_manager=None,
        get_state: Optional[Callable] = None,
        is_syncing: Optional[Callable[[], bool]] = None,
        consensus_reactor=None,
        router=None,
        mempool_reactor=None,
        unsafe: bool = False,
    ):
        self.node_info = node_info
        self.genesis = genesis
        self.block_store = block_store
        self.state_store = state_store
        self.consensus = consensus
        self.mempool = mempool
        self.evidence_pool = evidence_pool
        self.app = app_client
        self.event_bus = event_bus
        self.indexer = indexer
        self.peer_manager = peer_manager
        self.get_state = get_state or (lambda: None)
        self.is_syncing = is_syncing or (lambda: False)
        self.consensus_reactor = consensus_reactor
        self.router = router
        self.mempool_reactor = mempool_reactor
        self.unsafe = unsafe

    # -- route table ----------------------------------------------------------

    def routes(self) -> Dict[str, Callable]:
        """internal/rpc/core/routes.go:28-80."""
        routes = {
            "health": self.health,
            "status": self.status,
            "net_info": self.net_info,
            "blockchain": self.blockchain,
            "genesis": self.genesis_route,
            "block": self.block,
            "block_by_hash": self.block_by_hash,
            "block_results": self.block_results,
            "commit": self.commit,
            "header": self.header,
            "header_by_hash": self.header_by_hash,
            "validators": self.validators,
            "consensus_state": self.consensus_state,
            "dump_consensus_state": self.dump_consensus_state,
            "consensus_params": self.consensus_params,
            "unconfirmed_txs": self.unconfirmed_txs,
            "num_unconfirmed_txs": self.num_unconfirmed_txs,
            "broadcast_tx_sync": self.broadcast_tx_sync,
            "broadcast_tx_async": self.broadcast_tx_sync,  # alias, routes.go:64
            "broadcast_tx_commit": self.broadcast_tx_commit,
            "check_tx": self.check_tx,
            "tx": self.tx,
            "tx_search": self.tx_search,
            "block_search": self.block_search,
            "abci_query": self.abci_query,
            "abci_info": self.abci_info,
            "broadcast_evidence": self.broadcast_evidence,
            "events": self.events,
            "subscribe": self.subscribe_poll,
            "genesis_chunked": self.genesis_chunked,
            "remove_tx": self.remove_tx,
        }
        if self.unsafe:
            # Reference routes.go AddUnsafeRoutes / the pprof server
            # behind PprofListenAddress (node.go OnStart): the whole
            # diagnostic+operator surface requires the explicit
            # [rpc] unsafe opt-in — thread dumps leak peer identities
            # (router-send-<peer> thread names) to whoever can ask.
            routes["dump_routines"] = self.dump_routines
            routes["unsafe_disconnect_peers"] = self.unsafe_disconnect_peers
            routes["unsafe_start_profiler"] = self.unsafe_start_profiler
            routes["unsafe_stop_profiler"] = self.unsafe_stop_profiler
        return routes

    # -- info routes ----------------------------------------------------------

    def health(self) -> Dict[str, Any]:
        return {}

    def status(self) -> Dict[str, Any]:
        state = self.get_state()
        latest_height = self.block_store.height() if self.block_store else 0
        latest_meta = (
            self.block_store.load_block_meta(latest_height)
            if latest_height > 0
            else None
        )
        val_info = {}
        if state is not None and self.consensus is not None:
            pv = getattr(self.consensus, "priv_validator", None)
            if pv is not None:
                addr = pv.get_pub_key().address()
                _, val = state.validators.get_by_address(addr)
                val_info = {
                    "address": enc.hex_bytes(addr),
                    "pub_key": {
                        "type": pv.get_pub_key().type,
                        "value": enc.b64(pv.get_pub_key().bytes()),
                    },
                    "voting_power": str(val.voting_power if val else 0),
                }
        return {
            "node_info": self._node_info_json(),
            "sync_info": {
                "latest_block_hash": enc.hex_bytes(
                    latest_meta.block_id.hash if latest_meta else b""
                ),
                "latest_app_hash": enc.hex_bytes(
                    state.app_hash if state is not None else b""
                ),
                "latest_block_height": str(latest_height),
                "latest_block_time": enc.rfc3339(
                    latest_meta.header.time
                    if latest_meta
                    else enc.Timestamp(0, 0)
                ),
                "earliest_block_height": str(
                    self.block_store.base() if self.block_store else 0
                ),
                "catching_up": bool(self.is_syncing()),
            },
            "validator_info": val_info,
        }

    def _node_info_json(self) -> Dict[str, Any]:
        ni = self.node_info
        if ni is None:
            return {}
        return {
            "id": getattr(ni, "node_id", ""),
            "listen_addr": getattr(ni, "listen_addr", ""),
            "network": getattr(ni, "network", ""),
            "version": getattr(ni, "version", ""),
            "moniker": getattr(ni, "moniker", ""),
        }

    def net_info(self) -> Dict[str, Any]:
        peers = []
        if self.peer_manager is not None:
            for pid in self.peer_manager.connected_peers():
                peers.append({"node_id": pid})
        return {
            "listening": True,
            "listeners": [],
            "n_peers": str(len(peers)),
            "peers": peers,
        }

    def unsafe_disconnect_peers(self, duration: float = 5.0) -> Dict[str, Any]:
        """Drop all peer connections and quarantine dial/accept for
        ``duration`` seconds — the process-level 'disconnect'
        perturbation the e2e runner drives (perturb.go:42-72 network
        disconnect analog)."""
        if self.router is None:
            raise RPCError(INTERNAL_ERROR, "router unavailable")
        duration = min(max(float(duration), 0.0), 60.0)  # cap the outage
        dropped = self.router.disconnect_all(duration)
        return {"dropped": dropped, "duration": duration}

    def dump_routines(self) -> Dict[str, Any]:
        """Per-thread stack traces — the goroutine-dump half of the
        reference's pprof endpoint (node.go pprof server; read-only)."""
        import sys
        import traceback

        frames = sys._current_frames()
        names = {t.ident: t.name for t in threading.enumerate()}
        routines = []
        for ident, frame in frames.items():
            routines.append(
                {
                    "thread": names.get(ident, str(ident)),
                    "stack": traceback.format_stack(frame),
                }
            )
        return {"count": len(routines), "routines": routines}

    # cProfile hooks the whole interpreter, so the session is process-
    # wide by nature; the lock serializes the check-then-set against
    # concurrent RPCs (and multiple in-process nodes).
    _profiler = None
    _profiler_mtx = threading.Lock()

    def unsafe_start_profiler(self) -> Dict[str, Any]:
        """Start a process-wide cProfile session (the CPU-profile half of
        the reference's pprof surface; unsafe opt-in)."""
        import cProfile

        with Environment._profiler_mtx:
            if Environment._profiler is not None:
                raise RPCError(INTERNAL_ERROR, "profiler already running")
            prof = cProfile.Profile()
            Environment._profiler = prof
            prof.enable()
        return {"started": True}

    def unsafe_stop_profiler(self, top: int = 40) -> Dict[str, Any]:
        import io
        import pstats

        with Environment._profiler_mtx:
            prof = Environment._profiler
            if prof is None:
                raise RPCError(INTERNAL_ERROR, "profiler not running")
            prof.disable()
            Environment._profiler = None
        buf = io.StringIO()
        pstats.Stats(prof, stream=buf).sort_stats("cumulative").print_stats(
            int(top)
        )
        return {"stats": buf.getvalue()}

    def genesis_route(self) -> Dict[str, Any]:
        g = self.genesis
        return {
            "genesis": {
                "genesis_time": enc.rfc3339(g.genesis_time),
                "chain_id": g.chain_id,
                "initial_height": str(g.initial_height),
                "app_hash": enc.hex_bytes(g.app_hash),
                "validators": [
                    {
                        "address": enc.hex_bytes(v.address),
                        "pub_key": {"type": v.pub_key.type, "value": enc.b64(v.pub_key.bytes())},
                        "power": str(v.power),
                        "name": "",
                    }
                    for v in g.validators
                ],
            }
        }

    # -- block routes ---------------------------------------------------------

    def _height_param(self, height, default_latest: bool = True) -> int:
        if height is None or height == "":
            if not default_latest:
                raise RPCError(INVALID_PARAMS, "height required")
            return self.block_store.height()
        h = int(height)
        if h <= 0:
            return self.block_store.height()
        return h

    def blockchain(self, minHeight=None, maxHeight=None, min_height=None, max_height=None) -> Dict[str, Any]:
        lo = int(minHeight if minHeight is not None else (min_height or 1))
        latest = self.block_store.height()
        hi = int(maxHeight if maxHeight is not None else (max_height or latest))
        hi = min(hi if hi > 0 else latest, latest)
        lo = max(lo, self.block_store.base(), hi - 19)
        metas = []
        for h in range(hi, lo - 1, -1):
            m = self.block_store.load_block_meta(h)
            if m is None:
                continue
            metas.append(
                {
                    "block_id": enc.block_id_json(m.block_id),
                    "block_size": str(m.block_size),
                    "header": enc.header_json(m.header),
                    "num_txs": str(m.num_txs),
                }
            )
        return {"last_height": str(latest), "block_metas": metas}

    def block(self, height=None) -> Dict[str, Any]:
        h = self._height_param(height)
        blk = self.block_store.load_block(h)
        meta = self.block_store.load_block_meta(h)
        if blk is None:
            raise RPCError(INVALID_PARAMS, f"no block at height {h}")
        return {
            "block_id": enc.block_id_json(meta.block_id),
            "block": enc.block_json(blk),
        }

    def block_by_hash(self, hash=None) -> Dict[str, Any]:
        blk = self.block_store.load_block_by_hash(_to_bytes_param(hash))
        if blk is None:
            return {"block_id": None, "block": None}
        return self.block(blk.header.height)

    def header(self, height=None) -> Dict[str, Any]:
        h = self._height_param(height)
        meta = self.block_store.load_block_meta(h)
        if meta is None:
            raise RPCError(INVALID_PARAMS, f"no header at height {h}")
        return {"header": enc.header_json(meta.header)}

    def header_by_hash(self, hash=None) -> Dict[str, Any]:
        blk = self.block_store.load_block_by_hash(_to_bytes_param(hash))
        if blk is None:
            return {"header": None}
        return {"header": enc.header_json(blk.header)}

    def commit(self, height=None) -> Dict[str, Any]:
        h = self._height_param(height)
        meta = self.block_store.load_block_meta(h)
        if meta is None:
            raise RPCError(INVALID_PARAMS, f"no block at height {h}")
        canonical = True
        c = self.block_store.load_block_commit(h)
        if c is None:
            c = self.block_store.load_seen_commit()
            canonical = False
            if c is None or c.height != h:
                raise RPCError(INVALID_PARAMS, f"no commit for height {h}")
        return {
            "signed_header": {
                "header": enc.header_json(meta.header),
                "commit": enc.commit_json(c),
            },
            "canonical": canonical,
        }

    def block_results(self, height=None) -> Dict[str, Any]:
        h = self._height_param(height)
        raw = self.state_store.load_finalize_block_response(h)
        if raw is None:
            raise RPCError(INVALID_PARAMS, f"no results for height {h}")
        fres = _unmarshal_finalize_response(raw)
        return {
            "height": str(h),
            "txs_results": [enc.exec_tx_result_json(r) for r in fres.tx_results],
            "finalize_block_events": [enc.event_json(e) for e in fres.events],
            "validator_updates": [
                {"pub_key_type": u.pub_key_type, "power": str(u.power)}
                for u in fres.validator_updates
            ],
            "app_hash": enc.hex_bytes(fres.app_hash),
        }

    def validators(self, height=None, page=1, per_page=30) -> Dict[str, Any]:
        h = self._height_param(height)
        vset = self.state_store.load_validators(h)
        vals = vset.validators
        page = max(1, int(page))
        per_page = max(1, min(100, int(per_page)))
        start = (page - 1) * per_page
        sel = vals[start : start + per_page]
        return {
            "block_height": str(h),
            "validators": [enc.validator_json(v) for v in sel],
            "count": str(len(sel)),
            "total": str(len(vals)),
        }

    def consensus_params(self, height=None) -> Dict[str, Any]:
        h = self._height_param(height)
        params = self.state_store.load_consensus_params(h)
        return {
            "block_height": str(h),
            "consensus_params": {
                "block": {
                    "max_bytes": str(params.block.max_bytes),
                    "max_gas": str(params.block.max_gas),
                },
                "evidence": {
                    "max_age_num_blocks": str(params.evidence.max_age_num_blocks),
                    "max_age_duration": str(params.evidence.max_age_duration),
                    "max_bytes": str(params.evidence.max_bytes),
                },
                "validator": {
                    "pub_key_types": list(params.validator.pub_key_types)
                },
            },
        }

    def consensus_state(self) -> Dict[str, Any]:
        """internal/rpc/core/consensus.go GetConsensusState: the round
        state summary."""
        cs = self.consensus
        rs = getattr(cs, "rs", None) if cs is not None else None
        if rs is None:
            return {"round_state": None}
        return {
            "round_state": {
                "height/round/step": rs.height_round_step(),
                "height": str(rs.height),
                "round": rs.round,
                "step": rs.step.name,
                "start_time": str(rs.start_time.to_unix_ns()),
                "proposal_block_hash": enc.hex_bytes(
                    rs.proposal_block.hash() if rs.proposal_block is not None else b""
                ),
                "locked_block_hash": enc.hex_bytes(
                    rs.locked_block.hash() if rs.locked_block is not None else b""
                ),
                "valid_block_hash": enc.hex_bytes(
                    rs.valid_block.hash() if rs.valid_block is not None else b""
                ),
                "height_vote_set": self._height_vote_set_json(rs),
            }
        }

    @staticmethod
    def _bits(ba) -> str:
        if ba is None:
            return ""
        return "".join("x" if ba.get_index(i) else "_" for i in range(ba.size()))

    def _height_vote_set_json(self, rs) -> List[Dict[str, Any]]:
        out: List[Dict[str, Any]] = []
        if rs.votes is None:
            return out
        for r in range(rs.round + 1):
            prevotes = rs.votes.prevotes(r)
            precommits = rs.votes.precommits(r)
            out.append(
                {
                    "round": r,
                    "prevotes_bit_array": self._bits(
                        prevotes.bit_array() if prevotes else None
                    ),
                    "precommits_bit_array": self._bits(
                        precommits.bit_array() if precommits else None
                    ),
                }
            )
        return out

    def dump_consensus_state(self) -> Dict[str, Any]:
        """internal/rpc/core/consensus.go DumpConsensusState: full round
        state + per-peer round states from the reactor's PeerStates."""
        base = self.consensus_state()
        cs = self.consensus
        rs = getattr(cs, "rs", None) if cs is not None else None
        if rs is not None:
            base["round_state"]["validators"] = {
                "proposer": enc.hex_bytes(
                    rs.validators.get_proposer().address
                    if rs.validators is not None and not rs.validators.is_nil_or_empty()
                    else b""
                ),
                "count": len(rs.validators) if rs.validators is not None else 0,
            }
            base["round_state"]["last_commit_bit_array"] = self._bits(
                rs.last_commit.bit_array() if rs.last_commit is not None else None
            )
        peers = []
        reactor = self.consensus_reactor
        if reactor is not None:
            with reactor._peers_mtx:
                peer_states = dict(reactor._peers)
            for pid, ps in sorted(peer_states.items()):
                height, round_, step, lcr = ps.snapshot()
                peers.append(
                    {
                        "node_address": pid,
                        "peer_state": {
                            "round_state": {
                                "height": str(height),
                                "round": round_,
                                "step": step,
                                "last_commit_round": lcr,
                                "has_proposal": ps.has_proposal,
                                "proposal_block_parts": self._bits(ps.parts),
                            }
                        },
                    }
                )
        base["peers"] = peers
        return base

    # -- mempool routes -------------------------------------------------------

    def unconfirmed_txs(self, page=1, per_page=30) -> Dict[str, Any]:
        txs = self.mempool.tx_list()
        page = max(1, int(page))
        per_page = max(1, min(100, int(per_page)))
        sel = txs[(page - 1) * per_page : (page - 1) * per_page + per_page]
        return {
            "n_txs": str(len(sel)),
            "total": str(len(txs)),
            "total_bytes": str(self.mempool.size_bytes()),
            "txs": [enc.b64(t) for t in sel],
        }

    def num_unconfirmed_txs(self) -> Dict[str, Any]:
        return {
            "n_txs": str(len(self.mempool)),
            "total": str(len(self.mempool)),
            "total_bytes": str(self.mempool.size_bytes()),
        }

    def check_tx(self, tx=None) -> Dict[str, Any]:
        raw = _to_bytes_param(tx)
        res = self.app.check_tx(abci.RequestCheckTx(tx=raw))
        return {"code": res.code, "codespace": res.codespace, "data": enc.b64(res.data)}

    def _admit(self, raw: bytes) -> abci.ResponseCheckTx:
        """CheckTx into the mempool, and gossip the tx if it was admitted
        (the repair in the module note)."""
        res = self.mempool.check_tx(raw)
        if res.is_ok() and self.mempool_reactor is not None:
            self.mempool_reactor.broadcast_tx(raw)
        return res

    def broadcast_tx_sync(self, tx=None) -> Dict[str, Any]:
        raw = _to_bytes_param(tx)
        res = self._admit(raw)
        return {
            "code": res.code,
            "data": enc.b64(res.data),
            "codespace": res.codespace,
            "hash": enc.hex_bytes(hashlib.sha256(raw).digest()),
        }

    def broadcast_tx_commit(self, tx=None, timeout: float = 30.0) -> Dict[str, Any]:
        """mempool.go DeliverTx flow: CheckTx, then wait for the tx event
        (internal/rpc/core/mempool.go:48-108)."""
        raw = _to_bytes_param(tx)
        tx_hash = hashlib.sha256(raw).hexdigest().upper()
        if self.event_bus is None:
            raise RPCError(INVALID_PARAMS, "event bus not configured")
        subscriber = f"tx-commit-{tx_hash[:16]}-{time.monotonic_ns()}"
        sub = self.event_bus.subscribe(
            subscriber, f"{eb.TX_HASH_KEY} = '{tx_hash}'", capacity=4
        )
        try:
            res = self._admit(raw)
            out: Dict[str, Any] = {
                "check_tx": {
                    "code": res.code,
                    "data": enc.b64(res.data),
                    "codespace": res.codespace,
                },
                "hash": tx_hash,
                "height": "0",
            }
            if res.code != abci.CODE_TYPE_OK:
                return out
            msg = sub.next(timeout=timeout)
            if msg is None:
                out["tx_result"] = None
                out["error"] = "timed out waiting for tx to be included in a block"
                return out
            data = msg.data
            out["tx_result"] = enc.exec_tx_result_json(data.result)
            out["height"] = str(data.height)
            return out
        finally:
            self.event_bus.unsubscribe_all(subscriber)

    # -- query routes ---------------------------------------------------------

    def tx(self, hash=None, prove=False) -> Dict[str, Any]:
        if self.indexer is None:
            raise RPCError(INVALID_PARAMS, "tx indexing disabled")
        h = _to_bytes_param(hash)
        tr = self.indexer.get_tx(h)
        if tr is None:
            raise RPCError(INVALID_PARAMS, f"tx not found: {h.hex()}")
        out = {
            "hash": enc.hex_bytes(h),
            "height": str(tr.height),
            "index": tr.index,
            "tx_result": enc.exec_tx_result_json(tr.result),
            "tx": enc.b64(tr.tx),
        }
        if prove:
            # types/tx.go Txs.Proof: merkle inclusion over per-tx hashes
            # (the leaves of Data.hash); rpc/core/tx.go:52.
            block = self.block_store.load_block(tr.height)
            if block is None:
                raise RPCError(
                    INVALID_PARAMS, f"block at height {tr.height} pruned"
                )
            leaves = [_tx_hash(t) for t in block.data.txs]
            root, proofs = merkle.proofs_from_byte_slices(leaves)
            if tr.index >= len(proofs):
                raise RPCError(INTERNAL_ERROR, "tx index out of range")
            p = proofs[tr.index]
            out["proof"] = {
                "root_hash": enc.hex_bytes(root),
                "data": enc.b64(tr.tx),
                "proof": {
                    "total": str(p.total),
                    "index": str(p.index),
                    "leaf_hash": enc.b64(p.leaf_hash),
                    "aunts": [enc.b64(a) for a in p.aunts],
                },
            }
        return out

    def genesis_chunked(self, chunk=0) -> Dict[str, Any]:
        """rpc/core/net.go GenesisChunked: the genesis doc in 16 MiB
        base64 chunks, for documents too large for one response.
        Chunks are computed once and cached — the doc is immutable and
        re-serializing a huge genesis per request defeats the point."""
        chunks = getattr(self, "_genesis_chunks", None)
        if chunks is None:
            data = self.genesis.to_json().encode()
            size = 16 * 1024 * 1024
            chunks = [
                data[i : i + size] for i in range(0, len(data), size)
            ] or [b""]
            self._genesis_chunks = chunks
        c = int(chunk)
        if c < 0 or c >= len(chunks):
            raise RPCError(
                INVALID_PARAMS,
                f"there are {len(chunks)} chunks, cannot fetch chunk {c}",
            )
        return {
            "chunk": str(c),
            "total": str(len(chunks)),
            "data": enc.b64(chunks[c]),
        }

    def remove_tx(self, tx_key=None) -> Dict[str, Any]:
        """rpc/core/mempool.go RemoveTx: evict by tx key (sha256 of tx)."""
        if tx_key is None:
            raise RPCError(INVALID_PARAMS, "tx_key required")
        key = _to_bytes_param(tx_key)
        if len(key) != 32:
            raise RPCError(INVALID_PARAMS, "tx_key must be 32 bytes")
        self.mempool.remove_tx_by_key(key)
        return {}

    def tx_search(self, query=None, page=1, per_page=30, order_by="asc") -> Dict[str, Any]:
        if self.indexer is None:
            raise RPCError(INVALID_PARAMS, "tx indexing disabled")
        try:
            q = Query.parse(query or "")
        except QueryError as e:
            raise RPCError(INVALID_PARAMS, str(e))
        # Paginate over index keys; only the selected page's records are
        # decoded (a query matching the whole chain stays O(page)).
        keys = self.indexer.search_tx_keys(q)
        if order_by == "desc":
            keys = keys[::-1]
        page = max(1, int(page))
        per_page = max(1, min(100, int(per_page)))
        sel_keys = keys[(page - 1) * per_page : (page - 1) * per_page + per_page]
        sel = [self.indexer.get_tx(h) for _, _, h in sel_keys]
        return {
            "txs": [
                {
                    "hash": enc.hex_bytes(t.hash()),
                    "height": str(t.height),
                    "index": t.index,
                    "tx_result": enc.exec_tx_result_json(t.result),
                    "tx": enc.b64(t.tx),
                }
                for t in sel
                if t is not None
            ],
            "total_count": str(len(keys)),
        }

    def block_search(self, query=None, page=1, per_page=30, order_by="asc") -> Dict[str, Any]:
        if self.indexer is None:
            raise RPCError(INVALID_PARAMS, "block indexing disabled")
        try:
            q = Query.parse(query or "")
        except QueryError as e:
            raise RPCError(INVALID_PARAMS, str(e))
        heights = self.indexer.search_block_heights(q, limit=10000)
        if order_by == "desc":
            heights = heights[::-1]
        page = max(1, int(page))
        per_page = max(1, min(100, int(per_page)))
        sel = heights[(page - 1) * per_page : (page - 1) * per_page + per_page]
        blocks = []
        for h in sel:
            meta = self.block_store.load_block_meta(h)
            blk = self.block_store.load_block(h)
            if meta is None or blk is None:
                continue
            blocks.append(
                {"block_id": enc.block_id_json(meta.block_id), "block": enc.block_json(blk)}
            )
        return {"blocks": blocks, "total_count": str(len(heights))}

    # -- ABCI routes ----------------------------------------------------------

    def abci_query(self, path="", data=None, height=0, prove=False) -> Dict[str, Any]:
        raw = _to_bytes_param(data) if data else b""
        res = self.app.query(
            abci.RequestQuery(data=raw, path=path, height=int(height), prove=bool(prove))
        )
        proof_ops = None
        if res.proof_ops:
            proof_ops = {
                "ops": [
                    {
                        "type": getattr(op, "type", ""),
                        "key": enc.b64(getattr(op, "key", b"")),
                        "data": enc.b64(getattr(op, "data", b"")),
                    }
                    for op in res.proof_ops
                ]
            }
        return {
            "response": {
                "code": res.code,
                "log": res.log,
                "info": res.info,
                "index": str(res.index),
                "key": enc.b64(res.key),
                "value": enc.b64(res.value),
                "proof_ops": proof_ops,
                "height": str(res.height),
                "codespace": res.codespace,
            }
        }

    def abci_info(self) -> Dict[str, Any]:
        res = self.app.info(abci.RequestInfo())
        return {
            "response": {
                "data": res.data,
                "version": res.version,
                "app_version": str(res.app_version),
                "last_block_height": str(res.last_block_height),
                "last_block_app_hash": enc.b64(res.last_block_app_hash),
            }
        }

    def broadcast_evidence(self, evidence=None) -> Dict[str, Any]:
        ev = evidence_from_proto_bytes(_to_bytes_param(evidence))
        self.evidence_pool.add_evidence(ev)
        return {"hash": enc.hex_bytes(ev.hash())}

    # -- event routes ---------------------------------------------------------

    def events(self, filter=None, maxItems=100, after=0, waitTime=5.0) -> Dict[str, Any]:
        """Long-poll over the sliding-window event log
        (internal/rpc/core/events.go:103, eventlog-backed /events)."""
        if self.event_bus is None:
            raise RPCError(INVALID_PARAMS, "event bus not configured")
        q = None
        if filter:
            fq = filter.get("query") if isinstance(filter, dict) else filter
            if fq:
                try:
                    q = Query.parse(fq)
                except QueryError as e:
                    raise RPCError(INVALID_PARAMS, str(e))
        items, more, resume = self.event_bus.eventlog.scan(
            query=q,
            after=int(after),
            max_items=min(int(maxItems), 500),
            wait=min(float(waitTime), 30.0),
        )
        return {
            "items": [
                {
                    "cursor": str(it.cursor),
                    "event": it.type,
                    "data": _event_data_json(it.data),
                }
                for it in items
            ],
            "more": more,
            "oldest": str(items[0].cursor) if items else "0",
            # resume cursor: pass back as `after` — never skips events
            # even when the response was truncated.
            "newest": str(resume),
        }

    def subscribe_poll(self, query=None, after=0, waitTime=5.0, maxItems=100) -> Dict[str, Any]:
        """Long-poll subscribe: same contract as /events but keyed by the
        caller's query (the reference's websocket subscribe is replaced
        by cursor-based polling; see server.py docstring)."""
        return self.events(
            filter={"query": query} if query else None,
            maxItems=maxItems,
            after=after,
            waitTime=waitTime,
        )


def _event_data_json(data: object) -> Dict[str, Any]:
    if isinstance(data, eb.EventDataNewBlock):
        return {
            "type": "new_block",
            "height": str(data.block.header.height),
            "block": enc.block_json(data.block),
        }
    if isinstance(data, eb.EventDataTx):
        return {
            "type": "tx",
            "height": str(data.height),
            "index": data.index,
            "tx": enc.b64(data.tx),
            "result": enc.exec_tx_result_json(data.result),
        }
    if isinstance(data, eb.EventDataNewBlockHeader):
        return {"type": "new_block_header", "header": enc.header_json(data.header)}
    if isinstance(data, eb.EventDataNewRound):
        return {
            "type": "new_round",
            "height": str(data.height),
            "round": data.round,
            "step": data.step,
        }
    if isinstance(data, eb.EventDataRoundState):
        return {
            "type": "round_state",
            "height": str(data.height),
            "round": data.round,
            "step": data.step,
        }
    if isinstance(data, eb.EventDataValidatorSetUpdates):
        return {"type": "validator_set_updates"}
    if isinstance(data, eb.EventDataVote):
        v = data.vote
        return {
            "type": "vote",
            "height": str(v.height),
            "round": v.round,
            "vote_type": v.type,
            "validator_address": enc.hex_bytes(v.validator_address),
            "validator_index": v.validator_index,
        }
    if isinstance(data, eb.EventDataCompleteProposal):
        return {
            "type": "complete_proposal",
            "height": str(data.height),
            "round": data.round,
            "step": data.step,
            "block_hash": enc.hex_bytes(data.block_id.hash)
            if data.block_id is not None
            else "",
        }
    if isinstance(data, eb.EventDataBlockSyncStatus):
        return {
            "type": "block_sync_status",
            "complete": data.complete,
            "height": str(data.height),
        }
    if isinstance(data, eb.EventDataStateSyncStatus):
        return {
            "type": "state_sync_status",
            "complete": data.complete,
            "height": str(data.height),
        }
    return {"type": type(data).__name__}
