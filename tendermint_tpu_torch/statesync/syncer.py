"""State syncer: discover snapshots, restore the app, bootstrap state.

A copy of ``tendermint_tpu/statesync/syncer.py``: the client half of
state sync (internal/statesync/syncer.go:353-535 +
stateprovider.go:33-361): broadcast discovery, rank offered snapshots,
build a verified sm.State at the snapshot height from light blocks
(anchored at a configured trust (height, hash), walked to the target
through the light-client verifier on ``device``), OfferSnapshot to the
app, fetch chunks with concurrent fetchers feeding an in-order applier,
check the restored app against the trusted app hash, then bootstrap the
stores and optionally backfill verified headers for the evidence window
(reactor.go:416 Backfill).

One divergence: an error of
:data:`~tendermint_tpu_torch.consensus.state.DEVICE_ERRORS` in the light
walk is neither a reason to try the next snapshot nor wrapped in
:class:`StateSyncFatalError`: it leaves :meth:`StateSyncer.sync` as it
is, and the node fails on it (``node/node.py``). In the reference such an
error escapes ``sync()`` too, and its node answers it with a block sync
from genesis (``node.py:608-621``).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field as dc_field
from typing import Dict, List, Optional, Set, Tuple

from tendermint_tpu_torch import resolve_device
from tendermint_tpu_torch.abci import types as abci
from tendermint_tpu_torch.consensus.state import DEVICE_ERRORS
from tendermint_tpu_torch.encoding.canonical import Timestamp
from tendermint_tpu_torch.light import verifier as light_verifier
from tendermint_tpu_torch.state.state import State
from tendermint_tpu_torch.types.block import Consensus
from tendermint_tpu_torch.types.light import LightBlock
from tendermint_tpu_torch.types.validation import Fraction


class SyncAbortedError(RuntimeError):
    pass


class NoSnapshotError(RuntimeError):
    pass


class StateSyncFatalError(RuntimeError):
    """Failure AFTER the app was mutated by a snapshot restore: the node
    must not retry other snapshots or degrade to block sync from genesis
    on top of restored state."""


# Bound attacker-controlled chunk counts before any allocation.
MAX_SNAPSHOT_CHUNKS = 16384


@dataclass
class StateSyncConfig:
    """config/config.go StateSyncConfig condensed."""

    enabled: bool = False
    trust_height: int = 0
    trust_hash: bytes = b""
    trust_period: float = 14 * 86400.0
    discovery_time: float = 2.0
    chunk_fetchers: int = 4  # config.go:863-882 Fetchers default
    chunk_timeout: float = 10.0
    light_block_timeout: float = 10.0
    backfill_blocks: int = 0
    max_clock_drift: float = 10.0


_SnapKey = Tuple[int, int, bytes, int]  # height, format, hash, chunks


class StateSyncer:
    def __init__(self, reactor, app_client, state_store, block_store, genesis, config, device=None):
        if not config.trust_hash or config.trust_height <= 0:
            # Without a verified anchor every light block is accepted on a
            # single peer's say-so — refuse the configuration (the
            # reference requires trust_height+trust_hash the same way).
            raise ValueError(
                "state sync requires trust_height > 0 and a non-empty "
                "trust_hash anchor"
            )
        self.device = resolve_device(device)
        self.reactor = reactor
        self.app = app_client
        self.state_store = state_store
        self.block_store = block_store
        self.genesis = genesis
        self.config = config
        self._mtx = threading.Lock()
        self._cond = threading.Condition(self._mtx)
        self._snapshots: Dict[_SnapKey, Set[str]] = {}  # -> peers serving it
        self._light_blocks: Dict[int, LightBlock] = {}
        self._params: Dict[int, object] = {}
        self._chunks: Dict[int, Optional[bytes]] = {}
        self._chunk_target: Optional[Tuple[int, int]] = None  # (height, format)
        self.backfilled: Dict[int, LightBlock] = {}

    # --- reactor sinks --------------------------------------------------------

    def install(self) -> None:
        self.reactor.on_snapshot = self._on_snapshot
        self.reactor.on_chunk = self._on_chunk
        self.reactor.on_light_block = self._on_light_block
        self.reactor.on_params = self._on_params

    def _on_snapshot(self, peer: str, s: abci.Snapshot) -> None:
        if not (0 < s.chunks <= MAX_SNAPSHOT_CHUNKS) or s.height <= 0:
            return  # hostile/garbage advertisement
        key = (s.height, s.format, s.hash, s.chunks)
        with self._cond:
            self._snapshots.setdefault(key, set()).add(peer)
            self._cond.notify_all()

    def _on_chunk(self, peer, height, format_, index, body) -> None:
        with self._cond:
            if self._chunk_target != (height, format_):
                return
            if body is not None and self._chunks.get(index) is None:
                self._chunks[index] = body
            self._cond.notify_all()

    def _on_light_block(self, peer, height, lb) -> None:
        with self._cond:
            if lb is not None and height not in self._light_blocks:
                # Basic integrity: the signed header must hash-match itself.
                if (
                    lb.signed_header.header is not None
                    and lb.signed_header.commit is not None
                    and lb.signed_header.commit.block_id.hash
                    == lb.signed_header.header.hash()
                    and lb.validator_set is not None
                    and lb.validator_set.hash()
                    == lb.signed_header.header.validators_hash
                ):
                    self._light_blocks[height] = lb
            self._cond.notify_all()

    def _on_params(self, peer, height, params) -> None:
        with self._cond:
            self._params.setdefault(height, params)
            self._cond.notify_all()

    # --- fetch helpers --------------------------------------------------------

    def _peers(self) -> List[str]:
        with self._mtx:
            out: Set[str] = set()
            for peers in self._snapshots.values():
                out |= peers
        return sorted(out)

    def _fetch_light_block(self, height: int) -> LightBlock:
        deadline = time.monotonic() + self.config.light_block_timeout
        peers = self._peers()
        i = 0
        while time.monotonic() < deadline:
            with self._cond:
                if height in self._light_blocks:
                    return self._light_blocks[height]
            if peers:
                self.reactor.request_light_block(peers[i % len(peers)], height)
                i += 1
            with self._cond:
                self._cond.wait(0.25)
        raise SyncAbortedError(f"no light block at height {height}")

    def _fetch_params(self, height: int):
        deadline = time.monotonic() + self.config.light_block_timeout
        peers = self._peers()
        i = 0
        while time.monotonic() < deadline:
            with self._cond:
                if height in self._params:
                    return self._params[height]
            if peers:
                self.reactor.request_params(peers[i % len(peers)], height)
                i += 1
            with self._cond:
                self._cond.wait(0.25)
        raise SyncAbortedError(f"no consensus params at height {height}")

    # --- the state provider ---------------------------------------------------

    def _verified_light_block(
        self, height: int, trusted: LightBlock
    ) -> LightBlock:
        """Walk trust from `trusted` to `height` via the light verifier
        (stateprovider.go uses an embedded light client the same way)."""
        lb = self._fetch_light_block(height)
        now = Timestamp.from_unix_ns(time.time_ns() + 10**9)
        light_verifier.verify(
            trusted.signed_header,
            trusted.validator_set,
            lb.signed_header,
            lb.validator_set,
            self.config.trust_period,
            now,
            self.config.max_clock_drift,
            Fraction(1, 3),
            device=self.device,
        )
        return lb

    def _build_state(self, snapshot: abci.Snapshot) -> Tuple[State, LightBlock]:
        """stateprovider.go State(): state at the snapshot height from
        three verified light blocks (h, h+1, h+2)."""
        cfg = self.config
        h = snapshot.height
        anchor = self._fetch_light_block(cfg.trust_height)
        if cfg.trust_hash and anchor.signed_header.header.hash() != cfg.trust_hash:
            raise SyncAbortedError(
                f"trust hash mismatch at height {cfg.trust_height}"
            )
        base = self._verified_light_block(h, anchor) if h != cfg.trust_height else anchor
        nxt = self._verified_light_block(h + 1, base)
        nxt2 = self._verified_light_block(h + 2, nxt)
        params = self._fetch_params(h + 1)

        state = State(
            version=Consensus(
                block=base.signed_header.header.version.block,
                app=base.signed_header.header.version.app,
            ),
            chain_id=self.genesis.chain_id,
            initial_height=self.genesis.initial_height,
            last_block_height=h,
            last_block_id=base.signed_header.commit.block_id,
            last_block_time=base.signed_header.header.time,
            next_validators=nxt2.validator_set,
            validators=nxt.validator_set,
            last_validators=base.validator_set,
            last_height_validators_changed=h + 1,
            consensus_params=params,
            last_height_consensus_params_changed=h + 1,
            last_results_hash=nxt.signed_header.header.last_results_hash,
            app_hash=nxt.signed_header.header.app_hash,
        )
        return state, base

    # --- chunk restore --------------------------------------------------------

    def _restore_chunks(self, snapshot: abci.Snapshot, peers: List[str]) -> bool:
        """4 concurrent fetchers + in-order apply (syncer.go:389-533).
        True = app fully restored; False = app rejected the snapshot and
        wiped its own state (safe to try another). Raises on timeout
        (app not yet mutated — chunks only land at the final apply)."""
        with self._cond:
            self._chunks = {i: None for i in range(snapshot.chunks)}
            self._chunk_target = (snapshot.height, snapshot.format)
        stop = threading.Event()
        next_req = {"i": 0}

        def fetcher(worker: int) -> None:
            # Runs until the applier stops it — chunks can be re-nulled by
            # APPLY_CHUNK_RETRY/RETRY_SNAPSHOT after all of them arrived,
            # so "nothing pending" only means idle, never done.
            while not stop.is_set():
                with self._cond:
                    pending = [i for i, c in self._chunks.items() if c is None]
                    if pending:
                        i = pending[next_req["i"] % len(pending)]
                        next_req["i"] += 1
                    else:
                        i = None
                if i is not None:
                    peer = peers[(worker + next_req["i"]) % len(peers)]
                    self.reactor.request_chunk(
                        peer, snapshot.height, snapshot.format, i
                    )
                with self._cond:
                    self._cond.wait(0.3)

        threads = [
            threading.Thread(target=fetcher, args=(w,), daemon=True)
            for w in range(min(self.config.chunk_fetchers, max(len(peers), 1)))
        ]
        for t in threads:
            t.start()
        try:
            deadline = time.monotonic() + self.config.chunk_timeout * snapshot.chunks
            applied = 0
            while applied < snapshot.chunks:
                if time.monotonic() > deadline:
                    raise SyncAbortedError("chunk fetch timed out")
                with self._cond:
                    body = self._chunks.get(applied)
                    if body is None:
                        self._cond.wait(0.25)
                        continue
                res = self.app.apply_snapshot_chunk(
                    abci.RequestApplySnapshotChunk(index=applied, chunk=body)
                )
                if res.result == abci.APPLY_CHUNK_ACCEPT:
                    applied += 1
                elif res.result == abci.APPLY_CHUNK_RETRY:
                    with self._cond:
                        self._chunks[applied] = None
                elif res.result == abci.APPLY_CHUNK_RETRY_SNAPSHOT:
                    with self._cond:
                        for i in self._chunks:
                            self._chunks[i] = None
                    applied = 0
                else:
                    return False  # rejected/aborted; app wiped its state
                for i in res.refetch_chunks:
                    with self._cond:
                        self._chunks[i] = None
            return True
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=1)
            with self._cond:
                self._chunk_target = None

    # --- backfill -------------------------------------------------------------

    def _backfill(self, base: LightBlock) -> None:
        """Verify headers backwards from the snapshot height so evidence
        within the window can be validated (reactor.go Backfill:416)."""
        base_height = base.signed_header.header.height
        stop_at = max(base_height - self.config.backfill_blocks, 1)
        trusted = base
        for height in range(base_height - 1, stop_at - 1, -1):
            lb = self._fetch_light_block(height)
            light_verifier.verify_backwards(
                lb.signed_header.header, trusted.signed_header.header
            )
            self.backfilled[height] = lb
            self.state_store._save_validators(height, height, lb.validator_set)
            trusted = lb

    # --- the main entry -------------------------------------------------------

    def sync(self, timeout: float = 60.0) -> State:
        """Discover, restore, bootstrap; returns the bootstrapped state."""
        self.install()
        deadline = time.monotonic() + timeout
        self.reactor.request_snapshots()
        time.sleep(self.config.discovery_time)

        tried: Set[_SnapKey] = set()
        last_err: Optional[Exception] = None
        while time.monotonic() < deadline:
            with self._mtx:
                candidates = sorted(
                    (k for k in self._snapshots if k not in tried),
                    key=lambda k: (-k[0], k[1]),
                )
                peers_by_key = {k: sorted(self._snapshots[k]) for k in candidates}
            if not candidates:
                self.reactor.request_snapshots()
                time.sleep(0.5)
                continue
            key = candidates[0]
            tried.add(key)
            snapshot = abci.Snapshot(
                height=key[0], format=key[1], chunks=key[3], hash=key[2]
            )
            try:
                state, base_lb = self._build_state(snapshot)
                res = self.app.offer_snapshot(
                    abci.RequestOfferSnapshot(
                        snapshot=snapshot, app_hash=state.app_hash
                    )
                )
                if res.result != abci.OFFER_SNAPSHOT_ACCEPT:
                    raise SyncAbortedError(f"snapshot offer result {res.result}")
                restored = self._restore_chunks(snapshot, peers_by_key[key])
            except (SyncAbortedError, light_verifier.InvalidHeaderError) as e:
                last_err = e
                continue
            if not restored:
                # The app rejected the assembled payload (bad hash / bad
                # content) and wiped its state — another snapshot is safe.
                last_err = SyncAbortedError("snapshot rejected by app")
                continue
            # The app now holds restored state: any failure past this
            # point is fatal (retrying onto mutated state is unsound).
            try:
                self._verify_app(state)
                self.state_store.bootstrap(state)
                self.block_store.save_seen_commit(base_lb.signed_header.commit)
                if self.config.backfill_blocks > 0:
                    self._backfill(base_lb)
            except DEVICE_ERRORS:
                raise
            except Exception as e:
                raise StateSyncFatalError(
                    f"post-restore state sync failure at height "
                    f"{snapshot.height}: {e}"
                ) from e
            return state
        raise NoSnapshotError(f"state sync failed: {last_err}")

    def _verify_app(self, state: State) -> None:
        """syncer.go verifyApp:535: Info must report the restored height
        and the trusted app hash."""
        info = self.app.info(abci.RequestInfo())
        if info.last_block_app_hash != state.app_hash:
            raise SyncAbortedError(
                f"restored app hash {info.last_block_app_hash.hex()} != "
                f"trusted {state.app_hash.hex()}"
            )
        if info.last_block_height != state.last_block_height:
            raise SyncAbortedError(
                f"restored app height {info.last_block_height} != "
                f"{state.last_block_height}"
            )
