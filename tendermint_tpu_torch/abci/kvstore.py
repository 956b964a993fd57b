"""The canonical example/test app: a merkle key-value store.

A copy of ``tendermint_tpu/abci/kvstore.py``, mirroring
abci/example/kvstore/kvstore.go: txs are "key=value" (or "key"
meaning key=key); "val:base64pubkey!power" txs update the validator set;
Query returns values (path "/key") with the app hash over sorted pairs.
Deterministic across restarts via an injected KVStore. With
``snapshot_interval`` it takes a state-sync snapshot every that many
heights: the whole state as sorted JSON, cut into 4,096-byte chunks,
the same bytes as the reference's.
"""

from __future__ import annotations

import base64
import hashlib
import json
from typing import Dict, List, Optional

from tendermint_tpu_torch.abci import types as abci
from tendermint_tpu_torch.storage.kv import KVStore, MemDB

VALIDATOR_TX_PREFIX = "val:"

CODE_TYPE_INVALID_TX_FORMAT = 1
CODE_TYPE_BANNED = 2
CODE_TYPE_UNKNOWN_ERROR = 3


SNAPSHOT_CHUNK_SIZE = 4096  # small so tests exercise multi-chunk flows
SNAPSHOTS_KEPT = 3


class KVStoreApplication(abci.BaseApplication):
    def __init__(self, db: Optional[KVStore] = None, snapshot_interval: int = 0):
        self._db = db or MemDB()
        self._pending: Dict[bytes, bytes] = {}
        self._pending_val_updates: List[abci.ValidatorUpdate] = []
        self._validators: Dict[str, int] = {}  # base64 pubkey -> power
        self._height = 0
        self._app_hash = b""
        # State-sync snapshots (the e2e app's snapshots.go role): payload
        # is the full serialized state, split into fixed-size chunks.
        self._snapshot_interval = snapshot_interval
        self._snapshots: Dict[int, tuple] = {}  # height -> (Snapshot, chunks)
        self._restoring: Optional[tuple] = None  # (Snapshot, app_hash, chunks)
        self._restore()

    # --- state management ---------------------------------------------------

    def _save_meta(self) -> None:
        self._db.set(
            b"__meta__",
            json.dumps(
                {
                    "height": self._height,
                    "app_hash": self._app_hash.hex(),
                    "validators": self._validators,
                }
            ).encode(),
        )

    def _restore(self) -> None:
        raw = self._db.get(b"__meta__")
        if raw is not None:
            meta = json.loads(raw.decode())
            self._height = meta["height"]
            self._app_hash = bytes.fromhex(meta["app_hash"])
            self._validators = meta.get("validators", {})

    def _compute_app_hash(self) -> bytes:
        h = hashlib.sha256()
        h.update(self._height.to_bytes(8, "big"))
        for k, v in self._db.iterator():
            if k.startswith(b"__"):
                continue
            h.update(len(k).to_bytes(4, "big") + k)
            h.update(len(v).to_bytes(4, "big") + v)
        for pk in sorted(self._validators):
            h.update(pk.encode() + self._validators[pk].to_bytes(8, "big"))
        return h.digest()

    # --- tx handling --------------------------------------------------------

    @staticmethod
    def _parse_tx(tx: bytes):
        """Returns (key, value) or raises ValueError."""
        text = tx.decode("utf-8", errors="strict")
        if text.startswith(VALIDATOR_TX_PREFIX):
            body = text[len(VALIDATOR_TX_PREFIX):]
            pubkey_b64, _, power_s = body.partition("!")
            if not pubkey_b64 or not power_s:
                raise ValueError("validator tx must be val:pubkey!power")
            base64.b64decode(pubkey_b64, validate=True)
            int(power_s)
            return None, None
        if "=" in text:
            key, _, value = text.partition("=")
        else:
            key = value = text
        if not key:
            raise ValueError("empty key")
        return key.encode(), value.encode()

    def check_tx(self, req: abci.RequestCheckTx) -> abci.ResponseCheckTx:
        try:
            self._parse_tx(req.tx)
        except ValueError:
            return abci.ResponseCheckTx(code=CODE_TYPE_INVALID_TX_FORMAT)
        return abci.ResponseCheckTx(code=abci.CODE_TYPE_OK, gas_wanted=1)

    def _exec_tx(self, tx: bytes) -> abci.ExecTxResult:
        try:
            text = tx.decode("utf-8")
            if text.startswith(VALIDATOR_TX_PREFIX):
                body = text[len(VALIDATOR_TX_PREFIX):]
                pubkey_b64, _, power_s = body.partition("!")
                power = int(power_s)
                raw = base64.b64decode(pubkey_b64, validate=True)
                if power == 0:
                    self._validators.pop(pubkey_b64, None)
                else:
                    self._validators[pubkey_b64] = power
                self._pending_val_updates.append(
                    abci.ValidatorUpdate("ed25519", raw, power)
                )
                return abci.ExecTxResult(
                    events=[
                        abci.Event(
                            "val_update",
                            [abci.EventAttribute("power", power_s, True)],
                        )
                    ]
                )
            key, value = self._parse_tx(tx)
            self._pending[key] = value
            return abci.ExecTxResult(
                events=[
                    abci.Event(
                        "app",
                        [
                            abci.EventAttribute("key", key.decode(), True),
                            abci.EventAttribute("creator", "kvstore", True),
                        ],
                    )
                ]
            )
        except ValueError:
            return abci.ExecTxResult(code=CODE_TYPE_INVALID_TX_FORMAT)

    # --- consensus connection -----------------------------------------------

    def init_chain(self, req: abci.RequestInitChain) -> abci.ResponseInitChain:
        for vu in req.validators:
            self._validators[base64.b64encode(vu.pub_key_bytes).decode()] = vu.power
        if req.app_state_bytes:
            state = json.loads(req.app_state_bytes.decode() or "{}")
            for k, v in (state or {}).items():
                self._db.set(k.encode(), str(v).encode())
        self._height = 0
        self._app_hash = self._compute_app_hash()
        return abci.ResponseInitChain(app_hash=self._app_hash)

    def process_proposal(
        self, req: abci.RequestProcessProposal
    ) -> abci.ResponseProcessProposal:
        for tx in req.txs:
            try:
                self._parse_tx(tx)
            except ValueError:
                return abci.ResponseProcessProposal(abci.PROCESS_PROPOSAL_REJECT)
        return abci.ResponseProcessProposal(abci.PROCESS_PROPOSAL_ACCEPT)

    def finalize_block(
        self, req: abci.RequestFinalizeBlock
    ) -> abci.ResponseFinalizeBlock:
        self._pending = {}
        self._pending_val_updates = []
        results = [self._exec_tx(tx) for tx in req.txs]
        # Stage writes so the app hash reflects this block pre-commit.
        for k, v in self._pending.items():
            self._db.set(k, v)
        self._height = req.height
        self._app_hash = self._compute_app_hash()
        return abci.ResponseFinalizeBlock(
            tx_results=results,
            validator_updates=list(self._pending_val_updates),
            app_hash=self._app_hash,
        )

    def commit(self) -> abci.ResponseCommit:
        self._save_meta()
        if self._snapshot_interval and self._height % self._snapshot_interval == 0:
            self._take_snapshot()
        retain = self._height - 100 if self._height > 100 else 0
        return abci.ResponseCommit(retain_height=retain)

    # --- state-sync snapshots -------------------------------------------------

    def _serialize_state(self) -> bytes:
        pairs = {
            k.hex(): v.hex()
            for k, v in self._db.iterator()
            if not k.startswith(b"__")
        }
        return json.dumps(
            {
                "height": self._height,
                "app_hash": self._app_hash.hex(),
                "validators": self._validators,
                "pairs": pairs,
            },
            sort_keys=True,
        ).encode()

    def _take_snapshot(self) -> None:
        payload = self._serialize_state()
        chunks = [
            payload[i : i + SNAPSHOT_CHUNK_SIZE]
            for i in range(0, max(len(payload), 1), SNAPSHOT_CHUNK_SIZE)
        ]
        snap = abci.Snapshot(
            height=self._height,
            format=1,
            chunks=len(chunks),
            hash=hashlib.sha256(payload).digest(),
        )
        self._snapshots[self._height] = (snap, chunks)
        for h in sorted(self._snapshots):
            if len(self._snapshots) <= SNAPSHOTS_KEPT:
                break
            del self._snapshots[h]

    def list_snapshots(self, req) -> abci.ResponseListSnapshots:
        return abci.ResponseListSnapshots(
            snapshots=[s for s, _ in self._snapshots.values()]
        )

    def load_snapshot_chunk(self, req) -> abci.ResponseLoadSnapshotChunk:
        ent = self._snapshots.get(req.height)
        if ent is None or req.format != 1 or not (0 <= req.chunk < len(ent[1])):
            return abci.ResponseLoadSnapshotChunk(chunk=b"")
        return abci.ResponseLoadSnapshotChunk(chunk=ent[1][req.chunk])

    # Bound attacker-controlled chunk counts (a hostile Snapshot message
    # must not drive a multi-GB allocation; 16384 * 4 KB = 64 MB state).
    MAX_SNAPSHOT_CHUNKS = 16384

    def offer_snapshot(self, req) -> abci.ResponseOfferSnapshot:
        snap = req.snapshot
        if (
            snap is None
            or snap.format != 1
            or not (0 < snap.chunks <= self.MAX_SNAPSHOT_CHUNKS)
        ):
            return abci.ResponseOfferSnapshot(result=abci.OFFER_SNAPSHOT_REJECT_FORMAT)
        self._restoring = (snap, req.app_hash, [None] * snap.chunks)
        return abci.ResponseOfferSnapshot(result=abci.OFFER_SNAPSHOT_ACCEPT)

    def apply_snapshot_chunk(self, req) -> abci.ResponseApplySnapshotChunk:
        if self._restoring is None:
            return abci.ResponseApplySnapshotChunk(result=abci.APPLY_CHUNK_ABORT)
        snap, trusted_app_hash, chunks = self._restoring
        if not (0 <= req.index < len(chunks)):
            return abci.ResponseApplySnapshotChunk(result=abci.APPLY_CHUNK_RETRY)
        chunks[req.index] = req.chunk
        if any(c is None for c in chunks):
            return abci.ResponseApplySnapshotChunk(result=abci.APPLY_CHUNK_ACCEPT)
        payload = b"".join(chunks)
        if hashlib.sha256(payload).digest() != snap.hash:
            # A bad chunk poisoned the payload: restart the snapshot.
            self._restoring = (snap, trusted_app_hash, [None] * snap.chunks)
            return abci.ResponseApplySnapshotChunk(
                result=abci.APPLY_CHUNK_RETRY_SNAPSHOT
            )
        state = json.loads(payload.decode())
        for k, _ in list(self._db.iterator()):
            self._db.delete(k)
        for k_hex, v_hex in state["pairs"].items():
            self._db.set(bytes.fromhex(k_hex), bytes.fromhex(v_hex))
        self._height = state["height"]
        self._validators = state["validators"]
        # RECOMPUTE the app hash from the restored pairs — the payload's
        # own app_hash field is attacker-controlled; only a hash derived
        # from the actual state may be compared against the light-client-
        # verified one (the forged-pairs-with-real-hash attack).
        self._app_hash = self._compute_app_hash()
        if trusted_app_hash and self._app_hash != trusted_app_hash:
            # Wipe the poisoned restore; the node retries another snapshot.
            for k, _ in list(self._db.iterator()):
                self._db.delete(k)
            self._height = 0
            self._app_hash = b""
            self._validators = {}
            self._restoring = None
            return abci.ResponseApplySnapshotChunk(
                result=abci.APPLY_CHUNK_REJECT_SNAPSHOT
            )
        self._save_meta()
        self._restoring = None
        return abci.ResponseApplySnapshotChunk(result=abci.APPLY_CHUNK_ACCEPT)

    # --- info/query ---------------------------------------------------------

    def info(self, req: abci.RequestInfo) -> abci.ResponseInfo:
        return abci.ResponseInfo(
            data=json.dumps({"size": self._height}),
            version="0.1.0",
            app_version=1,
            last_block_height=self._height,
            last_block_app_hash=self._app_hash,
        )

    def query(self, req: abci.RequestQuery) -> abci.ResponseQuery:
        if req.path == "/val":
            return abci.ResponseQuery(
                code=abci.CODE_TYPE_OK,
                value=json.dumps(self._validators).encode(),
                height=self._height,
            )
        key = req.data
        value = self._db.get(key)
        return abci.ResponseQuery(
            code=abci.CODE_TYPE_OK,
            key=key,
            value=value or b"",
            log="exists" if value is not None else "does not exist",
            height=self._height,
        )
