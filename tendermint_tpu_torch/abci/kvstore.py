"""The canonical example/test app: a key-value store.

A copy of ``tendermint_tpu/abci/kvstore.py`` without its state-sync
snapshots (ROADMAP §A item 8f), mirroring abci/example/kvstore/kvstore.go: txs are "key=value" (or "key"
meaning key=key); "val:base64pubkey!power" txs update the validator set;
Query returns values (path "/key") with the app hash over sorted pairs.
Deterministic across restarts via an injected KVStore.
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


class KVStoreApplication(abci.BaseApplication):
    def __init__(self, db: Optional[KVStore] = None):
        self._db = db or MemDB()
        self._pending: Dict[bytes, bytes] = {}
        self._pending_val_updates: List[abci.ValidatorUpdate] = []
        self._validators: Dict[str, int] = {}  # base64 pubkey -> power
        self._height = 0
        self._app_hash = b""
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
        retain = self._height - 100 if self._height > 100 else 0
        return abci.ResponseCommit(retain_height=retain)

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
