"""BlockExecutor: the consensus <-> ABCI <-> storage bridge.

A copy of ``tendermint_tpu/state/execution.py``, mirroring
internal/state/execution.go:53-420: CreateProposalBlock (reap mempool +
evidence, ABCI PrepareProposal), ProcessProposal, ValidateBlock
(header/state linkage + LastCommit batch verification on the card),
ApplyBlock (FinalizeBlock -> state.Update -> Commit -> save), ExtendVote
and VerifyVoteExtension (the consensus state machine's calls).
``event_publisher`` (a node's ``_fire_events``) hears of every applied
block with its FinalizeBlock response and validator updates.
``BlockExecutor(device=)`` and
:func:`validate_block` take the device the LastCommit is verified on
(``validation.verify_commit``). The ``Mempool`` and ``EvidencePool``
classes here are the reference's minimal contracts and the defaults; a
node passes ``mempool/mempool.py`` ``TxMempool`` and
``evidence/pool.py`` ``EvidencePool``, whose ``check_evidence`` verifies
a block's evidence in ``validate_block``.
"""

from __future__ import annotations

import json
import time as _time
from typing import Callable, List, Optional, Tuple

from tendermint_tpu_torch.abci import types as abci
from tendermint_tpu_torch.abci.client import AbciClient
from tendermint_tpu_torch.crypto import merkle
from tendermint_tpu_torch.encoding.canonical import Timestamp
from tendermint_tpu_torch.state.state import State
from tendermint_tpu_torch.state.store import StateStore
from tendermint_tpu_torch.storage.blockstore import BlockStore
from tendermint_tpu_torch import resolve_device
from tendermint_tpu_torch.libs.metrics import StateMetrics
from tendermint_tpu_torch.types.block import (
    BLOCK_ID_FLAG_ABSENT,
    Block,
    BlockID,
    Commit,
    ExtendedCommit,
    Vote,
    make_block,
    tx_hash,
)
from tendermint_tpu_torch.types.evidence import Evidence
from tendermint_tpu_torch.types.validator import Validator


class InvalidBlockError(ValueError):
    pass


class Mempool:
    """Minimal mempool contract the executor needs
    (internal/mempool/mempool.go Mempool interface subset)."""

    def lock(self) -> None: ...

    def unlock(self) -> None: ...

    def reap_max_bytes_max_gas(self, max_bytes: int, max_gas: int) -> List[bytes]:
        return []

    def update(
        self,
        height: int,
        txs: List[bytes],
        tx_results: List[abci.ExecTxResult],
        recheck: bool = True,
    ) -> None: ...

    def remove_tx_by_key(self, key: bytes) -> None: ...

    def flush(self) -> None: ...


class EvidencePool:
    """Minimal evidence-pool contract (internal/evidence/pool.go subset)."""

    def pending_evidence(self, max_bytes: int) -> Tuple[List[Evidence], int]:
        return [], 0

    def check_evidence(self, evidence: List[Evidence]) -> None: ...

    def update(self, state: State, evidence: List[Evidence]) -> None: ...


def max_data_bytes(max_bytes: int, evidence_bytes: int, num_validators: int) -> int:
    """types/block.go MaxDataBytes: block budget minus header/commit/evidence
    overhead (approximated with the same worst-case constants)."""
    max_overhead = 1000  # header+encoding slack
    commit_overhead = 110 * num_validators
    return max(0, max_bytes - max_overhead - commit_overhead - evidence_bytes)


class BlockExecutor:
    def __init__(
        self,
        state_store: StateStore,
        app_client: AbciClient,
        block_store: BlockStore,
        mempool: Optional[Mempool] = None,
        evidence_pool: Optional[EvidencePool] = None,
        event_publisher: Optional[Callable] = None,
        now: Optional[Callable[[], Timestamp]] = None,
        metrics=None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.metrics = metrics or StateMetrics.nop()
        self.state_store = state_store
        self.app = app_client
        self.block_store = block_store
        # `is not None`, NOT truthiness: an empty TxMempool has len() == 0
        # and would be silently swapped for the no-op default.
        self.mempool = mempool if mempool is not None else Mempool()
        self.evidence_pool = (
            evidence_pool if evidence_pool is not None else EvidencePool()
        )
        self._now = now or (lambda: Timestamp.from_unix_ns(_time.time_ns()))
        self.event_publisher = event_publisher
        self._validate_cache: set = set()

    # --- proposal -----------------------------------------------------------

    def create_proposal_block(
        self,
        height: int,
        state: State,
        last_ext_commit: ExtendedCommit,
        proposer_addr: bytes,
    ) -> Block:
        """execution.go:86-143."""
        max_bytes = state.consensus_params.block.max_bytes
        max_gas = state.consensus_params.block.max_gas
        evidence, ev_size = self.evidence_pool.pending_evidence(
            state.consensus_params.evidence.max_bytes
        )
        data_budget = max_data_bytes(max_bytes, ev_size, len(state.validators))
        txs = self.mempool.reap_max_bytes_max_gas(data_budget, max_gas)
        commit = last_ext_commit.to_commit()
        block = self._make_block(state, height, txs, commit, evidence, proposer_addr)
        rpp = self.app.prepare_proposal(
            abci.RequestPrepareProposal(
                max_tx_bytes=data_budget,
                txs=list(block.data.txs),
                local_last_commit=self._build_extended_commit_info(
                    last_ext_commit, state
                ),
                misbehavior=_evidence_to_abci(evidence),
                height=height,
                time=block.header.time,
                next_validators_hash=block.header.next_validators_hash,
                proposer_address=proposer_addr,
            )
        )
        included: List[bytes] = []
        total = 0
        for rec in rpp.tx_records:
            if rec.action == abci.TX_RECORD_REMOVED:
                self.mempool.remove_tx_by_key(tx_hash(rec.tx))
                continue
            if rec.action in (abci.TX_RECORD_UNMODIFIED, abci.TX_RECORD_ADDED):
                total += len(rec.tx)
                if total > data_budget:
                    raise InvalidBlockError(
                        "PrepareProposal returned more tx bytes than the limit"
                    )
                included.append(rec.tx)
        return self._make_block(
            state, height, included, commit, evidence, proposer_addr,
            time=block.header.time,
        )

    def _make_block(
        self,
        state: State,
        height: int,
        txs: List[bytes],
        commit: Commit,
        evidence: List[Evidence],
        proposer_addr: bytes,
        time: Optional[Timestamp] = None,
    ) -> Block:
        """internal/state/state.go:264-285 MakeBlock + Header.Populate."""
        block = make_block(height, txs, commit, evidence)
        h = block.header
        h.version = state.version
        h.chain_id = state.chain_id
        h.time = time if time is not None else self._now()
        h.last_block_id = state.last_block_id
        h.validators_hash = state.validators.hash()
        h.next_validators_hash = state.next_validators.hash()
        h.consensus_hash = state.consensus_params.hash()
        h.app_hash = state.app_hash
        h.last_results_hash = state.last_results_hash
        h.proposer_address = proposer_addr
        return block

    def process_proposal(self, block: Block, state: State) -> bool:
        """execution.go:144-172."""
        resp = self.app.process_proposal(
            abci.RequestProcessProposal(
                hash=block.hash(),
                height=block.header.height,
                time=block.header.time,
                txs=list(block.data.txs),
                proposed_last_commit=self._build_last_commit_info(block, state),
                misbehavior=_evidence_to_abci(block.evidence),
                proposer_address=block.header.proposer_address,
                next_validators_hash=block.header.next_validators_hash,
            )
        )
        return resp.is_accepted()

    # --- validation ---------------------------------------------------------

    def validate_block(self, state: State, block: Block) -> None:
        """execution.go:173-198 + internal/state/validation.go:14-138."""
        hash_ = block.hash()
        if hash_ in self._validate_cache:
            return
        validate_block(state, block, device=self.device)
        self.evidence_pool.check_evidence(block.evidence)
        self._validate_cache.add(hash_)

    # --- apply --------------------------------------------------------------

    def apply_block(self, state: State, block_id: BlockID, block: Block) -> State:
        """execution.go:199-305."""
        try:
            self.validate_block(state, block)
        except ValueError as e:
            raise InvalidBlockError(str(e)) from e
        _t0 = _time.monotonic()
        fres = self.app.finalize_block(
            abci.RequestFinalizeBlock(
                hash=block.hash(),
                height=block.header.height,
                time=block.header.time,
                txs=list(block.data.txs),
                decided_last_commit=self._build_last_commit_info(block, state),
                misbehavior=_evidence_to_abci(block.evidence),
                proposer_address=block.header.proposer_address,
                next_validators_hash=block.header.next_validators_hash,
            )
        )
        # execution.go:222 block-processing latency metric
        self.metrics.block_processing_time.observe(_time.monotonic() - _t0)
        self.state_store.save_finalize_block_response(
            block.header.height, _marshal_finalize_response(fres)
        )
        validator_updates = _validate_validator_updates(
            fres.validator_updates, state.consensus_params
        )
        if validator_updates:
            self.metrics.validator_set_updates.inc()
        if fres.consensus_param_updates is not None:
            self.metrics.consensus_param_updates.inc()
        results_hash = merkle.hash_from_byte_slices(
            [r.deterministic_bytes() for r in fres.tx_results]
        )
        new_state = state.update(
            block_id,
            block.header,
            results_hash,
            fres.consensus_param_updates,
            validator_updates,
        )
        retain_height = self._commit(new_state, block, fres.tx_results)
        self.evidence_pool.update(new_state, block.evidence)
        new_state.app_hash = fres.app_hash
        self.state_store.save(new_state)
        if retain_height > 0:
            try:
                self.block_store.prune_blocks(retain_height)
            except ValueError:
                pass
        self._validate_cache = set()
        if self.event_publisher is not None:
            self.event_publisher(block, block_id, fres, validator_updates)
        return new_state

    def _commit(
        self, state: State, block: Block, tx_results: List[abci.ExecTxResult]
    ) -> int:
        """execution.go:330-380: lock mempool, ABCI Commit, mempool update."""
        self.mempool.lock()
        try:
            res = self.app.commit()
            self.mempool.update(
                block.header.height, list(block.data.txs), tx_results
            )
            return res.retain_height
        finally:
            self.mempool.unlock()

    # --- vote extensions ----------------------------------------------------

    def extend_vote(self, vote: Vote) -> bytes:
        resp = self.app.extend_vote(
            abci.RequestExtendVote(hash=vote.block_id.hash, height=vote.height)
        )
        return resp.vote_extension

    def verify_vote_extension(self, vote: Vote) -> None:
        resp = self.app.verify_vote_extension(
            abci.RequestVerifyVoteExtension(
                hash=vote.block_id.hash,
                validator_address=vote.validator_address,
                height=vote.height,
                vote_extension=vote.extension,
            )
        )
        if not resp.is_accepted():
            raise InvalidBlockError("invalid vote extension")

    # --- commit info builders ------------------------------------------------

    def _build_last_commit_info(self, block: Block, state: State) -> abci.CommitInfo:
        """execution.go:388-427."""
        if block.header.height == state.initial_height:
            return abci.CommitInfo()
        last_val_set = self.state_store.load_validators(block.header.height - 1)
        commit = block.last_commit
        if commit.size() != len(last_val_set):
            raise InvalidBlockError(
                f"commit size ({commit.size()}) doesn't match validator set "
                f"length ({len(last_val_set)}) at height {block.header.height}"
            )
        votes = [
            abci.VoteInfo(
                validator_address=val.address,
                validator_power=val.voting_power,
                signed_last_block=sig.block_id_flag != BLOCK_ID_FLAG_ABSENT,
            )
            for val, sig in zip(last_val_set.validators, commit.signatures)
        ]
        return abci.CommitInfo(round=commit.round, votes=votes)

    def _build_extended_commit_info(
        self, ec: ExtendedCommit, state: State
    ) -> abci.ExtendedCommitInfo:
        """execution.go buildExtendedCommitInfo."""
        if ec.height < state.initial_height:
            return abci.ExtendedCommitInfo()
        val_set = self.state_store.load_validators(ec.height)
        extensions_enabled = state.consensus_params.abci.vote_extensions_enabled(
            ec.height
        )
        votes = []
        for val, esig in zip(val_set.validators, ec.extended_signatures):
            sig = esig.commit_sig
            if extensions_enabled and sig.block_id_flag != BLOCK_ID_FLAG_ABSENT:
                ext, ext_sig = esig.extension, esig.extension_signature
            else:
                ext, ext_sig = b"", b""
            votes.append(
                abci.ExtendedVoteInfo(
                    validator_address=val.address,
                    validator_power=val.voting_power,
                    signed_last_block=sig.block_id_flag != BLOCK_ID_FLAG_ABSENT,
                    vote_extension=ext,
                    extension_signature=ext_sig,
                )
            )
        return abci.ExtendedCommitInfo(round=ec.round, votes=votes)


def validate_block(state: State, block: Block, device=None) -> None:
    """internal/state/validation.go:14-138. The LastCommit check routes
    through the batch verifier on ``device`` (the card from 16 lanes, the
    host oracle below)."""
    block.validate_basic()
    if (
        block.header.version.app != state.version.app
        or block.header.version.block != state.version.block
    ):
        raise ValueError(
            f"wrong Block.Header.Version. Expected {state.version}, got "
            f"{block.header.version}"
        )
    if block.header.chain_id != state.chain_id:
        raise ValueError(
            f"wrong Block.Header.ChainID. Expected {state.chain_id}, got "
            f"{block.header.chain_id}"
        )
    if state.last_block_height == 0 and block.header.height != state.initial_height:
        raise ValueError(
            f"wrong Block.Header.Height. Expected {state.initial_height} for "
            f"initial block, got {block.header.height}"
        )
    if (
        state.last_block_height > 0
        and block.header.height != state.last_block_height + 1
    ):
        raise ValueError(
            f"wrong Block.Header.Height. Expected {state.last_block_height + 1}, "
            f"got {block.header.height}"
        )
    if block.header.last_block_id != state.last_block_id:
        raise ValueError(
            f"wrong Block.Header.LastBlockID. Expected {state.last_block_id}, "
            f"got {block.header.last_block_id}"
        )
    if block.header.app_hash != state.app_hash:
        raise ValueError("wrong Block.Header.AppHash")
    if block.header.consensus_hash != state.consensus_params.hash():
        raise ValueError("wrong Block.Header.ConsensusHash")
    if block.header.last_results_hash != state.last_results_hash:
        raise ValueError("wrong Block.Header.LastResultsHash")
    if block.header.validators_hash != state.validators.hash():
        raise ValueError("wrong Block.Header.ValidatorsHash")
    if block.header.next_validators_hash != state.next_validators.hash():
        raise ValueError("wrong Block.Header.NextValidatorsHash")

    if block.header.height == state.initial_height:
        if block.last_commit.signatures:
            raise ValueError("initial block can't have LastCommit signatures")
    else:
        state.last_validators.verify_commit(
            state.chain_id,
            state.last_block_id,
            block.header.height - 1,
            block.last_commit,
            device=device,
        )

    if not state.validators.has_address(block.header.proposer_address):
        raise ValueError(
            f"block.Header.ProposerAddress {block.header.proposer_address.hex()} "
            "is not a validator"
        )

    if block.header.height > state.initial_height:
        if block.header.time.to_unix_ns() <= state.last_block_time.to_unix_ns():
            raise ValueError(
                f"block time {block.header.time} not greater than last block "
                f"time {state.last_block_time}"
            )
    elif block.header.height == state.initial_height:
        if block.header.time.to_unix_ns() < state.last_block_time.to_unix_ns():
            raise ValueError("block time is before genesis time")
    else:
        raise ValueError(
            f"block height {block.header.height} lower than initial height "
            f"{state.initial_height}"
        )
    ev_bytes = sum(len(ev.bytes()) for ev in block.evidence)
    if ev_bytes > state.consensus_params.evidence.max_bytes:
        raise ValueError("evidence exceeds max bytes")


def _validate_validator_updates(
    updates: List[abci.ValidatorUpdate], params
) -> List[Validator]:
    """execution.go validateValidatorUpdates + PB2TM conversion."""
    out = []
    for vu in updates:
        if vu.power < 0:
            raise ValueError(f"voting power can't be negative: {vu}")
        if vu.power == 0:
            pass  # removal
        if vu.pub_key_type not in params.validator.pub_key_types:
            raise ValueError(
                f"validator {vu} is using pubkey {vu.pub_key_type}, which is "
                "unsupported for consensus"
            )
        out.append(vu.to_validator())
    return out


def _evidence_to_abci(evidence: List[Evidence]) -> List[abci.Misbehavior]:
    out = []
    for ev in evidence:
        for m in ev.abci():
            out.append(
                abci.Misbehavior(
                    type=m["type"],
                    validator_address=m["validator"]["address"],
                    validator_power=m["validator"]["power"],
                    height=m["height"],
                    time=m["time"],
                    total_voting_power=m["total_voting_power"],
                )
            )
    return out


def _events_to_json(events: List[abci.Event]) -> list:
    return [
        {
            "type": e.type,
            "attributes": [
                {"key": a.key, "value": a.value, "index": a.index}
                for a in e.attributes
            ],
        }
        for e in events
    ]


def _events_from_json(data: list) -> List[abci.Event]:
    return [
        abci.Event(
            type=e["type"],
            attributes=[
                abci.EventAttribute(
                    key=a["key"], value=a["value"], index=a.get("index", False)
                )
                for a in e["attributes"]
            ],
        )
        for e in data
    ]


def _unmarshal_finalize_response(raw: bytes) -> abci.ResponseFinalizeBlock:
    """Inverse of _marshal_finalize_response (RPC /block_results and
    index rebuilds read the full persisted response back)."""
    d = json.loads(raw.decode())
    return abci.ResponseFinalizeBlock(
        app_hash=bytes.fromhex(d["app_hash"]),
        events=_events_from_json(d.get("events", [])),
        tx_results=[
            abci.ExecTxResult(
                code=r["code"],
                data=bytes.fromhex(r["data"]),
                log=r.get("log", ""),
                info=r.get("info", ""),
                gas_wanted=r["gas_wanted"],
                gas_used=r["gas_used"],
                events=_events_from_json(r.get("events", [])),
                codespace=r.get("codespace", ""),
            )
            for r in d["tx_results"]
        ],
        validator_updates=[
            abci.ValidatorUpdate(
                pub_key_type=vu["type"],
                pub_key_bytes=bytes.fromhex(vu["pub_key"]),
                power=vu["power"],
            )
            for vu in d["validator_updates"]
        ],
    )


def _marshal_finalize_response(fres: abci.ResponseFinalizeBlock) -> bytes:
    """Persistence of the FinalizeBlock response for replay, /block_results,
    and index rebuilds (store.go SaveFinalizeBlockResponses). Events and
    logs are retained — ABCI-event consumers (indexer/relayers) depend on
    /block_results carrying them."""
    return json.dumps(
        {
            "app_hash": fres.app_hash.hex(),
            "events": _events_to_json(fres.events),
            "tx_results": [
                {
                    "code": r.code,
                    "data": r.data.hex(),
                    "log": r.log,
                    "info": r.info,
                    "gas_wanted": r.gas_wanted,
                    "gas_used": r.gas_used,
                    "events": _events_to_json(r.events),
                    "codespace": r.codespace,
                }
                for r in fres.tx_results
            ],
            "validator_updates": [
                {
                    "type": vu.pub_key_type,
                    "pub_key": vu.pub_key_bytes.hex(),
                    "power": vu.power,
                }
                for vu in fres.validator_updates
            ],
        }
    ).encode()
