"""ABCI++ request/response types and the Application interface.

A copy of ``tendermint_tpu/abci/types.py``, mirroring
abci/types/application.go:8-34 (14 methods over four logical
connections: info/query, mempool, consensus, statesync) and the message
structs from proto/tendermint/abci/types.proto that those methods carry.
Requests/responses are dataclasses; wire marshalling lives with the
socket and gRPC transports (``abci/codec.py``), not here.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import List, Optional

from tendermint_tpu_torch.crypto.keys import pubkey_from_type_and_bytes
from tendermint_tpu_torch.encoding.canonical import Timestamp
from tendermint_tpu_torch.encoding.proto import encode_bytes_field, encode_varint_field
from tendermint_tpu_torch.types.block import GO_ZERO_TIME
from tendermint_tpu_torch.types.validator import Validator

CODE_TYPE_OK = 0

VERIFY_VOTE_EXTENSION_ACCEPT = 1
VERIFY_VOTE_EXTENSION_REJECT = 2

PROCESS_PROPOSAL_ACCEPT = 1
PROCESS_PROPOSAL_REJECT = 2

CHECK_TX_TYPE_NEW = 0
CHECK_TX_TYPE_RECHECK = 1

# ResponseOfferSnapshot / ResponseApplySnapshotChunk result enums
OFFER_SNAPSHOT_ACCEPT = 1
OFFER_SNAPSHOT_ABORT = 2
OFFER_SNAPSHOT_REJECT = 3
OFFER_SNAPSHOT_REJECT_FORMAT = 4
OFFER_SNAPSHOT_REJECT_SENDER = 5

APPLY_CHUNK_ACCEPT = 1
APPLY_CHUNK_ABORT = 2
APPLY_CHUNK_RETRY = 3
APPLY_CHUNK_RETRY_SNAPSHOT = 4
APPLY_CHUNK_REJECT_SNAPSHOT = 5


# --- shared sub-messages ----------------------------------------------------


@dataclass
class ValidatorUpdate:
    """abci.ValidatorUpdate: pubkey + power (power 0 removes)."""

    pub_key_type: str
    pub_key_bytes: bytes
    power: int

    def to_validator(self) -> Validator:
        return Validator(
            pubkey_from_type_and_bytes(self.pub_key_type, self.pub_key_bytes),
            self.power,
        )


@dataclass
class VoteInfo:
    """abci.VoteInfo: who signed the last commit."""

    validator_address: bytes
    validator_power: int
    signed_last_block: bool


@dataclass
class ExtendedVoteInfo:
    validator_address: bytes
    validator_power: int
    signed_last_block: bool
    vote_extension: bytes = b""
    extension_signature: bytes = b""


@dataclass
class CommitInfo:
    round: int = 0
    votes: List[VoteInfo] = dc_field(default_factory=list)


@dataclass
class ExtendedCommitInfo:
    round: int = 0
    votes: List[ExtendedVoteInfo] = dc_field(default_factory=list)


@dataclass
class Misbehavior:
    type: int = 0  # 1 = duplicate vote, 2 = light client attack
    validator_address: bytes = b""
    validator_power: int = 0
    height: int = 0
    time: Timestamp = GO_ZERO_TIME
    total_voting_power: int = 0


@dataclass
class EventAttribute:
    key: str
    value: str
    index: bool = False


@dataclass
class Event:
    type: str
    attributes: List[EventAttribute] = dc_field(default_factory=list)


@dataclass
class ExecTxResult:
    """abci.ExecTxResult: the deterministic result of one tx."""

    code: int = CODE_TYPE_OK
    data: bytes = b""
    log: str = ""
    info: str = ""
    gas_wanted: int = 0
    gas_used: int = 0
    events: List[Event] = dc_field(default_factory=list)
    codespace: str = ""

    def is_ok(self) -> bool:
        return self.code == CODE_TYPE_OK

    def deterministic_bytes(self) -> bytes:
        """The hashed subset {code, data, gas_wanted, gas_used} — matches
        deterministicExecTxResult (internal/state/execution.go:700-712)."""
        return (
            encode_varint_field(1, self.code)
            + encode_bytes_field(2, self.data)
            + encode_varint_field(5, self.gas_wanted)
            + encode_varint_field(6, self.gas_used)
        )


# --- requests / responses ---------------------------------------------------


@dataclass
class Snapshot:
    height: int = 0
    format: int = 0
    chunks: int = 0
    hash: bytes = b""
    metadata: bytes = b""


@dataclass
class RequestInfo:
    version: str = ""
    block_version: int = 0
    p2p_version: int = 0
    abci_version: str = ""


@dataclass
class ResponseInfo:
    data: str = ""
    version: str = ""
    app_version: int = 0
    last_block_height: int = 0
    last_block_app_hash: bytes = b""


@dataclass
class RequestQuery:
    data: bytes = b""
    path: str = ""
    height: int = 0
    prove: bool = False


@dataclass
class ResponseQuery:
    code: int = CODE_TYPE_OK
    log: str = ""
    info: str = ""
    index: int = 0
    key: bytes = b""
    value: bytes = b""
    proof_ops: List[object] = dc_field(default_factory=list)
    height: int = 0
    codespace: str = ""


@dataclass
class RequestCheckTx:
    tx: bytes = b""
    type: int = CHECK_TX_TYPE_NEW


@dataclass
class ResponseCheckTx:
    code: int = CODE_TYPE_OK
    data: bytes = b""
    gas_wanted: int = 0
    codespace: str = ""
    sender: str = ""
    priority: int = 0

    def is_ok(self) -> bool:
        return self.code == CODE_TYPE_OK


@dataclass
class RequestInitChain:
    time: Timestamp = GO_ZERO_TIME
    chain_id: str = ""
    consensus_params: Optional[object] = None  # types.params.ConsensusParams
    validators: List[ValidatorUpdate] = dc_field(default_factory=list)
    app_state_bytes: bytes = b""
    initial_height: int = 0


@dataclass
class ResponseInitChain:
    consensus_params: Optional[object] = None
    validators: List[ValidatorUpdate] = dc_field(default_factory=list)
    app_hash: bytes = b""


@dataclass
class RequestPrepareProposal:
    max_tx_bytes: int = 0
    txs: List[bytes] = dc_field(default_factory=list)
    local_last_commit: ExtendedCommitInfo = dc_field(default_factory=ExtendedCommitInfo)
    misbehavior: List[Misbehavior] = dc_field(default_factory=list)
    height: int = 0
    time: Timestamp = GO_ZERO_TIME
    next_validators_hash: bytes = b""
    proposer_address: bytes = b""


@dataclass
class ResponsePrepareProposal:
    tx_records: List["TxRecord"] = dc_field(default_factory=list)
    app_hash: bytes = b""
    tx_results: List[ExecTxResult] = dc_field(default_factory=list)
    validator_updates: List[ValidatorUpdate] = dc_field(default_factory=list)
    consensus_param_updates: Optional[object] = None


TX_RECORD_UNKNOWN = 0
TX_RECORD_UNMODIFIED = 1
TX_RECORD_ADDED = 2
TX_RECORD_REMOVED = 3


@dataclass
class TxRecord:
    action: int = TX_RECORD_UNMODIFIED
    tx: bytes = b""


@dataclass
class RequestProcessProposal:
    txs: List[bytes] = dc_field(default_factory=list)
    proposed_last_commit: CommitInfo = dc_field(default_factory=CommitInfo)
    misbehavior: List[Misbehavior] = dc_field(default_factory=list)
    hash: bytes = b""
    height: int = 0
    time: Timestamp = GO_ZERO_TIME
    next_validators_hash: bytes = b""
    proposer_address: bytes = b""


@dataclass
class ResponseProcessProposal:
    status: int = PROCESS_PROPOSAL_ACCEPT

    def is_accepted(self) -> bool:
        return self.status == PROCESS_PROPOSAL_ACCEPT


@dataclass
class RequestExtendVote:
    hash: bytes = b""
    height: int = 0


@dataclass
class ResponseExtendVote:
    vote_extension: bytes = b""


@dataclass
class RequestVerifyVoteExtension:
    hash: bytes = b""
    validator_address: bytes = b""
    height: int = 0
    vote_extension: bytes = b""


@dataclass
class ResponseVerifyVoteExtension:
    status: int = VERIFY_VOTE_EXTENSION_ACCEPT

    def is_accepted(self) -> bool:
        return self.status == VERIFY_VOTE_EXTENSION_ACCEPT


@dataclass
class RequestFinalizeBlock:
    txs: List[bytes] = dc_field(default_factory=list)
    decided_last_commit: CommitInfo = dc_field(default_factory=CommitInfo)
    misbehavior: List[Misbehavior] = dc_field(default_factory=list)
    hash: bytes = b""
    height: int = 0
    time: Timestamp = GO_ZERO_TIME
    next_validators_hash: bytes = b""
    proposer_address: bytes = b""


@dataclass
class ResponseFinalizeBlock:
    events: List[Event] = dc_field(default_factory=list)
    tx_results: List[ExecTxResult] = dc_field(default_factory=list)
    validator_updates: List[ValidatorUpdate] = dc_field(default_factory=list)
    consensus_param_updates: Optional[object] = None
    app_hash: bytes = b""


@dataclass
class ResponseCommit:
    retain_height: int = 0


# --- Application interface --------------------------------------------------


@dataclass
class RequestListSnapshots:
    pass


@dataclass
class ResponseListSnapshots:
    snapshots: List[Snapshot] = dc_field(default_factory=list)


@dataclass
class RequestOfferSnapshot:
    snapshot: Optional[Snapshot] = None
    app_hash: bytes = b""


@dataclass
class ResponseOfferSnapshot:
    result: int = OFFER_SNAPSHOT_ACCEPT


@dataclass
class RequestLoadSnapshotChunk:
    height: int = 0
    format: int = 0
    chunk: int = 0


@dataclass
class ResponseLoadSnapshotChunk:
    chunk: bytes = b""


@dataclass
class RequestApplySnapshotChunk:
    index: int = 0
    chunk: bytes = b""
    sender: str = ""


@dataclass
class ResponseApplySnapshotChunk:
    result: int = APPLY_CHUNK_ACCEPT
    refetch_chunks: List[int] = dc_field(default_factory=list)
    reject_senders: List[str] = dc_field(default_factory=list)


class Application:
    """abci/types/application.go:8-34: the 14-method state machine
    contract. Every method is synchronous here; transports add async."""

    # Info/Query connection
    def info(self, req: RequestInfo) -> ResponseInfo:
        raise NotImplementedError

    def query(self, req: RequestQuery) -> ResponseQuery:
        raise NotImplementedError

    # Mempool connection
    def check_tx(self, req: RequestCheckTx) -> ResponseCheckTx:
        raise NotImplementedError

    # Consensus connection
    def init_chain(self, req: RequestInitChain) -> ResponseInitChain:
        raise NotImplementedError

    def prepare_proposal(self, req: RequestPrepareProposal) -> ResponsePrepareProposal:
        raise NotImplementedError

    def process_proposal(self, req: RequestProcessProposal) -> ResponseProcessProposal:
        raise NotImplementedError

    def extend_vote(self, req: RequestExtendVote) -> ResponseExtendVote:
        raise NotImplementedError

    def verify_vote_extension(
        self, req: RequestVerifyVoteExtension
    ) -> ResponseVerifyVoteExtension:
        raise NotImplementedError

    def finalize_block(self, req: RequestFinalizeBlock) -> ResponseFinalizeBlock:
        raise NotImplementedError

    def commit(self) -> ResponseCommit:
        raise NotImplementedError

    # Statesync connection
    def list_snapshots(self, req: RequestListSnapshots) -> ResponseListSnapshots:
        raise NotImplementedError

    def offer_snapshot(self, req: RequestOfferSnapshot) -> ResponseOfferSnapshot:
        raise NotImplementedError

    def load_snapshot_chunk(
        self, req: RequestLoadSnapshotChunk
    ) -> ResponseLoadSnapshotChunk:
        raise NotImplementedError

    def apply_snapshot_chunk(
        self, req: RequestApplySnapshotChunk
    ) -> ResponseApplySnapshotChunk:
        raise NotImplementedError


class BaseApplication(Application):
    """No-op defaults (abci/types/application.go BaseApplication)."""

    def info(self, req: RequestInfo) -> ResponseInfo:
        return ResponseInfo()

    def query(self, req: RequestQuery) -> ResponseQuery:
        return ResponseQuery(code=CODE_TYPE_OK)

    def check_tx(self, req: RequestCheckTx) -> ResponseCheckTx:
        return ResponseCheckTx(code=CODE_TYPE_OK)

    def init_chain(self, req: RequestInitChain) -> ResponseInitChain:
        return ResponseInitChain()

    def prepare_proposal(self, req: RequestPrepareProposal) -> ResponsePrepareProposal:
        """Default: include txs unmodified up to max_tx_bytes
        (application.go:95-111)."""
        total = 0
        records = []
        for tx in req.txs:
            total += len(tx)
            if total > req.max_tx_bytes:
                break
            records.append(TxRecord(TX_RECORD_UNMODIFIED, tx))
        return ResponsePrepareProposal(tx_records=records)

    def process_proposal(self, req: RequestProcessProposal) -> ResponseProcessProposal:
        return ResponseProcessProposal(PROCESS_PROPOSAL_ACCEPT)

    def extend_vote(self, req: RequestExtendVote) -> ResponseExtendVote:
        return ResponseExtendVote()

    def verify_vote_extension(
        self, req: RequestVerifyVoteExtension
    ) -> ResponseVerifyVoteExtension:
        return ResponseVerifyVoteExtension(VERIFY_VOTE_EXTENSION_ACCEPT)

    def finalize_block(self, req: RequestFinalizeBlock) -> ResponseFinalizeBlock:
        return ResponseFinalizeBlock(
            tx_results=[ExecTxResult() for _ in req.txs]
        )

    def commit(self) -> ResponseCommit:
        return ResponseCommit()

    def list_snapshots(self, req: RequestListSnapshots) -> ResponseListSnapshots:
        return ResponseListSnapshots()

    def offer_snapshot(self, req: RequestOfferSnapshot) -> ResponseOfferSnapshot:
        return ResponseOfferSnapshot()

    def load_snapshot_chunk(
        self, req: RequestLoadSnapshotChunk
    ) -> ResponseLoadSnapshotChunk:
        return ResponseLoadSnapshotChunk()

    def apply_snapshot_chunk(
        self, req: RequestApplySnapshotChunk
    ) -> ResponseApplySnapshotChunk:
        return ResponseApplySnapshotChunk()
