"""ABCI clients (abci/client/client.go).

A copy of ``tendermint_tpu/abci/client.py``: the client contract (one
method per ABCI call plus lifecycle, the statesync connection's four
included) and ``LocalClient``, an in-process Application behind a mutex
as in abci/client/local_client.go:40 (the app sees serialized calls).
The socket and gRPC transports are ``socket_client.py`` and
``grpc_client.py``.
"""

from __future__ import annotations

import threading

from tendermint_tpu_torch.abci import types as abci


class AbciClient:
    """abci/client/client.go:25: transport-agnostic client contract."""

    def start(self) -> None:
        pass

    def stop(self) -> None:
        pass

    def is_running(self) -> bool:
        return True

    def echo(self, msg: str) -> str:
        raise NotImplementedError

    def info(self, req: abci.RequestInfo) -> abci.ResponseInfo:
        raise NotImplementedError

    def query(self, req: abci.RequestQuery) -> abci.ResponseQuery:
        raise NotImplementedError

    def check_tx(self, req: abci.RequestCheckTx) -> abci.ResponseCheckTx:
        raise NotImplementedError

    def init_chain(self, req: abci.RequestInitChain) -> abci.ResponseInitChain:
        raise NotImplementedError

    def prepare_proposal(
        self, req: abci.RequestPrepareProposal
    ) -> abci.ResponsePrepareProposal:
        raise NotImplementedError

    def process_proposal(
        self, req: abci.RequestProcessProposal
    ) -> abci.ResponseProcessProposal:
        raise NotImplementedError

    def extend_vote(self, req: abci.RequestExtendVote) -> abci.ResponseExtendVote:
        raise NotImplementedError

    def verify_vote_extension(
        self, req: abci.RequestVerifyVoteExtension
    ) -> abci.ResponseVerifyVoteExtension:
        raise NotImplementedError

    def finalize_block(
        self, req: abci.RequestFinalizeBlock
    ) -> abci.ResponseFinalizeBlock:
        raise NotImplementedError

    def commit(self) -> abci.ResponseCommit:
        raise NotImplementedError

    def list_snapshots(
        self, req: abci.RequestListSnapshots
    ) -> abci.ResponseListSnapshots:
        raise NotImplementedError

    def offer_snapshot(
        self, req: abci.RequestOfferSnapshot
    ) -> abci.ResponseOfferSnapshot:
        raise NotImplementedError

    def load_snapshot_chunk(
        self, req: abci.RequestLoadSnapshotChunk
    ) -> abci.ResponseLoadSnapshotChunk:
        raise NotImplementedError

    def apply_snapshot_chunk(
        self, req: abci.RequestApplySnapshotChunk
    ) -> abci.ResponseApplySnapshotChunk:
        raise NotImplementedError


class LocalClient(AbciClient):
    """In-process app behind one mutex (abci/client/local_client.go:40)."""

    def __init__(self, app: abci.Application):
        self._app = app
        self._mtx = threading.Lock()
        self._running = False

    def start(self) -> None:
        self._running = True

    def stop(self) -> None:
        self._running = False

    def is_running(self) -> bool:
        return self._running

    def echo(self, msg: str) -> str:
        return msg

    def info(self, req):
        with self._mtx:
            return self._app.info(req)

    def query(self, req):
        with self._mtx:
            return self._app.query(req)

    def check_tx(self, req):
        with self._mtx:
            return self._app.check_tx(req)

    def init_chain(self, req):
        with self._mtx:
            return self._app.init_chain(req)

    def prepare_proposal(self, req):
        with self._mtx:
            return self._app.prepare_proposal(req)

    def process_proposal(self, req):
        with self._mtx:
            return self._app.process_proposal(req)

    def extend_vote(self, req):
        with self._mtx:
            return self._app.extend_vote(req)

    def verify_vote_extension(self, req):
        with self._mtx:
            return self._app.verify_vote_extension(req)

    def finalize_block(self, req):
        with self._mtx:
            return self._app.finalize_block(req)

    def commit(self):
        with self._mtx:
            return self._app.commit()

    def list_snapshots(self, req):
        with self._mtx:
            return self._app.list_snapshots(req)

    def offer_snapshot(self, req):
        with self._mtx:
            return self._app.offer_snapshot(req)

    def load_snapshot_chunk(self, req):
        with self._mtx:
            return self._app.load_snapshot_chunk(req)

    def apply_snapshot_chunk(self, req):
        with self._mtx:
            return self._app.apply_snapshot_chunk(req)
