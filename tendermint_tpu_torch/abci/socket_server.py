"""ABCI socket server: serve an Application to out-of-process nodes.

A copy of ``tendermint_tpu/abci/socket_server.py``: the mirror of
abci/server/socket_server.go:317 — accept loop, one handler thread per
connection, requests dispatched to the app behind a global mutex (apps
see serialized calls, exactly the LocalClient contract), responses
written in request order. Runnable as a process, over the socket or the
gRPC transport:

    python -m tendermint_tpu_torch.abci.socket_server --addr 127.0.0.1:26658 \
        [--transport socket|grpc] --app kvstore [--db /path/state.fdb] \
        [--snapshot-interval N]

It prints ``abci server listening on HOST:PORT`` once it serves.
"""

from __future__ import annotations

import socket
import threading
from typing import Optional

from tendermint_tpu_torch.abci import codec
from tendermint_tpu_torch.abci import types as abci


class SocketServer:
    def __init__(self, app: abci.Application, host: str = "127.0.0.1", port: int = 0):
        self.app = app
        self._app_mtx = threading.Lock()
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(8)
        self._stop_flag = threading.Event()
        self._threads = []

    @property
    def address(self):
        return self._listener.getsockname()[:2]

    def start(self) -> None:
        t = threading.Thread(target=self._accept_loop, daemon=True)
        t.start()
        self._threads.append(t)

    def serve_forever(self) -> None:
        self.start()
        self._stop_flag.wait()

    def stop(self) -> None:
        self._stop_flag.set()
        try:
            self._listener.close()
        except OSError:
            pass

    def _accept_loop(self) -> None:
        while not self._stop_flag.is_set():
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            t = threading.Thread(target=self._handle_conn, args=(conn,), daemon=True)
            t.start()
            self._threads.append(t)

    def _handle_conn(self, conn: socket.socket) -> None:
        try:
            while not self._stop_flag.is_set():
                raw = codec.read_frame(conn)
                if raw is None:
                    return
                kind, type_, body = codec.decode_frame(raw)
                if kind != "req":
                    continue
                try:
                    resp = self._dispatch(type_, body)
                    conn.sendall(codec.encode_frame("res", type_, resp))
                except Exception as exc:  # app errors -> exception response
                    conn.sendall(
                        codec.encode_frame("exc", type_, {"error": str(exc)})
                    )
        except (OSError, ValueError):
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _dispatch(self, type_: str, body):
        if type_ == "echo":
            return {"message": body.get("message", "")}
        if type_ == "flush":
            return {}
        entry = codec.METHODS.get(type_)
        if entry is None:
            raise ValueError(f"unknown ABCI method {type_!r}")
        req_cls, _ = entry
        req = codec.decode_obj(req_cls, body) if req_cls is not type(None) else None
        with self._app_mtx:
            method = getattr(self.app, type_)
            return method(req) if req is not None else method()


def main(argv: Optional[list] = None) -> None:
    import argparse

    p = argparse.ArgumentParser(description="Run an ABCI app over a socket")
    p.add_argument("--addr", default="127.0.0.1:26658")
    p.add_argument("--app", default="kvstore", choices=["kvstore", "noop"])
    p.add_argument("--db", default="", help="persist kvstore state to this filedb path")
    p.add_argument("--snapshot-interval", type=int, default=0)
    p.add_argument(
        "--transport", default="socket", choices=["socket", "grpc"],
        help="wire transport (abci/server: socket_server.go / grpc_server.go)",
    )
    args = p.parse_args(argv)

    if args.app == "kvstore":
        from tendermint_tpu_torch.abci.kvstore import KVStoreApplication

        db = None
        if args.db:
            from tendermint_tpu_torch.storage.filedb import FileDB

            db = FileDB(args.db)
        app: abci.Application = KVStoreApplication(
            db=db, snapshot_interval=args.snapshot_interval
        )
    else:
        app = abci.BaseApplication()

    host, _, port = args.addr.rpartition(":")
    if args.transport == "grpc":
        from tendermint_tpu_torch.abci.grpc_server import GrpcABCIServer

        server = GrpcABCIServer(app, host or "127.0.0.1", int(port))
    else:
        server = SocketServer(app, host or "127.0.0.1", int(port))
    print(f"abci server listening on {server.address[0]}:{server.address[1]}", flush=True)
    server.serve_forever()


if __name__ == "__main__":
    main()
