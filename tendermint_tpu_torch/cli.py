"""Operator command line; counterpart of ``tendermint_tpu/cli.py``, cut
to its ``verifyd`` subcommand on one server.

    python -m tendermint_tpu_torch verifyd [--listen HOST:PORT] [--port N]
        [--device cuda|cpu] [--metrics HOST:PORT] [--trace MODE] ...

The daemon (``verifyd/server.py``) owns the card (``--device``, default
CUDA) and serves batched signature verification over gRPC. It prints
the reference's banner line, then, with ``--metrics``, a line naming the
HTTP listener that serves ``/metrics`` and ``/debug/memstats``
(``rpc/server.py``), and runs until SIGTERM or SIGINT. Left out of the
reference's subcommand: ``--shm``, ``--shard-id``, ``--shards``,
``--mesh`` and the ``stats`` action.
"""

from __future__ import annotations

import argparse
import signal
import sys
import time
from typing import List, Optional


def cmd_verifyd(args) -> int:
    """Run the verification service until SIGTERM or SIGINT."""
    from tendermint_tpu_torch.libs import tracing
    from tendermint_tpu_torch.libs.metrics import EvloopMetrics, Registry, VerifydMetrics
    from tendermint_tpu_torch.ops import introspect
    from tendermint_tpu_torch.verifyd.server import VerifydServer

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
    if args.port is not None:
        port = str(args.port)
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
        dyn_batch=args.dyn_batch == "on",
        tenant_slos=tenant_slos,
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
    # the kernel profiler and the device-byte ledger answer
    # GET /debug/memstats on the metrics listener
    introspect.install()
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
            f"shm=off, "
            f"shard=standalone)",
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
        introspect.uninstall()
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="tendermint_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)
    p = sub.add_parser("verifyd", help="run the shared verification daemon")
    p.add_argument("--listen", default="127.0.0.1:26670", metavar="HOST:PORT",
                   help="gRPC listen address")
    p.add_argument("--port", type=int, default=None,
                   help="gRPC listen port, overriding --listen's (0 picks a free one)")
    p.add_argument("--device", default=None,
                   help="device the kernels run on: cuda (the default) or cpu")
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
    p.add_argument("--dyn-batch", choices=("on", "off"), default="on",
                   help="deadline-aware dynamic batching (crypto/adaptive.py); off "
                   "pins the static max-batch/max-delay config")
    p.add_argument("--tenant-slo", action="append", default=[], metavar="TENANT=MS",
                   help="declare a tenant's p99 latency target in ms (repeatable)")
    p.add_argument("--metrics", default="", metavar="HOST:PORT",
                   help="serve /metrics and /debug/memstats here")
    p.add_argument("--trace", default="", help="span tracing: off | ring | <chrome-trace path>")
    p.set_defaults(fn=cmd_verifyd)
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
