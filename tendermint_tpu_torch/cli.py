"""Operator command line; counterpart of ``tendermint_tpu/cli.py``, cut
to its ``verifyd``, ``light`` and ``lightd`` subcommands.

    python -m tendermint_tpu_torch verifyd [serve|stats] [--listen HOST:PORT]
        [--device cuda|cpu] [--metrics HOST:PORT] [--trace MODE]
        [--shm auto|on|off] [--shard-id N] [--shards H:P,H:P,...] ...
    python -m tendermint_tpu_torch light PRIMARY_URL --chain-id ID
        --trust-height H --trust-hash HEX [--witness URL ...]
        [--laddr HOST:PORT] [--sequential] [--device cuda|cpu]
    python -m tendermint_tpu_torch lightd PRIMARY_URL --chain-id ID
        --trust-height H --trust-hash HEX [--witness URL ...]
        [--listen HOST:PORT] [--workers N] [--device cuda|cpu] ...

The daemon (``verifyd/server.py``) owns the card (``--device``, default
CUDA) and serves batched signature verification over gRPC and, for
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
banner line and runs until SIGTERM or SIGINT. ``--device`` is the
port's own: a client that bisects in rounds rides the shared
scheduler, which verifies on the package's device, so the flag sets
that. ``lightd`` serves on the event loop with ``--workers`` handler
threads and installs the flight recorder, as the reference does.
"""

from __future__ import annotations

import argparse
import signal
import sys
import time
from typing import List, Optional


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
    p.add_argument("--device", default=None,
                   help="device the verifications run on: cuda (the default) or cpu")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="tendermint_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)
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
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
