"""E2E runner: stage a manifest's testnet through its lifecycle.

A copy of ``tendermint_tpu/e2e/runner.py`` whose processes are the
port's. test/e2e/runner analog. Stages (runner/main.go order):

  setup    generate per-node homes (config.toml, shared genesis, keys)
  start    spawn one ``python -m tendermint_tpu_torch start --device D``
           per node
           (start_at > 0 nodes join late and block-sync the gap)
  load     background transaction generator over RPC
           (runner/load.go)
  perturb  kill -9 / SIGSTOP+SIGCONT / SIGTERM-restart per manifest
           (runner/perturb.go:42-72)
  wait     every running node advances ``wait_heights`` past the start
  test     invariants over RPC only: heights advance, block hashes agree
           at every common height, app hashes agree, txs committed
           (test/e2e/tests/{block,app,net}_test.go)
  stop     SIGTERM everything, collect exit codes

Runnable: ``python -m tendermint_tpu_torch.e2e <manifest.toml>``.

Where the JAX package's children always run on the CPU (its
``_child_env`` pins them there), the port's nodes verify on the
runner's ``device`` (default CUDA): every ``start`` it spawns gets
``--device``, and a node that cannot reach the device exits, which
fails the stage that waits for it. The app and signer processes
(``abci/socket_server.py``, ``privval/remote.py``, ``privval/grpc.py``)
verify nothing. Each perturbation's recovery is timed into
``Runner.recoveries``.
"""

from __future__ import annotations

import base64
import hashlib
import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.request
from dataclasses import dataclass
from typing import Dict, List, Optional

from tendermint_tpu_torch.config import Config
from tendermint_tpu_torch.e2e.manifest import Manifest, NodeManifest

REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


class E2EError(Exception):
    pass


@dataclass
class _Node:
    manifest: NodeManifest
    home: str
    p2p_port: int
    rpc_port: int
    proc: Optional[subprocess.Popen] = None
    log_path: str = ""
    # out-of-process ABCI app (proxy_app = "tcp" | "grpc"): its port and
    # process; the app outlives node kill/restart perturbations, like a
    # real deployment's app container.
    app_port: int = 0
    app_proc: Optional[subprocess.Popen] = None
    # out-of-process signer (privval = "remote" | "grpc"); also outlives
    # node perturbations (the socket flavor redials forever).
    signer_port: int = 0
    signer_proc: Optional[subprocess.Popen] = None

    @property
    def rpc_url(self) -> str:
        return f"http://127.0.0.1:{self.rpc_port}"

    def rpc(self, method: str, params: Optional[dict] = None, timeout=5.0):
        req = json.dumps(
            {
                "jsonrpc": "2.0",
                "id": 1,
                "method": method,
                "params": params or {},
            }
        ).encode()
        with urllib.request.urlopen(
            urllib.request.Request(
                self.rpc_url, req, {"Content-Type": "application/json"}
            ),
            timeout=timeout,
        ) as resp:
            doc = json.load(resp)
        if "error" in doc:
            raise E2EError(f"{method}: {doc['error']}")
        return doc["result"]

    def height(self) -> int:
        return int(self.rpc("status")["sync_info"]["latest_block_height"])

    def running(self) -> bool:
        return self.proc is not None and self.proc.poll() is None


def _free_ports(n: int) -> List[int]:
    socks, ports = [], []
    for _ in range(n):
        s = socket.socket()
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("127.0.0.1", 0))
        socks.append(s)
        ports.append(s.getsockname()[1])
    for s in socks:
        s.close()
    return ports


def _child_env() -> dict:
    """The environment of node/app/signer subprocesses: this one, with
    the checkout first on the module path. The device is chosen by each
    node's ``--device``, not by the environment."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (REPO_ROOT, env.get("PYTHONPATH", "")) if p)
    return env


class Runner:
    def __init__(self, manifest: Manifest, workdir: str, log=print, device: str = "cuda"):
        self.manifest = manifest
        self.workdir = workdir
        self.log = log
        self.device = device
        # (node, perturbation, seconds from the perturbation to a new height)
        self.recoveries: List[tuple] = []
        self.nodes: Dict[str, _Node] = {}
        self._load_proc_stop = False
        self._sent_txs: List[bytes] = []
        self.failures: List[str] = []

    # --- setup ---------------------------------------------------------------

    def setup(self) -> None:
        """runner/setup.go: homes, keys, shared genesis, peer wiring."""
        from tendermint_tpu_torch.encoding.canonical import Timestamp
        from tendermint_tpu_torch.p2p.key import NodeKey
        from tendermint_tpu_torch.privval import FilePV
        from tendermint_tpu_torch.types.genesis import GenesisDoc, GenesisValidator
        from tendermint_tpu_torch.types.params import ConsensusParams, TimeoutParams

        names = list(self.manifest.nodes)
        ports = _free_ports(4 * len(names))
        pvs, node_keys = {}, {}
        for i, name in enumerate(names):
            nm = self.manifest.nodes[name]
            home = os.path.join(self.workdir, name)
            node = _Node(
                manifest=nm,
                home=home,
                p2p_port=ports[4 * i],
                rpc_port=ports[4 * i + 1],
                log_path=os.path.join(self.workdir, f"{name}.log"),
            )
            cfg = Config(home=home)
            cfg.base.moniker = name
            cfg.base.db_backend = nm.db_backend
            if nm.proxy_app in ("tcp", "grpc"):
                # out-of-process app behind the matching ABCI transport
                node.app_port = ports[4 * i + 2]
                cfg.base.proxy_app = (
                    f"{nm.proxy_app}://127.0.0.1:{node.app_port}"
                )
            else:
                cfg.base.proxy_app = nm.proxy_app
            cfg.base.app_snapshot_interval = nm.snapshot_interval
            if nm.privval in ("remote", "grpc"):
                # out-of-process signer: socket flavor = node listens,
                # signer dials in; grpc flavor = signer serves, node
                # dials (privval/grpc direction).
                node.signer_port = ports[4 * i + 3]
                cfg.privval.laddr = (
                    f"grpc://127.0.0.1:{node.signer_port}"
                    if nm.privval == "grpc"
                    else f"tcp://127.0.0.1:{node.signer_port}"
                )
            cfg.p2p.laddr = f"127.0.0.1:{node.p2p_port}"
            cfg.rpc.laddr = f"127.0.0.1:{node.rpc_port}"
            # perturbations drive unsafe operator routes (disconnect)
            cfg.rpc.unsafe = True
            os.makedirs(cfg.config_dir(), exist_ok=True)
            os.makedirs(cfg.data_dir(), exist_ok=True)
            node_keys[name] = NodeKey.load_or_gen(cfg.node_key_file())
            pvs[name] = FilePV.load_or_generate(
                cfg.privval_key_file(), cfg.privval_state_file()
            )
            self.nodes[name] = node
            node._cfg = cfg  # type: ignore[attr-defined]

        params = ConsensusParams()
        params.timeout = TimeoutParams(
            propose=0.8, propose_delta=0.2, vote=0.4, vote_delta=0.1,
            commit=0.2,
        )
        genesis = GenesisDoc(
            chain_id=self.manifest.chain_id,
            genesis_time=Timestamp.from_unix_ns(time.time_ns()),
            initial_height=self.manifest.initial_height,
            consensus_params=params,
            validators=[
                GenesisValidator(pub_key=pvs[n].get_pub_key(), power=10)
                for n in names
                if self.manifest.nodes[n].mode == "validator"
            ],
        )
        peers = [
            f"{node_keys[n].node_id}@127.0.0.1:{self.nodes[n].p2p_port}"
            for n in names
        ]
        for i, name in enumerate(names):
            cfg = self.nodes[name]._cfg  # type: ignore[attr-defined]
            cfg.p2p.persistent_peers = [
                p for j, p in enumerate(peers) if j != i
            ]
            cfg.save()
            genesis.save_as(cfg.genesis_file())
        self.log(f"setup: {len(names)} node homes under {self.workdir}")

    # --- start/stop ----------------------------------------------------------

    def _wait_bound(self, proc, port: int, what: str, log_path: str) -> None:
        """Wait for a helper process to accept connections, failing fast
        with its exit code if it died first."""
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline:
            rc = proc.poll()
            if rc is not None:
                raise E2EError(
                    f"{what} exited rc={rc} before binding :{port} "
                    f"(log: {log_path})"
                )
            try:
                socket.create_connection(("127.0.0.1", port), timeout=1).close()
                return
            except OSError:
                time.sleep(0.2)
        raise E2EError(f"{what} never bound :{port} (log: {log_path})")

    def _ensure_app(self, node: _Node) -> None:
        """Spawn (or respawn) the node's out-of-process ABCI app and
        wait until it accepts connections — the node's client probes at
        startup and must not race the app's bind."""
        if node.app_port == 0:
            return
        if node.app_proc is not None and node.app_proc.poll() is None:
            return
        with open(node.log_path, "ab") as log_fh:
            # the child inherits the fd; the parent copy closes right away
            node.app_proc = subprocess.Popen(
                [
                    sys.executable, "-m", "tendermint_tpu_torch.abci.socket_server",
                    "--transport",
                    "grpc" if node.manifest.proxy_app == "grpc" else "socket",
                    "--addr", f"127.0.0.1:{node.app_port}",
                    "--snapshot-interval",
                    str(node.manifest.snapshot_interval),
                ],
                cwd=REPO_ROOT,
                env=_child_env(),
                stdout=log_fh,
                stderr=subprocess.STDOUT,
            )
        self._wait_bound(
            node.app_proc, node.app_port,
            f"{node.manifest.name} abci app", node.log_path,
        )

    def _ensure_signer(self, node: _Node) -> None:
        """Spawn (or respawn) the node's out-of-process signer. The
        socket flavor dials the node and retries forever, so spawn order
        does not matter; the grpc flavor must be serving before the node
        dials (the node grants signer_connect_timeout grace)."""
        if node.signer_port == 0:
            return
        if node.signer_proc is not None and node.signer_proc.poll() is None:
            return
        flavor = node.manifest.privval
        if flavor == "grpc":
            mod = "tendermint_tpu_torch.privval.grpc"
        else:
            mod = "tendermint_tpu_torch.privval.remote"
        cfg = node._cfg  # type: ignore[attr-defined]
        addr = (
            f"127.0.0.1:{node.signer_port}"
            if flavor == "grpc"
            else f"tcp://127.0.0.1:{node.signer_port}"
        )
        with open(node.log_path, "ab") as log_fh:
            node.signer_proc = subprocess.Popen(
                [
                    sys.executable, "-m", mod,
                    "--addr", addr,
                    "--chain-id", self.manifest.chain_id,
                    "--key-file", cfg.privval_key_file(),
                    "--state-file", cfg.privval_state_file(),
                ],
                cwd=REPO_ROOT,
                env=_child_env(),
                stdout=log_fh,
                stderr=subprocess.STDOUT,
            )
        if flavor == "grpc":
            self._wait_bound(
                node.signer_proc, node.signer_port,
                f"{node.manifest.name} signer", node.log_path,
            )
        else:
            # the dialing signer binds nothing; still catch instant death
            time.sleep(0.3)
            rc = node.signer_proc.poll()
            if rc is not None:
                raise E2EError(
                    f"{node.manifest.name} signer exited rc={rc} at spawn "
                    f"(log: {node.log_path})"
                )

    def _spawn(self, node: _Node) -> None:
        self._ensure_app(node)
        self._ensure_signer(node)
        with open(node.log_path, "ab") as log_fh:
            node.proc = subprocess.Popen(
                [
                    sys.executable,
                    "-m",
                    "tendermint_tpu_torch",
                    "--home",
                    node.home,
                    "start",
                    "--device",
                    self.device,
                ],
                cwd=REPO_ROOT,
                env=_child_env(),
                stdout=log_fh,
                stderr=subprocess.STDOUT,
            )

    def start(self) -> None:
        """Start genesis nodes; late joiners start in wait()."""
        for name, node in self.nodes.items():
            if node.manifest.start_at == 0:
                self._spawn(node)
                self.log(f"start: {name} (rpc :{node.rpc_port})")
        self._wait_all_up(
            [n for n in self.nodes.values() if n.manifest.start_at == 0]
        )

    def _wait_all_up(self, nodes: List[_Node], timeout: float = 120) -> None:
        deadline = time.monotonic() + timeout
        for node in nodes:
            while True:
                try:
                    node.height()
                    break
                except Exception:
                    if time.monotonic() > deadline:
                        raise E2EError(
                            f"node {node.manifest.name} rpc never came up "
                            f"(log: {node.log_path})"
                        )
                    time.sleep(0.5)

    def stop(self) -> None:
        for node in self.nodes.values():
            if node.proc is not None and node.proc.poll() is None:
                node.proc.send_signal(signal.SIGTERM)
        for node in self.nodes.values():
            if node.proc is not None:
                try:
                    node.proc.wait(timeout=15)
                except subprocess.TimeoutExpired:
                    node.proc.kill()
        for node in self.nodes.values():
            for helper in (node.app_proc, node.signer_proc):
                if helper is not None and helper.poll() is None:
                    helper.kill()
                    try:
                        helper.wait(timeout=5)
                    except subprocess.TimeoutExpired:
                        pass

    # --- load ----------------------------------------------------------------

    def load(self, duration: float) -> int:
        """runner/load.go: steady tx stream against round-robin nodes."""
        rate = self.manifest.load_tx_per_sec
        if rate <= 0:
            return 0
        targets = [
            n for n in self.nodes.values()
            if n.running() and n.manifest.start_at == 0
        ]
        sent = 0
        deadline = time.monotonic() + duration
        seq = 0
        while time.monotonic() < deadline:
            node = targets[seq % len(targets)]
            tx = f"load-{seq}={os.urandom(4).hex()}".encode()
            seq += 1
            try:
                node.rpc(
                    "broadcast_tx_sync",
                    {"tx": base64.b64encode(tx).decode()},
                )
                self._sent_txs.append(tx)
                sent += 1
            except Exception:
                pass  # nodes may be mid-perturbation
            time.sleep(1.0 / rate)
        self.log(f"load: sent {sent} txs")
        return sent

    # --- perturb -------------------------------------------------------------

    def perturb(self) -> None:
        """runner/perturb.go:42-72: one perturbation at a time, waiting
        for recovery after each."""
        for name, node in self.nodes.items():
            for p in node.manifest.perturb:
                self.log(f"perturb: {p} {name}")
                t0 = time.monotonic()
                if p == "kill":
                    node.proc.kill()
                    node.proc.wait(timeout=10)
                    time.sleep(1.0)
                    self._spawn(node)
                elif p == "restart":
                    node.proc.send_signal(signal.SIGTERM)
                    try:
                        node.proc.wait(timeout=15)
                    except subprocess.TimeoutExpired:
                        node.proc.kill()
                        node.proc.wait(timeout=5)
                    self._spawn(node)
                elif p == "pause":
                    node.proc.send_signal(signal.SIGSTOP)
                    time.sleep(3.0)
                    node.proc.send_signal(signal.SIGCONT)
                elif p == "disconnect":
                    # perturb.go:42-72 network-disconnect analog: the
                    # node drops all peers and quarantines redials.
                    node.rpc("unsafe_disconnect_peers", {"duration": 3.0})
                self._wait_recovery(node)
                self.recoveries.append((name, p, time.monotonic() - t0))

    def _wait_recovery(self, node: _Node, timeout: float = 90) -> None:
        """Node serves RPC and its height advances again."""
        deadline = time.monotonic() + timeout
        base = None
        while time.monotonic() < deadline:
            try:
                h = node.height()
                if base is None:
                    base = h
                elif h > base:
                    self.log(f"perturb: {node.manifest.name} recovered at {h}")
                    return
            except Exception:
                pass
            time.sleep(0.5)
        raise E2EError(f"{node.manifest.name} did not recover")

    # --- wait + late joiners -------------------------------------------------

    def wait(self, timeout: float = 180) -> None:
        """Every node reaches start height + wait_heights; late joiners
        start once the chain passes their start_at and must catch up."""
        if any(n.manifest.statesync for n in self.nodes.values()):
            # snapshot discovery + chunk restore + backfill + catch-up
            # is the longest join path; give it room on loaded machines
            # (observed: a joiner under a full parallel test-suite load
            # syncs correctly but needs several minutes to catch up)
            timeout = max(timeout, 600)
        running = [
            n for n in self.nodes.values() if n.manifest.start_at == 0
        ]
        target = max(n.height() for n in running) + self.manifest.wait_heights
        late = [n for n in self.nodes.values() if n.manifest.start_at > 0]
        deadline = time.monotonic() + timeout
        started_late = set()
        while time.monotonic() < deadline:
            heights = {}
            for node in self.nodes.values():
                if node.proc is None:
                    continue
                try:
                    heights[node.manifest.name] = node.height()
                except Exception:
                    heights[node.manifest.name] = -1
            chain_h = max((h for h in heights.values()), default=0)
            for node in late:
                if (
                    node.manifest.name not in started_late
                    and chain_h >= node.manifest.start_at
                ):
                    if node.manifest.statesync:
                        self._arm_statesync(node, running)
                    self.log(
                        f"start: late joiner {node.manifest.name} "
                        f"at chain height {chain_h}"
                        + (" (statesync)" if node.manifest.statesync else "")
                    )
                    self._spawn(node)
                    started_late.add(node.manifest.name)
            if all(h >= target for h in heights.values()) and len(
                heights
            ) == len(self.nodes):
                self.log(f"wait: all nodes >= {target} {heights}")
                return
            time.sleep(1.0)
        raise E2EError(
            f"wait: nodes never reached {target}: "
            f"{ {n: h for n, h in heights.items()} }"
        )

    def _arm_statesync(self, node: _Node, providers: List[_Node]) -> None:
        """Resolve the light-client trust anchor from a running node and
        write it into the joiner's [statesync] config — what the
        reference runner does against the first node's RPC before
        starting a state-syncing member."""
        anchor = None
        trust_height = 0
        for p in providers:
            try:
                status = p.rpc("status")["sync_info"]
                # Recent anchor: pruning (app retain_height) may have
                # discarded early blocks, and the snapshot the joiner
                # restores sits near the tip anyway.
                trust_height = max(
                    int(status["earliest_block_height"]),
                    int(status["latest_block_height"]) - 24,
                    1,
                )
                anchor = p.rpc("block", {"height": trust_height})
                break
            except Exception:
                continue
        if anchor is None:
            raise E2EError(
                f"{node.manifest.name}: no provider served the trust anchor"
            )
        cfg = node._cfg  # type: ignore[attr-defined]
        cfg.statesync.enabled = True
        cfg.statesync.trust_height = trust_height
        cfg.statesync.trust_hash = bytes.fromhex(anchor["block_id"]["hash"])
        cfg.statesync.discovery_time = 2.0
        cfg.statesync.backfill_blocks = 2
        cfg.save()

    # --- invariants ----------------------------------------------------------

    def test(self) -> None:
        """tests/{block,app,net}_test.go: RPC-only invariant checks."""
        nodes = [n for n in self.nodes.values() if n.running()]
        if len(nodes) < 2:
            raise E2EError("fewer than two nodes running at test stage")

        # net_test.go: everyone has peers
        for node in nodes:
            n_peers = int(node.rpc("net_info")["n_peers"])
            if n_peers < 1:
                self.failures.append(
                    f"{node.manifest.name}: no peers connected"
                )

        # block_test.go: block ids agree at every common height
        statuses = {n.manifest.name: n.rpc("status") for n in nodes}
        earliest = max(
            int(s["sync_info"]["earliest_block_height"])
            for s in statuses.values()
        )
        latest_common = min(
            int(s["sync_info"]["latest_block_height"])
            for s in statuses.values()
        )
        if latest_common < earliest:
            self.failures.append("no common heights between nodes")
        # Pruning keeps advancing while we sample (the kvstore app
        # retains ~100 blocks): a height present in `status` can be gone
        # by the time we query it. Skip freshly-pruned heights but
        # require that enough comparisons actually happened.
        step = max(1, (latest_common - earliest) // 10)
        compared = 0
        for h in range(earliest, latest_common + 1, step):
            ids = {}
            pruned = False
            for n in nodes:
                try:
                    ids[n.manifest.name] = n.rpc("block", {"height": h})[
                        "block_id"
                    ]["hash"]
                except E2EError as e:
                    if "no block" in str(e):
                        pruned = True
                        break
                    raise
            if pruned:
                continue
            compared += 1
            if len(set(ids.values())) != 1:
                self.failures.append(f"block id mismatch at {h}: {ids}")
        sampled = len(range(earliest, latest_common + 1, step))
        if compared < min(3, sampled):
            self.failures.append(
                f"only {compared} of {sampled} common heights comparable "
                "(pruning race?)"
            )

        # app_test.go: app hash agreement at the common tip
        hashes = {
            n.manifest.name: n.rpc("block", {"height": latest_common})[
                "block"
            ]["header"]["app_hash"]
            for n in nodes
        }
        if len(set(hashes.values())) != 1:
            self.failures.append(
                f"app hash mismatch at {latest_common}: {hashes}"
            )

        # load made it into the chain: spot-check a committed tx
        committed = 0
        for tx in self._sent_txs[:20]:
            h = hashlib.sha256(tx).hexdigest()
            try:
                nodes[0].rpc("tx", {"hash": "0x" + h})
                committed += 1
            except Exception:
                pass
        if self._sent_txs and committed == 0:
            self.failures.append("none of the load txs committed")

        if self.failures:
            raise E2EError("; ".join(self.failures))
        self.log(
            f"test: invariants ok over heights {earliest}..{latest_common}, "
            f"{committed} load txs verified committed"
        )

    # --- full lifecycle ------------------------------------------------------

    def run(self) -> None:
        try:
            self.setup()
            self.start()
            self.load(duration=3.0)
            self.perturb()
            self.load(duration=2.0)
            self.wait()
            self.test()
        finally:
            self.stop()


def main(argv=None) -> int:
    import argparse
    import tempfile

    ap = argparse.ArgumentParser(prog="python -m tendermint_tpu_torch.e2e")
    ap.add_argument("manifest", help="path to a testnet manifest (TOML)")
    ap.add_argument("--workdir", default="")
    ap.add_argument("--device", default="cuda", help="device the nodes verify on: cuda (the default) or cpu")
    args = ap.parse_args(argv)
    manifest = Manifest.load(args.manifest)
    workdir = args.workdir or tempfile.mkdtemp(prefix="tmtpu-torch-e2e-")
    runner = Runner(manifest, workdir, device=args.device)
    try:
        runner.run()
    except E2EError as e:
        print(f"E2E FAILED: {e}", file=sys.stderr)
        return 1
    print("E2E PASSED")
    return 0
