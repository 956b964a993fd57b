"""``python -m tendermint_tpu_torch verifyd`` as its own process, on the
CPU: it prints the reference's banner line, serves a request over gRPC
and ``/metrics`` over HTTP, and exits 0 on SIGTERM. Every wait is
bounded."""

import os
import queue
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.request

import pytest

pytest.importorskip("torch")

from tendermint_tpu_torch.cli import build_parser
from tendermint_tpu_torch.crypto import ed25519_ref as ref
from tendermint_tpu_torch.verifyd import protocol
from tendermint_tpu_torch.verifyd.client import VerifydClient

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANNER = re.compile(
    r"^verifyd serving on (\S+):(\d+) \(max_batch=256, max_delay=0\.002s, admission_cap=1024, "
    r"continuous=True, pipeline_depth=2, dyn_batch=on, tenant_slos=none, tenant_cap=512, "
    r"shm=(\S+\.sock), shard=standalone\)$"
)


def _line_reader(proc):
    """A function returning the daemon's next stdout line, waiting at
    most 60 s (a thread reads the pipe)."""
    lines = queue.Queue()
    threading.Thread(target=lambda: [lines.put(x) for x in proc.stdout], daemon=True).start()
    return lambda: lines.get(timeout=60)


def test_parser_defaults_match_the_reference():
    args = build_parser().parse_args(["verifyd"])
    assert (args.listen, args.device, args.max_delay, args.admission_cap,
            args.max_pending, args.pipeline_depth, args.tenant_cap, args.tenant_pin_quota,
            args.max_tenants, args.dyn_batch, args.continuous) == (
        "127.0.0.1:26670", None, 0.002, 1024, 4096, 2, 512, 256, 16, "on", "on")
    assert (args.action, args.shm, args.shard_id, args.shards) == ("serve", "auto", -1, "")
    # the reference has --shm (auto, on, off) and no --port
    assert build_parser().parse_args(["verifyd", "--shm", "on"]).shm == "on"
    for flag in (["--shm", "sometimes"], ["--port", "0"]):
        with pytest.raises(SystemExit):
            build_parser().parse_args(["verifyd"] + flag)


def test_verifyd_serves_a_request_and_stops_on_sigterm():
    env = dict(os.environ, PYTHONPATH=REPO, PYTHONUNBUFFERED="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "tendermint_tpu_torch", "verifyd", "--device", "cpu", "--listen", "127.0.0.1:0",
         "--metrics", "127.0.0.1:0"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    readline = _line_reader(proc)
    try:
        m = BANNER.match(readline().rstrip("\n"))
        assert m, "banner"
        metrics_line = readline().strip()
        mm = re.match(r"^verifyd metrics on (\S+):(\d+) \(device=cpu\)$", metrics_line)
        assert mm, metrics_line
        priv, pub = ref.keypair_from_seed(b"\x09" * 32)
        msgs = [b"cli-%d" % i for i in range(3)]
        sigs = [ref.sign(priv, m) for m in msgs]
        sigs[2] = bytes(64)
        c = VerifydClient(f"{m.group(1)}:{m.group(2)}")
        try:
            got = c.verify([pub] * 3, msgs, sigs, klass=protocol.CLASS_CONSENSUS)
            assert got == [True, True, False]
            assert c.server_stats()["stats"]["requests_served"] == 1
        finally:
            c.close()
        url = f"http://{mm.group(1)}:{mm.group(2)}/metrics"
        with urllib.request.urlopen(url, timeout=10) as resp:
            text = resp.read().decode()
        assert 'tendermint_verifyd_requests_total{kind="commit",status="ok"} 1' in text
        assert "tendermint_evloop_connections" in text
        t0 = time.monotonic()
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=10) == 0
        assert time.monotonic() - t0 < 10
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        proc.stderr.close()
