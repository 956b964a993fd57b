#!/usr/bin/env python3
"""Vote ingest with the host tier on and off, in one process.

    python3 scripts/vote_ingest_tiers.py [--thresholds 16,1] [--rounds 2]

``tiered_verify_ed25519`` answers a flush under ``DEVICE_THRESHOLD``
(16) lanes with the host oracle, the reference's crossover for a native
host verify. The port's host oracle is pure Python, milliseconds a lane.
This script runs ``chip_smoke.py``'s phase 9 (the 10,000-precommit flood
from 4 peers, then the 150-validator round with extensions) once per
threshold and round, in the order given and then reversed on odd rounds
(16, 1, 1, 16 for the defaults), so the host's drift falls on both; a
threshold of 1 sends every flush to the card. Each run makes its checks
(every verdict, no fallback, a healthy health machine) and prints the
phase's two JSON lines; then one ``RESULT`` line a run with the flood's
time to all votes, its verifier lanes/s, its per-vote latency p50 and
p99, the tiers' lanes and seconds, and the round's p50 and p99, and the
card's ``nvidia-smi`` name and power limit. Without CUDA it exits with
code 2.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import multiprocessing
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--thresholds", default="16,1")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("vote_ingest_tiers: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from tendermint_tpu_torch.crypto import batch as crypto_batch
    from tendermint_tpu_torch.ops import _build, device_policy

    thresholds = [int(t) for t in args.thresholds.split(",")]
    rng = np.random.default_rng(cs.SEED)
    t0 = time.perf_counter()
    with multiprocessing.get_context("spawn").Pool(min(8, os.cpu_count() or 1)) as pool:
        signer = cs.Signer(pool)
        commit = cs.commit_workload(rng, signer)
        round_wl = cs.round_workload(rng, signer)
    print(json.dumps({"setup_s": time.perf_counter() - t0}), flush=True)
    _build.build_all()
    dev = torch.device("cuda", 0)
    for r in range(args.rounds):
        for threshold in thresholds if r % 2 == 0 else thresholds[::-1]:
            crypto_batch.DEVICE_THRESHOLD = threshold
            device_policy.shared.reset()
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                cs.phase_votes(commit, round_wl, dev)
            cs.check_healthy(f"threshold {threshold}")
            crypto_batch.shutdown_shared_scheduler()
            lines = {}
            for line in out.getvalue().splitlines():
                print(line, flush=True)
                row = json.loads(line)
                lines[row["phase"]] = row
            flood, rnd = lines["votes_flood"], lines["votes_round"]
            print("RESULT " + json.dumps({
                "round": r, "threshold": threshold,
                "flood_to_all_ms": flood["to_all_ms"], "flood_to_two_thirds_ms": flood["to_two_thirds_ms"],
                "flood_lanes_per_s": flood["lanes_per_s"],
                "flood_latency_p50_ms": flood["latency_p50_ms"],
                "flood_latency_p99_ms": flood["latency_p99_ms"],
                "flood_flushes": flood["flushes"], "flood_host_tier_lanes": flood["host_tier_lanes"],
                "flood_host_tier_cached": flood["host_tier_cached"],
                "flood_host_tier_s": flood["host_tier_s"], "flood_device_tier_s": flood["device_tier_s"],
                "flood_launches": flood["launches"],
                "round_latency_p50_ms": rnd["latency_p50_ms"], "round_latency_p99_ms": rnd["latency_p99_ms"],
                "round_host_tier_lanes": rnd["host_tier_lanes"],
            }), flush=True)
    print(cs.nvidia_smi("name,power.limit"), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
