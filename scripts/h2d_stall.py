#!/usr/bin/env python3
"""Whether a chunk's host-to-device copies wait for the kernel before them.

    python3 scripts/h2d_stall.py [--busy-ms 2.0] [--reps 7]

The verify engine launches chunk j's kernel and then prepares chunk j+1
on the host, copying its inputs to the card while chunk j's kernel runs
on the same stream. This script queues a busy kernel of about
``--busy-ms`` (``torch.cuda._sleep``), then times on the host one copy
of each input of a 4,096-lane chunk: the K4 blocks (two 128-byte blocks
a lane), the R/s/k rows and the K3 column indices. Each copy is made two
ways: ``tensor.to(device)`` from pageable memory, and
``tendermint_tpu_torch.ops.field.upload`` (pinned memory, non-blocking),
which the engine uses. A copy that waits for the busy kernel takes about
``--busy-ms`` of host time; one that does not takes the copy's own time,
which each way is also timed for with the stream idle. After each copy
the data is checked on the card.

Prints one JSON line per input with every rep's host ms for both ways,
behind the busy kernel and idle, then the card's ``nvidia-smi`` name and
power limit. Without CUDA it exits with code 2.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

LANES = 4096


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--busy-ms", type=float, default=2.0)
    parser.add_argument("--reps", type=int, default=7)
    args = parser.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("h2d_stall: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    from tendermint_tpu_torch.ops import field as F

    dev = torch.device("cuda", 0)
    # Calibrate the busy kernel: cycles for --busy-ms.
    cycles = 1_000_000
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(cycles)
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    torch.cuda.synchronize()
    cycles = int(cycles * args.busy_ms / start.elapsed_time(end))
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    torch.cuda.synchronize()
    busy_ms = start.elapsed_time(end)

    rng = np.random.default_rng(7)
    inputs = {
        "k4_blocks": rng.integers(0, 256, size=(LANES, 256), dtype=np.uint8),
        "rsk_rows": rng.integers(0, 256, size=(LANES, 32), dtype=np.uint8),
        "k3_idx": rng.integers(0, 10_001, size=LANES).astype(np.int32),
    }
    ways = {
        "pageable": lambda a: torch.from_numpy(a).to(dev),
        "upload": lambda a: F.upload(a, dev),
    }
    for name, arr in inputs.items():
        row = {"input": name, "bytes": int(arr.nbytes), "busy_kernel_ms": busy_ms}
        for way, copy in ways.items():
            copy(arr)  # first use: pinned pool, allocator
            torch.cuda.synchronize()
            for when, busy in (("", True), ("_idle", False)):
                host_ms = []
                for _ in range(args.reps):
                    if busy:
                        torch.cuda._sleep(cycles)
                    t0 = time.perf_counter()
                    out = copy(arr)
                    host_ms.append((time.perf_counter() - t0) * 1e3)
                    torch.cuda.synchronize()
                    if not np.array_equal(out.cpu().numpy(), arr):
                        raise SystemExit(f"h2d_stall: {way} copy of {name} arrived wrong")
                row[f"{way}{when}_host_ms"] = host_ms
                row[f"{way}{when}_host_ms_median"] = statistics.median(host_ms)
        print(json.dumps(row), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
