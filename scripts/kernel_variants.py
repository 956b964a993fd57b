#!/usr/bin/env python3
"""Compare versions of the port's kernel source on one GPU, in one process.

    python3 scripts/kernel_variants.py NAME=PATH.cu [NAME=PATH.cu ...] [--rounds N]

Each PATH is a version of ``tendermint_tpu_torch/csrc/ed25519_verify.cu``
(the committed one, or an edited copy). Every variant is built with the
port's nvcc flags into ``build/variants``; then, for each round, the
variants take turns: the loaded library is swapped for the variant's and
``chip_smoke.phase_kernels`` runs, which checks the kernels against
their plain versions (failing on any mismatch) and times them. Each turn
prints one line

    RESULT <round> <name> {"verify": [ms, ms_at_16384, registers,
    local_bytes, resident_warps_per_sm], "verify_tables": [...],
    "verify_resident": [...], "challenge": [...]}

and the run ends with the card's ``nvidia-smi`` name and power limit.
Without CUDA it exits with code 2.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import multiprocessing
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def build(name: str, path: str) -> str:
    from tendermint_tpu_torch.ops import _build

    out_dir = os.path.join(REPO, "build", "variants")
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, f"lib{name}.so")
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib, path],
                          capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode:
        raise SystemExit(f"nvcc failed for {name} ({path}):\n{log}")
    print(name, [ln.strip() for ln in log.splitlines() if "Used" in ln or "spill" in ln],
          flush=True)
    return lib


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("variants", nargs="+", metavar="NAME=PATH.cu")
    parser.add_argument("--rounds", type=int, default=2)
    args = parser.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("kernel_variants: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from tendermint_tpu_torch.ops import _build

    libs = {}
    for spec in args.variants:
        name, _, path = spec.partition("=")
        libs[name] = build(name, path)
    with multiprocessing.get_context("spawn").Pool(min(8, os.cpu_count() or 1)) as pool:
        lanes = cs.fault_lanes(np.random.default_rng(cs.SEED), cs.Signer(pool))
    dev = torch.device("cuda", 0)
    for rnd in range(args.rounds):
        for name, lib in libs.items():
            _build._libs["ed25519_verify"] = ctypes.CDLL(lib)
            rows = cs.phase_kernels(lanes, dev)
            summary = {k: [r["ms"], r["ms_at_16384"], r["registers"], r["local_bytes"],
                           r["resident_warps_per_sm"]] for k, r in rows.items()}
            print("RESULT", rnd, name, json.dumps(summary), flush=True)
    print(cs.nvidia_smi("name,power.limit"), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
