#!/usr/bin/env python3
"""Compare versions of the port's kernel sources on one GPU, in one process.

    python3 scripts/kernel_variants.py NAME=PATH.cu [NAME=PATH.cu ...] [--rounds N]

Each PATH is a version of ``tendermint_tpu_torch/csrc/ed25519_verify.cu``
(K1-K3) or of ``csrc/sha512_challenge.cu`` (K4): the committed one, or an
edited copy; which one is told by the C entry point the source defines.
Every variant is built with the port's nvcc flags into ``build/variants``
(one nvcc process each, all started together); then, for each round, the
variants take turns, in the order given and in reverse on odd rounds
(so two variants run A, B, B, A): the loaded library is swapped
for the variant's, and ``chip_smoke.phase_kernels`` (K1-K3) or
``chip_smoke.phase_challenge`` (K4) runs, which checks the kernels
against their plain versions (failing on any mismatch) and times them.
Each turn prints one line

    RESULT <round> <name> {"verify": [ms, ms_at_16384, registers,
    local_bytes, resident_warps_per_sm], "verify_tables": [...],
    "verify_resident": [...]}

(or ``{"challenge": [...]}`` for a K4 variant), and the run ends with the
card's ``nvidia-smi`` name and power limit. Without CUDA it exits with
code 2.
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

# Library stem of each kernel source, told by an entry point it defines.
ENTRY_POINTS = {"ed25519_verify_launch": "ed25519_verify",
                "sha512_challenge_launch": "sha512_challenge"}


def stem_of(path: str) -> str:
    with open(path) as fh:
        src = fh.read()
    stems = [stem for entry, stem in ENTRY_POINTS.items() if f'"C" int {entry}(' in src]
    if len(stems) != 1:
        raise SystemExit(f"{path}: defines none or several of {sorted(ENTRY_POINTS)}")
    return stems[0]


def build_all(variants):
    """Build every (name, path) at once; returns {name: (stem, library)}."""
    from tendermint_tpu_torch.ops import _build

    out_dir = os.path.join(REPO, "build", "variants")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, path in variants:
        lib = os.path.join(out_dir, f"lib{name}.so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib, path]
        procs[name] = (stem_of(path), lib, path, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (stem, lib, path, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name} ({path}):\n{log}")
        print(name, [ln.strip() for ln in log.splitlines() if "Used" in ln or "spill" in ln],
              flush=True)
        libs[name] = (stem, lib)
    return libs


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

    libs = build_all([spec.partition("=")[::2] for spec in args.variants])
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clock_hz = float(cs.nvidia_smi("clocks.max.sm").split()[0]) * 1e6
    lanes = None
    if any(stem == "ed25519_verify" for stem, _ in libs.values()):
        with multiprocessing.get_context("spawn").Pool(min(8, os.cpu_count() or 1)) as pool:
            lanes = cs.fault_lanes(np.random.default_rng(cs.SEED), cs.Signer(pool))
    for rnd in range(args.rounds):
        names = list(libs) if rnd % 2 == 0 else list(reversed(libs))
        for name in names:
            stem, lib = libs[name]
            _build._libs[stem] = ctypes.CDLL(lib)
            if stem == "ed25519_verify":
                rows = cs.phase_kernels(lanes, dev, challenge=False)
            else:
                rows = {"challenge": cs.phase_challenge(dev, sms, clock_hz)}
            summary = {k: [r["ms"], r["ms_at_16384"], r["registers"], r["local_bytes"],
                           r["resident_warps_per_sm"]] for k, r in rows.items()}
            print("RESULT", rnd, name, json.dumps(summary), flush=True)
    print(cs.nvidia_smi("name,power.limit"), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
