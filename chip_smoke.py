#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

Run from the repository root on a machine with a CUDA GPU:

    python3 chip_smoke.py

It imports only ``tendermint_tpu_torch`` (never jax or the JAX package)
and, in order:

0. set-up: makes every key, message and signature of the run from one
   numpy seed, signing with the port's pure-Python RFC 8032 signer in a
   pool of worker processes (before any CUDA work; timed on its own);
1. device: prints the card and builds the kernels with nvcc;
2. kernels: runs each kernel (K1 ``verify``, K2 ``verify_tables``) on
   1,024 seeded lanes with planted faults and ZIP-215 edge cases, on the
   card, and requires its verdicts to equal its plain PyTorch version's
   lane for lane and, on the faulty lanes and a sample of the rest, the
   host oracle's (K2 also on the same tables scaled to Z != 1); then
   checks kernel against plain version again on 1,001 and 4,095 lanes
   (ragged edges), a 4,096-lane chunk (the main path's shape: the 1,024
   lanes four times, each copy rotated) and 16,384 lanes; times the
   kernel at 4,096 and 16,384 lanes and the plain version at 4,096 (CUDA
   events, median); and prints each kernel's registers, stack and shared
   bytes, and its resident and launched warps per SM;
3. verify_batch: 8,192 lanes from 256 signers with 8 planted bad lanes and
   no activated validator set (K1, two chunks), and its sigs/s;
4. verify_commit: a 10,000-validator commit (activates the set, builds
   the tables on the host, K2 over three chunks), a second commit at the
   next height (the steady state: no table builds), its p50 latency, and
   a third commit with one bad signature, which must be rejected at that
   index.

Kernel launch counts are reset just before phase 3 and read just after
phase 4. Each phase prints one JSON line; then the kernel table, the
card's ``nvidia-smi`` name and power limit, and last
``{"ok": true, "device": {...}}``. Any failure exits non-zero before the
last line. Without CUDA it exits with code 2 and prints no result.
"""

from __future__ import annotations

import hashlib
import json
import multiprocessing
import os
import statistics
import subprocess
import sys
import time

import numpy as np

SEED = 20261016
KERNEL_LANES = 1024
KERNEL_SIGNERS = 64
TIMING_LANES = 4096
WIDE_TIMING_LANES = 16384
RAGGED_LANES = (1001, TIMING_LANES - 1)
BATCH_LANES = 8192
BATCH_SIGNERS = 256
COMMIT_VALIDATORS = 10_000
COMMIT_HEIGHTS = (1, 2, 3)  # cold, steady state, bad signature
BAD_COMMIT_INDEX = 4321
CHAIN_ID = "chip-smoke"
P50_REPS = 9
BATCH_REPS = 5

# Field squarings and multiplies per lane, as counted in the source note
# of csrc/ed25519_verify.cu. A multiply is 100 32x32->64-bit products and
# a squaring 55, each product two 32-bit integer multiplies.
SQS_PER_LANE = {"verify": 1546, "verify_tables": 1291}
MULS_PER_LANE = {"verify": 2107, "verify_tables": 1960}
INT32_MULS_PER_FE_SQ = 110
INT32_MULS_PER_FE_MUL = 200
INT32_MULS_PER_SM_CLOCK = 64  # CUDA programming guide, compute capability 9.0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
# Bytes a lane must move: each input row read once, the verdict written once.
BYTES_PER_LANE = {"verify": 4 * 32 + 1, "verify_tables": 8 * 4 * 32 + 1 + 3 * 32 + 1}
REPLACES = {
    "verify": "tendermint_tpu/ops/pallas_verify.py:443",
    "verify_tables": "tendermint_tpu/ops/pallas_verify.py:498",
}


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def host_profile(fn, top: int = 20) -> dict:
    """One call of ``fn`` under cProfile: the functions with the largest
    cumulative time, as {"file:function": ms}, and the profiled wall ms.
    The profiler slows Python code, so read the shares, not the sums."""
    import cProfile
    import pstats

    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    fn()
    prof.disable()
    wall_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(pstats.Stats(prof).stats.items(), key=lambda kv: -kv[1][3])
    out = {}
    for (path, _, func), (_, _, _, cum, _) in rows:
        label = f"{os.path.basename(path)}:{func}" if path != "~" else func
        if label not in out and "chip_smoke" not in path and "cProfile" not in label:
            out[label] = cum * 1e3
        if len(out) == top:
            break
    return {"profiled_wall_ms": wall_ms, "cumulative_ms": out}


def cuda_ms(fn, reps: int) -> float:
    """Median device time of ``fn()`` over ``reps`` runs, by CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# --- set-up: keys, messages, signatures ---------------------------------------


def _keypair(seed: bytes):
    from tendermint_tpu_torch.crypto import ed25519_ref as ref

    return ref.keypair_from_seed(seed)


def _sign(job):
    from tendermint_tpu_torch.crypto import ed25519_ref as ref

    priv, msg = job
    return ref.sign(priv, msg)


class Signer:
    """Pure-Python key generation and signing spread over a process pool."""

    def __init__(self, pool):
        self.pool = pool

    def keys(self, rng, n):
        seeds = [bytes(rng.integers(0, 256, 32, dtype=np.uint8)) for _ in range(n)]
        return self.pool.map(_keypair, seeds, chunksize=64)

    def sign(self, privs, msgs):
        return self.pool.map(_sign, list(zip(privs, msgs)), chunksize=64)


def fault_lanes(rng, signer):
    """KERNEL_LANES lanes from KERNEL_SIGNERS signers; every 8th lane
    carries one of eight faults or ZIP-215 edge cases. Returns pks, msgs,
    sigs and the faulty lane indices."""
    from tendermint_tpu_torch.crypto import ed25519_ref as ref

    keys = signer.keys(rng, KERNEL_SIGNERS)
    pks = [keys[i % KERNEL_SIGNERS][1] for i in range(KERNEL_LANES)]
    msgs = [bytes(rng.integers(0, 256, 100, dtype=np.uint8)) for _ in range(KERNEL_LANES)]
    sigs = signer.sign([keys[i % KERNEL_SIGNERS][0] for i in range(KERNEL_LANES)], msgs)
    ident = (1).to_bytes(32, "little")
    s0 = 12345
    r0 = ref.pt_compress(ref.pt_mul(s0, ref.B_POINT))
    sig215 = r0 + s0.to_bytes(32, "little")
    faulty = list(range(3, KERNEL_LANES, 8))
    for j, i in enumerate(faulty):
        kind = j % 8
        if kind == 0:  # bad s (still canonical)
            s = (int.from_bytes(sigs[i][32:], "little") + 1) % ref.L
            sigs[i] = sigs[i][:32] + s.to_bytes(32, "little")
        elif kind == 1:  # tampered message
            msgs[i] = msgs[i][:-1] + bytes([msgs[i][-1] ^ 1])
        elif kind == 2:  # R replaced by another lane's
            sigs[i] = sigs[i - 1][:32] + sigs[i][32:]
        elif kind == 3:  # wrong key
            pks[i] = pks[i - 1]
        elif kind == 4:  # identity key: R = [s]B verifies for any message
            pks[i], msgs[i], sigs[i] = ident, b"x", sig215
        elif kind == 5:  # non-canonical encoding P + 1 of the identity
            pks[i], msgs[i], sigs[i] = (ref.P + 1).to_bytes(32, "little"), b"x", sig215
        elif kind == 6:  # s >= L: the host check rejects it
            pks[i], msgs[i], sigs[i] = ident, b"x", r0 + (s0 + ref.L).to_bytes(32, "little")
        else:  # off-curve R (y = 2)
            sigs[i] = bytes([2] + [0] * 31) + sigs[i][32:]
    return pks, msgs, sigs, faulty


def batch_lanes(rng, signer):
    """BATCH_LANES lanes, signers cycled as in bench/workload.py, with 8
    planted bad lanes. Returns pks, msgs, sigs and the expected verdicts."""
    keys = signer.keys(rng, BATCH_SIGNERS)
    msgs = [bytes(rng.integers(0, 256, 120, dtype=np.uint8)) for _ in range(BATCH_LANES)]
    pks = [keys[i % BATCH_SIGNERS][1] for i in range(BATCH_LANES)]
    sigs = signer.sign([keys[i % BATCH_SIGNERS][0] for i in range(BATCH_LANES)], msgs)
    bad = sorted(rng.choice(BATCH_LANES, 8, replace=False).tolist())
    for j, i in enumerate(bad):
        if j % 2:
            msgs[i] = msgs[i][:-1] + bytes([msgs[i][-1] ^ 0x80])
        else:
            sigs[i] = sigs[i][:40] + bytes([sigs[i][40] ^ 1]) + sigs[i][41:]
    want = np.ones(BATCH_LANES, dtype=bool)
    want[bad] = False
    return pks, msgs, sigs, want


def commit_workload(rng, signer):
    """A COMMIT_VALIDATORS-validator set and one fully signed commit per
    height in COMMIT_HEIGHTS; the last one gets a bad signature at
    BAD_COMMIT_INDEX."""
    from tendermint_tpu_torch.crypto.keys import Ed25519PubKey
    from tendermint_tpu_torch.encoding.canonical import Timestamp
    from tendermint_tpu_torch.types.block import (
        BLOCK_ID_FLAG_COMMIT,
        BlockID,
        Commit,
        CommitSig,
        PartSetHeader,
    )
    from tendermint_tpu_torch.types.validator import Validator
    from tendermint_tpu_torch.types.validator_set import ValidatorSet

    keys = signer.keys(rng, COMMIT_VALIDATORS)
    vset = ValidatorSet([Validator(Ed25519PubKey(pub), 10) for _, pub in keys])
    priv_by_addr = {Ed25519PubKey(pub).address(): priv for priv, pub in keys}
    privs = [priv_by_addr[v.address] for v in vset.validators]
    block_id = BlockID(hashlib.sha256(b"block").digest(),
                       PartSetHeader(1, hashlib.sha256(b"parts").digest()))
    commits = []
    for height in COMMIT_HEIGHTS:
        ns = 1_700_000_000_000_000_000 + height * 10**9
        commit = Commit(height=height, round=0, block_id=block_id)
        commit.signatures = [
            CommitSig(BLOCK_ID_FLAG_COMMIT, v.address, Timestamp.from_unix_ns(ns + i), b"")
            for i, v in enumerate(vset.validators)
        ]
        msgs = [commit.vote_sign_bytes(CHAIN_ID, i) for i in range(COMMIT_VALIDATORS)]
        for cs, sig in zip(commit.signatures, signer.sign(privs, msgs)):
            cs.signature = sig
        commits.append(commit)
    bad = commits[-1].signatures[BAD_COMMIT_INDEX]
    bad.signature = bad.signature[:40] + bytes([bad.signature[40] ^ 1]) + bad.signature[41:]
    return vset, block_id, commits


# --- phase 2 -------------------------------------------------------------------


def projective(tab: np.ndarray, lam: int) -> np.ndarray:
    """A (8, 4, 32) lane table with X, Y, Z and T of every entry scaled by
    ``lam``: the same points, with Z != 1."""
    from tendermint_tpu_torch.crypto import ed25519_ref as ref

    out = np.empty_like(tab)
    for t in range(tab.shape[0]):
        for c in range(tab.shape[1]):
            v = int.from_bytes(tab[t, c].tobytes(), "little") * lam % ref.P
            out[t, c] = np.frombuffer(v.to_bytes(32, "little"), dtype=np.uint8)
    return out


def lane_subset(args, keys, idx):
    """The lanes ``idx`` of a kernel's inputs (the table's lane axis is
    its last)."""
    return [a.index_select(a.dim() - 1 if k == "tab" else 0, idx).contiguous()
            for k, a in zip(keys, args)]


def rotated_lanes(lanes: int):
    """A ``lanes``-lane index into the KERNEL_LANES lanes: the lanes
    ``lanes // KERNEL_LANES`` times, each copy rotated differently so no
    lane sits where its copy does."""
    return np.concatenate([np.roll(np.arange(KERNEL_LANES), 37 * b)
                           for b in range(lanes // KERNEL_LANES)])


def phase_kernels(lanes, dev):
    import torch

    from tendermint_tpu_torch.crypto import ed25519_ref as ref
    from tendermint_tpu_torch.ops import cuda_verify, ed25519_batch as eb, precompute

    pks, msgs, sigs, faulty = lanes
    checked = faulty + list(range(0, KERNEL_LANES, 16))
    want = {i: ref.verify_zip215(pks[i], msgs[i], sigs[i]) for i in checked}
    inp, host_ok = eb.prepare_batch(pks, msgs, sigs, pad_to=KERNEL_LANES)
    tabs, oks = zip(*(precompute.build_table(pk) for pk in pks))
    inp_t, host_ok_t = eb._prep_table_chunk(pks, msgs, sigs, list(tabs), list(oks), KERNEL_LANES)
    # The same points with Z != 1: K2's general (non-mixed) table add.
    proj_tabs = [projective(t, 2 + i) for i, t in enumerate(tabs)]
    inp_p, _ = eb._prep_table_chunk(pks, msgs, sigs, proj_tabs, list(oks), KERNEL_LANES)
    cases = {
        "verify": (cuda_verify.verify, eb.verify_kernel, ("pk", "r", "s", "k"), inp, host_ok),
        "verify_tables": (
            cuda_verify.verify_tables, eb.verify_kernel_tables,
            ("tab", "ok", "r", "s", "k"), inp_t, host_ok_t,
        ),
    }
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clock_hz = float(nvidia_smi("clocks.max.sm").split()[0]) * 1e6
    attrs = cuda_verify.kernel_attributes()
    # Lane sets beyond the 1,024: ragged counts (a block and a chunk cut
    # short), the main path's 4,096-lane chunk, and a 16,384-lane launch
    # that can hold more warps on each SM.
    big_np = rotated_lanes(TIMING_LANES)
    lane_sets = {
        RAGGED_LANES[0]: np.arange(RAGGED_LANES[0]),
        RAGGED_LANES[1]: big_np[:RAGGED_LANES[1]],
        TIMING_LANES: big_np,
        WIDE_TIMING_LANES: rotated_lanes(WIDE_TIMING_LANES),
    }
    rows = {}
    for name, (kernel, plain, keys, inputs, ok) in cases.items():
        args = [torch.from_numpy(inputs[k]).to(dev) for k in keys]
        got = kernel(*args).cpu().numpy()
        ref_out = plain(*args).cpu().numpy()
        mismatches = int((got != ref_out).sum())
        check(mismatches == 0, f"{name}: {mismatches} lanes differ from the plain version")
        bad = [i for i in checked if bool(got[i] and ok[i]) != want[i]]
        check(not bad, f"{name}: lanes {bad} differ from the host oracle")
        check(any(want.values()) and got[[i for i in checked if want[i]]].all(),
              f"{name}: valid lanes rejected")
        extra = {}
        if name == "verify_tables":
            pargs = [torch.from_numpy(inp_p[k]).to(dev) for k in keys]
            got_p = kernel(*pargs).cpu().numpy()
            proj_mismatches = int((got_p != plain(*pargs).cpu().numpy()).sum())
            check(proj_mismatches == 0 and np.array_equal(got_p, got),
                  f"{name}: projective tables give {proj_mismatches} mismatches")
            extra["projective_mismatches"] = proj_mismatches
        by_lanes = {KERNEL_LANES: mismatches}
        err = np.abs(got.astype(np.int32) - ref_out.astype(np.int32)).max()
        subsets = {}
        for n_lanes, idx_np in lane_sets.items():
            sub = lane_subset(args, keys, torch.from_numpy(idx_np).to(dev))
            got_sub = kernel(*sub).cpu().numpy()
            plain_sub = plain(*sub).cpu().numpy()
            by_lanes[n_lanes] = int((got_sub != plain_sub).sum())
            check(by_lanes[n_lanes] == 0,
                  f"{name}: {by_lanes[n_lanes]} of {n_lanes} lanes differ from the plain version")
            check(np.array_equal(got_sub, got[idx_np]),
                  f"{name}: {n_lanes}-lane verdicts differ from the {KERNEL_LANES}-lane ones")
            err = max(err, np.abs(got_sub.astype(np.int32) - plain_sub.astype(np.int32)).max())
            subsets[n_lanes] = sub
        big, wide = subsets[TIMING_LANES], subsets[WIDE_TIMING_LANES]
        ms = cuda_ms(lambda: kernel(*big), reps=20)
        ms_wide = cuda_ms(lambda: kernel(*wide), reps=10)
        plain_ms = cuda_ms(lambda: plain(*big), reps=3)
        ops_s = TIMING_LANES * (
            SQS_PER_LANE[name] * INT32_MULS_PER_FE_SQ + MULS_PER_LANE[name] * INT32_MULS_PER_FE_MUL
        ) / (sms * INT32_MULS_PER_SM_CLOCK * clock_hz)
        bytes_s = TIMING_LANES * BYTES_PER_LANE[name] / HBM_BYTES_PER_S
        bound_ms = max(ops_s, bytes_s) * 1e3
        a = attrs[name]
        warps_per_block = a["threads_per_block"] // 32
        blocks = -(-TIMING_LANES // a["lanes_per_block"])
        launch = {
            "registers": a["registers"],
            "local_bytes": a["local_bytes"],
            "shared_bytes_per_block": a["shared_bytes"],
            "threads_per_block": a["threads_per_block"],
            "resident_warps_per_sm": a["resident_blocks_per_sm"] * warps_per_block,
            "launched_warps_per_sm_at_4096_max": -(-blocks // sms) * warps_per_block,
            "launched_warps_per_sm_at_4096_mean": blocks * warps_per_block / sms,
        }
        rows[name] = {
            "name": name,
            "route": "cuda",
            "source": "tendermint_tpu_torch/csrc/ed25519_verify.cu",
            "replaces": REPLACES[name],
            "max_abs_err": float(err),
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "operations" if ops_s >= bytes_s else "bytes",
            "library_ms": None,
            "match_plain": True,
            "timing_lanes": TIMING_LANES,
            "bound_share": bound_ms / ms,
            "ms_at_16384": ms_wide,
            "mismatches": mismatches,
            "mismatches_at_timing_lanes": by_lanes[TIMING_LANES],
            "mismatches_by_lanes": {str(k): v for k, v in sorted(by_lanes.items())},
            **launch,
        }
        emit({"phase": "kernel", "name": name, "lanes": KERNEL_LANES, "match_plain": True,
              "lanes_checked_vs_oracle": len(checked), "timing_lanes": TIMING_LANES,
              "mismatches_by_lanes": rows[name]["mismatches_by_lanes"], **extra,
              "ms": ms, "ms_at_16384": ms_wide, "plain_ms": plain_ms, "bound_ms": bound_ms,
              "bound_share": bound_ms / ms, **launch, "sms": sms, "max_sm_clock_hz": clock_hz})
    return rows


# --- phase 3 -------------------------------------------------------------------


def phase_verify_batch(lanes, dev):
    from tendermint_tpu_torch.ops import cuda_verify, precompute, verify_batch

    pks, msgs, sigs, want = lanes
    precompute.reset()  # no activated set: every lane takes K1
    k1_before = cuda_verify.LAUNCHES["verify"]
    times = []
    for _ in range(BATCH_REPS):
        precompute.results.clear()
        t0 = time.perf_counter()
        got = verify_batch(pks, msgs, sigs, device=dev)
        times.append(time.perf_counter() - t0)
        check(np.array_equal(np.asarray(got), want), "verify_batch verdicts wrong")
    k1 = cuda_verify.LAUNCHES["verify"] - k1_before
    check(k1 == 2 * BATCH_REPS, f"verify_batch launched K1 {k1} times, expected {2 * BATCH_REPS}")
    check(cuda_verify.LAUNCHES["verify_tables"] == 0, "verify_batch took K2 without a table")
    precompute.results.clear()
    profile = host_profile(lambda: verify_batch(pks, msgs, sigs, device=dev))
    emit({"phase": "verify_batch", "lanes": BATCH_LANES, "bad_lanes_rejected": int((~want).sum()),
          "seconds": times, "sigs_per_s_median": BATCH_LANES / statistics.median(times),
          "k1_launches": k1, "host_profile": profile})


# --- phase 4 -------------------------------------------------------------------


def phase_commit(workload, dev):
    from tendermint_tpu_torch.ops import cuda_verify, precompute
    from tendermint_tpu_torch.types.validation import InvalidCommitError, verify_commit

    vset, block_id, commits = workload
    chunks = -(-COMMIT_VALIDATORS // 4096)

    def run(commit):
        before = dict(cuda_verify.LAUNCHES)
        builds = precompute.tables.builds
        t = time.perf_counter()
        verify_commit(CHAIN_ID, vset, block_id, commit.height, commit, device=dev)
        secs = time.perf_counter() - t
        delta = {k: cuda_verify.LAUNCHES[k] - before[k] for k in before}
        check(delta == {"verify": 0, "verify_tables": chunks}, f"commit launches {delta}")
        return secs, precompute.tables.builds - builds

    cold_s, cold_builds = run(commits[0])
    check(cold_builds == COMMIT_VALIDATORS, f"first commit built {cold_builds} tables")
    steady_s, steady_builds = run(commits[1])
    check(steady_builds == 0, f"steady-state commit built {steady_builds} tables")
    reps = []
    for _ in range(P50_REPS):  # the same commit with the verdict cache emptied
        precompute.results.clear()
        secs, builds = run(commits[1])
        check(builds == 0, "table builds in the steady state")
        reps.append(secs)
    precompute.results.clear()
    profile = host_profile(lambda: run(commits[1]))
    try:
        verify_commit(CHAIN_ID, vset, block_id, commits[2].height, commits[2], device=dev)
    except InvalidCommitError as exc:
        check(f"(#{BAD_COMMIT_INDEX})" in str(exc), f"bad commit rejected wrongly: {exc}")
    else:
        raise SmokeFailure("commit with a bad signature was accepted")
    emit({"phase": "verify_commit", "validators": COMMIT_VALIDATORS,
          "cold_ms": cold_s * 1e3, "table_builds_cold": cold_builds,
          "steady_first_ms": steady_s * 1e3, "steady_ms": [r * 1e3 for r in reps],
          "steady_p50_ms": statistics.median(reps) * 1e3, "k2_launches_per_commit": chunks,
          "bad_signature_index": BAD_COMMIT_INDEX, "host_profile": profile})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing to run", file=sys.stderr)
        return 2
    from tendermint_tpu_torch.ops import _build, cuda_verify

    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    workers = min(8, os.cpu_count() or 1)
    with multiprocessing.get_context("spawn").Pool(workers) as pool:
        signer = Signer(pool)
        kernel_lanes = fault_lanes(rng, signer)
        batch = batch_lanes(rng, signer)
        commit = commit_workload(rng, signer)
    emit({"phase": "setup", "seconds": time.perf_counter() - t0, "workers": workers,
          "signatures": KERNEL_LANES + BATCH_LANES + len(COMMIT_HEIGHTS) * COMMIT_VALIDATORS})

    dev = torch.device("cuda", 0)
    smi = nvidia_smi("name,power.limit")
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    for src, log in _build.build_log.items():
        print(f"--- nvcc {src}\n{log}", file=sys.stderr)
    emit({"phase": "device", "name": torch.cuda.get_device_name(0), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda, "build_s": build_s})

    rows = phase_kernels(kernel_lanes, dev)
    cuda_verify.reset_launches()  # the main path starts here
    phase_verify_batch(batch, dev)
    phase_commit(commit, dev)
    launches = dict(cuda_verify.LAUNCHES)
    for name, row in rows.items():
        check(launches[name] > 0, f"kernel {name} never launched on the main path")
        row["launches"] = launches[name]
    emit({"kernels": list(rows.values())})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
