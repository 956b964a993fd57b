#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

Run from the repository root on a machine with a CUDA GPU:

    python3 chip_smoke.py

It imports only ``tendermint_tpu_torch`` (never jax or the JAX package)
and, in order:

0. set-up: makes every key, message and signature of the run from one
   numpy seed, signing with the port's pure-Python RFC 8032 signer in a
   pool of worker processes (before any CUDA work; timed on its own);
1. device: prints the card and builds the kernels with nvcc (one process
   per source, in parallel);
2. kernels: runs each verify kernel (K1 ``verify``, K2 ``verify_tables``,
   K3 ``verify_resident``) on 1,024 seeded lanes with planted faults and
   ZIP-215 edge cases, on the card, and requires its verdicts to equal
   its plain PyTorch version's lane for lane and, on the faulty lanes and
   a sample of the rest, the host oracle's; then checks kernel against
   plain version again on 1,001 and 4,095 lanes (ragged edges), a
   4,096-lane chunk (the main path's shape: the 1,024 lanes four times,
   each copy rotated) and 16,384 lanes (K2 also on the same tables scaled
   to Z != 1; K3 on a store of the lanes' keys, with its columns in order
   and shuffled); times the kernel at 4,096 and 16,384 lanes and the
   plain version at 4,096 (CUDA events around back-to-back launches; K3
   and K4 through their C launchers, without the wrappers' host work; K3
   also on a store with one column a lane, indices consecutive and
   shuffled, beside ``index_select`` then K2); and prints each kernel's
   registers, stack and shared bytes, and its resident and launched
   warps per SM. K4 (``challenge``) is held to hashlib and
   ``reduce_mod_l`` at the SHA-512 padding boundaries and on prefixed
   challenges of 1-3 blocks at 1,024, 1,001, 4,095 (padded), 4,096 and
   16,384 lanes, and to its plain version; it is timed at 4,096 and
   16,384 lanes of the phase-3 shape. K5 (``verify_sr``, sr25519) runs
   the same checks on 1,024 seeded sr25519 lanes whose k challenges were
   made in the set-up pool, with planted faults (a mutated s, a wrong
   key, a swapped R, the encodings that DECODE rejects at each step, an
   odd R, the identity key, a cleared marker bit, s >= L), against its
   plain version and, on the faulty lanes and a sample of the rest, the
   host ``sr25519.verify``; it is timed at 4,096 and 16,384 lanes;
3. verify_batch: 8,192 lanes from 256 signers with 8 planted bad lanes and
   no activated validator set (K1 and K4, two chunks each), and its
   sigs/s;
4. verify_commit with the resident store on (the default on CUDA): a
   10,000-validator commit (activates the set, builds the tables on the
   host, uploads the store once, K3 over three chunks), a second commit
   at the next height (the steady state: no table builds, no upload),
   its p50 latency, and a third commit with one bad signature, which must
   be rejected at that index. K4 hashes the chunks whose sign-bytes have
   one length; 4b. the same steady commit with the store off (K2 over
   three chunks, the tables shipped each commit), its runs alternating
   with store-on runs, and both p50s;
5. the mixed commit: 10,000 validators whose keys alternate ed25519 /
   sr25519 (the mix of ``bench/workload.py``'s ``mixed_key_factory``),
   through ``verify_commit`` and its ``MultiBatchVerifier``: the ed25519
   half on K3 (and K4 where a chunk's messages share one length), the
   sr25519 half on K5 with its Merlin challenges on the host. One cold
   commit, the p50 of at least 3 steady ones (as many as fit the phase's
   time budget at the Merlin rate measured there), the Merlin share of
   the host time, a host profile, and a copy with one bad sr25519
   signature, which must be rejected at its index;
7. blocksync: a 32-block window under 500 validators through
   ``verify_commits_pipelined`` (K3), every verdict checked, then a small
   mixed window (K5);
8. the light client: ``verify_adjacent`` walks over 16 headers under
   1,000 validators, one non-adjacent ``verify``, and a tampered, an
   expired and an unlinked header;
9. vote ingest through ``VotePreverifier``, the shared scheduler (its
   defaults) and a ``VoteSet``: after verifying height 2's commit (so the
   node holds the 10,000-validator set's tables), 9a delivers height 3's
   10,000 precommits from 4 peer threads, each in its own seeded order
   and held back while the pre-verifier's queue is over half full, with
   3 bad signatures that must be forwarded untagged and rejected; 9b a
   150-validator round with vote extensions, each step's arrivals spread
   over 100 ms. Each part's warm-up must launch a kernel, every valid
   vote must come tagged and reach its ``VoteSet`` (+2/3 for the block),
   and no flush may fail or fall back; it prints time to +2/3 and to
   all, verifier lanes/s, per-vote latency p50/p99, flushes, coalesced
   and cache-answered lanes, the host and device tiers, and launches;
10. the light client's bisection round: ``evaluate_candidates`` from
   header 1 of phase 8's chain to headers 16, 8, 4, 2 and a copy of 8
   with a bad signature, one ``submit_many`` and one flush; each outcome
   must equal the sequential verifier's; a cold round and the p50 of 5,
   beside the p50 of 5 sequential walks over the same candidates;
11. the light client and its serving tier over 16 heights of 1,000
   validators whose set slides 100 a height (so a jump of more than 6
   heights cannot be trusted at 1/3): 11a, ``LightClient`` syncs from
   height 1 to 16 (``MemoryProvider`` primary behind ``RetryingProvider``,
   one honest witness, an empty store) in its three modes, bisection
   rounds (3 rounds, stored heights 1, 4, 10, 16), one verify a pivot
   (the same heights) and the sequential walk (all 16), each cold and 5
   more times with the verdict cache emptied, with rounds, flushes,
   lanes, table builds, store decodes, launches and a host profile; 11b,
   a bad signature on 16 must give one error in all three modes; 11c,
   a ``LightServer`` on 127.0.0.1 answers ``light_header`` over HTTP: a
   cold miss (3 rounds), a hit with the same bytes, 2,000 hits from 8
   threads (latency p50/p99, hits/s), 8 threads on a fresh server's cold
   16 (one verification), bad heights (``INVALID_PARAMS``),
   ``light_status`` and ``/metrics``; 11d, a witness with a conflicting
   16 gives ``DivergedHeaderError`` with its evidence at the primary,
   and through lightd ``INTERNAL_ERROR`` with the chain's cache dropped;
12. the main path observed: the port's tracer in ``ring`` mode, one
   ``OpsMetrics`` (and lightd's ``LightMetrics``) in one registry bound
   to every unit, the stage observer and the kernel profiler installed.
   12a, the steady 10,000-validator commit (phase 4's set, its tables
   built in the set-up's pool) with the verdict cache emptied, then
   warm: the span tree (``verify_commit`` > ``verify_batch`` >
   ``cache_lookup`` with 0 then 10,000 hits, one ``prep_chunk``,
   ``dispatch_chunk`` and ``collect_chunk`` a K3 chunk, no
   ``host_fallback``), the stage
   histogram against the stage spans, the store and cache counters
   against ``stats()``, and the byte ledger against the store tensor,
   ``memstats()`` and ``torch.cuda.memory_allocated()``; 12f, 5 steady
   commits with the instruments off against 5 with them on, in turns;
   12e, ``torch.profiler`` (CPU and CUDA) over one steady commit and
   one 8,192-lane batch: the kernels it saw against the launches
   counted, the device-busy share of the wall, the top device
   operations and the longest idle gaps with the tracer span open on
   the host at each, the Chrome traces written under ``--trace-dir``
   (default ``build``); 12b, the mixed commit once (sr25519 spans
   against K5 launches); 12c, a fault on one chunk with host fallback
   off (it escapes) and on (``host_fallback`` span lanes, the fallback
   counter and ``snapshot()`` agree; the transition instants equal the
   counter); 12d, phase 11's lightd with the ops metrics in its
   registry: a cold ``light_header`` whose request carries a ``trace``
   member, ``/metrics``, ``/debug/traces?format=chrome`` (the serve's
   ``verify_batch`` spans in the request's trace under
   ``rpc_dispatch``) and ``/debug/memstats``;
13. verifyd on the card (``verifyd/server.py`` and its client): 13a, an
   in-process ``VerifydServer`` with the reference's defaults and
   ``vclient.set_remote_addr``: phase 4's 10,000-validator commit through
   ``verify_commit`` over the wire (three requests of at most 4,096
   lanes), one cold run then 5 in turns with the in-process path, and
   the bad commit rejected with the in-process error's message; 13b,
   four clients at once on a server with room for the mix (admission
   cap, ``max_pending`` and tenant cap 16,384, service budget 60 s; the
   reference's defaults shed a 667-lane light request outright):
   consensus (phase 4's
   commits, 10,000 lanes a call), blocksync (phase 7's blocks, 334 lanes
   a request), light (phase 8's headers, 667) and sr25519 (phase 7's
   mixed window, 64, K5), each with planted bad lanes; every verdict
   must equal the in-process one, some flush must mix clients, and
   nothing may be shed, answered on the host or fail; per-class p50/p99
   and the lanes/s the server verified; 13c, ``brownout.force(1..5)``:
   rpc, light and blocksync shed in that order, consensus never, and
   host-direct (counted) at rungs 4 and 5; after ``force(None)``
   consensus launches again; a fault at ``ed25519.chunk`` with host
   fallback off reaches the client as ``STATUS_INTERNAL``, not as
   verdicts; 13d, set-less traffic from phase 3's 256 signers seen 3
   times under two tenants of 128 pins: K1, then the store (K3), pins
   within quota and the ledger's tenant rows summing to the store's
   bytes; 13e, ``python -m tendermint_tpu_torch verifyd`` as a child
   process: phase 8's header commits (its verdicts equal the in-process
   ones) and one ``verify_commit`` from this process, its STATS_PATH
   snapshot (with its own launch counts), ``/metrics`` and SIGTERM;
6. faults, after the main path, on batches of 256 ed25519 and 128
   sr25519 lanes with bad lanes among them. With host fallback off (the
   default), a transient fault injected at ``ed25519.chunk``,
   ``ed25519.collect`` and ``sr25519.chunk`` must escape the engine after
   the health machine recorded it, with no lane answered on the host and
   the next batch back on the card; a sticky ``CudaError`` 719 must
   disable the card and both engines must then refuse. With host fallback
   on, the same transient faults and a permanent one: every verdict must
   stay right, the host-fallback lanes counted must be the chunk's, and
   the health machine must come back to healthy after the next success
   (or stay disabled, with the batch answered on the host); a hand-built
   ``CudaError`` 700 must classify permanent and 2 transient.

Kernel launch counts are reset just before phase 3 and read just after
phase 4b (K1-K4), and again around each of phases 5 (K5, and the
ed25519 kernels of the mixed commit), 7, 8, 9, 10, 11, 12 and 13 (whose
count is that of the served requests only: each sub-phase's deltas around
what a server answered, without the in-process references, plus the
daemon's own of 13e). After each of these the health machine
must show no host fallback, no transition and the healthy state (in
phase 13 after 13b, and after 13c has reset it). Each phase prints one JSON line; then the kernel table,
the card's ``nvidia-smi`` name and power limit, and last
``{"ok": true, "device": {...}}``. Any failure exits non-zero before the
last line. Without CUDA it exits with code 2 and prints no result.
"""

from __future__ import annotations

import copy
import hashlib
import json
import multiprocessing
import os
import statistics
import subprocess
import sys
import threading
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
STORE_OFF_REPS = 7
BATCH_REPS = 5
TABLE_BYTES = 8 * 4 * 32  # one key's (8, 4, 32) uint8 table column
HASH_LENGTHS = (0, 55, 56, 64, 111, 112, 128)  # SHA-512 padding boundaries
HASH_MSG_LEN_BY_BLOCKS = {1: 40, 2: 120, 3: 250}  # after the 64-byte R || A prefix
MIXED_VALIDATORS = 10_000
MIXED_MIN_REPS = 3  # steady mixed commits, at least
MIXED_MAX_REPS = 9
MIXED_BUDGET_S = 120.0  # phase 5's wall time the repetitions are sized to
FAULT_ED_LANES = 256
FAULT_SR_LANES = 128
# Phase 7, bench/sections.py run_blocksync's shape: a 32-block window
# under 500 validators of equal power.
SYNC_BLOCKS = 32
SYNC_VALIDATORS = 500
SYNC_REPS = 5
SYNC_BAD_BLOCK, SYNC_BAD_INDEX = 9, 200  # a bad signature among the first 334 signers
SYNC_SHORT_BLOCK = 20  # a block short of +2/3
MIXED_SYNC_BLOCKS = 2
MIXED_SYNC_VALIDATORS = 64
# Phase 8, bench/sections.py run_light_client's shape: 16 headers under
# 1,000 validators, walked with verify_adjacent.
LIGHT_HEADERS = 16
LIGHT_VALIDATORS = 1000
LIGHT_REPS = 5
LIGHT_TRUSTING_PERIOD_S = 86400.0
LIGHT_MAX_CLOCK_DRIFT_S = 10.0
LIGHT_BAD_HEADER, LIGHT_BAD_INDEX = 5, 100
# Phase 9, vote ingest. 9a: the precommits of phase 4's 10,000 validators
# for height 3 (the signatures of its third commit), each delivered by
# VOTE_PEERS peer threads in their own seeded order, three of them bad.
# 9b: one round of BASELINE config 2's size, 150 validators with vote
# extensions on, the arrivals of each step spread over ROUND_SPREAD_S.
VOTE_PEERS = 4
VOTE_EXTRA_BAD = 17  # beside BAD_COMMIT_INDEX and COMMIT_VALIDATORS - VOTE_EXTRA_BAD
VOTE_WAIT_S = 300.0  # the longest a part may take before it fails
ROUND_VALIDATORS = 150
ROUND_HEIGHT = 7
ROUND_SPREAD_S = 0.1
# Phase 10: phase 8's chain, one evaluate_candidates round from header 1
# to headers 16, 8, 4 and 2 and a copy of header 8 with one bad signature
# in the trusting pass.
LIGHT_ROUND_CANDIDATES = (16, 8, 4, 2)
LIGHT_ROUND_BAD_INDEX = 200
LIGHT_ROUND_REPS = 5
# Phase 11: the light client and its serving tier (BASELINE config 3 as
# users run it, through light/client.py and light/lightd.py): 16 heights
# of 1,000 validators whose set slides 100 validators a height, so
# heights h and h + k share 1,000 - 100k validators and the 1/3 trust
# level trusts a jump of at most 6: skipping from 1 to 16 bisects in 3
# rounds and stores heights 1, 4, 10 and 16.
LIGHTD_HEADERS = 16
LIGHTD_VALIDATORS = 1000
LIGHTD_SLIDE = 100
LIGHTD_STORE_HEIGHTS = [1, 4, 10, 16]
LIGHTD_ROUNDS = 3
LIGHTD_REPS = 5
LIGHTD_BAD_INDEX = 300  # inside the +2/3 pass of every mode
LIGHTD_HERD = 8  # threads asking for one cold height at once
LIGHTD_HIT_THREADS = 8
LIGHTD_HIT_REQUESTS = 2000

# Field squarings and multiplies per lane, as counted in the source note
# of csrc/ed25519_verify.cu. A multiply is 100 32x32->64-bit products and
# a squaring 55, each product two 32-bit integer multiplies.
SQS_PER_LANE = {"verify": 1546, "verify_tables": 1291, "verify_resident": 1291, "verify_sr": 1538}
MULS_PER_LANE = {"verify": 2107, "verify_tables": 1960, "verify_resident": 1960, "verify_sr": 2103}
INT32_MULS_PER_FE_SQ = 110
INT32_MULS_PER_FE_MUL = 200
INT32_OPS_PER_SM_CLOCK = 64  # CUDA programming guide, compute capability 9.0
# 32-bit integer instructions a SHA-512 block, as counted in the source
# note of csrc/sha512_challenge.cu.
INT32_OPS_PER_SHA512_BLOCK = 3696
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
# Bytes a lane must move: each input row read once, the verdict written once.
BYTES_PER_LANE = {
    "verify": 4 * 32 + 1,
    "verify_tables": TABLE_BYTES + 1 + 3 * 32 + 1,
    "verify_resident": 4 + TABLE_BYTES + 1 + 3 * 32 + 1,
    "verify_sr": 4 * 32 + 1,
}
REPLACES = {
    "verify": "tendermint_tpu/ops/pallas_verify.py:443",
    "verify_tables": "tendermint_tpu/ops/pallas_verify.py:498",
    "verify_resident": "tendermint_tpu/ops/ed25519_batch.py:341",
    "challenge": "tendermint_tpu/ops/hash512.py:298",
    "verify_sr": "tendermint_tpu/ops/sr25519_batch.py:122",
}
SOURCES = {
    "verify": "tendermint_tpu_torch/csrc/ed25519_verify.cu",
    "verify_tables": "tendermint_tpu_torch/csrc/ed25519_verify.cu",
    "verify_resident": "tendermint_tpu_torch/csrc/ed25519_verify.cu",
    "challenge": "tendermint_tpu_torch/csrc/sha512_challenge.cu",
    "verify_sr": "tendermint_tpu_torch/csrc/ed25519_verify.cu",
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


def host_profile(fn, top: int = 30) -> dict:
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


def cuda_ms(fn, reps: int, rounds: int = 3) -> float:
    """Device time of one ``fn()``: CUDA events around ``reps`` calls
    back to back (so the host's time between calls hides behind the
    device's), divided by ``reps``; the median of ``rounds`` such runs."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


# --- set-up: keys, messages, signatures ---------------------------------------


def _keypair(seed: bytes):
    from tendermint_tpu_torch.crypto import ed25519_ref as ref

    return ref.keypair_from_seed(seed)


def _sign(job):
    from tendermint_tpu_torch.crypto import ed25519_ref as ref

    priv, msg = job
    return ref.sign(priv, msg)


def _sr_keypair(seed: bytes):
    """An sr25519 seed's expanded secret (scalar, nonce, public key) and
    its public key."""
    from tendermint_tpu_torch.crypto import sr25519 as sr

    scalar, nonce = sr.expand_seed(seed)
    pub = sr.compress(sr.pt_mul(scalar, sr.B_POINT))
    return (scalar, nonce, pub), pub


def _sign_sr(job):
    from tendermint_tpu_torch.crypto import sr25519 as sr

    expanded, msg, entropy = job
    return sr.sign(b"", msg, _expanded=expanded, entropy=entropy)


def _sr_challenge(job):
    from tendermint_tpu_torch.ops import sr25519_batch as tsb

    msg, pub, r = job
    return tsb._challenge_row(msg, pub, r).tobytes()


def _table(pk: bytes):
    from tendermint_tpu_torch.ops import precompute

    return (pk, *precompute.build_table(pk))


class Signer:
    """Pure-Python key generation and signing spread over a process pool."""

    def __init__(self, pool):
        self.pool = pool

    def keys(self, rng, n):
        seeds = [bytes(rng.integers(0, 256, 32, dtype=np.uint8)) for _ in range(n)]
        return self.pool.map(_keypair, seeds, chunksize=64)

    def sign(self, privs, msgs):
        return self.pool.map(_sign, list(zip(privs, msgs)), chunksize=64)

    def sr_keys(self, rng, n):
        seeds = [bytes(rng.integers(0, 256, 32, dtype=np.uint8)) for _ in range(n)]
        return self.pool.map(_sr_keypair, seeds, chunksize=64)

    def sr_sign(self, rng, expanded, msgs):
        """sr25519 signatures, the RNG's entropy of each drawn from ``rng``."""
        jobs = [(e, m, bytes(rng.integers(0, 256, 32, dtype=np.uint8)))
                for e, m in zip(expanded, msgs)]
        return self.pool.map(_sign_sr, jobs, chunksize=64)

    def sr_challenges(self, msgs, pks, rs):
        """The Merlin challenge rows k of sr25519 lanes, as 32 bytes each."""
        return self.pool.map(_sr_challenge, list(zip(msgs, pks, rs)), chunksize=64)

    def tables(self, vset):
        """The host tables ``(pk, table, ok)`` of ``vset``'s keys, built as
        ``precompute.build_table`` builds them."""
        return self.pool.map(_table, [v.pub_key.bytes() for v in vset.validators], chunksize=64)


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


# The faults planted in sr25519 lanes, in the order plant_sr_faults cycles
# through them.
SR_FAULT_KINDS = (
    "mutated_s", "wrong_key", "swapped_r", "non_square_a", "odd_r", "t_negative_a",
    "y_zero_a", "identity_a", "marker_cleared", "s_not_below_l",
)


def sr_edge_encodings():
    """Encodings below p and even that ristretto255 DECODE rejects, one
    for each step that can reject: {"non_square_a", "t_negative_a",
    "y_zero_a": 32 bytes}. p - 1 gives y = 0; the others are the first
    of a fixed hash sequence that fails at that step."""
    from tendermint_tpu_torch.crypto import ristretto as rist

    p = rist.P
    found = {"y_zero_a": (p - 1).to_bytes(32, "little")}
    i = 0
    while len(found) < 3:
        s = int.from_bytes(hashlib.sha256(b"sr-edge-%d" % i).digest(), "little")
        s = (s & ((1 << 255) - 1)) & ~1
        i += 1
        if s >= p:
            continue
        ss = s * s % p
        u1, u2 = (1 - ss) % p, (1 + ss) % p
        v = (-(rist.D * u1 * u1) - u2 * u2) % p
        square, inv = rist.invsqrt(v * u2 * u2 % p)
        if not square:
            found.setdefault("non_square_a", s.to_bytes(32, "little"))
            continue
        x = rist._abs(2 * s * inv * u2)
        y = u1 * (inv * inv * u2 * v) % p
        if rist._is_negative(x * y) and y:
            found.setdefault("t_negative_a", s.to_bytes(32, "little"))
    return found


def plant_sr_faults(pks, msgs, sigs, lanes):
    """Plant SR_FAULT_KINDS, cycled, into sr25519 lanes ``lanes`` (in
    place; lane i - 1 must be a valid lane of another signer). Returns
    {lane: kind}. Every kind is rejected but "identity_a": the identity
    key with R = [s]B verifies for any message."""
    from tendermint_tpu_torch.crypto import ristretto as rist

    edges = sr_edge_encodings()

    def marked(s: int) -> bytes:
        return (s | 1 << 255).to_bytes(32, "little")

    s0 = 12345
    kinds = {}
    for j, i in enumerate(lanes):
        kind = SR_FAULT_KINDS[j % len(SR_FAULT_KINDS)]
        s = int.from_bytes(sigs[i][32:], "little") & ((1 << 255) - 1)
        if kind == "mutated_s":
            sigs[i] = sigs[i][:32] + marked((s + 1) % rist.L)
        elif kind == "wrong_key":
            pks[i] = pks[i - 1]
        elif kind == "swapped_r":
            sigs[i] = sigs[i - 1][:32] + sigs[i][32:]
        elif kind == "odd_r":
            sigs[i] = bytes([sigs[i][0] ^ 1]) + sigs[i][1:]
        elif kind == "identity_a":
            pks[i] = bytes(32)
            sigs[i] = rist.compress(rist.pt_mul(s0, rist.B_POINT)) + marked(s0)
        elif kind == "marker_cleared":
            sigs[i] = sigs[i][:32] + s.to_bytes(32, "little")
        elif kind == "s_not_below_l":
            sigs[i] = sigs[i][:32] + marked(s + rist.L)
        else:
            pks[i] = edges[kind]
        kinds[i] = kind
    return kinds


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


def sr_fault_lanes(rng, signer):
    """KERNEL_LANES sr25519 lanes from KERNEL_SIGNERS signers; every 8th
    lane carries one of SR_FAULT_KINDS. The k challenges are made in the
    pool. Returns pks, msgs, sigs, {faulty lane: kind} and the k rows."""
    keys = signer.sr_keys(rng, KERNEL_SIGNERS)
    pks = [keys[i % KERNEL_SIGNERS][1] for i in range(KERNEL_LANES)]
    msgs = [bytes(rng.integers(0, 256, 100, dtype=np.uint8)) for _ in range(KERNEL_LANES)]
    sigs = signer.sr_sign(rng, [keys[i % KERNEL_SIGNERS][0] for i in range(KERNEL_LANES)], msgs)
    kinds = plant_sr_faults(pks, msgs, sigs, range(3, KERNEL_LANES, 8))
    ks = signer.sr_challenges(msgs, pks, [sig[:32] for sig in sigs])
    return pks, msgs, sigs, kinds, ks


def mixed_commit_workload(rng, signer):
    """A MIXED_VALIDATORS-validator set whose keys alternate ed25519 /
    sr25519 in the order they are made (bench/workload.py's
    mixed_key_factory), one commit signed by all, and a copy of it with a
    bad signature at the first sr25519 validator from BAD_COMMIT_INDEX on.
    Returns the set, the block id, the commit, the bad copy and its bad
    index."""
    from tendermint_tpu_torch.crypto.keys import Ed25519PubKey
    from tendermint_tpu_torch.crypto.sr25519 import Sr25519PubKey
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

    ed = signer.keys(rng, MIXED_VALIDATORS // 2)
    sr = signer.sr_keys(rng, MIXED_VALIDATORS - MIXED_VALIDATORS // 2)
    secret_of = {}  # address -> ed25519 private key or sr25519 expanded secret
    vals = []
    for i in range(MIXED_VALIDATORS):
        secret, raw = ed[i // 2] if i % 2 == 0 else sr[i // 2]
        pub = Ed25519PubKey(raw) if i % 2 == 0 else Sr25519PubKey(raw)
        secret_of[pub.address()] = secret
        vals.append(Validator(pub, 10))
    vset = ValidatorSet(vals)
    block_id = BlockID(hashlib.sha256(b"mixed-block").digest(),
                       PartSetHeader(1, hashlib.sha256(b"mixed-parts").digest()))
    commit = Commit(height=1, round=0, block_id=block_id)
    ns = 1_700_000_000_000_000_000
    commit.signatures = [
        CommitSig(BLOCK_ID_FLAG_COMMIT, v.address, Timestamp.from_unix_ns(ns + i), b"")
        for i, v in enumerate(vset.validators)
    ]
    is_sr = [v.pub_key.type == "sr25519" for v in vset.validators]
    msgs = [commit.vote_sign_bytes(CHAIN_ID, i) for i in range(MIXED_VALIDATORS)]
    for want_sr, sign in ((False, signer.sign), (True, lambda e, m: signer.sr_sign(rng, e, m))):
        idx = [i for i in range(MIXED_VALIDATORS) if is_sr[i] == want_sr]
        sigs = sign([secret_of[vset.validators[i].address] for i in idx], [msgs[i] for i in idx])
        for i, sig in zip(idx, sigs):
            commit.signatures[i].signature = sig
    bad_index = next(i for i in range(BAD_COMMIT_INDEX, MIXED_VALIDATORS) if is_sr[i])
    bad = copy.deepcopy(commit)
    sig = bad.signatures[bad_index].signature
    bad.signatures[bad_index].signature = sig[:40] + bytes([sig[40] ^ 1]) + sig[41:]
    return vset, block_id, commit, bad, bad_index


def chain_workload(rng, signer, n_heights, n_vals, mixed=False):
    """A signed-header chain of ``n_heights`` under ``n_vals`` validators
    (``types/carry.py``'s twin of bench/workload.py's build_header_chain),
    signed in the pool. With ``mixed`` the keys alternate ed25519 /
    sr25519 as they are made (bench/workload.py's mixed_key_factory)."""
    from tendermint_tpu_torch.crypto.keys import Ed25519PubKey
    from tendermint_tpu_torch.crypto.sr25519 import Sr25519PubKey
    from tendermint_tpu_torch.types import carry

    if mixed:
        ed = signer.keys(rng, n_vals - n_vals // 2)
        sr = signer.sr_keys(rng, n_vals // 2)
        keys = [(ed[i // 2][0], Ed25519PubKey(ed[i // 2][1])) if i % 2 == 0
                else (sr[i // 2][0], Sr25519PubKey(sr[i // 2][1])) for i in range(n_vals)]
    else:
        keys = [(priv, Ed25519PubKey(pub)) for priv, pub in signer.keys(rng, n_vals)]

    def sign_many(secrets, msgs):
        """ed25519 secrets are private-key bytes, sr25519 ones expanded tuples."""
        sigs = [None] * len(msgs)
        for is_ed, sign in ((True, signer.sign), (False, lambda e, m: signer.sr_sign(rng, e, m))):
            idx = [i for i, sec in enumerate(secrets) if isinstance(sec, bytes) == is_ed]
            if idx:
                for i, sig in zip(idx, sign([secrets[i] for i in idx], [msgs[i] for i in idx])):
                    sigs[i] = sig
        return sigs

    return carry.build_header_chain(n_heights, keys, sign_many, chain_id=CHAIN_ID)


def round_workload(rng, signer):
    """BASELINE config 2's round: ROUND_VALIDATORS validators, a prevote
    and a non-nil precommit with a signed vote extension from each, for
    one block at ROUND_HEIGHT. Returns the set, the block id, the
    prevotes and the precommits (the port's votes, in validator order)."""
    from tendermint_tpu_torch.crypto.keys import Ed25519PubKey
    from tendermint_tpu_torch.encoding.canonical import (
        SIGNED_MSG_TYPE_PRECOMMIT,
        SIGNED_MSG_TYPE_PREVOTE,
        Timestamp,
    )
    from tendermint_tpu_torch.types.block import BlockID, PartSetHeader, Vote
    from tendermint_tpu_torch.types.validator import Validator
    from tendermint_tpu_torch.types.validator_set import ValidatorSet

    keys = signer.keys(rng, ROUND_VALIDATORS)
    vset = ValidatorSet([Validator(Ed25519PubKey(pub), 10) for _, pub in keys])
    priv_by_addr = {Ed25519PubKey(pub).address(): priv for priv, pub in keys}
    privs = [priv_by_addr[v.address] for v in vset.validators]
    block_id = BlockID(hashlib.sha256(b"round-block").digest(),
                       PartSetHeader(1, hashlib.sha256(b"round-parts").digest()))
    ns = 1_700_000_000_000_000_000 + ROUND_HEIGHT * 10**9
    votes = {}
    for t, msg_type in enumerate((SIGNED_MSG_TYPE_PREVOTE, SIGNED_MSG_TYPE_PRECOMMIT)):
        votes[msg_type] = [
            Vote(type=msg_type, height=ROUND_HEIGHT, round=0, block_id=block_id,
                 timestamp=Timestamp.from_unix_ns(ns + t * 10**8 + i), validator_address=v.address,
                 validator_index=i,
                 extension=b"oracle-price/%d" % i if msg_type == SIGNED_MSG_TYPE_PRECOMMIT else b"")
            for i, v in enumerate(vset.validators)
        ]
    prevotes, precommits = votes[SIGNED_MSG_TYPE_PREVOTE], votes[SIGNED_MSG_TYPE_PRECOMMIT]
    msgs = ([v.sign_bytes(CHAIN_ID) for v in prevotes] + [v.sign_bytes(CHAIN_ID) for v in precommits]
            + [v.extension_sign_bytes(CHAIN_ID) for v in precommits])
    sigs = signer.sign(privs * 3, msgs)
    n = ROUND_VALIDATORS
    for i in range(n):
        prevotes[i].signature = sigs[i]
        precommits[i].signature = sigs[n + i]
        precommits[i].extension_signature = sigs[2 * n + i]
    return vset, block_id, prevotes, precommits


def lightd_workload(rng, signer):
    """Phase 11's chain: ``LIGHTD_HEADERS`` light blocks whose set of
    ``LIGHTD_VALIDATORS`` slides ``LIGHTD_SLIDE`` keys a height
    (``types/carry.py`` ``build_rotating_chain``), a copy of the last
    block with one bad signature, and a conflicting last block (the same
    set, another app hash, signed anew), all signed in the pool."""
    from tendermint_tpu_torch.crypto.keys import Ed25519PubKey
    from tendermint_tpu_torch.types import carry
    from tendermint_tpu_torch.types.block import BlockID, Commit, CommitSig, PartSetHeader
    from tendermint_tpu_torch.types.light import LightBlock, SignedHeader

    keys = [(priv, Ed25519PubKey(pub))
            for priv, pub in signer.keys(rng, LIGHTD_HEADERS * LIGHTD_SLIDE + LIGHTD_VALIDATORS)]
    chain = carry.build_rotating_chain(LIGHTD_HEADERS, keys, window=LIGHTD_VALIDATORS,
                                       slide=LIGHTD_SLIDE, sign_many=signer.sign, chain_id=CHAIN_ID)
    top = chain[-1]
    bad = copy.deepcopy(top)
    cs = bad.signed_header.commit.signatures[LIGHTD_BAD_INDEX]
    cs.signature = cs.signature[:40] + bytes([cs.signature[40] ^ 1]) + cs.signature[41:]
    header = copy.deepcopy(top.header)
    header.app_hash = hashlib.sha256(b"conflicting app state").digest()
    block_id = BlockID(header.hash(), PartSetHeader(1, hashlib.sha256(b"conflicting parts").digest()))
    sigs = [CommitSig(c.block_id_flag, c.validator_address, c.timestamp, b"")
            for c in top.signed_header.commit.signatures]
    commit = Commit(height=top.height, round=0, block_id=block_id, signatures=sigs)
    secret_of = {pub.address(): priv for priv, pub in keys}
    for c, sig in zip(sigs, signer.sign([secret_of[c.validator_address] for c in sigs],
                                        [commit.vote_sign_bytes(CHAIN_ID, i) for i in range(len(sigs))])):
        c.signature = sig
    fork = LightBlock(SignedHeader(header, commit), top.validator_set)
    return chain, bad, fork


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
    """The lanes ``idx`` (a CPU index) of a kernel's inputs: the table's
    lane axis is its last, the resident store is shared by every lane,
    and the resident index stays on the host."""
    out = []
    for key, a in zip(keys, args):
        if key == "store":
            out.append(a)
        else:
            dim = a.dim() - 1 if key == "tab" else 0
            out.append(a.index_select(dim, idx.to(a.device)).contiguous())
    return out


def rotated_lanes(lanes: int):
    """A ``lanes``-lane index into the KERNEL_LANES lanes: the lanes
    ``lanes // KERNEL_LANES`` times, each copy rotated differently so no
    lane sits where its copy does."""
    return np.concatenate([np.roll(np.arange(KERNEL_LANES), 37 * b)
                           for b in range(lanes // KERNEL_LANES)])


def kernel_args(inputs, keys, dev):
    """A kernel's arguments on the card; the resident index stays on the
    host, where its wrapper checks it."""
    import torch

    return [torch.as_tensor(inputs[k]).to("cpu" if k == "idx" else dev) for k in keys]


def signer_store(pks, tabs, shuffle_rng=None):
    """A resident store of the lanes' distinct keys: column 0 the pad
    table, then one column a key, in the order of first appearance (or
    shuffled). Returns the (8, 4, 32, K) store and the lanes' columns."""
    from tendermint_tpu_torch.ops import ed25519_batch as eb

    keys = list(dict.fromkeys(pks))
    order = np.arange(len(keys)) if shuffle_rng is None else shuffle_rng.permutation(len(keys))
    col_of = {keys[j]: 1 + c for c, j in enumerate(order)}
    cols = [eb._pad_table()] + [None] * len(keys)
    for pk, tab in zip(pks, tabs):
        cols[col_of[pk]] = tab
    store = np.ascontiguousarray(np.stack(cols).transpose(1, 2, 3, 0))
    return store, np.array([col_of[pk] for pk in pks], dtype=np.int32)


def compare_rows(got, want):
    """(rows of ``got`` that differ from ``want``, max |got - want|), for
    two arrays of one shape whose first axis is the lane."""
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32)).reshape(len(got), -1)
    return int(diff.any(axis=1).sum()), int(diff.max(initial=0))


def check_lane_sets(name, kernel, plain, args, keys, got, lane_sets):
    """Kernel against plain version on every lane set, and against the
    1,024-lane verdicts; returns ({lanes: mismatches}, max |error|,
    {lanes: arguments})."""
    import torch

    by_lanes, err, subsets = {}, 0, {}
    for n_lanes, idx_np in lane_sets.items():
        sub = lane_subset(args, keys, torch.from_numpy(idx_np))
        got_sub = kernel(*sub).cpu().numpy()
        plain_sub = plain(*sub).cpu().numpy()
        by_lanes[n_lanes], e = compare_rows(got_sub, plain_sub)
        check(by_lanes[n_lanes] == 0,
              f"{name}: {by_lanes[n_lanes]} of {n_lanes} lanes differ from the plain version")
        check(np.array_equal(got_sub, got[idx_np]),
              f"{name}: {n_lanes}-lane verdicts differ from the {KERNEL_LANES}-lane ones")
        err = max(err, e)
        subsets[n_lanes] = sub
    return by_lanes, err, subsets


def launch_facts(a, lanes, sms):
    warps_per_block = a["threads_per_block"] // 32
    blocks = -(-lanes // a["lanes_per_block"])
    return {
        "registers": a["registers"],
        "local_bytes": a["local_bytes"],
        "shared_bytes_per_block": a["shared_bytes"],
        "threads_per_block": a["threads_per_block"],
        "resident_warps_per_sm": a["resident_blocks_per_sm"] * warps_per_block,
        "launched_warps_per_sm_at_4096_max": -(-blocks // sms) * warps_per_block,
        "launched_warps_per_sm_at_4096_mean": blocks * warps_per_block / sms,
    }


def resident_timing(k2_subsets, dev, rng):
    """K3 on a store with one column a lane (as a commit's store is), its
    indices consecutive and shuffled, beside ``index_select`` then K2, at
    TIMING_LANES and WIDE_TIMING_LANES. Every variant's verdicts must equal
    K2's on the same lanes."""
    import torch

    from tendermint_tpu_torch.ops import cuda_verify, ed25519_batch as eb

    pad = torch.from_numpy(eb._pad_table()).to(dev)[..., None]
    out = {}
    for n_lanes in (TIMING_LANES, WIDE_TIMING_LANES):
        tab, ok, r, s, k = k2_subsets[n_lanes]
        want = cuda_verify.verify_tables(tab, ok, r, s, k).cpu().numpy()
        consec = torch.cat([pad, tab], dim=3).contiguous()
        idx_c = torch.arange(1, n_lanes + 1, dtype=torch.int32)
        perm = torch.from_numpy(rng.permutation(n_lanes).astype(np.int64))
        shuffled = torch.empty_like(consec)
        shuffled[..., 0] = pad[..., 0]
        shuffled[..., 1 + perm.to(dev)] = tab
        idx_s = (1 + perm).to(torch.int32)
        idx_c_dev, idx_s_dev, idx_l_dev = idx_c.to(dev), idx_s.to(dev), idx_c.to(dev).long()
        variants = {
            "consecutive": lambda: launch_resident(consec, idx_c_dev, ok, r, s, k),
            "shuffled": lambda: launch_resident(shuffled, idx_s_dev, ok, r, s, k),
            "index_select_then_k2": lambda: cuda_verify.verify_tables(
                consec.index_select(3, idx_l_dev), ok, r, s, k),
            "wrapper_consecutive": lambda: cuda_verify.verify_resident(consec, idx_c, ok, r, s, k),
        }
        for label, fn in variants.items():
            check(np.array_equal(fn().cpu().numpy(), want),
                  f"verify_resident ({label}, {n_lanes} lanes) differs from K2")
            out[f"ms_{label}_at_{n_lanes}"] = cuda_ms(fn, reps=20 if n_lanes == TIMING_LANES else 10)
    return out


def launch_resident(store, idx_dev, ok, r, s, k):
    """K3 launched with its index already on the card: the kernel's own
    time, without the wrapper's host check and index upload."""
    from tendermint_tpu_torch.ops import cuda_verify

    return cuda_verify._launch("ed25519_verify_resident_launch", "verify_resident",
                               (store, idx_dev, ok, r, s, k), r.shape[0], r.device, store.shape[3])


def sr_case(sr_lanes):
    """K5's entry of phase_kernels' cases: its inputs from the pool's k
    rows (checked equal to the engine's prep on the first 64 lanes), and
    the host sr25519.verify on the faulty lanes and every 16th."""
    from tendermint_tpu_torch.crypto import sr25519 as sr
    from tendermint_tpu_torch.ops import cuda_verify, sr25519_batch as tsb

    pks, msgs, sigs, kinds, ks = sr_lanes
    pk, r, s, host_ok, has_fields = tsb._host_checks(pks, sigs)
    k = np.stack([np.frombuffer(row, dtype=np.uint8) for row in ks])
    k[~has_fields] = 0
    inputs = dict(pk=pk, r=r, s=s, k=k)
    prep, prep_ok = tsb.prepare_batch_sr(pks[:64], msgs[:64], sigs[:64], pad_to=64)
    check(all(np.array_equal(inputs[key][:64], prep[key]) for key in prep)
          and np.array_equal(host_ok[:64], prep_ok),
          "verify_sr: the pool's inputs differ from prepare_batch_sr's")
    checked = sorted(kinds) + list(range(0, KERNEL_LANES, 16))
    want = {i: sr.verify(pks[i], msgs[i], sigs[i]) for i in checked}
    return (cuda_verify.verify_sr, tsb.verify_kernel_sr, ("pk", "r", "s", "k"), inputs, host_ok, want)


def phase_kernels(lanes, dev, challenge=True, sr_lanes=None):
    """K1-K3 (and K4 with ``challenge``, K5 with ``sr_lanes``) against
    their plain versions and the host oracle, timed; returns the
    ``kernels`` rows by name."""
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
    # K3: a store of the lanes' keys, columns in order of appearance, and
    # the same store with its columns shuffled.
    rng = np.random.default_rng(SEED + 1)
    stores = [signer_store(pks, tabs), signer_store(pks, tabs, rng)]
    inp_r = [dict(inp_t, store=st, idx=ix) for st, ix in stores]
    k3_keys = ("store", "idx", "ok", "r", "s", "k")
    cases = {
        "verify": (cuda_verify.verify, eb.verify_kernel, ("pk", "r", "s", "k"), inp, host_ok, want),
        "verify_tables": (
            cuda_verify.verify_tables, eb.verify_kernel_tables,
            ("tab", "ok", "r", "s", "k"), inp_t, host_ok_t, want,
        ),
        "verify_resident": (
            cuda_verify.verify_resident, eb.verify_kernel_resident, k3_keys, inp_r[0], host_ok_t,
            want,
        ),
    }
    if sr_lanes is not None:
        cases["verify_sr"] = sr_case(sr_lanes)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clock_hz = float(nvidia_smi("clocks.max.sm").split()[0]) * 1e6
    attrs = cuda_verify.kernel_attributes(tuple(cases))
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
    rows, all_subsets = {}, {}
    for name, (kernel, plain, keys, inputs, ok, want) in cases.items():
        checked = sorted(want)
        args = kernel_args(inputs, keys, dev)
        got = kernel(*args).cpu().numpy()
        ref_out = plain(*args).cpu().numpy()
        mismatches, err_1024 = compare_rows(got, ref_out)
        check(mismatches == 0, f"{name}: {mismatches} lanes differ from the plain version")
        bad = [i for i in checked if bool(got[i] and ok[i]) != want[i]]
        check(not bad, f"{name}: lanes {bad} differ from the host oracle")
        check(any(want.values()) and got[[i for i in checked if want[i]]].all(),
              f"{name}: valid lanes rejected")
        extra = {}
        if name == "verify_tables":
            pargs = kernel_args(inp_p, keys, dev)
            got_p = kernel(*pargs).cpu().numpy()
            proj_mismatches, err_p = compare_rows(got_p, plain(*pargs).cpu().numpy())
            check(proj_mismatches == 0 and np.array_equal(got_p, got),
                  f"{name}: projective tables give {proj_mismatches} mismatches")
            by_proj, err_pl, _ = check_lane_sets(name, kernel, plain, pargs, keys, got, lane_sets)
            by_proj[KERNEL_LANES] = proj_mismatches
            extra["projective_mismatches"] = proj_mismatches
            extra["mismatches_by_lanes_projective"] = {str(k): v for k, v in sorted(by_proj.items())}
            err_1024 = max(err_1024, err_p, err_pl)
        by_lanes, err, subsets = check_lane_sets(name, kernel, plain, args, keys, got, lane_sets)
        by_lanes[KERNEL_LANES] = mismatches
        err = max(err, err_1024)
        all_subsets[name] = subsets
        if name == "verify_resident":
            check(np.array_equal(got, rows["verify_tables"]["_got"]), "verify_resident differs from K2")
            sargs = kernel_args(inp_r[1], keys, dev)
            got_s = kernel(*sargs).cpu().numpy()
            plain_s = plain(*sargs).cpu().numpy()
            by_shuffled, err_s, _ = check_lane_sets(name, kernel, plain, sargs, keys, got, lane_sets)
            by_shuffled[KERNEL_LANES], err_1024 = compare_rows(got_s, plain_s)
            check(by_shuffled[KERNEL_LANES] == 0 and np.array_equal(got_s, got),
                  f"verify_resident with shuffled store columns: {by_shuffled[KERNEL_LANES]} lanes "
                  "differ from the plain version")
            err = max(err, err_s, err_1024)
            extra["mismatches_by_lanes_shuffled_store"] = {
                str(k): v for k, v in sorted(by_shuffled.items())}
            extra["store_columns"] = int(stores[0][0].shape[3])
            extra.update(resident_timing(all_subsets["verify_tables"], dev, rng))
        big, wide = subsets[TIMING_LANES], subsets[WIDE_TIMING_LANES]
        if name == "verify_resident":  # the kernel alone; the wrapper's time is in `extra`
            big, wide = ([a.to(dev) for a in sub] for sub in (big, wide))
            kernel_t = launch_resident
        else:
            kernel_t = kernel
        ms = cuda_ms(lambda: kernel_t(*big), reps=20)
        ms_wide = cuda_ms(lambda: kernel_t(*wide), reps=10)
        plain_ms = cuda_ms(lambda: plain(*big), reps=1)
        ops_s = TIMING_LANES * (
            SQS_PER_LANE[name] * INT32_MULS_PER_FE_SQ + MULS_PER_LANE[name] * INT32_MULS_PER_FE_MUL
        ) / (sms * INT32_OPS_PER_SM_CLOCK * clock_hz)
        bytes_s = TIMING_LANES * BYTES_PER_LANE[name] / HBM_BYTES_PER_S
        bound_ms = max(ops_s, bytes_s) * 1e3
        launch = launch_facts(attrs[name], TIMING_LANES, sms)
        rows[name] = {
            "name": name,
            "route": "cuda",
            "source": SOURCES[name],
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
            **extra,
            "_got": got,
        }
        emit({"phase": "kernel", "name": name, "lanes": KERNEL_LANES, "match_plain": True,
              "lanes_checked_vs_oracle": len(checked), "timing_lanes": TIMING_LANES,
              "mismatches_by_lanes": rows[name]["mismatches_by_lanes"], **extra,
              "ms": ms, "ms_at_16384": ms_wide, "plain_ms": plain_ms, "bound_ms": bound_ms,
              "bound_share": bound_ms / ms, **launch, "sms": sms, "max_sm_clock_hz": clock_hz})
    for row in rows.values():
        del row["_got"]
    if challenge:
        rows["challenge"] = phase_challenge(dev, sms, clock_hz)
    return rows


def phase_challenge(dev, sms, clock_hz):
    """K4 against hashlib and reduce_mod_l, and against its plain version;
    its time at TIMING_LANES of the phase-3 shape."""
    import torch

    from tendermint_tpu_torch.crypto.hashing import reduce_mod_l, sha512_batch, sha512_batch_prefixed
    from tendermint_tpu_torch.ops import cuda_hash, ed25519_batch as eb, hash512

    rng = np.random.default_rng(SEED + 2)
    err = 0
    by_length = {}
    for length in HASH_LENGTHS:  # the SHA-512 padding boundaries
        mat = rng.integers(0, 256, size=(64, length), dtype=np.uint8)
        blocks = torch.from_numpy(hash512._pack(mat)).to(dev)
        want = reduce_mod_l(sha512_batch([row.tobytes() for row in mat]))
        by_length[str(length)], e = compare_rows(cuda_hash.challenge(blocks).cpu().numpy(), want)
        check(by_length[str(length)] == 0,
              f"challenge: {by_length[str(length)]} rows differ from hashlib mod L at {length} bytes")
        err = max(err, e)
    pad_row_np = eb._pad_rows()[3].reshape(32)
    pad_row = torch.from_numpy(pad_row_np).to(dev)
    vs_host, vs_plain = {}, {}
    for n_lanes, pad_to in ((KERNEL_LANES, KERNEL_LANES), (RAGGED_LANES[0], RAGGED_LANES[0]),
                            (TIMING_LANES - 1, TIMING_LANES), (TIMING_LANES, TIMING_LANES),
                            (WIDE_TIMING_LANES, WIDE_TIMING_LANES)):
        for nblocks, msg_len in HASH_MSG_LEN_BY_BLOCKS.items():
            prefix = rng.integers(0, 256, size=(n_lanes, 64), dtype=np.uint8)
            mat = rng.integers(0, 256, size=(n_lanes, msg_len), dtype=np.uint8)
            blocks = torch.from_numpy(hash512._pack(np.concatenate([prefix, mat], axis=1))).to(dev)
            check(blocks.shape[1] == 128 * nblocks, "challenge: block count")
            got = cuda_hash.challenge(blocks, pad_row, pad_to).cpu().numpy()
            want = reduce_mod_l(sha512_batch_prefixed(prefix, [r.tobytes() for r in mat]))
            want = np.concatenate([want, np.tile(pad_row_np, (pad_to - n_lanes, 1))])
            plain = hash512.challenge_kernel(blocks, pad_row, pad_to).cpu().numpy()
            key = f"{n_lanes}x{nblocks}"
            vs_host[key], e_host = compare_rows(got, want)
            vs_plain[key], e_plain = compare_rows(got, plain)
            check(vs_host[key] == 0 and vs_plain[key] == 0,
                  f"challenge: {n_lanes} lanes, {nblocks} blocks: {vs_host[key]} rows differ "
                  f"from hashlib mod L, {vs_plain[key]} from the plain version")
            err = max(err, e_host, e_plain)
    nblocks = 2  # phase 3: R || A || a 120-byte message
    timed = {}
    for n_lanes in (TIMING_LANES, WIDE_TIMING_LANES):
        prefix = rng.integers(0, 256, size=(n_lanes, 64), dtype=np.uint8)
        mat = rng.integers(0, 256, size=(n_lanes, HASH_MSG_LEN_BY_BLOCKS[nblocks]), dtype=np.uint8)
        blocks = torch.from_numpy(hash512._pack(np.concatenate([prefix, mat], axis=1))).to(dev)
        # The kernel's own time: its C launcher back to back (the wrapper's
        # Python takes longer than the kernel); the wrapper's time beside it.
        out = torch.empty((n_lanes, 32), dtype=torch.uint8, device=dev)
        launcher = cuda_hash._launcher("sha512_challenge_launch")
        stream = torch.cuda.current_stream(dev).cuda_stream
        raw = (blocks.data_ptr(), nblocks, n_lanes, None, out.data_ptr(), n_lanes, stream)
        check(launcher(*raw) == 0, "challenge: raw launch failed")
        check(torch.equal(out, cuda_hash.challenge(blocks)), "challenge: raw launch differs")
        timed[n_lanes] = cuda_ms(lambda: launcher(*raw), reps=200)
        if n_lanes == TIMING_LANES:
            ms_wrapper = cuda_ms(lambda: cuda_hash.challenge(blocks), reps=200)
            plain_ms = cuda_ms(lambda: hash512.challenge_kernel(blocks), reps=1)
    ms = timed[TIMING_LANES]
    ops_s = TIMING_LANES * nblocks * INT32_OPS_PER_SHA512_BLOCK / (
        sms * INT32_OPS_PER_SM_CLOCK * clock_hz)
    bytes_s = TIMING_LANES * (128 * nblocks + 32) / HBM_BYTES_PER_S
    bound_ms = max(ops_s, bytes_s) * 1e3
    launch = launch_facts(cuda_hash.challenge_attributes(), TIMING_LANES, sms)
    row = {
        "name": "challenge",
        "route": "cuda",
        "source": SOURCES["challenge"],
        "replaces": REPLACES["challenge"],
        "max_abs_err": float(err),
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "operations" if ops_s >= bytes_s else "bytes",
        "library_ms": None,
        "match_plain": True,
        "timing_lanes": TIMING_LANES,
        "timing_blocks": nblocks,
        "ms_at_16384": timed[WIDE_TIMING_LANES],
        "ms_wrapper": ms_wrapper,
        "bound_share": bound_ms / ms,
        "mismatches_by_boundary_length": by_length,
        "mismatches_by_lanes_x_blocks": vs_host,
        "plain_mismatches_by_lanes_x_blocks": vs_plain,
        **launch,
    }
    emit({"phase": "kernel", **row})
    return row


# --- phase 3 -------------------------------------------------------------------


def chunk_sizes(lanes):
    """The padded sizes of the chunks ``lanes`` lanes are verified in."""
    from tendermint_tpu_torch.ops import ed25519_batch as eb

    return [eb._bucket(min(eb.CHUNK, lanes - lo)) for lo in range(0, lanes, eb.CHUNK)]


def launches():
    """Every kernel's launch count so far."""
    from tendermint_tpu_torch.ops import cuda_hash, cuda_verify

    return {**cuda_verify.LAUNCHES, **cuda_hash.LAUNCHES}


def delta(before):
    return {k: v - before[k] for k, v in launches().items() if v != before[k]}


def add_launches(*counts):
    """The sum of launch-count dicts, by kernel."""
    out = {}
    for c in counts:
        for k, v in c.items():
            out[k] = out.get(k, 0) + v
    return out


def phase_verify_batch(lanes, dev):
    from tendermint_tpu_torch.ops import hash512, precompute, resident, verify_batch

    pks, msgs, sigs, want = lanes
    precompute.reset()  # no activated set: every lane takes K1
    check(resident.stats()["resident_keys"] == 0, "precompute.reset() left the store")
    before = launches()
    lanes_before = hash512.stats()["device_lanes"]
    times = []
    for _ in range(BATCH_REPS):
        precompute.results.clear()
        t0 = time.perf_counter()
        got = verify_batch(pks, msgs, sigs, device=dev)
        times.append(time.perf_counter() - t0)
        check(np.array_equal(np.asarray(got), want), "verify_batch verdicts wrong")
    d = delta(before)
    device_lanes = hash512.stats()["device_lanes"] - lanes_before
    want_n = len(chunk_sizes(BATCH_LANES)) * BATCH_REPS
    check(d == {"verify": want_n, "challenge": want_n},
          f"verify_batch launches {d}, expected K1 and K4 {want_n} times each")
    check(device_lanes == BATCH_LANES * BATCH_REPS,
          f"device hash took {device_lanes} lanes, expected {BATCH_LANES * BATCH_REPS}")
    precompute.results.clear()
    profile = host_profile(lambda: verify_batch(pks, msgs, sigs, device=dev))
    emit({"phase": "verify_batch", "lanes": BATCH_LANES, "bad_lanes_rejected": int((~want).sum()),
          "seconds": times, "sigs_per_s_median": BATCH_LANES / statistics.median(times),
          "launches": d, "device_hash_lanes": device_lanes, "host_profile": profile})


# --- phase 4 -------------------------------------------------------------------


def sign_bytes_lengths(commit):
    """The distinct sign-bytes lengths of a commit, over all lanes and per
    chunk."""
    from tendermint_tpu_torch.ops import ed25519_batch as eb

    lens = [len(commit.vote_sign_bytes(CHAIN_ID, i)) for i in range(COMMIT_VALIDATORS)]
    return sorted(set(lens)), [sorted(set(lens[lo:lo + eb.CHUNK])) for lo in range(0, len(lens), eb.CHUNK)]


def phase_commit(workload, dev):
    from tendermint_tpu_torch.ops import hash512, precompute, resident
    from tendermint_tpu_torch.types.validation import InvalidCommitError, verify_commit

    vset, block_id, commits = workload
    chunks = len(chunk_sizes(COMMIT_VALIDATORS))
    lengths, chunk_lengths = sign_bytes_lengths(commits[1])
    # The device hash takes the chunks whose messages share one length.
    hashed = sum(len(c) == 1 for c in chunk_lengths)

    def run(commit, kernel):
        before = launches()
        mixed = hash512.stats()["declined_mixed_lengths"]
        builds = precompute.tables.builds
        t = time.perf_counter()
        verify_commit(CHAIN_ID, vset, block_id, commit.height, commit, device=dev)
        secs = time.perf_counter() - t
        d = delta(before)
        want = {kernel: chunks, **({"challenge": hashed} if hashed else {})}
        check(d == want, f"commit launches {d}, expected {want}")
        check(hash512.stats()["declined_mixed_lengths"] - mixed == chunks - hashed,
              "chunks of mixed sign-bytes lengths not sent to host hashing")
        return secs, precompute.tables.builds - builds

    def steady(kernel, reps):
        out = []
        for _ in range(reps):  # the same commit with the verdict cache emptied
            precompute.results.clear()
            secs, builds = run(commits[1], kernel)
            check(builds == 0, "table builds in the steady state")
            out.append(secs)
        return out

    resident.reset()
    cold_s, cold_builds = run(commits[0], "verify_resident")
    check(cold_builds == COMMIT_VALIDATORS, f"first commit built {cold_builds} tables")
    store = resident.stats()
    check(store["uploads"] == 1 and store["resident_keys"] == COMMIT_VALIDATORS
          and store["h2d_bytes"] == (COMMIT_VALIDATORS + 1) * TABLE_BYTES,
          f"cold commit store {store}")
    steady_s, steady_builds = run(commits[1], "verify_resident")
    check(steady_builds == 0, f"steady-state commit built {steady_builds} tables")
    reps = steady("verify_resident", P50_REPS)
    precompute.results.clear()
    profile = host_profile(lambda: run(commits[1], "verify_resident"))
    after = resident.stats()
    check(after["uploads"] == 1 and after["gathered_h2d_bytes"] == 0,
          f"steady commits moved table bytes: {after}")
    try:
        verify_commit(CHAIN_ID, vset, block_id, commits[2].height, commits[2], device=dev)
    except InvalidCommitError as exc:
        check(f"(#{BAD_COMMIT_INDEX})" in str(exc), f"bad commit rejected wrongly: {exc}")
    else:
        raise SmokeFailure("commit with a bad signature was accepted")
    emit({"phase": "verify_commit", "resident_store": "on", "validators": COMMIT_VALIDATORS,
          "cold_ms": cold_s * 1e3, "table_builds_cold": cold_builds,
          "steady_first_ms": steady_s * 1e3, "steady_ms": [r * 1e3 for r in reps],
          "steady_p50_ms": statistics.median(reps) * 1e3, "k3_launches_per_commit": chunks,
          "k4_launches_per_commit": hashed, "sign_bytes_lengths": lengths,
          "sign_bytes_lengths_by_chunk": chunk_lengths,
          "host_hashed_chunks_per_commit": chunks - hashed, "host_hash_reason": "mixed lengths",
          "store": resident.stats(), "bad_signature_index": BAD_COMMIT_INDEX,
          "host_profile": profile})

    # 4b: the store off, the same steady commit: K2 and the tables shipped.
    # Off and on runs alternate, so the host's drift falls on both.
    off_reps, on_reps = [], []
    gathered = resident.stats()["gathered_h2d_bytes"]
    for _ in range(STORE_OFF_REPS):
        resident.configure("off")
        try:
            off_reps += steady("verify_tables", 1)
        finally:
            resident.configure(None)
        on_reps += steady("verify_resident", 1)
    per_commit = (resident.stats()["gathered_h2d_bytes"] - gathered) / STORE_OFF_REPS
    padded = sum(chunk_sizes(COMMIT_VALIDATORS))
    check(per_commit == padded * TABLE_BYTES,
          f"store off: {per_commit} table bytes a commit, expected {padded * TABLE_BYTES}")
    check(resident.stats()["uploads"] == 1, "the store was uploaded again")
    resident.configure("off")
    try:
        precompute.results.clear()
        off_profile = host_profile(lambda: run(commits[1], "verify_tables"))
    finally:
        resident.configure(None)
    emit({"phase": "verify_commit", "resident_store": "off", "validators": COMMIT_VALIDATORS,
          "steady_ms": [r * 1e3 for r in off_reps],
          "steady_p50_ms": statistics.median(off_reps) * 1e3,
          "interleaved_store_on_ms": [r * 1e3 for r in on_reps],
          "interleaved_store_on_p50_ms": statistics.median(on_reps) * 1e3,
          "phase4_store_on_p50_ms": statistics.median(reps) * 1e3,
          "k2_launches_per_commit": chunks, "gathered_table_bytes_per_commit": per_commit,
          "host_profile": off_profile})
    precompute.reset()
    check(resident.stats()["resident_keys"] == 0, "precompute.reset() left the store")


# --- health ---------------------------------------------------------------------


def check_healthy(where: str) -> dict:
    """The health machine after a stretch of the main path: no host
    fallback in either engine, no transition, healthy. Returns the
    snapshot."""
    from tendermint_tpu_torch.ops import device_policy

    snap = device_policy.shared.snapshot()
    check(snap["state"] == "healthy" and not snap["transitions"] and snap["fallback_batches"] == 0
          and not any(snap["fallback_lanes"].values()),
          f"host fallback or a health transition on the main path ({where}): {snap}")
    return snap


# --- phase 5 -------------------------------------------------------------------


def phase_mixed_commit(workload, dev):
    """The mixed ed25519 + sr25519 commit; returns the launch counts of the
    phase (which starts with every count at 0)."""
    from tendermint_tpu_torch.ops import precompute, resident, sr25519_batch as tsb
    from tendermint_tpu_torch.ops import ed25519_batch as eb
    from tendermint_tpu_torch.types.validation import InvalidCommitError, verify_commit

    vset, block_id, commit, bad, bad_index = workload
    is_sr = [v.pub_key.type == "sr25519" for v in vset.validators]
    n_sr = sum(is_sr)
    n_ed = MIXED_VALIDATORS - n_sr
    ed_lens = [len(commit.vote_sign_bytes(CHAIN_ID, i)) for i in range(MIXED_VALIDATORS) if not is_sr[i]]
    ed_chunk_lengths = [sorted(set(ed_lens[lo:lo + eb.CHUNK])) for lo in range(0, n_ed, eb.CHUNK)]
    hashed = sum(len(c) == 1 for c in ed_chunk_lengths)
    want = {"verify_resident": len(chunk_sizes(n_ed)), "verify_sr": len(chunk_sizes(n_sr)),
            **({"challenge": hashed} if hashed else {})}
    merlin = [0.0]
    challenge_row = tsb._challenge_row

    def timed_challenge_row(*args):
        t = time.perf_counter()
        try:
            return challenge_row(*args)
        finally:
            merlin[0] += time.perf_counter() - t

    def run(c):
        """One verify_commit of ``c`` with the verdict cache emptied:
        (seconds, Merlin seconds)."""
        precompute.results.clear()
        before = launches()
        merlin[0] = 0.0
        t = time.perf_counter()
        verify_commit(CHAIN_ID, vset, block_id, c.height, c, device=dev)
        secs = time.perf_counter() - t
        d = delta(before)
        check(d == want, f"mixed commit launches {d}, expected {want}")
        return secs, merlin[0]

    t_phase = time.perf_counter()
    tsb._challenge_row = timed_challenge_row
    try:
        resident.reset()
        builds = precompute.tables.builds
        cold_s, cold_merlin = run(commit)
        cold_builds = precompute.tables.builds - builds
        check(cold_builds == n_ed, f"mixed cold commit built {cold_builds} tables, expected {n_ed}")
        steady = [run(commit)]
        # As many steady commits as fit the phase's budget at this host's
        # rate, leaving room for the profiled run (about two commits under
        # cProfile) and the bad commit.
        left = MIXED_BUDGET_S - (time.perf_counter() - t_phase)
        reps = max(MIXED_MIN_REPS, min(MIXED_MAX_REPS, int(left / steady[0][0]) - 3))
        steady += [run(commit) for _ in range(reps - 1)]
        check(precompute.tables.builds - builds == n_ed, "table builds in the mixed steady state")
    finally:
        tsb._challenge_row = challenge_row
    precompute.results.clear()
    profile = host_profile(lambda: verify_commit(CHAIN_ID, vset, block_id, commit.height, commit,
                                                 device=dev))
    try:
        verify_commit(CHAIN_ID, vset, block_id, bad.height, bad, device=dev)
    except InvalidCommitError as exc:
        check(f"(#{bad_index})" in str(exc), f"bad mixed commit rejected wrongly: {exc}")
    else:
        raise SmokeFailure("mixed commit with a bad sr25519 signature was accepted")
    counts = launches()
    secs = [r[0] for r in steady]
    shares = [r[1] / r[0] for r in steady]
    emit({"phase": "mixed_commit", "validators": MIXED_VALIDATORS, "ed25519_lanes": n_ed,
          "sr25519_lanes": n_sr, "cold_ms": cold_s * 1e3, "cold_merlin_ms": cold_merlin * 1e3,
          "table_builds_cold": cold_builds, "steady_ms": [x * 1e3 for x in secs],
          "steady_p50_ms": statistics.median(secs) * 1e3,
          "steady_merlin_ms": [r[1] * 1e3 for r in steady],
          "merlin_share_of_steady": shares, "merlin_share_p50": statistics.median(shares),
          "merlin_ms_per_sr25519_lane_p50": statistics.median(r[1] for r in steady) * 1e3 / n_sr,
          "engine_split_launches_per_commit": want,
          "ed25519_sign_bytes_lengths_by_chunk": ed_chunk_lengths,
          "bad_signature_index": bad_index, "launches": counts, "store": resident.stats(),
          "phase_s": time.perf_counter() - t_phase, "host_profile": profile})
    precompute.reset()
    return counts


# --- phase 7 -------------------------------------------------------------------


def sync_tasks(chain, vset, commits=None):
    from tendermint_tpu_torch.parallel.pipeline import CommitTask

    commits = commits or [sh.commit for sh in chain]
    return [CommitTask(CHAIN_ID, vset, c.block_id, c.height, c) for c in commits]


def lanes_and_chunks(tasks):
    """The lanes a window verifies (each block stops past +2/3, every
    signature here a commit one) and their sign-bytes lengths by chunk."""
    from tendermint_tpu_torch.ops import ed25519_batch as eb

    lens = []
    for t in tasks:
        needed, tallied = t.vals.total_voting_power() * 2 // 3, 0
        for i, v in enumerate(t.vals.validators):
            lens.append(len(t.commit.vote_sign_bytes(CHAIN_ID, i)))
            tallied += v.voting_power
            if tallied > needed:
                break
    return len(lens), [sorted(set(lens[lo:lo + eb.CHUNK])) for lo in range(0, len(lens), eb.CHUNK)]


def phase_blocksync(sync, mixed_sync, dev):
    """BASELINE config 4: a 32-block window through
    ``verify_commits_pipelined``, every verdict checked; then a small
    mixed ed25519 + sr25519 window. Returns the phase's launch counts
    (which start at 0)."""
    from tendermint_tpu_torch.ops import hash512, precompute, resident
    from tendermint_tpu_torch.parallel.pipeline import verify_commits_pipelined
    from tendermint_tpu_torch.types.block import CommitSig
    from tendermint_tpu_torch.types.validation import InvalidCommitError, NotEnoughVotingPowerError

    chain, vset, _ = sync
    tasks = sync_tasks(chain, vset)
    n_lanes, chunk_lengths = lanes_and_chunks(tasks)
    check(n_lanes == SYNC_BLOCKS * (SYNC_VALIDATORS * 2 // 3 + 1),
          f"blocksync window of {n_lanes} lanes")
    hashed = sum(len(c) == 1 for c in chunk_lengths)
    chunks = len(chunk_sizes(n_lanes))
    want_launches = {"verify_resident": chunks, **({"challenge": hashed} if hashed else {})}

    def run(window):
        precompute.results.clear()  # new blocks: no verdict is cached
        before = launches()
        mixed = hash512.stats()["declined_mixed_lengths"]
        t = time.perf_counter()
        verdicts = verify_commits_pipelined(window, device=dev)
        secs = time.perf_counter() - t
        d = delta(before)
        check(d == want_launches, f"blocksync launches {d}, expected {want_launches}")
        check(hash512.stats()["declined_mixed_lengths"] - mixed == chunks - hashed,
              "blocksync chunks of mixed sign-bytes lengths not sent to host hashing")
        return secs, verdicts

    precompute.reset()
    builds = precompute.tables.builds
    cold_s, verdicts = run(tasks)
    check(all(v.ok for v in verdicts), f"blocksync window rejected: {verdicts}")
    # A table for each validator that signs before its block's stop.
    cold_builds = precompute.tables.builds - builds
    check(cold_builds == n_lanes // SYNC_BLOCKS, f"blocksync warm-up built {cold_builds} tables")
    reps = []
    for _ in range(SYNC_REPS):
        secs, verdicts = run(tasks)
        check(all(v.ok for v in verdicts), "blocksync window rejected")
        reps.append(secs)
    check(precompute.tables.builds - builds == cold_builds, "table builds in the steady window")
    profile = host_profile(lambda: run(tasks))

    # Every verdict: a bad signature among a block's first 334 signers,
    # and a block with a third of its validators absent.
    commits = [sh.commit for sh in chain]
    commits[SYNC_BAD_BLOCK] = copy.deepcopy(commits[SYNC_BAD_BLOCK])
    cs = commits[SYNC_BAD_BLOCK].signatures[SYNC_BAD_INDEX]
    cs.signature = cs.signature[:40] + bytes([cs.signature[40] ^ 1]) + cs.signature[41:]
    commits[SYNC_SHORT_BLOCK] = copy.deepcopy(commits[SYNC_SHORT_BLOCK])
    short = commits[SYNC_SHORT_BLOCK].signatures
    n_absent = SYNC_VALIDATORS - SYNC_VALIDATORS * 2 // 3
    for i in range(SYNC_VALIDATORS - n_absent, SYNC_VALIDATORS):
        short[i] = CommitSig.absent()
    precompute.results.clear()
    verdicts = verify_commits_pipelined(sync_tasks(chain, vset, commits), device=dev)
    for b, v in enumerate(verdicts):
        if b == SYNC_BAD_BLOCK:
            check(not v.ok and isinstance(v.error, InvalidCommitError)
                  and f"(#{SYNC_BAD_INDEX})" in str(v.error), f"bad block verdict {v}")
        elif b == SYNC_SHORT_BLOCK:
            check(not v.ok and isinstance(v.error, NotEnoughVotingPowerError), f"short block verdict {v}")
        else:
            check(v.ok, f"block {b} rejected: {v.error!r}")
    rejections = {"bad": str(verdicts[SYNC_BAD_BLOCK].error)[:40],
                  "short": str(verdicts[SYNC_SHORT_BLOCK].error)}

    # The mixed window: sr25519 lanes go to K5, ed25519 ones to K3. The
    # JAX package's pipeline rejects this valid window.
    mchain, mvset, _ = mixed_sync
    mtasks = sync_tasks(mchain, mvset)
    precompute.results.clear()
    before = launches()
    t = time.perf_counter()
    mverdicts = verify_commits_pipelined(mtasks, device=dev)
    mixed_s = time.perf_counter() - t
    mixed_launches = delta(before)
    check(all(v.ok for v in mverdicts), f"mixed blocksync window rejected: {mverdicts}")
    check(mixed_launches.get("verify_sr", 0) >= 1 and mixed_launches.get("verify_resident", 0) >= 1,
          f"mixed blocksync window launches {mixed_launches}")
    sr_idx = [i for i, v in enumerate(mvset.validators) if v.pub_key.type == "sr25519"]
    mcommits = [sh.commit for sh in mchain]
    mcommits[1] = copy.deepcopy(mcommits[1])
    cs = mcommits[1].signatures[sr_idx[3]]
    cs.signature = cs.signature[:40] + bytes([cs.signature[40] ^ 1]) + cs.signature[41:]
    precompute.results.clear()
    bad_mixed = verify_commits_pipelined(sync_tasks(mchain, mvset, mcommits), device=dev)
    check(bad_mixed[0].ok and not bad_mixed[1].ok and f"(#{sr_idx[3]})" in str(bad_mixed[1].error),
          f"mixed window with a bad sr25519 signature: {bad_mixed}")
    counts = launches()
    emit({"phase": "blocksync", "blocks": SYNC_BLOCKS, "validators": SYNC_VALIDATORS,
          "lanes_per_call": n_lanes, "chunks_per_call": chunk_sizes(n_lanes),
          "sign_bytes_lengths_by_chunk": chunk_lengths, "launches_per_call": want_launches,
          "cold_ms": cold_s * 1e3, "table_builds_cold": cold_builds,
          "seconds": reps, "blocksync_blocks_per_s_v500": SYNC_BLOCKS / statistics.median(reps),
          "window_p50_ms": statistics.median(reps) * 1e3,
          "bad_block": SYNC_BAD_BLOCK, "bad_index": SYNC_BAD_INDEX, "short_block": SYNC_SHORT_BLOCK,
          "rejections": rejections, "mixed_window": {
              "blocks": MIXED_SYNC_BLOCKS, "validators": MIXED_SYNC_VALIDATORS, "ms": mixed_s * 1e3,
              "launches": mixed_launches, "bad_sr25519_index": sr_idx[3]},
          "launches": counts, "store": resident.stats(), "host_profile": profile})
    precompute.reset()
    return counts


# --- phase 8 -------------------------------------------------------------------


def phase_light(light, dev):
    """BASELINE config 3: walks of ``verify_adjacent`` over a 16-header
    chain, one non-adjacent ``verify`` from the first header to the last,
    and the outcomes of a tampered signature, an expired trusted header
    and a broken validators-hash link. Returns the phase's launch counts
    (which start at 0)."""
    from tendermint_tpu_torch.encoding.canonical import Timestamp
    from tendermint_tpu_torch.light import verifier
    from tendermint_tpu_torch.ops import precompute, resident

    chain, vset, _ = light
    now = Timestamp.from_unix_ns(chain[-1].header.time.to_unix_ns() + 2 * 10**9)
    period, drift = LIGHT_TRUSTING_PERIOD_S, LIGHT_MAX_CLOCK_DRIFT_S
    step_lanes = LIGHT_VALIDATORS * 2 // 3 + 1
    per_walk = {"verify_resident": (LIGHT_HEADERS - 1) * len(chunk_sizes(step_lanes))}

    def walk():
        precompute.results.clear()  # each header is new: no verdict is cached
        before = launches()
        t = time.perf_counter()
        for i in range(1, len(chain)):
            verifier.verify_adjacent(chain[i - 1], chain[i], vset, period, now, drift, device=dev)
        secs = time.perf_counter() - t
        d = delta(before)
        check(d == per_walk, f"light walk launches {d}, expected {per_walk}")
        return secs

    precompute.reset()
    builds = precompute.tables.builds
    cold_s = walk()
    cold_builds = precompute.tables.builds - builds
    check(cold_builds == step_lanes, f"light warm-up built {cold_builds} tables")
    reps = [walk() for _ in range(LIGHT_REPS)]
    check(precompute.tables.builds - builds == step_lanes, "table builds in the steady walks")
    profile = host_profile(walk)
    # Header 1 to header 16: the trusting pass (1/3 of the trusted set,
    # looked up by address) and the +2/3 pass of the new set.
    precompute.results.clear()
    before = launches()
    t = time.perf_counter()
    verifier.verify(chain[0], vset, chain[-1], vset, period, now, drift, device=dev)
    skip_s = time.perf_counter() - t
    skip_launches = delta(before)
    # The +2/3 pass finds the trusting pass's lanes in the verdict cache;
    # the rest have one sign-bytes length, so K4 hashes them.
    check(skip_launches == {"verify_resident": 2, "challenge": 1},
          f"non-adjacent verify launches {skip_launches}")

    def outcome(fn, *args, **kwargs):
        precompute.results.clear()
        try:
            fn(*args, **kwargs, device=dev)
        except (verifier.InvalidHeaderError, verifier.HeaderExpiredError) as exc:
            return type(exc).__name__, str(exc)
        return "ok", ""

    bad = copy.deepcopy(chain[LIGHT_BAD_HEADER])
    cs = bad.commit.signatures[LIGHT_BAD_INDEX]
    cs.signature = cs.signature[:40] + bytes([cs.signature[40] ^ 1]) + cs.signature[41:]
    unlinked = copy.deepcopy(chain[2])
    unlinked.header.next_validators_hash = hashlib.sha256(b"another set").digest()
    outcomes = {
        "tampered_signature": outcome(verifier.verify_adjacent, chain[LIGHT_BAD_HEADER - 1], bad,
                                      vset, period, now, drift),
        "expired": outcome(verifier.verify_adjacent, chain[0], chain[1], vset, 1.0, now, drift),
        "broken_next_validators_link": outcome(verifier.verify_adjacent, unlinked, chain[3], vset,
                                               period, now, drift),
    }
    check(outcomes["tampered_signature"][0] == "InvalidHeaderError"
          and f"(#{LIGHT_BAD_INDEX})" in outcomes["tampered_signature"][1],
          f"tampered header: {outcomes['tampered_signature']}")
    check(outcomes["expired"][0] == "HeaderExpiredError", f"expired header: {outcomes['expired']}")
    check(outcomes["broken_next_validators_link"] == (
        "InvalidHeaderError", "expected old header's next validators to match those from new header"),
        f"broken link: {outcomes['broken_next_validators_link']}")
    counts = launches()
    walk_p50 = statistics.median(reps)
    emit({"phase": "light_client", "headers": LIGHT_HEADERS, "validators": LIGHT_VALIDATORS,
          "lanes_per_step": step_lanes, "chunks_per_step": chunk_sizes(step_lanes),
          "launches_per_walk": per_walk, "cold_walk_ms": cold_s * 1e3,
          "table_builds_cold": cold_builds, "walk_ms": [r * 1e3 for r in reps],
          "walk_p50_ms": walk_p50 * 1e3, "step_p50_ms": walk_p50 * 1e3 / (LIGHT_HEADERS - 1),
          "light_client_headers_per_s_v1000": (LIGHT_HEADERS - 1) / walk_p50,
          "non_adjacent_1_to_16_ms": skip_s * 1e3, "non_adjacent_launches": skip_launches,
          "outcomes": {k: v[0] for k, v in outcomes.items()}, "launches": counts,
          "store": resident.stats(), "host_profile": profile})
    precompute.reset()
    return counts


# --- phase 9 -------------------------------------------------------------------


class ConsensusStandIn:
    """The slice of ``ConsensusState`` that ``VotePreverifier`` reads
    (``consensus/reactor.py`` ``ConsensusView``): the round state's height
    and validators, the chain id, and ``add_vote_from_peer``, which adds
    the vote to the ``VoteSet`` of its type. Records, per delivery, the
    time from submit to forward, whether the vote came tagged, and what
    the vote set made of it."""

    def __init__(self, height, vset, vote_sets, bad, want_block):
        from types import SimpleNamespace

        self.rs = SimpleNamespace(height=height, validators=vset)
        self.state = SimpleNamespace(chain_id=CHAIN_ID)
        self.vote_sets = vote_sets  # signed message type -> VoteSet
        self.bad = bad  # (type, validator index) of the bad votes
        self.want_block = want_block  # the block every vote set must reach +2/3 for
        self.lock = threading.Lock()
        self.sent = {}  # id(vote) -> perf_counter at submit  # guarded-by: lock
        self.latencies = []
        self.forwarded = self.added = self.duplicates = 0
        self.untagged_valid = 0
        self.bad_outcomes = []  # (index, tagged, error type, message)
        self.errors = []  # anything else the vote sets raised
        self.t_quorum = {}  # type -> perf_counter when +2/3 was reached
        self.t_all = {}  # type -> perf_counter when every valid vote was in

    def submitting(self, vote) -> None:
        with self.lock:
            self.sent[id(vote)] = time.perf_counter()

    def add_vote_from_peer(self, vote, peer_id) -> None:
        from tendermint_tpu_torch.types.block import VoteError

        t = time.perf_counter()
        tagged = vote._pre_verified is not None
        vs = self.vote_sets[vote.type]
        err = None
        try:
            added = vs.add_vote(vote)
        except VoteError as exc:
            added, err = None, exc
        except Exception as exc:  # recorded and failed by the phase
            added, err = None, exc
        with self.lock:
            self.latencies.append(t - self.sent.pop(id(vote)))
            self.forwarded += 1
            key = (vote.type, vote.validator_index)
            if key in self.bad:
                self.bad_outcomes.append((vote.validator_index, tagged, type(err).__name__, str(err)))
                return
            if err is not None:
                self.errors.append(repr(err))
                return
            self.untagged_valid += not tagged
            if added:
                self.added += 1
                if vote.type not in self.t_quorum and vs.has_two_thirds_majority():
                    self.t_quorum[vote.type] = t
                valid = vs.size() - sum(1 for ty, _ in self.bad if ty == vote.type)
                if vs.sum == valid * vs.val_set.validators[0].voting_power:
                    self.t_all[vote.type] = t
            else:
                self.duplicates += 1

    def wait_forwarded(self, n, timeout) -> bool:
        deadline = time.perf_counter() + timeout
        while time.perf_counter() < deadline:
            with self.lock:
                if self.forwarded >= n:
                    return True
            time.sleep(0.002)
        return False


def percentile(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))]


def ingest_counters():
    """The counters a vote-ingest run is read by: the shared scheduler's,
    the verdict cache's, the tiers' and the kernels'."""
    from tendermint_tpu_torch.crypto import batch as crypto_batch
    from tendermint_tpu_torch.ops import precompute

    sched = crypto_batch.get_shared_scheduler().stats()
    return {"sched": sched, "cache": precompute.results.stats(), "tiers": dict(crypto_batch.tier_lanes),
            "tier_s": dict(crypto_batch.tier_seconds), "launches": launches()}


def ingest_delta(before):
    after = ingest_counters()
    sched = {k: after["sched"][k] - before["sched"][k] for k in after["sched"] if k != "flush_reasons"}
    sched["flush_reasons"] = {k: v - before["sched"]["flush_reasons"][k]
                              for k, v in after["sched"]["flush_reasons"].items()}
    return {
        "sched": sched,
        "cache": {k: after["cache"][k] - before["cache"][k] for k in ("hits", "misses")},
        "tiers": {k: after["tiers"][k] - before["tiers"][k] for k in after["tiers"]},
        "tier_s": {k: after["tier_s"][k] - before["tier_s"][k] for k in after["tier_s"]},
        "launches": {k: v - before["launches"][k] for k, v in after["launches"].items()
                     if v != before["launches"][k]},
    }


def start_preverifier(cs):
    """A started, warm pre-verifier over ``cs``; checks that its warm-up
    kept no error and launched a kernel. Returns it and the warm-up's
    launches."""
    from tendermint_tpu_torch.consensus.reactor import VotePreverifier

    before = launches()
    pv = VotePreverifier(cs)
    pv.start()
    warm = pv.wait_warmup(timeout=pv.WARMUP_TIMEOUT + 10)
    check(pv.warmup_error is None and warm, f"vote pre-verifier warm-up: {pv.warmup_error!r}")
    warm_launches = delta(before)
    check(sum(warm_launches.values()) > 0, "the warm-up's flush launched no kernel")
    return pv, warm_launches


def ingest_summary(cs, counts, wall):
    sched = counts["sched"]
    lat = cs.latencies
    return {
        "deliveries": cs.forwarded, "added": cs.added, "duplicates": cs.duplicates,
        "latency_p50_ms": percentile(lat, 0.5) * 1e3, "latency_p99_ms": percentile(lat, 0.99) * 1e3,
        "latency_max_ms": max(lat) * 1e3, "flushes": sched["flushes"],
        "lanes_submitted": sched["entries_verified"], "coalesced_lanes": sched["entries_coalesced"],
        "mean_lanes_per_flush": sched["entries_verified"] / max(1, sched["flushes"]),
        "flush_reasons": sched["flush_reasons"], "flush_errors": sched["flush_errors"],
        "fallback_flushes": sched["fallback_flushes"],
        "verdict_cache_answered": counts["cache"]["hits"], "verifier_lanes": counts["cache"]["misses"],
        "host_tier_lanes": counts["tiers"]["host"], "host_tier_cached": counts["tiers"]["host_cached"],
        "device_tier_lanes": counts["tiers"]["device"], "host_tier_s": counts["tier_s"]["host"],
        "device_tier_s": counts["tier_s"]["device"], "launches": counts["launches"],
        "wall_s": wall,
    }


def check_ingest(part, cs, pv, counts, n_valid_deliveries):
    sched = counts["sched"]
    check(not cs.errors, f"{part}: vote set errors {cs.errors[:3]}")
    check(cs.untagged_valid == 0, f"{part}: {cs.untagged_valid} valid votes forwarded untagged")
    check(pv.passthrough == len(cs.bad_outcomes),
          f"{part}: passthrough {pv.passthrough}, bad deliveries {len(cs.bad_outcomes)}")
    check(pv.batched == n_valid_deliveries, f"{part}: batched {pv.batched} of {n_valid_deliveries}")
    check(sched["flush_errors"] == 0 and sched["fallback_flushes"] == 0,
          f"{part}: flush errors {sched['flush_errors']}, fallback flushes {sched['fallback_flushes']}")
    for vs in cs.vote_sets.values():
        maj, ok = vs.two_thirds_majority()
        check(ok and maj == cs.want_block, f"{part}: no +2/3 for the block")
        valid = [i for i in range(vs.size()) if (vs.signed_msg_type, i) not in cs.bad]
        check(all(vs.get_by_index(i) is not None for i in valid), f"{part}: a valid vote is missing")


def phase_votes(commit_wl, round_wl, dev):
    """Vote ingest through ``VotePreverifier`` and the shared scheduler
    into a ``VoteSet``: 9a, the 10,000-validator flood; 9b, one round of
    150 validators with extensions. Returns the launch counts of both
    parts (warm-ups included; they start at 0)."""
    from tendermint_tpu_torch.encoding.canonical import (
        SIGNED_MSG_TYPE_PRECOMMIT,
        SIGNED_MSG_TYPE_PREVOTE,
    )
    from tendermint_tpu_torch.ops import cuda_hash, cuda_verify, precompute, resident
    from tendermint_tpu_torch.types.block import Vote
    from tendermint_tpu_torch.types.validation import verify_commit
    from tendermint_tpu_torch.types.vote_set import VoteSet

    vset, block_id, commits = commit_wl
    # A node that verified height 2's commit holds its set's tables.
    precompute.reset()
    t = time.perf_counter()
    verify_commit(CHAIN_ID, vset, block_id, commits[1].height, commits[1], device=dev)
    hold_s = time.perf_counter() - t
    check(resident.stats()["resident_keys"] == COMMIT_VALIDATORS, "phase 9: the store does not hold the set")
    precompute.results.clear()
    cuda_verify.reset_launches()  # the vote-ingest path starts here
    cuda_hash.reset_launches()

    # 9a: the flood.
    commit = commits[2]
    height = commit.height
    bad = {BAD_COMMIT_INDEX, VOTE_EXTRA_BAD, COMMIT_VALIDATORS - VOTE_EXTRA_BAD}
    sigs = [cs.signature for cs in commit.signatures]
    for i in bad - {BAD_COMMIT_INDEX}:  # commits[2] is already bad at BAD_COMMIT_INDEX
        sigs[i] = sigs[i][:40] + bytes([sigs[i][40] ^ 1]) + sigs[i][41:]

    def vote(i):
        cs = commit.signatures[i]
        return Vote(type=SIGNED_MSG_TYPE_PRECOMMIT, height=height, round=0, block_id=block_id,
                    timestamp=cs.timestamp, validator_address=cs.validator_address, validator_index=i,
                    signature=sigs[i])

    order_rng = np.random.default_rng(SEED + 9)
    deliveries = [[vote(int(i)) for i in order_rng.permutation(COMMIT_VALIDATORS)]
                  for _ in range(VOTE_PEERS)]
    vs = VoteSet(CHAIN_ID, height, 0, SIGNED_MSG_TYPE_PRECOMMIT, vset)
    cs = ConsensusStandIn(height, vset, {SIGNED_MSG_TYPE_PRECOMMIT: vs},
                          {(SIGNED_MSG_TYPE_PRECOMMIT, i) for i in bad}, block_id)
    pv, warm_launches = start_preverifier(cs)
    high_water = pv.QUEUE_MAX // 2

    def peer(k):
        # A peer connection's receive routine: it blocks while the
        # pre-verifier holds more than half its queue, as a Go reactor's
        # receive blocks on a full message queue and TCP holds the peer
        # back, so no valid vote is pushed to the inline path.
        for v in deliveries[k]:
            while pv.queue_depth() > high_water:
                time.sleep(0.0005)
            cs.submitting(v)
            pv.submit(v, f"peer{k}")

    before = ingest_counters()
    t0 = time.perf_counter()
    peers = [threading.Thread(target=peer, args=(k,), name=f"peer{k}") for k in range(VOTE_PEERS)]
    for th in peers:
        th.start()
    n = VOTE_PEERS * COMMIT_VALIDATORS
    done = cs.wait_forwarded(n, VOTE_WAIT_S)
    wall = time.perf_counter() - t0
    for th in peers:
        th.join(timeout=10)
    pv.stop()
    check(done, f"9a: {cs.forwarded} of {n} deliveries forwarded in {VOTE_WAIT_S} s")
    counts = ingest_delta(before)
    check_ingest("9a", cs, pv, counts, VOTE_PEERS * (COMMIT_VALIDATORS - len(bad)))
    check(sorted({i for i, *_ in cs.bad_outcomes}) == sorted(bad)
          and len(cs.bad_outcomes) == VOTE_PEERS * len(bad)
          and all(not tagged and err == "VoteError" and msg == "invalid signature"
                  for _, tagged, err, msg in cs.bad_outcomes),
          f"9a: bad votes {cs.bad_outcomes[:4]}")
    check("verify_resident" in counts["launches"], f"9a: K3 never launched: {counts['launches']}")
    flood = ingest_summary(cs, counts, wall)
    flood.update({
        "validators": COMMIT_VALIDATORS, "peers": VOTE_PEERS, "bad_votes": sorted(bad),
        "hold_commit_ms": hold_s * 1e3, "warmup_launches": warm_launches,
        "to_two_thirds_ms": (cs.t_quorum[SIGNED_MSG_TYPE_PRECOMMIT] - t0) * 1e3,
        "to_all_ms": (cs.t_all[SIGNED_MSG_TYPE_PRECOMMIT] - t0) * 1e3,
        "lanes_per_s": counts["cache"]["misses"] / (cs.t_all[SIGNED_MSG_TYPE_PRECOMMIT] - t0),
        "passthrough": pv.passthrough, "batched": pv.batched,
    })
    emit({"phase": "votes_flood", **flood})

    # 9b: one round of 150 validators, extensions on.
    rvset, rblock, prevotes, precommits = round_wl
    precompute.activate_validator_set(rvset)
    precompute.tables.gather([v.pub_key.bytes() for v in rvset.validators])  # a node holds these tables
    precompute.results.clear()
    sets = {SIGNED_MSG_TYPE_PREVOTE: VoteSet(CHAIN_ID, ROUND_HEIGHT, 0, SIGNED_MSG_TYPE_PREVOTE, rvset),
            SIGNED_MSG_TYPE_PRECOMMIT: VoteSet.extended(CHAIN_ID, ROUND_HEIGHT, 0,
                                                        SIGNED_MSG_TYPE_PRECOMMIT, rvset)}
    rcs = ConsensusStandIn(ROUND_HEIGHT, rvset, sets, set(), rblock)
    rpv, rwarm_launches = start_preverifier(rcs)
    arrival_rng = np.random.default_rng(SEED + 10)
    before = ingest_counters()
    t0 = time.perf_counter()
    step_ms = {}
    for name, votes in (("prevotes", prevotes), ("precommits", precommits)):
        # one gossip round-trip: the step's votes arrive uniformly over
        # ROUND_SPREAD_S, in a seeded order
        at = np.sort(arrival_rng.uniform(0.0, ROUND_SPREAD_S, len(votes)))
        order = arrival_rng.permutation(len(votes))
        start = time.perf_counter()
        for when, i in zip(at, order):
            wait = start + when - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            v = copy.copy(votes[int(i)])
            rcs.submitting(v)
            rpv.submit(v, "peer0")
        check(rcs.wait_forwarded(len(votes) * (1 + (name == "precommits")), VOTE_WAIT_S),
              f"9b: {name} not all forwarded")
        step_ms[name] = (time.perf_counter() - start) * 1e3
    wall = time.perf_counter() - t0
    rpv.stop()
    counts = ingest_delta(before)
    check_ingest("9b", rcs, rpv, counts, 2 * ROUND_VALIDATORS)
    rnd = ingest_summary(rcs, counts, wall)
    rnd.update({"validators": ROUND_VALIDATORS, "spread_ms": ROUND_SPREAD_S * 1e3,
                "step_ms": step_ms, "warmup_launches": rwarm_launches,
                "passthrough": rpv.passthrough, "batched": rpv.batched})
    emit({"phase": "votes_round", **rnd})
    counts = launches()
    precompute.reset()
    return counts


# --- phase 10 ------------------------------------------------------------------


def phase_light_round(light, dev):
    """BASELINE config 3 as one bisection round: ``evaluate_candidates``
    from header 1 to headers 16, 8, 4 and 2 and a copy of header 8 with a
    bad signature, one ``submit_many`` and one flush on the shared
    scheduler. Each outcome must equal the sequential
    ``light.verifier.verify``'s; the sequential walk over the same
    candidates is timed after the round's counts are read. Returns the
    round's launch counts (which start at 0)."""
    from tendermint_tpu_torch.crypto import batch as crypto_batch
    from tendermint_tpu_torch.encoding.canonical import Timestamp
    from tendermint_tpu_torch.light import batch as light_batch
    from tendermint_tpu_torch.light import verifier
    from tendermint_tpu_torch.ops import precompute
    from tendermint_tpu_torch.types.light import LightBlock
    from tendermint_tpu_torch.types.validation import Fraction

    chain, vset, _ = light
    now = Timestamp.from_unix_ns(chain[-1].header.time.to_unix_ns() + 2 * 10**9)
    period, drift, level = LIGHT_TRUSTING_PERIOD_S, LIGHT_MAX_CLOCK_DRIFT_S, Fraction(1, 3)
    bad = copy.deepcopy(chain[7])
    cs = bad.commit.signatures[LIGHT_ROUND_BAD_INDEX]
    cs.signature = cs.signature[:40] + bytes([cs.signature[40] ^ 1]) + cs.signature[41:]
    names = [f"header_{h}" for h in LIGHT_ROUND_CANDIDATES] + ["header_8_bad_signature"]
    base = LightBlock(chain[0], vset)
    cands = [LightBlock(chain[h - 1], vset) for h in LIGHT_ROUND_CANDIDATES] + [LightBlock(bad, vset)]
    sched = crypto_batch.get_shared_scheduler()

    def shape(outcome):
        err = outcome.error
        return outcome.kind, None if err is None else [type(err).__name__, str(err)]

    def one_round():
        precompute.results.clear()
        before = ingest_counters()
        stats0 = light_batch.stats()
        t = time.perf_counter()
        out = light_batch.evaluate_candidates(CHAIN_ID, base, cands, period, now, drift, level,
                                              device=dev)
        secs = time.perf_counter() - t
        stats = {k: v - stats0[k] for k, v in light_batch.stats().items()}
        delta = ingest_delta(before)
        check(stats["super_batches"] == 1 and stats["sequential"] == 0 and stats["timed_out"] == 0
              and stats["failed_closed"] == 0 and delta["sched"]["flushes"] == 1,
              f"light round: {stats}, {delta['sched']['flushes']} flushes")
        return secs, [shape(o) for o in out], delta, stats

    cold_s, outcomes, cold_counts, stats = one_round()  # the set's tables are built here
    reps = [one_round() for _ in range(LIGHT_ROUND_REPS)]
    counts = launches()
    for _, got, _, _ in reps:
        check(got == outcomes, "light round outcomes differ between runs")
    # The sequential verifier's outcome for each candidate, and the time
    # of the walk over all of them, with the verdict cache emptied
    # before each walk as it is before each round.
    walks = []
    for _ in range(LIGHT_ROUND_REPS):
        precompute.results.clear()
        t = time.perf_counter()
        want = [shape(light_batch._resolve_sequential(CHAIN_ID, base, cand, period, now, drift,
                                                      level, dev)) for cand in cands]
        walks.append(time.perf_counter() - t)
        check(outcomes == want, f"light round {outcomes} != sequential {want}")
    check([o[0] for o in outcomes] == ["ok"] * len(LIGHT_ROUND_CANDIDATES) + ["error"]
          and f"(#{LIGHT_ROUND_BAD_INDEX})" in outcomes[-1][1][1], f"light round outcomes {outcomes}")
    check("verify_resident" in counts, f"light round: K3 never launched: {counts}")
    steady = reps[-1][2]
    emit({"phase": "light_round", "headers": LIGHT_HEADERS, "validators": LIGHT_VALIDATORS,
          "candidates": names, "outcomes": dict(zip(names, outcomes)), "lanes": stats["lanes"],
          "cold_ms": cold_s * 1e3, "cold_launches": cold_counts["launches"],
          "round_ms": [r[0] * 1e3 for r in reps],
          "round_p50_ms": statistics.median(r[0] for r in reps) * 1e3,
          "sequential_walk_ms": [w * 1e3 for w in walks],
          "sequential_walk_p50_ms": statistics.median(walks) * 1e3,
          "flushes": steady["sched"]["flushes"], "coalesced_lanes": steady["sched"]["entries_coalesced"],
          "verifier_lanes": steady["cache"]["misses"], "verdict_cache_answered": steady["cache"]["hits"],
          "flush_reasons": steady["sched"]["flush_reasons"],
          "launches_per_round": steady["launches"], "launches": counts,
          "sched_flush_errors": sched.stats()["flush_errors"]})
    precompute.reset()
    return counts


# --- phase 11 ------------------------------------------------------------------


def profile_shares(fn) -> dict:
    """One call of ``fn`` under cProfile: the cumulative ms of the host
    costs the light client's path is read by, and each one's share of
    the profiled wall time. On Python 3.12 the profiler sees every
    thread, so the scheduler's flush thread is in it too; its time
    overlaps the calling thread's wait for it (``scheduler_wait``), so
    the shares can add up to more than 1."""
    import cProfile
    import pstats

    names = {
        "store_decode": ("light.py", "from_proto_bytes"),  # LightBlock's (the largest)
        "store_encode": ("light.py", "to_proto_bytes"),
        "validator_set_hash": ("validator_set.py", "hash"),
        "address_lookups": ("validator_set.py", "get_by_address"),
        "sign_bytes": ("canonical.py", "vote_sign_bytes"),
        "table_builds": ("precompute.py", "build_table"),
        "verify_batch": ("ed25519_batch.py", "verify_batch"),
        "round_plan": ("batch.py", "_plan_candidate"),
        "scheduler_wait": ("scheduler.py", "wait_many"),
        "verify_adjacent": ("verifier.py", "verify_adjacent"),
    }
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    try:
        fn()
    finally:
        prof.disable()
    wall_ms = (time.perf_counter() - t0) * 1e3
    stats = pstats.Stats(prof).stats
    out = {"profiled_wall_ms": wall_ms}
    for label, (base, func) in names.items():
        cum = max([c for (path, _, f), (_, _, _, c, _) in stats.items()
                   if f == func and os.path.basename(path) == base] or [0.0]) * 1e3
        out[label] = {"ms": cum, "share": cum / wall_ms}
    return out


def phase_lightd(workload, dev):
    """BASELINE config 3 as users run it: the light client
    (``light/client.py``) and its serving tier (``light/lightd.py``) over
    16 heights of 1,000 validators that slide 100 a height. 11a syncs
    from height 1 to 16 in the three modes (bisection rounds, the
    one-verify-per-pivot loop, the sequential walk); 11b the same with a
    bad signature on 16; 11c serves ``light_header`` over HTTP (a cold
    miss, hits, a herd on a cold height, bad parameters, status,
    metrics); 11d gives a witness a conflicting 16. Returns the phase's
    launch counts (which start at 0)."""
    import urllib.request

    from tendermint_tpu_torch.crypto import batch as crypto_batch
    from tendermint_tpu_torch.encoding.canonical import Timestamp
    from tendermint_tpu_torch.libs.metrics import LightMetrics, Registry
    from tendermint_tpu_torch.light import batch as light_batch
    from tendermint_tpu_torch.light.client import DivergedHeaderError, LightClient, TrustOptions
    from tendermint_tpu_torch.light.lightd import LightServer
    from tendermint_tpu_torch.light.provider import MemoryProvider, RetryingProvider
    from tendermint_tpu_torch.light.store import LightStore
    from tendermint_tpu_torch.ops import precompute
    from tendermint_tpu_torch.rpc.server import INTERNAL_ERROR, INVALID_PARAMS

    chain, bad_top, fork_top = workload
    top = LIGHTD_HEADERS
    now = Timestamp.from_unix_ns(chain[-1].header.time.to_unix_ns() + 2 * 10**9)
    sched = crypto_batch.get_shared_scheduler()
    flush_errors0 = sched.stats()["flush_errors"]
    failed_closed0 = light_batch.stats()["failed_closed"]

    class CountingStore(LightStore):
        """The client's store, counting the blocks it decodes."""

        decodes = 0

        def _counted(self, lb):
            if lb is not None:
                self.decodes += 1
            return lb

        def light_block(self, height):
            return self._counted(super().light_block(height))

        def latest_light_block(self):
            return self._counted(super().latest_light_block())

        def first_light_block(self):
            return self._counted(super().first_light_block())

        def light_block_before(self, height):
            return self._counted(super().light_block_before(height))

    modes = {
        "batched": {"bisect_batching": True},
        "skipping": {"bisect_batching": False},
        "sequential": {"sequential": True},
    }

    def client(blocks, mode, witness_blocks=None, metrics=None):
        witness = MemoryProvider(CHAIN_ID, chain if witness_blocks is None else witness_blocks)
        return LightClient(
            CHAIN_ID, TrustOptions(period=LIGHT_TRUSTING_PERIOD_S, height=1, hash=blocks[0].hash()),
            RetryingProvider(MemoryProvider(CHAIN_ID, blocks)), [witness], store=CountingStore(),
            max_clock_drift=LIGHT_MAX_CLOCK_DRIFT_S, now=lambda: now, metrics=metrics, device=dev,
            **modes[mode])

    def sync(mode, blocks=chain):
        """A fresh client over ``blocks`` with the verdict cache emptied,
        and its timed ``verify_light_block_at_height(16)``: the block (or
        the error) and the run's counters."""
        precompute.results.clear()
        c = client(blocks, mode)
        decodes0 = c.store.decodes
        before, stats0 = ingest_counters(), light_batch.stats()
        builds0 = precompute.tables.builds
        t = time.perf_counter()
        try:
            got = c.verify_light_block_at_height(top)
        except Exception as exc:  # 11b compares what escaped
            got = exc
        secs = time.perf_counter() - t
        d = ingest_delta(before)
        counts = {
            "ms": secs * 1e3, "rounds": light_batch.stats()["rounds"] - stats0["rounds"],
            "round_lanes": light_batch.stats()["lanes"] - stats0["lanes"],
            "flushes": d["sched"]["flushes"], "verifier_lanes": d["cache"]["misses"],
            "verdict_cache_answered": d["cache"]["hits"],
            "table_builds": precompute.tables.builds - builds0,
            "store_decodes": c.store.decodes - decodes0, "store_heights": c.store.heights(),
            "launches": d["launches"],
        }
        return got, counts

    # 11a: skipping sync, three ways
    want_heights = {"batched": LIGHTD_STORE_HEIGHTS, "skipping": LIGHTD_STORE_HEIGHTS,
                    "sequential": list(range(1, top + 1))}
    syncs = {}
    for mode in modes:
        precompute.reset()  # cold: no table, no verdict
        lb, cold = sync(mode)
        check(not isinstance(lb, Exception), f"phase 11a {mode}: {lb!r}")
        runs = []
        for _ in range(LIGHTD_REPS):
            got, counts = sync(mode)
            check(not isinstance(got, Exception) and got.hash() == chain[-1].hash(),
                  f"phase 11a {mode}: {got!r}")
            runs.append(counts)
        for counts in [cold] + runs:
            check(counts["store_heights"] == want_heights[mode],
                  f"phase 11a {mode}: stored heights {counts['store_heights']}")
            check(counts["rounds"] == (LIGHTD_ROUNDS if mode == "batched" else 0)
                  and counts["flushes"] == (LIGHTD_ROUNDS if mode == "batched" else 0),
                  f"phase 11a {mode}: {counts['rounds']} rounds, {counts['flushes']} flushes")
            check(counts["launches"].get("verify_resident", 0) > 0, f"phase 11a {mode}: K3 never launched")
        check(lb.hash() == chain[-1].hash(), f"phase 11a {mode}: trusted block 16 differs")
        syncs[mode] = {"cold": cold, "runs_ms": [r["ms"] for r in runs],
                       "p50_ms": statistics.median(r["ms"] for r in runs), "steady": runs[-1]}
    profiles = {}
    for name, mode in (("batched_cold", "batched"), ("sequential", "sequential")):
        if name == "batched_cold":
            precompute.reset()
        precompute.results.clear()
        profiles[name] = profile_shares(lambda: client(chain, mode).verify_light_block_at_height(top))
    emit({"phase": "light_sync", "headers": LIGHTD_HEADERS, "validators": LIGHTD_VALIDATORS,
          "slide": LIGHTD_SLIDE, "modes": syncs, "host_profile": profiles})

    # 11b: a bad signature on the target
    bad_chain = chain[:-1] + [bad_top]
    errors = {}
    for mode in modes:
        got, _ = sync(mode, bad_chain)
        check(isinstance(got, Exception), f"phase 11b {mode}: a bad target was accepted")
        errors[mode] = [type(got).__name__, str(got)]
    check(len({tuple(e) for e in errors.values()}) == 1 and errors["batched"][0] == "InvalidHeaderError"
          and errors["batched"][1].startswith(f"wrong signature (#{LIGHTD_BAD_INDEX}): "),
          f"phase 11b: the modes disagree: {errors}")
    emit({"phase": "light_bad_target", "errors": errors})

    # 11c: lightd
    def get(url):
        with urllib.request.urlopen(url, timeout=60) as resp:
            return resp.read()

    def serve(witness_blocks=None):
        reg = Registry()
        metrics = LightMetrics(reg)
        srv = LightServer(client(chain, "batched", witness_blocks, metrics), metrics=metrics, registry=reg)
        srv.start()
        return srv

    srv = serve()
    try:
        url = srv.url + f"/light_header?height={top}"
        precompute.results.clear()
        before, stats0 = ingest_counters(), light_batch.stats()
        t = time.perf_counter()
        miss = get(url)
        cold_ms = (time.perf_counter() - t) * 1e3
        cold_counts = ingest_delta(before)
        cold_rounds = light_batch.stats()["rounds"] - stats0["rounds"]
        result = json.loads(miss)["result"]
        check(result["hash"] == chain[-1].hash().hex().upper()
              and result["trust_path"] == [str(h) for h in LIGHTD_STORE_HEIGHTS[1:]]
              and cold_rounds == LIGHTD_ROUNDS and cold_counts["launches"],
              f"phase 11c: cold serve {result.get('trust_path')}, {cold_rounds} rounds")
        check(get(url) == miss, "phase 11c: the hit's payload differs from the miss's")
        lat, lat_mtx = [], threading.Lock()

        def hits(n):
            mine = []
            for _ in range(n):
                t = time.perf_counter()
                body = get(url)
                mine.append(time.perf_counter() - t)
                check(body == miss, "phase 11c: a hit's payload differs")
            with lat_mtx:
                lat.extend(mine)

        threads = [threading.Thread(target=hits, args=(LIGHTD_HIT_REQUESTS // LIGHTD_HIT_THREADS,))
                   for _ in range(LIGHTD_HIT_THREADS)]
        t = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(300)
        hit_wall = time.perf_counter() - t
        check(len(lat) == LIGHTD_HIT_REQUESTS, f"phase 11c: {len(lat)} hits answered")
        bad_params = {h: json.loads(get(srv.url + f"/light_header?height={h}"))["error"]["code"]
                      for h in ("0", "x")}
        check(set(bad_params.values()) == {INVALID_PARAMS}, f"phase 11c: bad params {bad_params}")
        status = json.loads(get(srv.url + "/light_status"))["result"]
        check(status["trusted_height"] == str(top) and status["cache"]["entries"] == 1,
              f"phase 11c: status {status}")
        metrics_text = get(srv.url + "/metrics").decode()
        families = sorted({line.split()[2] for line in metrics_text.splitlines()
                           if line.startswith("# TYPE tendermint_light_")})
        hits_line = f"tendermint_light_cache_hits_total {LIGHTD_HIT_REQUESTS + 1}"
        check(len(families) == 5 and hits_line in metrics_text, f"phase 11c: metrics families {families}")
    finally:
        srv.stop()
    # the herd: LIGHTD_HERD threads ask a fresh server for its cold 16 at once
    srv = serve()
    try:
        precompute.results.clear()
        gate = threading.Barrier(LIGHTD_HERD)
        answers = []

        def herd():
            gate.wait(60)
            answers.append(get(srv.url + f"/light_header?height={top}"))

        heights0, stats0 = srv.client.store.heights(), light_batch.stats()
        threads = [threading.Thread(target=herd) for _ in range(LIGHTD_HERD)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(300)
        herd_rounds = light_batch.stats()["rounds"] - stats0["rounds"]
        new_heights = sorted(set(srv.client.store.heights()) - set(heights0))
        check(len(answers) == LIGHTD_HERD and len(set(answers)) == 1
              and json.loads(answers[0])["result"]["hash"] == chain[-1].hash().hex().upper(),
              "phase 11c: the herd's answers differ")
        check(herd_rounds == LIGHTD_ROUNDS and new_heights == LIGHTD_STORE_HEIGHTS[1:],
              f"phase 11c: the herd verified {herd_rounds} rounds, stored {new_heights}")
    finally:
        srv.stop()
    # one miss of a fresh server under the profiler, called in-process
    srv = serve()
    try:
        precompute.results.clear()
        miss_profile = profile_shares(lambda: srv.light_header(height=top))
    finally:
        srv.stop()
    emit({"phase": "lightd", "cold_serve_ms": cold_ms, "cold_launches": cold_counts["launches"],
          "cold_rounds": cold_rounds, "cold_flushes": cold_counts["sched"]["flushes"],
          "hit_requests": LIGHTD_HIT_REQUESTS, "hit_threads": LIGHTD_HIT_THREADS,
          "hit_p50_ms": statistics.median(lat) * 1e3, "hit_p99_ms": percentile(lat, 0.99) * 1e3,
          "hits_per_s": LIGHTD_HIT_REQUESTS / hit_wall, "herd_threads": LIGHTD_HERD,
          "herd_rounds": herd_rounds, "herd_new_store_heights": new_heights,
          "bad_params": bad_params, "status": status, "metrics_families": families,
          "host_profile_miss": miss_profile})

    # 11d: a witness with a conflicting 16
    forked = chain[:-1] + [fork_top]
    precompute.results.clear()
    c = client(chain, "batched", forked)
    try:
        c.verify_light_block_at_height(top)
        check(False, "phase 11d: the fork was not detected")
    except DivergedHeaderError as exc:
        evidence = exc.evidence
    reported = c.primary.inner.evidence
    check([e.hash() for e in reported] == [evidence.hash()]
          and evidence.conflicting_block.hash() == fork_top.hash()
          and evidence.common_height == LIGHTD_STORE_HEIGHTS[-2] and top not in c.store.heights(),
          f"phase 11d: evidence {len(reported)}, common height {evidence.common_height}")
    srv = serve(forked)
    try:
        precompute.results.clear()
        below = json.loads(get(srv.url + "/light_header?height=4"))["result"]
        check(below["height"] == "4" and len(srv.cache) == 1, "phase 11d: height 4 not served")
        err = json.loads(get(srv.url + f"/light_header?height={top}"))["error"]
        check(err["code"] == INTERNAL_ERROR and "light client attack" in err["message"]
              and err["data"] == "invalidated 1 cached headers" and len(srv.cache) == 0,
              f"phase 11d: lightd answered {err}")
    finally:
        srv.stop()
    emit({"phase": "light_fork", "evidence_hash": evidence.hash().hex(),
          "common_height": evidence.common_height, "reported_to_primary": len(reported),
          "lightd_error": {k: err[k] for k in ("code", "message", "data")}})
    check(sched.stats()["flush_errors"] == flush_errors0
          and light_batch.stats()["failed_closed"] == failed_closed0, "phase 11: a flush failed")
    counts = launches()
    check(counts.get("verify_resident", 0) > 0, f"phase 11: K3 never launched: {counts}")
    precompute.reset()
    return counts


# --- phase 6 -------------------------------------------------------------------


def phase_faults(ed_lanes, sr_lanes, dev):
    """Injected faults on small batches of both engines (see the module
    note); leaves the health machine reset."""
    import warnings

    from tendermint_tpu_torch.crypto import ed25519_ref as ref, sr25519 as sr
    from tendermint_tpu_torch.ops import _build, device_policy, fault_injection, precompute
    from tendermint_tpu_torch.ops import verify_batch
    from tendermint_tpu_torch.ops.sr25519_batch import verify_batch_sr

    health = device_policy.shared
    ed = [x[:FAULT_ED_LANES] for x in ed_lanes[:3]]
    srl = [x[:FAULT_SR_LANES] for x in sr_lanes[:3]]
    wants = {"ed25519": [ref.verify_zip215(*lane) for lane in zip(*ed)],
             "sr25519": [sr.verify(*lane) for lane in zip(*srl)]}
    check(not all(wants["ed25519"]) and not all(wants["sr25519"]), "fault phase: no bad lane")

    def run_ed():
        precompute.results.clear()  # the device, not the verdict cache, answers
        return verify_batch(*ed, device=dev)

    runs = {"ed25519": run_ed, "sr25519": lambda: verify_batch_sr(*srl, device=dev)}

    def injected(engine, **plan):
        with warnings.catch_warnings(record=True) as warned:
            warnings.simplefilter("always")
            with fault_injection.inject(**plan) as p:
                t = time.perf_counter()
                got = runs[engine]()
                secs = time.perf_counter() - t
        return got, p, secs, len(warned)

    def raised(engine, **plan):
        """The error ``engine``'s batch raised under ``plan``, or None."""
        with fault_injection.inject(**plan) as p:
            try:
                runs[engine]()
            except Exception as exc:  # the phase checks what escaped
                return exc, p
        return None, p

    precompute.reset()
    strict = {}
    check(not health.host_fallback, "host fallback is on by default")
    for site in ("ed25519.chunk", "ed25519.collect", "sr25519.chunk"):
        engine = site.split(".")[0]
        health.reset()
        exc, plan = raised(engine, site=site, fail_calls=(1,))
        snap = health.snapshot()
        check(isinstance(exc, fault_injection.DeviceFault) and plan.faults_raised == 1
              and snap["state"] == "degraded" and snap["failures"]["transient"] == 1
              and snap["fallback_batches"] == 0,
              f"{site}: without host fallback the fault must be recorded and raised: {exc!r} {snap}")
        check(runs[engine]() == wants[engine] and health.state == "healthy",
              f"{site}: the next batch did not use the card again")
        strict[site] = {"raised": type(exc).__name__, "fallback_lanes": 0}
    health.reset()
    exc, _ = raised("sr25519", site="sr25519.chunk", fail_calls=(1,),
                    error_factory=lambda: _build.CudaError("sr25519_verify_launch", 719))
    check(isinstance(exc, _build.CudaError) and health.state == "disabled",
          f"sticky CudaError 719: {exc!r}, state {health.state}")
    refused = [type(raised(e, fail_from=1, fail_count=10**6)[0]).__name__ for e in ("ed25519", "sr25519")]
    check(refused == ["DeviceRefused"] * 2 and not any(health.snapshot()["fallback_lanes"].values()),
          f"disabled card without host fallback: {refused} {health.snapshot()}")
    strict["sticky_719"] = {"raised": type(exc).__name__, "then": refused}

    health.host_fallback = True
    try:
        cases = fallback_cases(health, wants, runs, injected)
    finally:
        health.host_fallback = False
    typed = {code: device_policy.classify_failure(_build.CudaError("sr25519_verify_launch", code))
             for code in (700, 2)}
    check(typed == {700: "permanent", 2: "transient"}, f"CudaError classes {typed}")
    health.reset()
    emit({"phase": "faults", "ed25519_lanes": FAULT_ED_LANES, "sr25519_lanes": FAULT_SR_LANES,
          "bad_lanes": {e: w.count(False) for e, w in wants.items()}, "without_host_fallback": strict,
          "with_host_fallback": cases, "cuda_error_classes": {str(k): v for k, v in typed.items()}})


def fallback_cases(health, wants, runs, injected) -> dict:
    """Phase 6 with host fallback on: transient faults at the three
    sites, then a permanent one."""
    cases = {}
    for site in ("ed25519.chunk", "ed25519.collect", "sr25519.chunk"):
        engine = site.split(".")[0]
        n = len(wants[engine])
        health.reset()
        got, plan, secs, warned = injected(engine, site=site, fail_calls=(1,))
        snap = health.snapshot()
        check(got == wants[engine], f"{site}: verdicts wrong under a transient fault")
        check(plan.faults_raised == 1 and warned >= 1 and snap["state"] == "degraded"
              and snap["failures"]["transient"] == 1 and snap["fallback_lanes"][engine] == n,
              f"{site}: transient fault not absorbed as expected: {snap}")
        check(runs[engine]() == wants[engine], f"{site}: verdicts wrong after the fault")
        after = health.snapshot()
        check(after["state"] == "healthy" and after["fallback_lanes"][engine] == n
              and after["transitions"] == [("healthy", "degraded"), ("degraded", "healthy")],
              f"{site}: no recovery after the next success: {after}")
        cases[site] = {"lanes": n, "fallback_lanes": n, "fallback_s": secs,
                       "transitions": after["transitions"]}
    health.reset()
    got, plan, secs, _ = injected("sr25519", site="sr25519.chunk", fail_calls=(1,), permanent=True)
    check(got == wants["sr25519"] and health.state == "disabled",
          f"permanent fault: verdicts or state wrong ({health.state})")
    # Disabled: the other engine answers on the host without a device try.
    got_ed, plan_ed, _, _ = injected("ed25519", fail_from=1, fail_count=10**6)
    snap = health.snapshot()
    check(got_ed == wants["ed25519"] and plan_ed.calls == 0
          and snap["fallback_lanes"] == {"ed25519": FAULT_ED_LANES, "sr25519": FAULT_SR_LANES},
          f"disabled card: {snap}")
    cases["permanent"] = {"state": snap["state"], "fallback_lanes": snap["fallback_lanes"],
                          "sr25519_fallback_s": secs}
    return cases


# --- phase 12 ------------------------------------------------------------------

OBSERVED_RING_CAP = 1 << 17  # spans phase 12 keeps; a lightd cold serve opens about 2,000
OVERHEAD_REPS = 5  # steady commits a side in 12f
PROFILE_TOP_OPS = 10
PROFILE_IDLE_GAPS = 5
PROFILE_SAMPLES = 256  # points a stretch of the trace is sampled at for its host spans
SPAN_COST_REPS = 20_000  # spans timed for 12f's cost a span
# The kernels' function names, as the profiler reports them.
KERNEL_FUNCTIONS = {
    "verify": "ed25519_verify_kernel", "verify_tables": "ed25519_verify_tables_kernel",
    "verify_resident": "ed25519_verify_resident_kernel", "verify_sr": "sr25519_verify_kernel",
    "challenge": "sha512_challenge_kernel",
}


def spans_of(events, name, **tags):
    """The completed spans called ``name`` whose args hold ``tags``."""
    return [e for e in events if e.get("ph") == "X" and e["name"] == name
            and all(e["args"].get(k) == v for k, v in tags.items())]


def stage_spans(events):
    """{(stage, engine): count} of the spans tagged with both."""
    out = {}
    for e in events:
        stage, engine = e["args"].get("stage"), e["args"].get("engine")
        if e.get("ph") == "X" and stage and engine:
            out[(stage, engine)] = out.get((stage, engine), 0) + 1
    return out


def stage_histogram(ops):
    """{(stage, engine): observations} of ``verify_stage_seconds``."""
    return {(dict(k)["stage"], dict(k)["engine"]): n for k, n in ops.verify_stage_seconds.counts().items()}


class Observed:
    """Phase 12's instruments and the readings a part is checked by: the
    tracer's ring in ``ring`` mode, one ``OpsMetrics`` (and the
    ``LightMetrics`` lightd serves) in one registry, bound to every unit,
    the stage observer and the kernel profiler."""

    def __init__(self):
        from tendermint_tpu_torch import ops as tops
        from tendermint_tpu_torch.libs import tracing
        from tendermint_tpu_torch.libs.metrics import LightMetrics, OpsMetrics, Registry
        from tendermint_tpu_torch.ops import introspect

        self.tracing, self.introspect = tracing, introspect
        self.registry = Registry()
        self.ops = OpsMetrics(self.registry)
        self.light = LightMetrics(self.registry)
        tops.bind_metrics(self.ops)
        self.on()

    def on(self):
        self.tracing.configure("ring", cap=OBSERVED_RING_CAP)
        self.tracing.tracer.set_metrics_observer(self.tracing.metrics_observer(ops=self.ops))
        self.introspect.install()

    def off(self):
        self.tracing.configure("off")
        self.tracing.tracer.set_metrics_observer(None)
        self.introspect.uninstall()

    def close(self):
        from tendermint_tpu_torch import ops as tops

        self.off()
        self.tracing.tracer.clear()
        tops.bind_metrics(None)

    def mark(self):
        """What a part's checks are deltas from."""
        from tendermint_tpu_torch.ops import hash512, precompute, resident

        return {"launches": launches(), "resident": resident.stats(),
                "results": precompute.results.stats(), "hash": hash512.stats(),
                "stages": stage_histogram(self.ops), "counters": self.counters(),
                "ring": self.tracing.tracer.recorded}

    def counters(self):
        ops = self.ops
        out = {name: getattr(ops, attr).value() for name, attr in (
            ("table_resident_hits", "table_resident_hits"),
            ("table_resident_misses", "table_resident_misses"),
            ("result_cache_hits", "result_cache_hits"), ("result_cache_misses", "result_cache_misses"),
            ("hash_device_lanes", "hash_device_lanes"), ("precompute_builds", "precompute_builds"))}
        for engine in ("ed25519", "sr25519"):
            out[f"fallback_lanes_{engine}"] = ops.device_fallback_lanes.value(engine=engine)
        for kind in ("transient", "permanent"):
            out[f"failures_{kind}"] = ops.device_failures.value(kind=kind)
        with ops.device_transitions._lock:
            out["transitions"] = sum(ops.device_transitions._values.values())
        return out

    def since(self, mark):
        """The events of the ring since ``mark`` (the ring must not have
        wrapped) and every delta the checks read."""
        from tendermint_tpu_torch.ops import hash512, precompute, resident

        tracer = self.tracing.tracer
        new = tracer.recorded - mark["ring"]
        check(new <= tracer.cap, f"phase 12: {new} events overflowed the ring of {tracer.cap}")
        events = tracer.events()[-new:] if new else []
        sub = lambda a, b: {k: a[k] - b.get(k, 0) for k in a if a[k] - b.get(k, 0)}
        return events, {
            "launches": sub(launches(), mark["launches"]),
            "resident": sub(resident.stats(), mark["resident"]),
            "results": sub(precompute.results.stats(), mark["results"]),
            "hash": sub(hash512.stats(), mark["hash"]),
            "stages": sub(stage_histogram(self.ops), mark["stages"]),
            "counters": sub(self.counters(), mark["counters"]),
        }


def check_engine_spans(part, events, d, engine, kernel, chunks=None, kind=None, parent="verify_batch"):
    """A part's per-chunk spans of ``engine``: one prep, dispatch and
    collect a chunk (``kind`` where given) under ``parent``, as many
    dispatches as ``kernel`` launches, no host fallback."""
    tags = {"engine": engine, **({"kind": kind} if kind else {})}
    counts = {name: len(spans_of(events, name, **tags))
              for name in ("prep_chunk", "dispatch_chunk", "collect_chunk")}
    launched = d["launches"].get(kernel, 0)
    check(counts["dispatch_chunk"] == launched > 0,
          f"{part}: {counts['dispatch_chunk']} dispatch_chunk spans of {engine}, {launched} {kernel} launches")
    check(counts["prep_chunk"] == counts["collect_chunk"] == launched,
          f"{part}: per-chunk spans {counts}, {launched} launches")
    if chunks is not None:
        check(launched == chunks, f"{part}: {launched} {kernel} launches, expected {chunks}")
    check(not spans_of(events, "host_fallback"), f"{part}: a host_fallback span")
    for name in counts:
        for e in spans_of(events, name, **tags):
            check(e["args"]["parent"] == parent, f"{part}: {name} under {e['args']['parent']}")
    return counts


def check_stage_histogram(part, events, d):
    """The stage histogram observed exactly the part's stage spans."""
    check(d["stages"] == stage_spans(events),
          f"{part}: stage histogram {d['stages']} != stage spans {stage_spans(events)}")


def check_ledger(part):
    """The resident store's bytes in the ledger, its gauge and memstats
    equal the store tensor's, within what the card holds."""
    import torch

    from tendermint_tpu_torch.ops import introspect, resident

    nbytes = resident.store.device_nbytes()
    ledger = introspect.accountant.bytes_for("resident_tables")
    mem = introspect.memstats()
    gauge = OBSERVED.ops.device_bytes.value(owner="resident_tables")
    allocated = torch.cuda.memory_allocated()
    check(nbytes == ledger == gauge == mem["device_bytes"].get("resident_tables", 0) <= allocated,
          f"{part}: store {nbytes} B, ledger {ledger}, gauge {gauge}, memstats {mem['device_bytes']}, "
          f"allocated {allocated}")
    return {"store_bytes": nbytes, "ledger_bytes": ledger, "memory_allocated": allocated}


OBSERVED = None  # phase 12's instruments, while it runs


def restore_tables(vset, tables):
    """Activate ``vset`` and put its host tables, built in the set-up's
    pool, into the cache."""
    from tendermint_tpu_torch.ops import precompute

    precompute.activate_validator_set(vset)
    for pk, tab, ok in tables:
        precompute.tables.insert(pk, tab, ok)


def observed_commit(commit_wl, dev):
    """12a: the steady 10,000-validator commit, verdict cache emptied, then
    warm."""
    from tendermint_tpu_torch.ops import precompute
    from tendermint_tpu_torch.types.validation import verify_commit

    vset, block_id, commits = commit_wl
    c = commits[1]
    chunks = len(chunk_sizes(COMMIT_VALIDATORS))
    mark = OBSERVED.mark()
    precompute.results.clear()
    t = time.perf_counter()
    verify_commit(CHAIN_ID, vset, block_id, c.height, c, device=dev)
    cold_s = time.perf_counter() - t
    t = time.perf_counter()
    verify_commit(CHAIN_ID, vset, block_id, c.height, c, device=dev)
    warm_s = time.perf_counter() - t
    events, d = OBSERVED.since(mark)
    part = "phase 12a"
    vcs = spans_of(events, "verify_commit")
    check(len(vcs) == 2 and all(e["args"] == {"height": c.height, "round": c.round,
                                              "sigs": COMMIT_VALIDATORS} for e in vcs),
          f"{part}: verify_commit spans {[e['args'] for e in vcs]}")
    vbs = spans_of(events, "verify_batch", engine="ed25519")
    check(len(vbs) == 2 and all(e["args"]["parent"] == "verify_commit" for e in vbs),
          f"{part}: verify_batch spans {[e['args'] for e in vbs]}")
    hits = [e["args"]["hits"] for e in spans_of(events, "cache_lookup")]
    check(hits == [0, COMMIT_VALIDATORS], f"{part}: cache_lookup hits {hits}")
    counts = check_engine_spans(part, events, d, "ed25519", "verify_resident", chunks, "resident")
    check(not spans_of(events, "dispatch_chunk", kind="tables")
          and not spans_of(events, "dispatch_chunk", kind="legacy"), f"{part}: a K1 or K2 chunk")
    check_stage_histogram(part, events, d)
    k = d["counters"]
    check(k.get("table_resident_hits", 0) == d["resident"].get("hits", 0) == COMMIT_VALIDATORS
          and k.get("table_resident_misses", 0) == d["resident"].get("misses", 0),
          f"{part}: resident counters {k} vs stats {d['resident']}")
    check(k.get("result_cache_hits", 0) == d["results"].get("hits", 0) == COMMIT_VALIDATORS
          and k.get("result_cache_misses", 0) == d["results"].get("misses", 0) == COMMIT_VALIDATORS,
          f"{part}: result-cache counters {k} vs stats {d['results']}")
    check(k.get("hash_device_lanes", 0) == d["hash"].get("device_lanes", 0),
          f"{part}: hash counter {k} vs stats {d['hash']}")
    check(k.get("precompute_builds", 0) == 0, f"{part}: table builds {k}: the saved tables were not used")
    ledger = check_ledger(part)
    check(ledger["store_bytes"] == (COMMIT_VALIDATORS + 1) * TABLE_BYTES, f"{part}: store {ledger}")
    check(OBSERVED.ops.inflight_lanes.value(engine="ed25519") == 0, f"{part}: lanes left in flight")
    uploads = spans_of(events, "resident_upload")
    check(len(uploads) == d["resident"].get("uploads", 0) == 1
          and uploads[0]["args"]["bytes"] == ledger["store_bytes"], f"{part}: uploads {uploads}")
    check_healthy(part)
    return {"cold_ms": cold_s * 1e3, "warm_ms": warm_s * 1e3, "spans": counts,
            "launches": d["launches"], "stage_spans": {f"{s}/{e}": n for (s, e), n in stage_spans(events).items()},
            "counters": k, **ledger}


def observed_mixed(mixed_wl, dev):
    """12b: the mixed commit, once: K5 under sr25519 spans, K3 under
    ed25519 spans."""
    from tendermint_tpu_torch.ops import precompute
    from tendermint_tpu_torch.types.validation import verify_commit

    vset, block_id, commit, _, _ = mixed_wl
    n_sr = sum(v.pub_key.type == "sr25519" for v in vset.validators)
    mark = OBSERVED.mark()
    precompute.results.clear()
    t = time.perf_counter()
    verify_commit(CHAIN_ID, vset, block_id, commit.height, commit, device=dev)
    secs = time.perf_counter() - t
    events, d = OBSERVED.since(mark)
    part = "phase 12b"
    sr = check_engine_spans(part, events, d, "sr25519", "verify_sr", len(chunk_sizes(n_sr)),
                            parent="verify_commit")
    ed = check_engine_spans(part, events, d, "ed25519", "verify_resident",
                            len(chunk_sizes(MIXED_VALIDATORS - n_sr)), "resident")
    check_stage_histogram(part, events, d)
    k = d["counters"]
    check(k.get("hash_device_lanes", 0) == d["hash"].get("device_lanes", 0),
          f"{part}: hash counter {k} vs stats {d['hash']}")
    check(k.get("result_cache_misses", 0) == d["results"].get("misses", 0),
          f"{part}: result-cache counters {k} vs stats {d['results']}")
    check_ledger(part)
    check_healthy(part)
    return {"ms": secs * 1e3, "sr25519_spans": sr, "ed25519_spans": ed, "launches": d["launches"],
            "hash_device_lanes": d["hash"].get("device_lanes", 0), "counters": k}


def observed_faults(ed_lanes, dev):
    """12c: a transient fault on one chunk, with host fallback off (it
    escapes) and on (the host answers the chunk)."""
    import warnings

    from tendermint_tpu_torch.crypto import ed25519_ref as ref
    from tendermint_tpu_torch.ops import device_policy, fault_injection, precompute, verify_batch

    health = device_policy.shared
    ed = [x[:FAULT_ED_LANES] for x in ed_lanes[:3]]
    want = [ref.verify_zip215(*lane) for lane in zip(*ed)]

    def run():
        precompute.results.clear()
        return verify_batch(*ed, device=dev)

    part = "phase 12c"
    health.reset()
    mark = OBSERVED.mark()
    with fault_injection.inject(site="ed25519.chunk", fail_calls=(1,)) as plan:
        try:
            run()
            raised = None
        except fault_injection.DeviceFault as exc:
            raised = exc
    check(raised is not None and plan.faults_raised == 1, f"{part}: the fault did not escape")
    check(OBSERVED.ops.inflight_lanes.value(engine="ed25519") == 0,
          f"{part}: lanes left in flight after the escaped fault")
    check(run() == want and health.state == "healthy", f"{part}: no recovery after the fault")
    check(not spans_of(OBSERVED.since(mark)[0], "host_fallback"),
          f"{part}: a host_fallback span with host fallback off")
    health.host_fallback = True
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with fault_injection.inject(site="ed25519.chunk", fail_calls=(1,)) as plan:
                got = run()
    finally:
        health.host_fallback = False
    check(got == want and plan.faults_raised == 1, f"{part}: verdicts under host fallback")
    check(run() == want and health.state == "healthy", f"{part}: no recovery after the fallback")
    events, d = OBSERVED.since(mark)
    snap = health.snapshot()
    k = d["counters"]
    fb = spans_of(events, "host_fallback", engine="ed25519", stage="fallback")
    fb_lanes = sum(e["args"]["lanes"] for e in fb)
    check(len(fb) == 1 and fb_lanes == k.get("fallback_lanes_ed25519", 0)
          == snap["fallback_lanes"]["ed25519"] == FAULT_ED_LANES,
          f"{part}: host_fallback spans {fb_lanes} lanes, counter {k}, snapshot {snap}")
    instants = [e for e in events if e.get("ph") == "i" and e["name"] == "device_health_transition"]
    edges = [(e["args"]["from_state"], e["args"]["to_state"]) for e in instants]
    check(edges == snap["transitions"] and len(edges) == k.get("transitions", 0) == 4,
          f"{part}: transition instants {edges}, counter {k}, snapshot {snap['transitions']}")
    check(k.get("failures_transient", 0) == snap["failures"]["transient"] == 2,
          f"{part}: failures {k} vs {snap['failures']}")
    check_stage_histogram(part, events, d)
    health.reset()
    return {"lanes": FAULT_ED_LANES, "raised_without_fallback": type(raised).__name__,
            "fallback_span_lanes": fb_lanes, "transitions": edges, "counters": k}


def trace_ancestors(by_id, event):
    """The span ids above ``event`` through its parent_span_id links."""
    out, sid = [], event.get("parent_span_id")
    while sid and sid not in out:
        out.append(sid)
        sid = by_id.get(sid, {}).get("parent_span_id")
    return out


def observed_lightd(lightd_wl, dev):
    """12d: phase 11's server with the ops metrics in its registry: a
    cold ``light_header`` whose request carries a ``trace`` member, then
    ``/metrics``, ``/debug/traces`` and ``/debug/memstats``."""
    import urllib.request

    from tendermint_tpu_torch.encoding.canonical import Timestamp
    from tendermint_tpu_torch.light.client import LightClient, TrustOptions
    from tendermint_tpu_torch.light.lightd import LightServer
    from tendermint_tpu_torch.light.provider import MemoryProvider, RetryingProvider
    from tendermint_tpu_torch.ops import precompute, resident

    chain = lightd_wl[0]
    top = LIGHTD_HEADERS
    now = Timestamp.from_unix_ns(chain[-1].header.time.to_unix_ns() + 2 * 10**9)
    tracing = OBSERVED.tracing
    part = "phase 12d"
    client = LightClient(
        CHAIN_ID, TrustOptions(period=LIGHT_TRUSTING_PERIOD_S, height=1, hash=chain[0].hash()),
        RetryingProvider(MemoryProvider(CHAIN_ID, chain)), [MemoryProvider(CHAIN_ID, chain)],
        max_clock_drift=LIGHT_MAX_CLOCK_DRIFT_S, now=lambda: now, metrics=OBSERVED.light, device=dev)
    srv = LightServer(client, metrics=OBSERVED.light, registry=OBSERVED.registry)
    srv.start()

    def get(path):
        with urllib.request.urlopen(srv.url + path, timeout=60) as resp:
            return resp.read()

    try:
        precompute.results.clear()
        mark = OBSERVED.mark()
        with tracing.span("light_request", height=top) as call:
            body = {"jsonrpc": "2.0", "id": 1, "method": "light_header",
                    "params": {"height": top}, "trace": call.context().to_header()}
            req = urllib.request.Request(srv.url, data=json.dumps(body).encode(),
                                         headers={"Content-Type": "application/json"})
            t = time.perf_counter()
            with urllib.request.urlopen(req, timeout=120) as resp:
                answer = json.loads(resp.read())
            serve_s = time.perf_counter() - t
        check(answer.get("result", {}).get("hash") == chain[-1].hash().hex().upper(),
              f"{part}: light_header answered {str(answer)[:300]}")
        events, d = OBSERVED.since(mark)
        metrics_text = get("/metrics").decode()
        families = {prefix: sorted({line.split()[2] for line in metrics_text.splitlines()
                                    if line.startswith("# TYPE " + prefix)})
                    for prefix in ("tendermint_ops_", "tendermint_light_")}
        check(len(families["tendermint_ops_"]) == 29 and len(families["tendermint_light_"]) == 5,
              f"{part}: /metrics families {families}")
        doc = json.loads(get("/debug/traces?format=chrome"))
        check(set(doc["otherData"]) == {"epoch_unix_us"}, f"{part}: chrome otherData {doc['otherData']}")
        spans = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
        by_id = {e["span_id"]: e for e in spans if "span_id" in e}
        mine = [e for e in spans if e.get("trace_id") == call.trace_id]
        (dispatch,) = [e for e in mine if e["name"] == "rpc_dispatch"]
        check(dispatch["parent_span_id"] == call.span_id and dispatch["args"]["method"] == "light_header",
              f"{part}: rpc_dispatch {dispatch}")
        vbs = [e for e in mine if e["name"] == "verify_batch"]
        check(len(vbs) >= LIGHTD_ROUNDS and all(dispatch["span_id"] in trace_ancestors(by_id, e)
                                                for e in vbs),
              f"{part}: {len(vbs)} verify_batch spans of the request's trace under rpc_dispatch")
        all_vbs = spans_of(events, "verify_batch")
        check(len(all_vbs) == len(vbs), f"{part}: verify_batch spans outside the request's trace")
        launched = sum(d["launches"].values())
        dispatched = len(spans_of(events, "dispatch_chunk"))
        check(dispatched == launched - d["launches"].get("challenge", 0) > 0,
              f"{part}: {dispatched} dispatch_chunk spans, launches {d['launches']}")
        check(not spans_of(events, "host_fallback"), f"{part}: a host_fallback span")
        check_stage_histogram(part, events, d)
        mem = json.loads(get("/debug/memstats"))
        ledger = check_ledger(part)
        check(mem["device_bytes"].get("resident_tables") == ledger["store_bytes"] > 0
              and mem["resident"] == resident.stats()
              and any(key.startswith("ed25519/b") for key in mem["profile"]["kernel"])
              and mem["compile_events"] == {"ed25519": 4, "pallas": 2, "sr25519": 1}
              and mem["exec_cache_entries"] == {"ed25519": 2, "pallas": 1, "sr25519": 1},
              f"{part}: memstats {json.dumps(mem)[:600]}")
    finally:
        srv.stop()
    check_healthy(part)
    return {"cold_serve_ms": serve_s * 1e3, "request_trace_verify_batches": len(vbs),
            "dispatch_chunk_spans": dispatched, "launches": d["launches"], "families": families,
            "memstats": {k: mem[k] for k in ("device_bytes", "compile_events", "exec_cache_entries",
                                             "builds")},
            "profile_kernel_digests": mem["profile"]["kernel"]}


def merged(intervals):
    """Sorted, merged (start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def profiled(label, fn, trace_dir):
    """12e: ``fn`` under ``torch.profiler`` (CPU and CUDA activities): the
    device-busy share of the call's wall, the top device operations, and
    the longest idle gaps, each with the innermost tracer span open on
    the host at its middle. The Chrome trace goes to ``trace_dir``."""
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    name = f"phase12_{label}"
    torch.cuda.synchronize()
    mark = OBSERVED.mark()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(name):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, f"{name}.trace.json")
    prof.export_chrome_trace(path)
    with open(path) as fh:
        trace = json.load(fh)["traceEvents"]
    events, d = OBSERVED.since(mark)
    part = f"phase 12e {label}"
    wins = [e for e in trace if e.get("name") == name and e.get("ph") == "X"
            and e.get("cat") == "user_annotation"]
    check(len(wins) == 1, f"{part}: {len(wins)} windows named {name} in the trace")
    lo, hi = wins[0]["ts"], wins[0]["ts"] + wins[0]["dur"]
    device = [e for e in trace if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    clip = lambda evs: [(max(lo, e["ts"]), min(hi, e["ts"] + e["dur"])) for e in evs
                        if e["ts"] < hi and e["ts"] + e["dur"] > lo]
    busy = merged(clip(device))
    kernel_busy = merged(clip([e for e in device if e["cat"] == "kernel"]))
    span_us = hi - lo
    seen = {key: sum(1 for e in device if e["cat"] == "kernel" and re.search(rf"\b{fn_name}\b", e["name"]))
            for key, fn_name in KERNEL_FUNCTIONS.items()}
    want = {key: d["launches"].get(key, 0) for key in KERNEL_FUNCTIONS}
    check(seen == want, f"{part}: kernels in the trace {seen}, launches counted {want}")
    by_op = {}
    for e in device:
        row = by_op.setdefault(e["name"][:90], [0.0, 0])
        row[0] += e["dur"] / 1e3
        row[1] += 1
    top = sorted(by_op.items(), key=lambda kv: -kv[1][0])[:PROFILE_TOP_OPS]
    # Idle gaps, and the host span open at each gap's middle: the window
    # opened at t0 on the host's clock, so trace time maps to it by one offset.
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i]) for i in range(0, len(edges), 2)), reverse=True)
    tracer = OBSERVED.tracing.tracer
    spans = [(tracer.to_perf_counter(e["ts"]), tracer.to_perf_counter(e["ts"] + e["dur"]), e)
             for e in events if e.get("ph") == "X"]

    def host_span(t_trace):
        """The innermost tracer span open on the host at trace time
        ``t_trace``, as its name and stage tags (None when none is)."""
        t = t0 + (t_trace - lo) / 1e6
        inside = [(b - a, e) for a, b, e in spans if a <= t <= b]
        if not inside:
            return None
        e = min(inside, key=lambda x: x[0])[1]
        return {"name": e["name"], **{k: e["args"][k] for k in ("stage", "kind", "engine") if k in e["args"]}}

    def host_shares(a, b, samples=PROFILE_SAMPLES):
        """Shares of [a, b) (trace time) by the innermost host span."""
        out = {}
        for i in range(samples):
            sp = host_span(a + (b - a) * (i + 0.5) / samples)
            key = "none" if sp is None else "/".join(str(sp.get(k)) for k in ("name", "kind") if sp.get(k))
            out[key] = out.get(key, 0) + 1 / samples
        return dict(sorted(out.items(), key=lambda kv: -kv[1]))

    idle = [{"ms": g / 1e3, "at_ms": (a - lo) / 1e3, "host_span": host_span(a + g / 2),
             "host_shares": host_shares(a, a + g)}
            for g, a in gaps[:PROFILE_IDLE_GAPS]]
    out = {"label": label, "wall_ms": wall * 1e3, "window_ms": span_us / 1e3,
           "device_busy_share": sum(b - a for a, b in busy) / span_us,
           "kernel_busy_share": sum(b - a for a, b in kernel_busy) / span_us,
           "kernel_ms": sum(b - a for a, b in kernel_busy) / 1e3, "launches": d["launches"],
           "top_device_ops": [{"name": k, "ms": v[0], "count": v[1]} for k, v in top],
           "idle_gaps": idle, "host_shares": host_shares(lo, hi, 4 * PROFILE_SAMPLES), "trace": path}
    emit({"phase": "observed_12e", **out})
    return out


def observed_overhead(commit_wl, dev):
    """12f: the steady commit with the tracer off and the profiler
    uninstalled, against ``ring`` with the profiler installed, in turns."""
    from tendermint_tpu_torch.ops import precompute
    from tendermint_tpu_torch.types.validation import verify_commit

    vset, block_id, commits = commit_wl
    c = commits[1]
    times = {"off": [], "on": []}
    for _ in range(OVERHEAD_REPS):
        for side in ("off", "on"):
            OBSERVED.off() if side == "off" else OBSERVED.on()
            precompute.results.clear()
            t = time.perf_counter()
            verify_commit(CHAIN_ID, vset, block_id, c.height, c, device=dev)
            times[side].append(time.perf_counter() - t)
    OBSERVED.on()
    p50 = {side: statistics.median(v) for side, v in times.items()}
    # What the instruments cost a span, on this host: a stage span under
    # the ring, the observer and the profiler, against the no-op span.
    tracing = OBSERVED.tracing
    mark = OBSERVED.mark()
    precompute.results.clear()
    verify_commit(CHAIN_ID, vset, block_id, c.height, c, device=dev)
    spans_per_commit = len([e for e in OBSERVED.since(mark)[0] if e.get("ph") == "X"])
    cost = {}
    for side in ("off", "on"):
        OBSERVED.off() if side == "off" else OBSERVED.on()
        t = time.perf_counter()
        for _ in range(SPAN_COST_REPS):
            with tracing.span("prep_chunk", stage="prep", engine="ed25519", kind="resident", lanes=1):
                pass
        cost[side] = (time.perf_counter() - t) / SPAN_COST_REPS
    OBSERVED.on()
    OBSERVED.tracing.tracer.clear()
    span_us = (cost["on"] - cost["off"]) * 1e6
    return {"off_ms": [x * 1e3 for x in times["off"]], "on_ms": [x * 1e3 for x in times["on"]],
            "off_p50_ms": p50["off"] * 1e3, "on_p50_ms": p50["on"] * 1e3,
            "on_over_off": p50["on"] / p50["off"], "span_cost_us": span_us,
            "spans_per_commit": spans_per_commit,
            "span_cost_share": span_us * spans_per_commit / (p50["off"] * 1e6)}


def phase_observed(commit_wl, commit_tables, mixed_wl, ed_lanes, batch, lightd_wl, dev, trace_dir):
    """Phase 12: the main path with the instruments on (see the module
    note). Returns the phase's launch counts (which start at 0)."""
    global OBSERVED
    from tendermint_tpu_torch.ops import precompute, verify_batch
    from tendermint_tpu_torch.types.validation import verify_commit

    t_phase = time.perf_counter()
    check(len(commit_tables) == COMMIT_VALIDATORS,
          f"phase 12: {len(commit_tables)} tables of the 10,000 set")
    precompute.reset()
    restore_tables(commit_wl[0], commit_tables)
    OBSERVED = Observed()
    vset, block_id, commits = commit_wl
    pks, msgs, sigs, want = batch

    def steady_commit():
        precompute.results.clear()
        verify_commit(CHAIN_ID, vset, block_id, commits[1].height, commits[1], device=dev)

    def batch_8192():
        precompute.results.clear()
        check(np.array_equal(np.asarray(verify_batch(pks, msgs, sigs, device=dev)), want),
              "phase 12e: verify_batch verdicts wrong")

    try:
        parts = [("12a_commit", lambda: observed_commit(commit_wl, dev)),
                 ("12f_overhead", lambda: observed_overhead(commit_wl, dev)),
                 ("12e_profile_commit", lambda: profiled("commit", steady_commit, trace_dir)),
                 ("12e_profile_batch", lambda: profiled("batch", batch_8192, trace_dir)),
                 ("12b_mixed", lambda: observed_mixed(mixed_wl, dev)),
                 ("12c_faults", lambda: observed_faults(ed_lanes, dev)),
                 ("12d_lightd", lambda: observed_lightd(lightd_wl, dev))]
        for label, run in parts:
            t = time.perf_counter()
            out = run()
            if not label.startswith("12e"):
                emit({"phase": f"observed_{label}", "seconds": time.perf_counter() - t, **out})
        check(OBSERVED.tracing.tracer.dropped == 0, "phase 12: the ring dropped events")
    finally:
        OBSERVED.close()
        OBSERVED = None
    precompute.reset()
    counts = launches()
    emit({"phase": "observed", "seconds": time.perf_counter() - t_phase, "launches": counts})
    return counts


# --- phase 13: verifyd -----------------------------------------------------------

VERIFYD_REPS = 5  # 13a: remote and in-process commits, in turns
VERIFYD_CONSENSUS_CALLS = 2  # 13b: 10,000-lane calls of the consensus client (heights 1, 2)
VERIFYD_SR_REQUESTS = 3  # 13b: sr25519 requests
VERIFYD_SR_LANES = 64  # 13b: lanes an sr25519 request (phase 7's mixed window holds 64)
VERIFYD_MIX_CAP = 16384  # 13b's admission cap, max_pending and tenant cap (see PERF.md)
VERIFYD_MIX_SERVICE_BUDGET = 60.0  # 13b's service-time budget, seconds (the default is 0.5)
VERIFYD_LADDER_SHED_LANES = 64  # 13c: a sheddable class's request
VERIFYD_LADDER_LANES = 256  # 13c: consensus, past the default tenant cap's shrunken share (128)
VERIFYD_HOT_SIGNERS = BATCH_SIGNERS  # 13d: phase 3's 256 signers, each seen 3 times
VERIFYD_HOT_SIGHTINGS = 3
VERIFYD_HOT_QUOTA = 128  # 13d: pins a tenant may hold (two tenants of 128 signers)
VERIFYD_CHILD_HEADERS = 3  # 13e: header commits sent to the daemon, then one verify_commit
VERIFYD_CHILD_WAIT_S = 180.0  # 13e: the daemon's start, its CUDA context and kernel load
VERIFYD_CHILD_STOP_S = 10.0
VERIFYD_PHASE_S = 60.0  # the phase's time limit


def commit_lanes(vset, commit, n=None):
    """The (pks, msgs, sigs) lanes of ``commit``'s first ``n`` signatures."""
    n = len(vset.validators) if n is None else n
    return ([v.pub_key.bytes() for v in vset.validators[:n]],
            [commit.vote_sign_bytes(CHAIN_ID, i) for i in range(n)],
            [cs.signature for cs in commit.signatures[:n]])


def plant_bad(lanes, idx):
    """A copy of ``lanes`` with the signatures at ``idx`` corrupted."""
    pks, msgs, sigs = (list(x) for x in lanes)
    for i in idx:
        sigs[i] = sigs[i][:40] + bytes([sigs[i][40] ^ 1]) + sigs[i][41:]
    return pks, msgs, sigs


def in_process(requests, dev, algo="ed25519"):
    """Each request's verdicts from the port's engine in this process (one
    call per class), with the verdict cache emptied after."""
    from tendermint_tpu_torch.ops import precompute, verify_batch
    from tendermint_tpu_torch.ops.sr25519_batch import verify_batch_sr

    flat = [sum((list(r[k]) for r in requests), []) for k in range(3)]
    fn = verify_batch if algo == "ed25519" else verify_batch_sr
    oks = list(fn(*flat, device=dev))
    precompute.results.clear()
    out, lo = [], 0
    for r in requests:
        out.append(oks[lo:lo + len(r[0])])
        lo += len(r[0])
    return out


def verifyd_remote_commit(srv, commit_wl, commit_tables, dev):
    """13a: phase 4's 10,000-validator commit through ``verify_commit``
    with the remote set, against the in-process path in turns."""
    from tendermint_tpu_torch.ops import precompute
    from tendermint_tpu_torch.types.validation import InvalidCommitError, verify_commit
    from tendermint_tpu_torch.verifyd import client as vclient, protocol

    part = "phase 13a"
    vset, block_id, commits = commit_wl
    addr = "%s:%d" % srv.address
    precompute.reset()
    restore_tables(vset, commit_tables)
    served0 = srv.stats()["requests_served"]
    sched0 = srv.scheduler.stats()
    remote_client = None

    def run(remote, commit):
        nonlocal remote_client
        vclient.set_remote_addr(addr if remote else "")
        if remote:
            remote_client = vclient.remote_client()
        precompute.results.clear()
        before = launches()
        t = time.perf_counter()
        try:
            verify_commit(CHAIN_ID, vset, block_id, commit.height, commit, device=dev)
            err = None
        except InvalidCommitError as exc:
            err = str(exc)
        return time.perf_counter() - t, delta(before), err

    cold_s, cold_d, err = run(True, commits[1])
    check(err is None, f"{part}: the cold remote commit failed: {err}")
    times = {"remote": [], "in_process": []}
    per_side = {"remote": {}, "in_process": {}}
    for _ in range(VERIFYD_REPS):
        for side in ("remote", "in_process"):
            s, d, err = run(side == "remote", commits[1])
            check(err is None, f"{part}: the {side} commit failed: {err}")
            times[side].append(s)
            for k, v in d.items():
                per_side[side][k] = per_side[side].get(k, 0) + v
    bad = {side: run(side == "remote", commits[2]) for side in ("remote", "in_process")}
    errors = {side: r[2] for side, r in bad.items()}
    vclient.set_remote_addr("")
    check(errors["remote"] is not None and errors["remote"] == errors["in_process"]
          and f"(#{BAD_COMMIT_INDEX})" in errors["remote"],
          f"{part}: bad commit remote {errors['remote']!r}, in process {errors['in_process']!r}")
    calls = VERIFYD_REPS + 2
    per_call = -(-COMMIT_VALIDATORS // protocol.MAX_LANES)
    stats, sched = srv.stats(), srv.scheduler.stats()
    served = stats["requests_served"] - served0
    flushes = sched["flushes"] - sched0["flushes"]
    reasons = {k: sched["flush_reasons"][k] - sched0["flush_reasons"][k] for k in sched["flush_reasons"]}
    cstats = remote_client.stats()
    check(served == calls * per_call, f"{part}: {served} requests served for {calls} commits")
    check(reasons["size"] + reasons["deadline"] == flushes > 0, f"{part}: flush reasons {reasons}")
    check(sched["flush_errors"] == sched0["flush_errors"]
          and sched["fallback_flushes"] == sched0["fallback_flushes"],
          f"{part}: failed or fallback flushes {sched}")
    check(stats["host_direct_lanes"] == 0 and stats["pin_errors"] == 0 and stats["failed_closed"] == 0
          and cstats["fallback_calls"] == 0, f"{part}: stats {stats} client {cstats}")
    check(cold_d.get("verify_resident", 0) > 0 and per_side["remote"].get("verify_resident", 0) > 0
          and set(cold_d) <= {"verify_resident", "challenge"},
          f"{part}: remote launches cold {cold_d}, steady {per_side['remote']}")
    p50 = {side: statistics.median(v) for side, v in times.items()}
    return {"validators": COMMIT_VALIDATORS, "requests_per_commit": per_call,
            "cold_remote_ms": cold_s * 1e3, "cold_remote_launches": cold_d,
            "remote_ms": [x * 1e3 for x in times["remote"]],
            "in_process_ms": [x * 1e3 for x in times["in_process"]],
            "remote_p50_ms": p50["remote"] * 1e3, "in_process_p50_ms": p50["in_process"] * 1e3,
            "remote_over_in_process": p50["remote"] / p50["in_process"],
            "launches_per_remote_commit": {k: v / VERIFYD_REPS for k, v in per_side["remote"].items()},
            "launches_per_in_process_commit": {k: v / VERIFYD_REPS
                                                for k, v in per_side["in_process"].items()},
            "flushes_per_remote_commit": flushes / (VERIFYD_REPS + 2), "flush_reasons": reasons,
            "bad_commit_error": errors["remote"], "client": cstats,
            "scheduler_knobs": stats["scheduler"], "cross_client_flushes": stats["cross_client_flushes"],
            "served_launches": add_launches(cold_d, per_side["remote"], bad["remote"][1])}


def verifyd_mix(commit_wl, sync, mixed_sync, light, dev):
    """13b: four clients at once on one server: consensus (phase 4's
    commits), blocksync (phase 7's blocks), light (phase 8's headers) and
    sr25519 (phase 7's mixed window), each with planted bad lanes."""
    from tendermint_tpu_torch.ops import precompute
    from tendermint_tpu_torch.verifyd import protocol
    from tendermint_tpu_torch.verifyd.client import VerifydClient
    from tendermint_tpu_torch.verifyd.server import VerifydServer

    part = "phase 13b"
    vset, _, commits = commit_wl
    chain, bvset, _ = sync
    lchain, lvset, _ = light
    mchain, mvset, _ = mixed_sync
    sync_lanes = SYNC_VALIDATORS * 2 // 3 + 1
    light_lanes = LIGHT_VALIDATORS * 2 // 3 + 1
    requests = {
        "consensus": [plant_bad(commit_lanes(vset, commits[h]), (17 + h, COMMIT_VALIDATORS // 2 + h,
                                                                   COMMIT_VALIDATORS - 1 - h))
                      for h in range(VERIFYD_CONSENSUS_CALLS)],
        "blocksync": [plant_bad(commit_lanes(bvset, sh.commit, sync_lanes),
                                (b % sync_lanes,) if b % 4 == 0 else ())
                      for b, sh in enumerate(chain[:SYNC_BLOCKS])],
        "light": [plant_bad(commit_lanes(lvset, sh.commit, light_lanes),
                            (h * 41 % light_lanes,) if h % 4 == 1 else ())
                  for h, sh in enumerate(lchain[:LIGHT_HEADERS])],
    }
    sr = [(v.pub_key.bytes(), sh.commit.vote_sign_bytes(CHAIN_ID, i), sh.commit.signatures[i].signature)
          for sh in mchain[:MIXED_SYNC_BLOCKS] for i, v in enumerate(mvset.validators)
          if v.pub_key.type == "sr25519"][:VERIFYD_SR_LANES]
    check(len(sr) == VERIFYD_SR_LANES, f"{part}: {len(sr)} sr25519 lanes in phase 7's mixed window")
    requests["sr25519"] = [plant_bad(tuple(zip(*sr)), (r * 7 % VERIFYD_SR_LANES,))
                           for r in range(VERIFYD_SR_REQUESTS)]
    klass = {"consensus": protocol.CLASS_CONSENSUS, "blocksync": protocol.CLASS_BLOCKSYNC,
             "light": protocol.CLASS_LIGHT, "sr25519": protocol.CLASS_BLOCKSYNC}
    t = time.perf_counter()
    want = {name: in_process(reqs, dev, "sr25519" if name == "sr25519" else "ed25519")
            for name, reqs in requests.items()}
    reference_s = time.perf_counter() - t
    planted = {"consensus": 3 * VERIFYD_CONSENSUS_CALLS, "blocksync": -(-SYNC_BLOCKS // 4),
               "light": LIGHT_HEADERS // 4, "sr25519": VERIFYD_SR_REQUESTS}
    falses = {name: sum(not x for w in want[name] for x in w) for name in want}
    check(falses == planted, f"{part}: in-process rejections {falses}, planted {planted}")
    precompute.results.clear()
    srv = VerifydServer(device=dev, admission_cap=VERIFYD_MIX_CAP, max_pending=VERIFYD_MIX_CAP,
                        tenant_cap=VERIFYD_MIX_CAP, service_budget=VERIFYD_MIX_SERVICE_BUDGET)
    srv.start()
    addr = "%s:%d" % srv.address
    results = {name: [] for name in requests}
    errors = []
    barrier = threading.Barrier(len(requests))
    clients = {name: VerifydClient(addr, timeout=60.0) for name in requests}
    t_end = {}

    def run(name):
        try:
            c = clients[name]
            barrier.wait(timeout=30)
            for r in requests[name]:
                t0 = time.perf_counter()
                got = c.verify(*r, klass=klass[name],
                               algo=protocol.ALGO_SR25519 if name == "sr25519" else protocol.ALGO_ED25519)
                results[name].append((time.perf_counter() - t0, got))
            t_end[name] = time.perf_counter()
        except Exception as exc:  # reported below
            errors.append((name, repr(exc)))

    before = launches()
    threads = [threading.Thread(target=run, args=(name,)) for name in requests]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=VERIFYD_PHASE_S)
    wall = max(t_end.values(), default=time.perf_counter()) - t0
    d = delta(before)
    try:
        check(not errors and all(not th.is_alive() for th in threads), f"{part}: clients {errors}")
        for name in requests:
            got = [v for _, v in results[name]]
            check(got == want[name], f"{part}: {name} verdicts differ from the in-process ones")
        stats = srv.stats()
        scheds = srv.scheduler_stats()
        cstats = {name: c.stats() for name, c in clients.items()}
        check(sum(stats["cross_client_flushes"].values()) > 0, f"{part}: no cross-client flush {stats}")
        check(stats["admission_rejections"] == 0 and stats["host_direct_lanes"] == 0
              and stats["pin_errors"] == 0 and stats["failed_closed"] == 0,
              f"{part}: sheds, host-direct lanes or pin errors {stats}")
        check(all(s["fallback_calls"] == 0 and s["shed_retries_used"] == 0 for s in cstats.values()),
              f"{part}: client fallbacks or sheds {cstats}")
        check(all(s["flush_errors"] == 0 and s["fallback_flushes"] == 0 for s in scheds.values()),
              f"{part}: failed or fallback flushes {scheds}")
        check(d.get("verify_sr", 0) > 0 and d.get("verify", 0) + d.get("verify_resident", 0) > 0,
              f"{part}: launches {d}")
    finally:
        for c in clients.values():
            c.close()
        srv.stop()
    lanes = sum(len(r[0]) for reqs in requests.values() for r in reqs)
    per_class = {}
    for name, res in results.items():
        ms = [s * 1e3 for s, _ in res]
        per_class[name] = {"requests": len(ms), "lanes_per_request": len(requests[name][0][0]),
                           "p50_ms": percentile(ms, 0.5), "p99_ms": percentile(ms, 0.99),
                           "max_ms": max(ms)}
    return {"config": {"admission_cap": VERIFYD_MIX_CAP, "max_pending": VERIFYD_MIX_CAP,
                       "tenant_cap": VERIFYD_MIX_CAP, "service_budget_s": VERIFYD_MIX_SERVICE_BUDGET,
                       "tenant": protocol.DEFAULT_TENANT},
            "brownout": srv.brownout.snapshot(),
            "lanes": lanes, "wall_s": wall, "lanes_per_s": lanes / wall, "per_class": per_class,
            "launches": d, "cross_client_flushes": stats["cross_client_flushes"],
            "schedulers": scheds, "scheduler_knobs": stats["scheduler"],
            "in_process_reference_s": reference_s}


def verifyd_ladder(srv, commit_wl, dev):
    """13c: ``brownout.force(1..5)`` on 13a's server (the reference's
    defaults): rpc, light and blocksync shed in that order, consensus
    never, host-direct at rungs 4 and 5; after ``force(None)`` consensus
    launches a kernel again. Then a fault at ``ed25519.chunk`` with host
    fallback off reaches the client as STATUS_INTERNAL."""
    from tendermint_tpu_torch.ops import device_policy, fault_injection, precompute
    from tendermint_tpu_torch.verifyd import protocol
    from tendermint_tpu_torch.verifyd.client import VerifydClient, VerifydRejectedError
    from tendermint_tpu_torch.verifyd.server import LEVEL_NAMES, level_sheds_class

    part = "phase 13c"
    vset, _, commits = commit_wl
    all_lanes = commit_lanes(vset, commits[0])
    cursor = [0]

    def take(n):
        lo = cursor[0]
        cursor[0] += n
        check(cursor[0] <= COMMIT_VALIDATORS, f"{part}: out of lanes")
        lanes = plant_bad(tuple(x[lo:lo + n] for x in all_lanes), (n // 2,))
        return lanes, [i != n // 2 for i in range(n)]

    health = device_policy.shared
    check(not health.host_fallback, f"{part}: host fallback is on")
    c = VerifydClient("%s:%d" % srv.address, shed_retries=0)
    classes = (protocol.CLASS_RPC, protocol.CLASS_LIGHT, protocol.CLASS_BLOCKSYNC, protocol.CLASS_CONSENSUS)
    rows = []
    try:
        for level in range(1, 6):
            srv.brownout.force(level)
            row = {"level": LEVEL_NAMES[level]}
            for klass in classes:
                n = VERIFYD_LADDER_LANES if klass == protocol.CLASS_CONSENSUS else VERIFYD_LADDER_SHED_LANES
                lanes, want = take(n)
                precompute.results.clear()
                host0, before = srv.stats()["host_direct_lanes"], launches()
                try:
                    got = c.verify(*lanes, klass=klass)
                    outcome = "ok"
                except VerifydRejectedError as exc:
                    got, outcome = None, protocol.STATUS_NAMES[exc.status]
                host = srv.stats()["host_direct_lanes"] - host0
                name = protocol.CLASS_NAMES[klass]
                if level_sheds_class(level, klass):
                    check(outcome == "resource_exhausted", f"{part}: {name} at {row['level']}: {outcome}")
                else:
                    check(outcome == "ok" and got == want, f"{part}: {name} at {row['level']}: {outcome}")
                if klass == protocol.CLASS_CONSENSUS:
                    direct = level >= 4
                    check(host == (n if direct else 0) and (not delta(before)) == direct,
                          f"{part}: consensus at {row['level']}: {host} host-direct lanes, "
                          f"launches {delta(before)}")
                row[name] = outcome if not host else f"host_direct ({host} lanes)"
            rows.append(row)
        srv.brownout.force(None)
        snap = health.snapshot()
        direct_lanes = srv.stats()["host_direct_lanes"]
        check(direct_lanes == 2 * VERIFYD_LADDER_LANES
              and snap["fallback_lanes"].get("ed25519", 0) == direct_lanes,
              f"{part}: host-direct lanes {direct_lanes}, health {snap}")
        health.reset()
        lanes, want = take(VERIFYD_LADDER_LANES)
        precompute.results.clear()
        before = launches()
        check(c.verify(*lanes, klass=protocol.CLASS_CONSENSUS) == want, f"{part}: after the ladder")
        after_ladder = delta(before)
        check(after_ladder, f"{part}: no kernel launched after force(None)")
        # a device fault with host fallback off: an error at the client,
        # never a verdict list
        lanes, _ = take(VERIFYD_LADDER_LANES)
        precompute.results.clear()
        failed0 = srv.stats()["failed_closed"]
        with fault_injection.inject(site="ed25519.chunk", fail_calls=(1,)) as plan:
            try:
                got = c.verify(*lanes, klass=protocol.CLASS_CONSENSUS)
            except VerifydRejectedError as exc:
                got, status, message = None, exc.status, str(exc)
            else:
                status, message = protocol.STATUS_OK, ""
        fault_snap = health.snapshot()
        check(got is None and status == protocol.STATUS_INTERNAL and "injected" in message
              and plan.faults_raised == 1 and srv.stats()["failed_closed"] == failed0 + 1,
              f"{part}: the fault reached the client as {status} {message!r} (verdicts {got is not None})")
        check(sum(fault_snap["failures"].values()) == 1 and fault_snap["fallback_batches"] == 0,
              f"{part}: health after the fault {fault_snap}")
    finally:
        srv.brownout.force(None)
        c.close()
        health.reset()
    return {"rungs": rows, "host_direct_lanes": direct_lanes,
            "launches_after_force_none": after_ladder,
            "fault": {"status": protocol.STATUS_NAMES[status], "message": message,
                      "health": {k: fault_snap[k] for k in ("state", "failures", "transitions")}}}


def verifyd_hot_keys(batch, dev):
    """13d: set-less traffic from phase 3's 256 signers, each seen 3 times,
    under two tenants with 128 pins each: K1 first, then the store (K3)."""
    from tendermint_tpu_torch.ops import introspect, precompute, resident
    from tendermint_tpu_torch.verifyd import protocol
    from tendermint_tpu_torch.verifyd.client import VerifydClient
    from tendermint_tpu_torch.verifyd.server import VerifydServer

    part = "phase 13d"
    pks, msgs, sigs, want = batch
    precompute.reset()
    resident.reset()
    check(precompute.tables.stats()["active_sets"] == 0 and resident.stats()["resident_keys"] == 0,
          f"{part}: caches not empty")
    srv = VerifydServer(device=dev, tenant_pin_quota=VERIFYD_HOT_QUOTA)
    srv.start()
    tenants = ("chain-a", "chain-b")
    clients = [VerifydClient("%s:%d" % srv.address, tenant=t) for t in tenants]
    half = VERIFYD_HOT_SIGNERS // 2
    rounds = []
    try:
        for r in range(VERIFYD_HOT_SIGHTINGS):
            before = launches()
            t = time.perf_counter()
            for h, c in enumerate(clients):
                lo = r * VERIFYD_HOT_SIGNERS + h * half
                got = c.verify(pks[lo:lo + half], msgs[lo:lo + half], sigs[lo:lo + half],
                               klass=protocol.CLASS_CONSENSUS)
                check(got == [bool(x) for x in want[lo:lo + half]], f"{part}: round {r} verdicts")
            d = delta(before)
            rounds.append({"ms": (time.perf_counter() - t) * 1e3, "launches": d,
                           "pinned": len(resident.pinned_keys())})
            if r < 2:
                check(d.get("verify", 0) > 0 and not d.get("verify_resident"),
                      f"{part}: round {r} launches {d}")
            else:
                check(d.get("verify_resident", 0) > 0 and not d.get("verify"),
                      f"{part}: round {r} launches {d}")
        pins = resident.tenant_pins()
        store = resident.stats()
        rows = {k: v for k, v in introspect.accountant.snapshot()["device_bytes"].items()
                if k.startswith("resident_tables/")}
        stats = srv.stats()
        check(pins == {t: half for t in tenants} and all(n <= VERIFYD_HOT_QUOTA for n in pins.values()),
              f"{part}: pins {pins}")
        check(store["hits"] > 0 and store["resident_keys"] == VERIFYD_HOT_SIGNERS,
              f"{part}: store {store}")
        check(set(rows) == {f"resident_tables/{t}" for t in tenants}
              and sum(rows.values()) == resident.store.device_nbytes() > 0,
              f"{part}: ledger rows {rows}, store {resident.store.device_nbytes()} bytes")
        check(stats["pin_errors"] == 0 and stats["host_direct_lanes"] == 0
              and stats["admission_rejections"] == 0, f"{part}: stats {stats}")
    finally:
        for c in clients:
            c.close()
        srv.stop()
        precompute.reset()
    return {"rounds": rounds, "tenant_pins": pins, "store": store, "ledger_rows": rows,
            "store_bytes": sum(rows.values())}


def verifyd_daemon(light, dev):
    """13e: ``python -m tendermint_tpu_torch verifyd`` as its own process
    on the card: phase 8's header commits from this process, the
    STATS_PATH snapshot, ``/metrics``, and SIGTERM."""
    import queue
    import signal
    import urllib.request

    from tendermint_tpu_torch.libs.metrics import Registry, VerifydMetrics
    from tendermint_tpu_torch.types.validation import verify_commit
    from tendermint_tpu_torch.verifyd import client as vclient, protocol
    from tendermint_tpu_torch.verifyd.client import VerifydClient

    part = "phase 13e"
    chain, lvset, _ = light
    requests = [plant_bad(commit_lanes(lvset, sh.commit), ((h * 131 + 17) % LIGHT_VALIDATORS,))
                for h, sh in enumerate(chain[:VERIFYD_CHILD_HEADERS])]
    want = in_process(requests, dev)
    check(all(sum(not x for x in w) == 1 for w in want), f"{part}: in-process verdicts")
    sh = chain[VERIFYD_CHILD_HEADERS]
    verify_commit(CHAIN_ID, lvset, sh.commit.block_id, sh.height, sh.commit, device=dev)
    root = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(root, "build"), exist_ok=True)
    err_path = os.path.join(root, "build", "verifyd_daemon.stderr")
    env = dict(os.environ, PYTHONPATH=root, PYTHONUNBUFFERED="1")
    t_start = time.perf_counter()
    with open(err_path, "w") as err:
        # the daemon's default device is CUDA; a CPU rehearsal names its own
        argv = [sys.executable, "-m", "tendermint_tpu_torch", "verifyd", "--port", "0",
                "--metrics", "127.0.0.1:0"] + ([] if dev.type == "cuda" else ["--device", dev.type])
        proc = subprocess.Popen(argv, cwd=root, env=env, stdout=subprocess.PIPE, stderr=err, text=True)
    lines = queue.Queue()
    threading.Thread(target=lambda: [lines.put(x) for x in proc.stdout], daemon=True).start()
    c = None
    try:
        banner = lines.get(timeout=VERIFYD_CHILD_WAIT_S).strip()
        metrics_line = lines.get(timeout=VERIFYD_CHILD_WAIT_S).strip()
        start_s = time.perf_counter() - t_start
        check(banner.startswith("verifyd serving on ") and "shm=off, shard=standalone)" in banner
              and f"device={dev.type}" in metrics_line, f"{part}: banner {banner!r} {metrics_line!r}")
        addr = banner.split()[3]
        murl = "http://" + metrics_line.split()[3] + "/metrics"
        c = VerifydClient(addr, timeout=60.0)
        header_ms = []
        for r, w in zip(requests, want):
            t = time.perf_counter()
            got = c.verify(*r, klass=protocol.CLASS_CONSENSUS)
            header_ms.append((time.perf_counter() - t) * 1e3)
            check(got == w, f"{part}: the daemon's verdicts differ from the in-process ones")
        vclient.set_remote_addr(addr)
        try:
            t = time.perf_counter()
            verify_commit(CHAIN_ID, lvset, sh.commit.block_id, sh.height, sh.commit, device=dev)
            commit_ms = (time.perf_counter() - t) * 1e3
        finally:
            vclient.set_remote_addr("")
        snap = c.server_stats(timeout=30.0)
        stats = snap["stats"]
        check(stats["requests_served"] == VERIFYD_CHILD_HEADERS + 1 and stats["host_direct_lanes"] == 0
              and stats["pin_errors"] == 0 and stats["admission_rejections"] == 0,
              f"{part}: daemon stats {stats}")
        check(all(s["flush_errors"] == 0 and s["fallback_flushes"] == 0
                  for s in snap["schedulers"].values())
              and snap["health"]["state"] == "healthy" and snap["health"]["fallback_batches"] == 0,
              f"{part}: daemon schedulers {snap['schedulers']}, health {snap['health']}")
        child_launches = {k: v for k, v in snap["launches"].items() if v}
        check(child_launches.get("verify", 0) > 0, f"{part}: daemon launches {child_launches}")
        with urllib.request.urlopen(murl, timeout=30) as resp:
            text = resp.read().decode()
        families = sorted({ln.split()[2] for ln in text.splitlines()
                           if ln.startswith("# TYPE tendermint_verifyd_")})
        ref_reg = Registry()
        VerifydMetrics(ref_reg)
        want_families = sorted({ln.split()[2] for ln in ref_reg.expose().splitlines()
                                if ln.startswith("# TYPE ")})
        check(families == want_families
              and 'tendermint_verifyd_requests_total{kind="commit",status="ok"}' in text,
              f"{part}: /metrics families {families}")
        c.close()
        c = None
        t = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=VERIFYD_CHILD_STOP_S)
        stop_s = time.perf_counter() - t
        check(rc == 0, f"{part}: the daemon exited {rc}")
    finally:
        if c is not None:
            c.close()
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    return {"start_s": start_s, "banner": banner, "header_lanes": LIGHT_VALIDATORS,
            "header_ms": header_ms, "cross_process_commit_ms": commit_ms,
            "requests_served": stats["requests_served"], "resident": snap["resident"],
            "pinned_keys": len(snap["pinned_keys"]), "tenant_pins": snap["tenant_pins"],
            "launches": child_launches, "metrics_families": len(families), "stop_s": stop_s}


def phase_verifyd(commit_wl, commit_tables, batch, sync, mixed_sync, light, dev):
    """Phase 13: verifyd on the card (see the module note). Returns the
    launches of the requests the servers answered: each sub-phase's
    deltas around its served requests only (13a's and 13b's in-process
    references and 13e's warm-up are left out), plus the daemon's own
    counts from its snapshot."""
    from tendermint_tpu_torch.ops import precompute
    from tendermint_tpu_torch.verifyd import client as vclient
    from tendermint_tpu_torch.verifyd.server import VerifydServer

    t_phase = time.perf_counter()
    check(len(commit_tables) == COMMIT_VALIDATORS, f"phase 13: {len(commit_tables)} tables of the set")
    srv = VerifydServer(device=dev)  # the reference's defaults
    srv.start()
    try:
        t = time.perf_counter()
        out = verifyd_remote_commit(srv, commit_wl, commit_tables, dev)
        served = {"13a": out["served_launches"]}
        emit({"phase": "verifyd_13a_remote_commit", "seconds": time.perf_counter() - t, **out})
        t = time.perf_counter()
        out = verifyd_mix(commit_wl, sync, mixed_sync, light, dev)
        served["13b"] = out["launches"]  # taken around the clients only
        emit({"phase": "verifyd_13b_mix", "seconds": time.perf_counter() - t, **out})
        health = check_healthy("phase 13a-13b")
        t = time.perf_counter()
        before = launches()  # 13c runs no in-process reference: all of it is served
        out = verifyd_ladder(srv, commit_wl, dev)
        served["13c"] = delta(before)
        emit({"phase": "verifyd_13c_ladder", "seconds": time.perf_counter() - t, **out})
    finally:
        vclient.reset_remote()
        srv.stop()
    t = time.perf_counter()
    out = verifyd_hot_keys(batch, dev)
    served["13d"] = add_launches(*(r["launches"] for r in out["rounds"]))
    emit({"phase": "verifyd_13d_hot_keys", "seconds": time.perf_counter() - t, **out})
    t = time.perf_counter()
    daemon = verifyd_daemon(light, dev)
    served["13e"] = daemon["launches"]
    emit({"phase": "verifyd_13e_daemon", "seconds": time.perf_counter() - t, **daemon})
    precompute.reset()
    counts = launches()
    summed = add_launches(*served.values())
    total = {k: summed.get(k, 0) for k in counts}
    seconds = time.perf_counter() - t_phase
    emit({"phase": "verifyd", "seconds": seconds, "launches_this_process": counts,
          "launches_served": served, "launches": total, "health_13a_13b": health})
    check(seconds <= VERIFYD_PHASE_S, f"phase 13 took {seconds:.1f} s")
    return total


def main(argv=None) -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description="Drive the port's main path on one GPU and check it.")
    parser.add_argument("--trace-dir", default="build",
                        help="where phase 12 writes its profiler traces (default: build)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing to run", file=sys.stderr)
        return 2
    from tendermint_tpu_torch.crypto import batch as crypto_batch
    from tendermint_tpu_torch.ops import _build, cuda_hash, cuda_verify, device_policy

    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    workers = min(8, os.cpu_count() or 1)
    with multiprocessing.get_context("spawn").Pool(workers) as pool:
        signer = Signer(pool)
        kernel_lanes = fault_lanes(rng, signer)
        batch = batch_lanes(rng, signer)
        commit = commit_workload(rng, signer)
        sr_lanes = sr_fault_lanes(rng, signer)
        mixed = mixed_commit_workload(rng, signer)
        sync = chain_workload(rng, signer, SYNC_BLOCKS, SYNC_VALIDATORS)
        mixed_sync = chain_workload(rng, signer, MIXED_SYNC_BLOCKS, MIXED_SYNC_VALIDATORS, mixed=True)
        light = chain_workload(rng, signer, LIGHT_HEADERS, LIGHT_VALIDATORS)
        round_wl = round_workload(rng, signer)
        lightd_wl = lightd_workload(rng, signer)
        commit_tables = signer.tables(commit[0])  # phase 12 starts from them
    emit({"phase": "setup", "seconds": time.perf_counter() - t0, "workers": workers,
          "signatures": 2 * KERNEL_LANES + BATCH_LANES + len(COMMIT_HEIGHTS) * COMMIT_VALIDATORS
          + MIXED_VALIDATORS + SYNC_BLOCKS * SYNC_VALIDATORS
          + MIXED_SYNC_BLOCKS * MIXED_SYNC_VALIDATORS + LIGHT_HEADERS * LIGHT_VALIDATORS
          + 3 * ROUND_VALIDATORS + (LIGHTD_HEADERS + 1) * LIGHTD_VALIDATORS})

    dev = torch.device("cuda", 0)
    smi = nvidia_smi("name,power.limit")
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    for src, log in _build.build_log.items():
        print(f"--- nvcc {src}\n{log}", file=sys.stderr)
    emit({"phase": "device", "name": torch.cuda.get_device_name(0), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda, "build_s": build_s})

    rows = phase_kernels(kernel_lanes, dev, sr_lanes=sr_lanes)
    device_policy.shared.reset()
    cuda_verify.reset_launches()  # the main path starts here
    cuda_hash.reset_launches()
    phase_verify_batch(batch, dev)
    phase_commit(commit, dev)
    counts = launches()
    health = {"phases_3_to_4b": check_healthy("phases 3-4b")}
    cuda_verify.reset_launches()  # the mixed commit's path starts here
    cuda_hash.reset_launches()
    mixed_counts = phase_mixed_commit(mixed, dev)
    health["phase_5"] = check_healthy("phase 5")
    cuda_verify.reset_launches()  # the blocksync path starts here
    cuda_hash.reset_launches()
    sync_counts = phase_blocksync(sync, mixed_sync, dev)
    health["phase_7"] = check_healthy("phase 7")
    cuda_verify.reset_launches()  # the light client's path starts here
    cuda_hash.reset_launches()
    light_counts = phase_light(light, dev)
    health["phase_8"] = check_healthy("phase 8")
    vote_counts = phase_votes(commit, round_wl, dev)  # resets the counts after its set-up
    health["phase_9"] = check_healthy("phase 9")
    cuda_verify.reset_launches()  # the light client's bisection round starts here
    cuda_hash.reset_launches()
    light_round_counts = phase_light_round(light, dev)
    health["phase_10"] = check_healthy("phase 10")
    cuda_verify.reset_launches()  # the light client and lightd start here
    cuda_hash.reset_launches()
    lightd_counts = phase_lightd(lightd_wl, dev)
    health["phase_11"] = check_healthy("phase 11")
    cuda_verify.reset_launches()  # the observed path starts here
    cuda_hash.reset_launches()
    observed_counts = phase_observed(commit, commit_tables, mixed, kernel_lanes, batch, lightd_wl, dev,
                                     args.trace_dir)
    health["phase_12"] = check_healthy("phase 12")
    cuda_verify.reset_launches()  # verifyd starts here
    cuda_hash.reset_launches()
    verifyd_counts = phase_verifyd(commit, commit_tables, batch, sync, mixed_sync, light, dev)
    for name in ("verify", "verify_resident", "verify_sr"):
        check(verifyd_counts[name] > 0, f"kernel {name} never launched through verifyd")
    health["phase_13"] = check_healthy("phase 13")
    crypto_batch.shutdown_shared_scheduler()
    emit({"phase": "health", **health})
    phase_faults(kernel_lanes, sr_lanes, dev)
    for name, row in rows.items():
        n = mixed_counts[name] if name == "verify_sr" else counts[name]
        check(n > 0, f"kernel {name} never launched on the main path")
        row["launches"] = n
        row["launches_mixed_commit"] = mixed_counts[name]
        row["launches_blocksync"] = sync_counts[name]
        row["launches_light_client"] = light_counts[name]
        row["launches_votes"] = vote_counts[name]
        row["launches_light_batch"] = light_round_counts[name]
        row["launches_lightd"] = lightd_counts[name]
        row["launches_observed"] = observed_counts[name]
        row["launches_verifyd"] = verifyd_counts[name]
    emit({"kernels": list(rows.values())})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
