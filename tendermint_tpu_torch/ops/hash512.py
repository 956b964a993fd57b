"""Batched SHA-512 and reduction mod L on the device: the challenge hash.

Counterpart of ``tendermint_tpu/ops/hash512.py``. The verifier's
challenge is ``k = SHA-512(R || A || M) mod L``. For a chunk whose
messages all have one length (vote and commit batches mostly do) the
host only packs the bytes into padded SHA-512 blocks, one ``(N, B*128)``
uint8 matrix, and the K4 kernel (``csrc/sha512_challenge.cu``, wrapper
:func:`tendermint_tpu_torch.ops.cuda_hash.challenge`) hashes and reduces
them on the card. k stays on the device: the engine hands it to the
verify kernel without a copy back.

:func:`sha512_blocks` and :func:`reduce_mod_l_bytes` are K4's plain
PyTorch version, a transcription of the reference's ``_sha512_blocks``
and ``_reduce_mod_l_bytes``: each 64-bit word is a (hi, lo) pair of
32-bit halves held in int64 tensors and masked after every add and
shift (PyTorch's uint32/uint64 lack arithmetic and shifts on the CPU in
many builds, and an int64 right shift is arithmetic). Both are exact.

:func:`try_challenge_device` returns ``None`` (the caller hashes on the
host) only for eligibility: the path is off, the chunk is empty, or the
messages differ in length; each case is counted in :func:`stats`, and
``bind_metrics`` mirrors the device lanes into
``tendermint_ops_hash_device_lanes_total``. A kernel error propagates. The path is on exactly when the chunk is
verified on a CUDA device: K4 takes the block count as an argument, so
no message length needs a cap.

Constants are derived, not transcribed: the round constants are the
fractional parts of the cube roots of the first 80 primes and the
initial state those of the square roots of the first 8, by integer
Newton roots. The CUDA source carries them as literals, and the tests
hold the literals to these.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tendermint_tpu_torch.crypto.hashing import L
from tendermint_tpu_torch.ops import field as F

_MASK64 = (1 << 64) - 1
_M32 = 0xFFFFFFFF


def _primes(count: int) -> List[int]:
    out: List[int] = []
    cand = 2
    while len(out) < count:
        if all(cand % p for p in out if p * p <= cand):
            out.append(cand)
        cand += 1
    return out


def _icbrt(n: int) -> int:
    """floor(n ** (1/3)) by integer Newton iteration."""
    x = 1 << -(-n.bit_length() // 3)
    while True:
        y = (2 * x + n // (x * x)) // 3
        if y >= x:
            return x
        x = y


_P80 = _primes(80)
# K[t] = frac(cbrt(p_t)) * 2^64; H0[i] = frac(sqrt(p_i)) * 2^64.
K64 = [_icbrt(p << 192) & _MASK64 for p in _P80]
H64 = [math.isqrt(p << 128) & _MASK64 for p in _P80[:8]]
# Barrett constant mu = floor(2^512 / L), as the reference's byte limbs.
MU = (1 << 512) // L
_MU_BYTES = [(MU >> (8 * i)) & 0xFF for i in range((MU.bit_length() + 7) // 8)]
_L_BYTES = [(L >> (8 * i)) & 0xFF for i in range(32)]


# --- plain version: 64-bit words as (hi, lo) int64 pairs -----------------------

Word = Tuple[torch.Tensor, torch.Tensor]


def _add(*words: Word) -> Word:
    """Sum mod 2^64 of (hi, lo) words."""
    lo = sum(w[1] for w in words)
    hi = sum(w[0] for w in words) + (lo >> 32)
    return hi & _M32, lo & _M32


def _const(v: int, like: torch.Tensor) -> Word:
    return (torch.full_like(like, v >> 32), torch.full_like(like, v & _M32))


def _rotr(w: Word, r: int) -> Word:
    """Rotate right by r in [1, 63], r % 32 != 0."""
    h, l = w if r < 32 else (w[1], w[0])
    r %= 32
    return (h >> r) | ((l << (32 - r)) & _M32), (l >> r) | ((h << (32 - r)) & _M32)


def _shr(w: Word, n: int) -> Word:
    """Logical shift right by n in [1, 31]."""
    return w[0] >> n, (w[1] >> n) | ((w[0] << (32 - n)) & _M32)


def _xor3(a: Word, b: Word, c: Word) -> Word:
    return a[0] ^ b[0] ^ c[0], a[1] ^ b[1] ^ c[1]


def _compress(state: List[Word], w: List[Word]) -> List[Word]:
    """One SHA-512 compression of 16 message words into ``state``."""
    w = list(w)
    for t in range(16, 80):
        s0 = _xor3(_rotr(w[t - 15], 1), _rotr(w[t - 15], 8), _shr(w[t - 15], 7))
        s1 = _xor3(_rotr(w[t - 2], 19), _rotr(w[t - 2], 61), _shr(w[t - 2], 6))
        w.append(_add(s1, w[t - 7], s0, w[t - 16]))
    a, b, c, d, e, f, g, h = state
    for t in range(80):
        bs1 = _xor3(_rotr(e, 14), _rotr(e, 18), _rotr(e, 41))
        ch = tuple((e[i] & f[i]) ^ ((e[i] ^ _M32) & g[i]) for i in range(2))
        t1 = _add(h, bs1, ch, _const(K64[t], e[0]), w[t])
        bs0 = _xor3(_rotr(a, 28), _rotr(a, 34), _rotr(a, 39))
        maj = tuple((a[i] & b[i]) ^ (a[i] & c[i]) ^ (b[i] & c[i]) for i in range(2))
        t2 = _add(bs0, maj)
        a, b, c, d, e, f, g, h = _add(t1, t2), a, b, c, _add(d, t1), e, f, g
    return [_add(s, v) for s, v in zip(state, (a, b, c, d, e, f, g, h))]


def sha512_blocks(data: torch.Tensor) -> torch.Tensor:
    """(N, B*128) uint8 padded blocks -> (N, 64) uint8 digests (the
    hash half of K4's plain version)."""
    n = data.shape[0]
    x = data.to(torch.int64).reshape(n, data.shape[1] // 128, 16, 8)
    hi = (x[..., 0] << 24) | (x[..., 1] << 16) | (x[..., 2] << 8) | x[..., 3]
    lo = (x[..., 4] << 24) | (x[..., 5] << 16) | (x[..., 6] << 8) | x[..., 7]
    zero = torch.zeros(n, dtype=torch.int64, device=data.device)
    state = [_const(v, zero) for v in H64]
    for blk in range(x.shape[1]):
        state = _compress(state, [(hi[:, blk, i], lo[:, blk, i]) for i in range(16)])
    # Each word big-endian: hi's bytes, then lo's.
    cols = [(half >> s) & 0xFF for w in state for half in w for s in (24, 16, 8, 0)]
    return torch.stack(cols, dim=1).to(torch.uint8)


def _mul_const_bytes(x: torch.Tensor, const_bytes: Sequence[int], out_len: int) -> torch.Tensor:
    """(N, a) int64 byte limbs times a constant's byte limbs -> (N,
    out_len) columns, not carried."""
    a = x.shape[1]
    cols = torch.zeros((x.shape[0], out_len), dtype=torch.int64, device=x.device)
    for j, cb in enumerate(const_bytes):
        cols[:, j : j + a] += x * cb
    return cols


def _carry_bytes(cols: torch.Tensor, nlimbs: int) -> torch.Tensor:
    """Carry int64 columns into nlimbs byte limbs (overflow dropped)."""
    outs = []
    c = torch.zeros(cols.shape[0], dtype=torch.int64, device=cols.device)
    for i in range(nlimbs):
        v = c + cols[:, i]
        outs.append(v & 0xFF)
        c = v >> 8
    return torch.stack(outs, dim=1)


def _sub_bytes(x: torch.Tensor, y) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, 32) byte limbs minus y's 32 limbs (a tensor or constant bytes)
    -> (limbs mod 2^256, borrow out)."""
    outs = []
    borrow = torch.zeros(x.shape[0], dtype=torch.int64, device=x.device)
    for i in range(32):
        v = x[:, i] - y[i] - borrow
        borrow = (v < 0).to(torch.int64)
        outs.append(v + (borrow << 8))
    return torch.stack(outs, dim=1), borrow


def reduce_mod_l_bytes(digest: torch.Tensor) -> torch.Tensor:
    """(N, 64) uint8 little-endian 512-bit values -> (N, 32) uint8 mod L,
    by the reference's byte-limb Barrett (q from x >> 240, then >> 272,
    up to three conditional subtractions)."""
    x = digest.to(torch.int64)
    q1 = x[:, 30:]
    q2_len = 34 + len(_MU_BYTES) + 1
    q = _carry_bytes(_mul_const_bytes(q1, _MU_BYTES, q2_len), q2_len)[:, 34:]
    ql = _carry_bytes(_mul_const_bytes(q, _L_BYTES, q.shape[1] + 32), 32)
    r, _ = _sub_bytes(x[:, :32], ql.T)
    for _ in range(3):
        sub, borrow = _sub_bytes(r, _L_BYTES)
        r = torch.where((borrow == 0)[:, None], sub, r)
    return r.to(torch.uint8)


def challenge_kernel(
    blocks: torch.Tensor, pad_row: Optional[torch.Tensor] = None, m: Optional[int] = None
) -> torch.Tensor:
    """Plain version of K4: (n, B*128) uint8 blocks -> (m, 32) uint8,
    rows below n ``SHA-512 mod L`` of the block rows, the rest
    ``pad_row``."""
    k = reduce_mod_l_bytes(sha512_blocks(blocks))
    n = blocks.shape[0]
    if m is not None and m > n:
        k = torch.cat([k, pad_row.reshape(1, 32).expand(m - n, 32)])
    return k


# --- host packing and entry points ---------------------------------------------


def _pack(rows: np.ndarray) -> np.ndarray:
    """(N, T) uint8 messages, all of one length -> (N, B*128) padded
    SHA-512 blocks: 0x80, zeros, the 128-bit big-endian bit length."""
    n, total = rows.shape
    padded = ((total + 17 + 127) // 128) * 128
    buf = np.zeros((n, padded), dtype=np.uint8)
    buf[:, :total] = rows
    buf[:, total] = 0x80
    buf[:, -16:] = np.frombuffer((total * 8).to_bytes(16, "big"), dtype=np.uint8)
    return buf


def device_hash_enabled(device) -> bool:
    """Whether the device hash serves eligible chunks verified on
    ``device``: a CUDA device (None: no device, so off)."""
    return device is not None and torch.device(device).type == "cuda"


_stats_lock = threading.Lock()
_REASONS = ("off", "empty", "mixed_lengths")
_counts: Dict[str, int] = {}  # guarded-by: _stats_lock
_metrics = None  # guarded-by: _stats_lock


def bind_metrics(metrics) -> None:
    """Mirror the device lanes into ``metrics.hash_device_lanes`` (an
    ``OpsMetrics``; None unbinds)."""
    global _metrics
    with _stats_lock:
        _metrics = metrics


def reset_stats() -> None:
    with _stats_lock:
        _counts.clear()
        _counts.update({"device_lanes": 0, **{f"declined_{r}": 0 for r in _REASONS}})


reset_stats()


def _count(key: str, n: int = 1) -> None:
    with _stats_lock:
        _counts[key] += n
        metrics = _metrics
    if metrics is not None and key == "device_lanes":
        metrics.hash_device_lanes.inc(n)


def stats() -> Dict[str, int]:
    """``device_lanes`` (lanes hashed by the device path) and a count of
    the chunks declined for each eligibility reason."""
    with _stats_lock:
        return dict(_counts)


def _matrix(msgs) -> np.ndarray:
    if isinstance(msgs, np.ndarray):
        return msgs.astype(np.uint8, copy=False)
    return np.frombuffer(b"".join(msgs), dtype=np.uint8).reshape(len(msgs), len(msgs[0]))


def try_challenge_device(
    prefix: np.ndarray,
    msgs: Sequence[bytes],
    device,
    pad_to: Optional[int] = None,
    pad_row: Optional[np.ndarray] = None,
) -> Optional[torch.Tensor]:
    """Challenge scalars of one chunk on ``device``, or None for the host.

    Returns an ``(m, 32)`` uint8 tensor on ``device`` (m = ``pad_to`` or
    N) whose row i < N is ``SHA-512(prefix_i || msg_i) mod L`` and whose
    pad rows are ``pad_row`` (a (1, 32) or (32,) uint8 module constant,
    sent to the device once), when the path is on and every message has
    the same length.
    """
    from tendermint_tpu_torch.ops import cuda_hash

    if not device_hash_enabled(device):
        _count("declined_off")
        return None
    n = len(msgs)
    if n == 0:
        _count("declined_empty")
        return None
    w = len(msgs[0])
    if any(len(m) != w for m in msgs):
        _count("declined_mixed_lengths")
        return None
    data = _pack(np.concatenate([prefix, _matrix(msgs)], axis=1))
    blocks = F.upload(data, device)
    m = n if pad_to is None else pad_to
    pad = F.on(pad_row, blocks).reshape(32) if m > n else None
    out = cuda_hash.challenge(blocks, pad, m)
    _count("device_lanes", n)
    return out
