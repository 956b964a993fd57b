"""Batched Ed25519 ZIP-215 verification: plain kernels and the host path.

Counterpart of ``tendermint_tpu/ops/ed25519_batch.py``. For each lane i
the verifier checks the cofactored equation

    [8]([s_i]B - R_i - [k_i]A_i) == identity

with a shared-doubling (Straus) double-scalar multiplication over 64
signed 4-bit windows (digits in [-8, 8)): a constant Niels table of
[1..8]B and a per-lane cached table of [1..8](-A_i).

:func:`verify_kernel` (decompress A and R, build the lane tables),
:func:`verify_kernel_tables` (tables gathered from ops/precompute.py,
decompress R only) and :func:`verify_kernel_resident` (tables read from
the resident store of ops/resident.py by column index) are the *plain*
PyTorch versions of the three CUDA kernels in ``csrc/ed25519_verify.cu``;
``ops/cuda_verify.py`` launches the kernels for CUDA tensors and calls
these for CPU tensors.

:func:`verify_batch` is the entry point: the result cache answers lanes
seen before; the rest split into resident, table and legacy jobs, in
that order, chunked at :data:`CHUNK` lanes, and the chunks are
double-buffered (chunk i's kernel is enqueued, then chunk i+1's host prep
runs). Host prep is the s < L check and the challenge k = SHA-512(R‖A‖M)
mod L, which a chunk of equal-length messages hashes on the device
(ops/hash512.py, K4) and keeps there; the device gets raw (N, 32) uint8
rows. The verdicts are ANDed with the host checks.

Device failures go to the health machine both engines share
(``ops/device_policy.py``), which classifies and counts them. Then they
propagate, and a batch the machine does not admit (cooling down or
disabled) raises ``device_policy.DeviceRefused``, unless the caller set
``device_policy.shared.host_fallback``: then a chunk whose host prep,
launch or read-back fails is answered by the host oracle, refused
batches are answered on the host whole, and their lanes are counted in
``device_policy.shared.snapshot()["fallback_lanes"]``. Three errors are
never handed to the machine and always propagate: a kernel that does not
build (``_build.KernelBuildError``), and an error of the resident store's
``acquire`` or of its upload.

Each stage runs in a span of ``libs/tracing.py`` with the reference's
names and tags: ``verify_batch`` (``engine``, ``lanes``) around
``cache_lookup`` (``hits``) and, per chunk, ``prep_chunk``,
``dispatch_chunk`` and ``collect_chunk`` (``stage``, ``engine``,
``kind``, ``lanes``); ``host_fallback`` only where the host answers.
``dispatch_chunk`` times the launch, not the kernel: launches are
asynchronous, and nothing in the span waits for the card.
"""

from __future__ import annotations

import warnings
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from tendermint_tpu_torch import resolve_device
from tendermint_tpu_torch.crypto import ed25519_ref as ref
from tendermint_tpu_torch.crypto.hashing import (
    L,
    reduce_mod_l,
    sha512_batch_mod_l,
    sha512_batch_prefixed,
)
from tendermint_tpu_torch.libs import tracing
from tendermint_tpu_torch.ops import (
    _build,
    curve,
    device_policy,
    fault_injection,
    field as F,
    hash512,
    precompute,
    resident,
)

_L_BYTES_BE = np.frombuffer(L.to_bytes(32, "big"), dtype=np.uint8)

NWINDOWS = 64  # 256 bits / 4
TABLE_WIDTH = 8  # rows of the per-lane signed-window table: [1..8](-A)

# Chunk size for pipelined dispatch; also the largest padded launch.
CHUNK = 4096
_BUCKETS = [64, 256, 1024, CHUNK]


# --- constant basepoint table (host precompute, Niels form) -----------------


def _build_b_niels_table(width: int = 8, base=ref.B_POINT) -> np.ndarray:
    """(width, 3, 32) f32: [1..width]base (B by default) as (Y+X, Y-X,
    2dT), Z=1."""
    out = np.zeros((width, 3, F.NLIMBS), dtype=np.float32)
    p = F.P
    acc = base
    for i in range(width):
        if i:
            acc = ref.pt_add(acc, base)
        zinv = pow(acc[2], p - 2, p)
        x, y = acc[0] * zinv % p, acc[1] * zinv % p
        out[i, 0] = F.int_to_limbs((y + x) % p)
        out[i, 1] = F.int_to_limbs((y - x) % p)
        out[i, 2] = F.int_to_limbs(2 * F.D * x * y % p)
    return out


B_NIELS = _build_b_niels_table()


# --- plain kernels ----------------------------------------------------------


def _bytes_to_fe(raw: torch.Tensor) -> torch.Tensor:
    """(N, 32) uint8 -> (32, N) f32 limbs (radix 2^8 == raw bytes)."""
    return raw.to(torch.float32).T.contiguous()


def _strip_sign(y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(32, N) limbs with bit 255 set-or-not -> (limbs, sign (N,))."""
    sign = torch.floor(y[31] * (1.0 / 128.0))
    return torch.cat([y[:31], (y[31] - 128.0 * sign)[None]], dim=0), sign


def _to_windows_signed(raw: torch.Tensor) -> torch.Tensor:
    """(N, 32) uint8 scalars (LE) -> (64, N) f32 signed digits in [-8, 8),
    most significant first.

    z = x + 0x88...88 (add 136 to every byte, ripple the carries), then
    digit_i = window_i(z) - 8, so x = sum d_i 16^i with every d_i in
    [-8, 7]. Exact for x < 2^253 (s is host-checked < L, k is reduced
    mod L); a larger s drops its carry-out and yields a well-defined
    verdict that the host-side s < L check rejects.
    """
    b = raw.to(torch.float32).T
    carry = torch.zeros_like(b[0])
    z = []
    for i in range(F.NLIMBS):
        t = b[i] + 136.0 + carry
        carry = torch.floor(t * (1.0 / 256.0))
        z.append(t - 256.0 * carry)
    zb = torch.stack(z)  # carry-out dropped
    hi = torch.floor(zb * (1.0 / 16.0))
    lo = zb - 16.0 * hi
    win = torch.stack([hi.flip(0), lo.flip(0)], dim=1).reshape(2 * F.NLIMBS, -1)
    return win - 8.0


def _onehot(digit: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(8, N) f32 one-hot of |digit| over [1..8], and the digit-0 mask."""
    absd = digit.abs()
    rows = torch.arange(1, TABLE_WIDTH + 1, dtype=torch.float32, device=digit.device)
    return (rows[:, None] == absd[None, :]).float(), (absd == 0.0).float()


def _select_b_niels(digit: torch.Tensor, table: torch.Tensor) -> curve.NielsPoint:
    """digit: (N,) in [-8, 8); table: (8, 3, 32) const [1..8]B.

    Digit 0 selects nothing; the miss mask restores the Niels identity
    (1, 1, 0) in limb 0, and digit < 0 negates.
    """
    onehot, miss = _onehot(digit)
    sel = (onehot[:, None, None, :] * table[:, :, :, None]).sum(dim=0)  # (3, 32, N)
    yplusx = torch.cat([sel[0, :1] + miss, sel[0, 1:]], dim=0)
    yminusx = torch.cat([sel[1, :1] + miss, sel[1, 1:]], dim=0)
    return curve.niels_cneg(digit < 0.0, (yplusx, yminusx, sel[2]))


def _select_lane_cached(digit: torch.Tensor, table: torch.Tensor) -> curve.CachedPoint:
    """digit: (N,) in [-8, 8); table: (8, 4, 32, N) cached [1..8]p.
    The cached identity (1, 1, 1, 0) is restored for digit 0."""
    onehot, miss = _onehot(digit)
    sel = (onehot[:, None, None, :] * table).sum(dim=0)  # (4, 32, N)
    fix = [torch.cat([sel[c, :1] + miss, sel[c, 1:]], dim=0) for c in range(3)]
    return curve.cached_cneg(digit < 0.0, (fix[0], fix[1], fix[2], sel[3]))


def _build_lane_table(p: curve.Point) -> torch.Tensor:
    """(8, 4, 32, N) cached-form table of [1..8]p: seven chained complete
    additions, then one wide conversion of all 8 entries to cached form."""
    n = p[0].shape[1]
    cached_p = curve.pt_to_cached(p)
    rows = [p]
    for _ in range(TABLE_WIDTH - 1):
        rows.append(curve.pt_add_cached(rows[-1], cached_p))
    # (32, 8N) per coordinate: entry-major lane blocks
    x, y, z, t = (torch.cat([r[c] for r in rows], dim=1) for c in range(4))
    td2 = F.fe_mul_const(t, F.D2_FE)
    cols = [F.fe_add(y, x), F.fe_sub(y, x), z, td2]
    # (4, 32, 8, N) -> (8, 4, 32, N)
    return torch.stack([c.reshape(F.NLIMBS, TABLE_WIDTH, n) for c in cols]).permute(2, 0, 1, 3)


def _straus_core(a_table: torch.Tensor, s_win: torch.Tensor, k_win: torch.Tensor) -> curve.Point:
    """64-step shared-doubling window loop over a prebuilt lane table:
    acc <- 16 * acc + d_s * B + d_k * (-A)."""
    n = a_table.shape[3]
    b_table = F.on(B_NIELS, a_table)
    acc = curve.pt_identity(n, a_table.device)
    for i in range(NWINDOWS):
        for _ in range(4):
            acc = curve.pt_double(acc)
        acc = curve.pt_madd(acc, _select_b_niels(s_win[i], b_table))
        acc = curve.pt_add_cached(acc, _select_lane_cached(k_win[i], a_table))
    return acc


def straus_sb_minus_ka(a_pt: curve.Point, s_win: torch.Tensor, k_win: torch.Tensor) -> curve.Point:
    """[s]B - [k]A per lane."""
    return _straus_core(_build_lane_table(curve.pt_neg(a_pt)), s_win, k_win)


def _finish_verify(acc: curve.Point, r_pt: curve.Point, ok: torch.Tensor) -> torch.Tensor:
    """Subtract R, multiply by the cofactor 8, test for the identity,
    mask structurally invalid lanes."""
    acc = curve.pt_add(acc, curve.pt_neg(r_pt))
    for _ in range(3):
        acc = curve.pt_double(acc)
    return curve.pt_is_identity(acc) & ok


def verify_kernel(
    pk_bytes: torch.Tensor,
    r_bytes: torch.Tensor,
    s_bytes: torch.Tensor,
    k_bytes: torch.Tensor,
) -> torch.Tensor:
    """Plain version of the K1 kernel: (N,32) uint8 x4 -> (N,) bool."""
    a_y, a_sign = _strip_sign(_bytes_to_fe(pk_bytes))
    r_y, r_sign = _strip_sign(_bytes_to_fe(r_bytes))
    s_win = _to_windows_signed(s_bytes)
    k_win = _to_windows_signed(k_bytes)
    # A and R decompress as one 2N batch.
    n = a_y.shape[1]
    both_pt, both_ok = curve.pt_decompress(
        torch.cat([a_y, r_y], dim=1), torch.cat([a_sign, r_sign], dim=0)
    )
    a_pt = tuple(c[:, :n] for c in both_pt)
    r_pt = tuple(c[:, n:] for c in both_pt)
    acc = straus_sb_minus_ka(a_pt, s_win, k_win)
    return _finish_verify(acc, r_pt, both_ok[:n] & both_ok[n:])


def verify_kernel_tables(
    a_table: torch.Tensor,
    a_ok: torch.Tensor,
    r_bytes: torch.Tensor,
    s_bytes: torch.Tensor,
    k_bytes: torch.Tensor,
) -> torch.Tensor:
    """Plain version of the K2 kernel.

    a_table: (8, 4, 32, N) uint8 gathered [1..8](-A) cached-form columns
    (canonical limbs); a_ok: (N,) uint8 decompression verdicts of A.
    Only R is decompressed.
    """
    r_y, r_sign = _strip_sign(_bytes_to_fe(r_bytes))
    s_win = _to_windows_signed(s_bytes)
    k_win = _to_windows_signed(k_bytes)
    r_pt, r_ok = curve.pt_decompress(r_y, r_sign)
    acc = _straus_core(a_table.to(torch.float32), s_win, k_win)
    return _finish_verify(acc, r_pt, (a_ok != 0) & r_ok)


def verify_kernel_resident(
    store: torch.Tensor,
    idx: torch.Tensor,
    a_ok: torch.Tensor,
    r_bytes: torch.Tensor,
    s_bytes: torch.Tensor,
    k_bytes: torch.Tensor,
) -> torch.Tensor:
    """Plain version of the K3 kernel: gather lane i's table from column
    ``idx[i]`` of the (8, 4, 32, K) uint8 resident store, then
    :func:`verify_kernel_tables`."""
    tab = store.index_select(3, idx.to(device=store.device, dtype=torch.int64))
    return verify_kernel_tables(tab, a_ok, r_bytes, s_bytes, k_bytes)


# --- host-side preparation --------------------------------------------------


def _bucket(n: int) -> int:
    """Padded size for n lanes: the next bucket, or the next CHUNK
    multiple above CHUNK."""
    for b in _BUCKETS:
        if n <= b:
            return b
    return ((n + CHUNK - 1) // CHUNK) * CHUNK


# A known-good padding triple, so padded lanes verify true and never
# mask real failures (they are sliced off anyway).
_PAD_SEED = b"\x42" * 32
_PAD_MSG = b"tendermint-tpu-pad"
_PAD_ROWS: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]] = None
_PAD_TABLE: Optional[np.ndarray] = None


def _pad_rows() -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(1, 32) uint8 rows pk, R, s, k of the padding triple."""
    global _PAD_ROWS
    if _PAD_ROWS is None:
        priv, pub = ref.keypair_from_seed(_PAD_SEED)
        sig = ref.sign(priv, _PAD_MSG)
        k = sha512_batch_mod_l([sig[:32] + pub + _PAD_MSG])[0]
        _PAD_ROWS = tuple(
            np.frombuffer(b, dtype=np.uint8).reshape(1, 32).copy()
            for b in (pub, sig[:32], sig[32:], k)
        )
    return _PAD_ROWS


def _pad_table() -> np.ndarray:
    """(8, 4, 32) uint8 signed-window table of the pad pubkey."""
    global _PAD_TABLE
    if _PAD_TABLE is None:
        _PAD_TABLE = precompute.build_table(_pad_rows()[0].tobytes())[0]
    return _PAD_TABLE


def canonical_lt(arr_le: np.ndarray, bound_be: np.ndarray) -> np.ndarray:
    """(N, 32) little-endian values -> (N,) bool value < bound (equality
    is non-canonical -> False)."""
    be = arr_le[:, ::-1].astype(np.int16)
    diff = be - bound_be.astype(np.int16)[None, :]
    nz = diff != 0
    first = np.argmax(nz, axis=1)
    val = diff[np.arange(arr_le.shape[0]), first]
    return np.where(nz.any(axis=1), val < 0, False)


def _s_canonical(s_arr: np.ndarray) -> np.ndarray:
    """(N, 32) little-endian s -> (N,) bool s < L."""
    return canonical_lt(s_arr, _L_BYTES_BE)


def _challenge_k(
    prefix: np.ndarray, msgs: Sequence[bytes], device=None, pad_to: Optional[int] = None
):
    """Challenge scalars k = SHA-512(R‖A‖M) mod L of one chunk.

    Prefers the device hash (ops/hash512.py) for the chunk's ``device``:
    it returns a ``(pad_to, 32)`` uint8 tensor that stays on the device,
    pad rows included. Otherwise (no device, off, or an ineligible chunk)
    it hashes on the host and returns an (N, 32) uint8 array.
    """
    if device is not None:
        k_dev = hash512.try_challenge_device(prefix, msgs, device, pad_to, _pad_rows()[3])
        if k_dev is not None:
            return k_dev
    return reduce_mod_l(sha512_batch_prefixed(prefix, list(msgs)))


def _pad_k(k, n: int, m: int):
    """k of n lanes padded to m rows: a device tensor comes padded
    already; a host array gets the pad row."""
    if isinstance(k, torch.Tensor) or m <= n:
        return k
    return np.concatenate([k, np.tile(_pad_rows()[3], (m - n, 1))])


def prepare_batch(
    pubkeys: Sequence[bytes],
    msgs: Sequence[bytes],
    sigs: Sequence[bytes],
    pad_to: Optional[int] = None,
    device=None,
) -> Tuple[dict, np.ndarray]:
    """Host prep: hash challenges, stack raw bytes, pad to the bucket.

    Returns (kernel inputs dict of (M, 32) uint8 arrays, host_ok (N,)
    bool of structural checks: lengths and s < L). With a ``device``
    whose hash path takes the chunk, k is a device tensor."""
    n = len(pubkeys)
    m = pad_to if pad_to is not None else _bucket(n)
    if all(len(pk) == 32 and len(sg) == 64 for pk, sg in zip(pubkeys, sigs)):
        pk_arr = np.frombuffer(b"".join(pubkeys), dtype=np.uint8).reshape(n, 32)
        sig_arr = np.frombuffer(b"".join(sigs), dtype=np.uint8).reshape(n, 64)
        r_arr, s_arr = sig_arr[:, :32], sig_arr[:, 32:]
        host_ok = _s_canonical(s_arr)
        k_arr = _challenge_k(np.concatenate([r_arr, pk_arr], axis=1), msgs, device, m)
    else:
        host_ok = np.ones(n, dtype=bool)
        pk_arr = np.zeros((n, 32), dtype=np.uint8)
        r_arr = np.zeros((n, 32), dtype=np.uint8)
        s_arr = np.zeros((n, 32), dtype=np.uint8)
        hash_inputs: List[bytes] = []
        hash_rows: List[int] = []
        for i, (pk, msg, sig) in enumerate(zip(pubkeys, msgs, sigs)):
            if len(pk) != 32 or len(sig) != 64:
                host_ok[i] = False
                continue
            pk_arr[i] = np.frombuffer(pk, dtype=np.uint8)
            r_arr[i] = np.frombuffer(sig[:32], dtype=np.uint8)
            s_arr[i] = np.frombuffer(sig[32:], dtype=np.uint8)
            hash_inputs.append(sig[:32] + pk + msg)
            hash_rows.append(i)
        host_ok &= _s_canonical(s_arr)
        k_arr = np.zeros((n, 32), dtype=np.uint8)
        if hash_inputs:
            k_list = sha512_batch_mod_l(hash_inputs)
            k_arr[np.asarray(hash_rows)] = np.frombuffer(
                b"".join(k_list), dtype=np.uint8
            ).reshape(-1, 32)

    k_arr = _pad_k(k_arr, n, m)
    if m > n:
        pk_row, r_row, s_row, _ = _pad_rows()
        reps = (m - n, 1)
        pk_arr = np.concatenate([pk_arr, np.tile(pk_row, reps)])
        r_arr = np.concatenate([r_arr, np.tile(r_row, reps)])
        s_arr = np.concatenate([s_arr, np.tile(s_row, reps)])
    # Own, writable, C-ordered copies: torch.from_numpy shares them.
    inputs = dict(pk=np.array(pk_arr), r=np.array(r_arr), s=np.array(s_arr), k=_own(k_arr))
    return inputs, host_ok


def _own(k):
    return k if isinstance(k, torch.Tensor) else np.array(k)


def _prep_rsk(
    pks: Sequence[bytes], msgs: Sequence[bytes], sigs: Sequence[bytes], pad_to: int, device
) -> Tuple[dict, np.ndarray]:
    """The R, s and k rows of a chunk of well-formed lanes, padded to
    ``pad_to``, and its host_ok (s < L)."""
    n = len(pks)
    pk_arr = np.frombuffer(b"".join(pks), dtype=np.uint8).reshape(n, 32)
    sig_arr = np.frombuffer(b"".join(sigs), dtype=np.uint8).reshape(n, 64)
    r_arr, s_arr = sig_arr[:, :32], sig_arr[:, 32:]
    host_ok = _s_canonical(s_arr)
    k_arr = _pad_k(
        _challenge_k(np.concatenate([r_arr, pk_arr], axis=1), msgs, device, pad_to), n, pad_to
    )
    if pad_to > n:
        _, r_row, s_row, _ = _pad_rows()
        reps = (pad_to - n, 1)
        r_arr = np.concatenate([r_arr, np.tile(r_row, reps)])
        s_arr = np.concatenate([s_arr, np.tile(s_row, reps)])
    return dict(r=np.array(r_arr), s=np.array(s_arr), k=_own(k_arr)), host_ok


def _prep_table_chunk(
    pks: Sequence[bytes],
    msgs: Sequence[bytes],
    sigs: Sequence[bytes],
    tabs: Sequence[np.ndarray],
    oks: Sequence[bool],
    pad_to: int,
    device=None,
) -> Tuple[dict, np.ndarray]:
    """Host prep for a cache-hit chunk: hash challenges and stack the
    per-key table columns into the kernel's (8, 4, 32, M) uint8 input.
    Lengths are pre-validated by the caller (ill-formed lanes take the
    legacy path). The stacked table's bytes are counted as gathered
    table traffic (``resident.stats()["gathered_h2d_bytes"]``)."""
    n = len(pks)
    inputs, host_ok = _prep_rsk(pks, msgs, sigs, pad_to, device)
    tab = np.stack(tabs)  # (n, 8, 4, 32) uint8
    a_ok = np.fromiter(oks, dtype=bool, count=n).astype(np.uint8)
    if pad_to > n:
        tab = np.concatenate(
            [tab, np.broadcast_to(_pad_table()[None], (pad_to - n, TABLE_WIDTH, 4, 32))]
        )
        a_ok = np.concatenate([a_ok, np.ones(pad_to - n, dtype=np.uint8)])
    tab = np.ascontiguousarray(tab.transpose(1, 2, 3, 0))  # (8, 4, 32, M)
    resident.note_table_h2d(tab.nbytes)
    return dict(tab=tab, ok=a_ok, **inputs), host_ok


def _prep_resident_chunk(
    pks: Sequence[bytes],
    msgs: Sequence[bytes],
    sigs: Sequence[bytes],
    idxs: np.ndarray,
    oks: np.ndarray,
    store: torch.Tensor,
    pad_to: int,
    device=None,
) -> Tuple[dict, np.ndarray]:
    """Host prep for a resident-store chunk: the tables already live on
    the device, so the chunk ships its (M,) int32 store columns beside the
    R, s and k rows. Pad lanes index column 0, the pad key's table, with
    a_ok = 1."""
    n = len(pks)
    inputs, host_ok = _prep_rsk(pks, msgs, sigs, pad_to, device)
    idx = np.zeros(pad_to, dtype=np.int32)
    idx[:n] = idxs
    a_ok = np.ones(pad_to, dtype=np.uint8)
    a_ok[:n] = oks
    return dict(store=store, idx=idx, ok=a_ok, **inputs), host_ok


def _run_chunk(inputs: dict, device: torch.device) -> torch.Tensor:
    """Launch one padded legacy chunk (K1); returns the (M,) bool verdicts
    on ``device`` without waiting for them."""
    from tendermint_tpu_torch.ops import cuda_verify

    fault_injection.fire("ed25519.chunk")
    args = [F.upload(inputs[key], device) for key in ("pk", "r", "s", "k")]
    return cuda_verify.verify(*args)


def _run_chunk_tables(inputs: dict, device: torch.device) -> torch.Tensor:
    """Launch one padded cache-hit chunk (K2)."""
    from tendermint_tpu_torch.ops import cuda_verify

    fault_injection.fire("ed25519.chunk")
    args = [F.upload(inputs[key], device) for key in ("tab", "ok", "r", "s", "k")]
    return cuda_verify.verify_tables(*args)


def _run_chunk_resident(inputs: dict, device: torch.device) -> torch.Tensor:
    """Launch one padded resident chunk (K3): only the column indices
    and the R, s, k rows ship; the store is on the device already."""
    from tendermint_tpu_torch.ops import cuda_verify

    fault_injection.fire("ed25519.chunk")
    args = [F.upload(inputs[key], device) for key in ("ok", "r", "s", "k")]
    return cuda_verify.verify_resident(inputs["store"], torch.from_numpy(inputs["idx"]), *args)


def _chunk_rows(rows: np.ndarray, span: int = CHUNK) -> List[np.ndarray]:
    return [rows[lo : lo + span] for lo in range(0, len(rows), span)]


def verify_batch(
    pubkeys: Sequence[bytes],
    msgs: Sequence[bytes],
    sigs: Sequence[bytes],
    device=None,
) -> List[bool]:
    """Batch ZIP-215 verification; returns per-entry validity.

    The entry point behind crypto.batch.Ed25519BatchVerifier (reference
    contract crypto/crypto.go:58-76). The result cache answers lanes
    verified before; the rest go to :func:`_verify_uncached` on
    ``device`` (default: the package's, which is CUDA).
    """
    dev = resolve_device(device)
    n = len(pubkeys)
    if n == 0:
        return []
    with tracing.span("verify_batch", engine="ed25519", lanes=n):
        verdicts = np.zeros(n, dtype=bool)
        pending = []
        with tracing.span("cache_lookup", stage="cache_lookup", engine="ed25519", lanes=n) as csp:
            for i in range(n):
                v = precompute.results.get(pubkeys[i], msgs[i], sigs[i])
                if v is None:
                    pending.append(i)
                else:
                    verdicts[i] = v
            csp.set(hits=n - len(pending))
        if pending:
            out = _verify_uncached(
                [pubkeys[i] for i in pending],
                [msgs[i] for i in pending],
                [sigs[i] for i in pending],
                dev,
            )
            verdicts[pending] = out
            for j, i in enumerate(pending):
                precompute.results.put(pubkeys[i], msgs[i], sigs[i], bool(out[j]))
        return [bool(v) for v in verdicts]


def _host_verify_rows(pubkeys, msgs, sigs, rows) -> np.ndarray:
    """The host oracle's verdicts on lanes ``rows``."""
    return np.fromiter(
        (ref.verify_zip215(pubkeys[i], msgs[i], sigs[i]) for i in rows), dtype=bool, count=len(rows)
    )


def _verify_uncached(
    pubkeys: Sequence[bytes],
    msgs: Sequence[bytes],
    sigs: Sequence[bytes],
    device: torch.device,
) -> np.ndarray:
    """Device verification of lanes the result cache could not answer,
    under the shared health machine (module note)."""
    health = device_policy.shared
    n = len(pubkeys)
    attempt = health.begin_attempt("ed25519")
    if attempt is None:
        # Cooling down or disabled: an instant answer on the host, where
        # the caller allows one.
        health.refuse("ed25519", n)
        with tracing.span("host_fallback", stage="fallback", engine="ed25519", lanes=n):
            return _host_verify_rows(pubkeys, msgs, sigs, range(n))
    try:
        # Lanes whose key has a cached (or eligible, host-built) table
        # take a table kernel; ill-formed lanes stay on the legacy path,
        # whose prep handles bad lengths.
        entries, has_table = precompute.tables.gather(pubkeys)
        if entries is not None:
            has_table &= np.fromiter(
                (len(pk) == 32 and len(sg) == 64 for pk, sg in zip(pubkeys, sigs)),
                dtype=bool,
                count=n,
            )
        # Of those, lanes whose key lives in the device-resident store
        # ship only their store column.
        res_mask = np.zeros(n, dtype=bool)
        res = resident.acquire(pubkeys, has_table, device)
    except BaseException:
        health.release_probe(attempt)
        raise
    if res is not None:
        res_mask, res_idx, res_ok, res_store = res
    jobs = [("resident", rows) for rows in _chunk_rows(np.nonzero(res_mask)[0])]
    jobs += [("tables", rows) for rows in _chunk_rows(np.nonzero(has_table & ~res_mask)[0])]
    jobs += [("legacy", rows) for rows in _chunk_rows(np.nonzero(~has_table)[0])]

    def prep(job) -> Tuple[dict, np.ndarray]:
        kind, rows = job
        with tracing.span("prep_chunk", stage="prep", engine="ed25519", kind=kind, lanes=len(rows)):
            return prep_rows(kind, rows)

    def prep_rows(kind, rows) -> Tuple[dict, np.ndarray]:
        pks = [pubkeys[i] for i in rows]
        ms = [msgs[i] for i in rows]
        sgs = [sigs[i] for i in rows]
        pad_to = _bucket(len(rows))
        if kind == "resident":
            idxs = res_idx[rows]
            return _prep_resident_chunk(
                pks, ms, sgs, idxs, res_ok[idxs], res_store, pad_to, device
            )
        if kind == "tables":
            return _prep_table_chunk(
                pks, ms, sgs,
                [entries[i][0] for i in rows],
                [entries[i][1] for i in rows],
                pad_to,
                device,
            )
        return prepare_batch(pks, ms, sgs, pad_to, device)

    inflight = 0  # lanes launched and not yet read back

    def in_flight(lanes: int) -> None:
        nonlocal inflight
        inflight += lanes
        health.note_inflight("ed25519", lanes)

    def failed(what: str, lanes: int, exc: Exception) -> None:
        nonlocal attempt
        health.record_failure(exc, attempt)
        attempt = None
        if not health.host_fallback:
            in_flight(-inflight)  # the error leaves the launched chunks unread
            raise exc
        warnings.warn(
            f"ed25519 chunk of {lanes} lanes: {what} failed ({exc!r}); host fallback "
            f"for the chunk (device state={health.state})"
        )

    def prep_or_none(job) -> Optional[Tuple[dict, np.ndarray]]:
        try:
            return prep(job)
        except _build.KernelBuildError:
            health.release_probe(attempt)
            raise
        except Exception as exc:
            failed("prepare", len(job[1]), exc)
            return None

    runners = {"resident": _run_chunk_resident, "tables": _run_chunk_tables, "legacy": _run_chunk}
    results = np.ones(n, dtype=bool)
    host_ok_all = np.ones(n, dtype=bool)
    outs: List[Optional[torch.Tensor]] = [None] * len(jobs)
    # Double-buffered dispatch: enqueue job j's kernel, then run job
    # j+1's host prep while the device works on job j. A failed chunk is
    # left without an output and answered on the host at collect.
    prepped = prep_or_none(jobs[0]) if jobs else None
    for j, (kind, rows) in enumerate(jobs):
        if prepped is not None:
            inputs, host_ok = prepped
            host_ok_all[rows] = host_ok[: len(rows)]
            if attempt is None:
                attempt = health.begin_attempt("ed25519")
            if attempt is not None:
                try:
                    with tracing.span("dispatch_chunk", stage="dispatch", engine="ed25519",
                                      kind=kind, lanes=len(rows)):
                        outs[j] = runners[kind](inputs, device)
                    in_flight(len(rows))
                except _build.KernelBuildError:
                    health.release_probe(attempt)
                    raise
                except Exception as exc:
                    failed("launch", len(rows), exc)
        prepped = prep_or_none(jobs[j + 1]) if j + 1 < len(jobs) else None
    fallback_lanes = 0
    device_chunks_ok = 0
    for (kind, rows), out in zip(jobs, outs):
        ok = None
        if out is not None:
            try:
                with tracing.span("collect_chunk", stage="collect", engine="ed25519", kind=kind,
                                  lanes=len(rows)):
                    fault_injection.fire("ed25519.collect")
                    ok = out[: len(rows)].cpu().numpy()
                device_chunks_ok += 1
            except Exception as exc:
                in_flight(-len(rows))
                failed("collect", len(rows), exc)
            else:
                in_flight(-len(rows))
        if ok is None:
            fallback_lanes += len(rows)
            with tracing.span("host_fallback", stage="fallback", engine="ed25519", lanes=len(rows)):
                results[rows] = _host_verify_rows(pubkeys, msgs, sigs, rows)
            host_ok_all[rows] = True  # the oracle's verdicts are final
        else:
            results[rows] = ok
    if fallback_lanes:
        health.count_fallback("ed25519", fallback_lanes)
    if attempt is not None and device_chunks_ok:
        # No failure took the attempt and device work came back: clear
        # DEGRADED, or complete a half-open probe.
        health.record_success(attempt)
    return np.logical_and(results, host_ok_all)
