"""Batched sr25519 (schnorrkel / ristretto255) verification.

Counterpart of ``tendermint_tpu/ops/sr25519_batch.py`` (the reference's
sr25519 batch verifier, crypto/sr25519/batch.go:15-47). Per lane it
checks the schnorr equation

    [s_i]B - [k_i]A_i - R_i  ==  the ristretto identity

on the same twisted-Edwards curve and limb field as ed25519: ristretto255
is a quotient of this curve, so the Straus core
(``ops/ed25519_batch.straus_sb_minus_ka``) is shared. What differs:

- A and R are decoded by RFC 9496 DECODE (:func:`ristretto_decompress`);
- a lane passes when the sum lies in the identity coset, X == 0 or
  Y == 0, instead of ed25519's multiply by the cofactor;
- the Merlin challenges k stay on the host (a sequential Keccak duplex
  per lane); the device sees (A, R, s, k) as raw 32-byte rows.

:func:`verify_kernel_sr` is the plain PyTorch version of K5
(``sr25519_verify_kernel`` in ``csrc/ed25519_verify.cu``, wrapper
``ops/cuda_verify.verify_sr``), which runs each chunk on a CUDA device;
on the CPU the wrapper runs this plain version.

:func:`verify_batch_sr` is the entry point: host checks, then chunks of
``CHUNK`` lanes padded to ``_bucket(n)``, with the Merlin challenges of
chunk j+1 computed while chunk j runs. Device failures are classified
and counted by the health machine both engines share
(``ops/device_policy.py``) and propagate; only with
``device_policy.shared.host_fallback`` set is a failed chunk answered
by the host oracle. A kernel that does not build always raises. The
stages run in the reference's spans (``prep_chunk``, ``dispatch_chunk``,
``collect_chunk``, ``host_fallback``; ``engine="sr25519"``).
"""

from __future__ import annotations

import warnings
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from tendermint_tpu_torch import resolve_device
from tendermint_tpu_torch.crypto import sr25519 as sr
from tendermint_tpu_torch.libs import tracing
from tendermint_tpu_torch.ops import _build, curve, device_policy, fault_injection, field as F
from tendermint_tpu_torch.ops.ed25519_batch import (
    CHUNK,
    _bucket,
    _bytes_to_fe,
    _to_windows_signed,
    canonical_lt,
    straus_sb_minus_ka,
)

# Canonicity bounds: ristretto encodings must be < p, scalars < L.
_P_BYTES_BE = np.frombuffer(F.P.to_bytes(32, "big"), dtype=np.uint8)
_L_BYTES_BE = np.frombuffer(sr.L.to_bytes(32, "big"), dtype=np.uint8)

_NEG_ONE_FE = F.const_np(F.P - 1)
_NEG_SQRT_M1_FE = F.const_np(F.P - F.SQRT_M1)


def ristretto_decompress(s_fe: torch.Tensor) -> Tuple[curve.Point, torch.Tensor]:
    """RFC 9496 4.3.1 DECODE, batched: (32, N) f32 limbs -> (point,
    valid). The host has checked the encodings canonical and
    non-negative. Invalid lanes hold the identity, as in
    ``curve.pt_decompress``."""
    n = s_fe.shape[1]
    one = F.fe_one(n, s_fe.device)
    ss = F.fe_sq(s_fe)
    u1 = F.fe_sub(one, ss)
    u2 = F.fe_add(one, ss)
    u2s = F.fe_sq(u2)
    # v = -(D * u1^2) - u2^2
    v = F.fe_sub(F.fe_neg(F.fe_mul_const(F.fe_sq(u1), F.D_FE)), u2s)
    # SQRT_RATIO_M1(1, v * u2s): with u = 1 the candidate root is
    # w^3 * (w^7)^((p-5)/8) for w = v * u2s.
    w = F.fe_mul(v, u2s)
    w3 = F.fe_mul(F.fe_sq(w), w)
    w7 = F.fe_mul(F.fe_sq(w3), w)
    r = F.fe_mul(w3, F.fe_pow22523(w7))
    check = F.fe_mul(w, F.fe_sq(r))
    correct = F.fe_eq(check, one)
    flipped = F.fe_eq(check, F.on(_NEG_ONE_FE, one).expand_as(one))
    flipped_i = F.fe_eq(check, F.on(_NEG_SQRT_M1_FE, one).expand_as(one))
    r = F.fe_select(flipped | flipped_i, F.fe_mul_const(r, F.SQRT_M1_FE), r)
    was_square = correct | flipped
    # |r|: the non-negative square root
    r = F.fe_select(F.fe_parity(r) == 1.0, F.fe_neg(r), r)

    den_x = F.fe_mul(r, u2)
    den_y = F.fe_mul(F.fe_mul(r, den_x), v)
    x = F.fe_mul(F.fe_add(s_fe, s_fe), den_x)
    x = F.fe_select(F.fe_parity(x) == 1.0, F.fe_neg(x), x)
    y = F.fe_mul(u1, den_y)
    t = F.fe_mul(x, y)

    valid = was_square & (F.fe_parity(t) != 1.0) & ~F.fe_is_zero(y)
    pt: curve.Point = (x, y, one, t)
    return curve.pt_select(valid, pt, curve.pt_identity(n, s_fe.device)), valid


def verify_kernel_sr(
    pk_bytes: torch.Tensor,
    r_bytes: torch.Tensor,
    s_bytes: torch.Tensor,
    k_bytes: torch.Tensor,
) -> torch.Tensor:
    """Plain version of K5: (N, 32) uint8 x 4 -> (N,) bool, schnorrkel
    verify per lane (not ANDed with the host checks)."""
    a_fe = _bytes_to_fe(pk_bytes)
    r_fe = _bytes_to_fe(r_bytes)
    n = a_fe.shape[1]
    # A and R decode as one 2N batch.
    both_pt, both_ok = ristretto_decompress(torch.cat([a_fe, r_fe], dim=1))
    a_pt = tuple(c[:, :n] for c in both_pt)
    r_pt = tuple(c[:, n:] for c in both_pt)
    # s (masked to 255 bits and checked < L on the host) and k (< L) are
    # below 2^253, so the signed recode is exact.
    acc = straus_sb_minus_ka(a_pt, _to_windows_signed(s_bytes), _to_windows_signed(k_bytes))
    x, y, _, _ = curve.pt_add(acc, curve.pt_neg(r_pt))
    # The ristretto identity coset: X == 0 or Y == 0 (RFC 9496 equality
    # against the identity, as crypto/ristretto.equals).
    return (F.fe_is_zero(x) | F.fe_is_zero(y)) & both_ok[:n] & both_ok[n:]


# --- host side ----------------------------------------------------------------


def _host_checks(pubkeys: Sequence[bytes], sigs: Sequence[bytes]):
    """(N, 32) uint8 A, R and s (marker bit cleared) rows, host_ok and
    has_fields: the marker bit, s < L, and A and R canonical (< p) and
    non-negative (even). Lanes of a wrong length or without the marker
    keep zero rows and no challenge (has_fields False)."""
    n = len(pubkeys)
    has_fields = np.ones(n, dtype=bool)
    pk_arr = np.zeros((n, 32), dtype=np.uint8)
    r_arr = np.zeros((n, 32), dtype=np.uint8)
    s_arr = np.zeros((n, 32), dtype=np.uint8)
    for i, (pub, sig) in enumerate(zip(pubkeys, sigs)):
        if len(pub) != 32 or len(sig) != 64 or not sig[63] & 0x80:
            has_fields[i] = False
            continue
        pk_arr[i] = np.frombuffer(pub, dtype=np.uint8)
        r_arr[i] = np.frombuffer(sig[:32], dtype=np.uint8)
        s_arr[i] = np.frombuffer(sig[32:64], dtype=np.uint8)
    s_arr[:, 31] &= 0x7F
    host_ok = has_fields & canonical_lt(s_arr, _L_BYTES_BE)
    for enc in (pk_arr, r_arr):
        host_ok &= canonical_lt(enc, _P_BYTES_BE) & ((enc[:, 0] & 1) == 0)
    return pk_arr, r_arr, s_arr, host_ok, has_fields


def _challenge_row(msg: bytes, pub: bytes, r_bytes: bytes) -> np.ndarray:
    k = sr._challenge(sr._signing_transcript(msg), pub, r_bytes)
    return np.frombuffer(k.to_bytes(32, "little"), dtype=np.uint8)


def _prep_chunk(checked, pubkeys, msgs, sigs, lo: int, hi: int) -> List[np.ndarray]:
    """The (hi - lo, 32) uint8 A, R, s and k rows of lanes [lo, hi) of
    the batch: Merlin challenges on the host, lanes past its end padded
    with :func:`_pad_entry`. ``checked`` is :func:`_host_checks`'s."""
    pk_arr, r_arr, s_arr, _, has_fields = checked
    top = min(hi, len(pubkeys))
    k_c = np.zeros((hi - lo, 32), dtype=np.uint8)
    for i in range(lo, top):
        if has_fields[i]:
            k_c[i - lo] = _challenge_row(msgs[i], pubkeys[i], sigs[i][:32])
    rows = [pk_arr[lo:top], r_arr[lo:top], s_arr[lo:top]]
    if hi > top:
        pad = _pad_entry()
        rows = [np.concatenate([a, np.tile(p, (hi - top, 1))]) for a, p in zip(rows, pad)]
        k_c[top - lo:] = pad[3]
    return [np.ascontiguousarray(a) for a in rows] + [k_c]


def prepare_batch_sr(
    pubkeys: Sequence[bytes], msgs: Sequence[bytes], sigs: Sequence[bytes],
    pad_to: Optional[int] = None,
) -> Tuple[dict, np.ndarray]:
    """Host prep of one chunk: ({"pk", "r", "s", "k": (M, 32) uint8}, the
    (N,) host_ok), padded to ``pad_to`` (default ``_bucket(N)``)."""
    checked = _host_checks(pubkeys, sigs)
    m = _bucket(len(pubkeys)) if pad_to is None else pad_to
    rows = _prep_chunk(checked, pubkeys, msgs, sigs, 0, m)
    return dict(zip(("pk", "r", "s", "k"), rows)), checked[3]


def _run_chunk_sr(rows, device: torch.device) -> torch.Tensor:
    """Launch one padded chunk (K5 on CUDA); returns the (M,) bool
    verdicts on ``device`` without waiting for them."""
    from tendermint_tpu_torch.ops import cuda_verify

    fault_injection.fire("sr25519.chunk")
    return cuda_verify.verify_sr(*(F.upload(a, device) for a in rows))


def verify_batch_sr(
    pubkeys: Sequence[bytes],
    msgs: Sequence[bytes],
    sigs: Sequence[bytes],
    device=None,
) -> List[bool]:
    """Per-entry schnorrkel verification on ``device`` (default: the
    package's, which is CUDA), Merlin challenges on the host.

    Chunk j+1's challenges, the costly sequential host work of this
    path, are computed while the device works on chunk j. A chunk whose
    prep, launch or read-back fails is recorded by the health machine
    and its error raised; with ``host_fallback`` set it is answered by
    the host oracle for its lanes only, and counted, and the machine
    decides whether later chunks may still use the device.
    """
    dev = resolve_device(device)
    health = device_policy.shared
    n = len(pubkeys)
    if n == 0:
        return []
    attempt = health.begin_attempt("sr25519")
    if attempt is None:
        health.refuse("sr25519", n)
        with tracing.span("host_fallback", stage="fallback", engine="sr25519", lanes=n):
            return [sr.verify(p, m, s) for p, m, s in zip(pubkeys, msgs, sigs)]

    checked = _host_checks(pubkeys, sigs)
    host_ok = checked[3]
    m = _bucket(n)

    inflight = 0  # lanes launched and not yet read back

    def in_flight(lanes: int) -> None:
        nonlocal inflight
        inflight += lanes
        health.note_inflight("sr25519", lanes)

    def failed(what: str, lo: int, hi: int, exc: Exception) -> None:
        nonlocal attempt
        health.record_failure(exc, attempt)
        attempt = None
        if not health.host_fallback:
            in_flight(-inflight)  # the error leaves the launched chunks unread
            raise exc
        warnings.warn(
            f"sr25519 chunk [{lo}:{hi}]: {what} failed ({exc!r}); host fallback for the "
            f"chunk (device state={health.state})"
        )

    def prep_or_none(lo: int, hi: int):
        try:
            with tracing.span("prep_chunk", stage="prep", engine="sr25519", lanes=hi - lo):
                return _prep_chunk(checked, pubkeys, msgs, sigs, lo, hi)
        except Exception as exc:
            failed("prepare", lo, hi, exc)
            return None

    bounds = [(lo, min(lo + CHUNK, m)) for lo in range(0, m, CHUNK)]
    chunks = []  # (lo, hi, device verdicts or None)
    prepped = prep_or_none(*bounds[0])
    for ci, (lo, hi) in enumerate(bounds):
        out = None
        if prepped is not None:
            if attempt is None:
                attempt = health.begin_attempt("sr25519")
            if attempt is not None:
                try:
                    with tracing.span("dispatch_chunk", stage="dispatch", engine="sr25519",
                                      lanes=hi - lo):
                        out = _run_chunk_sr(prepped, dev)
                    in_flight(hi - lo)
                except _build.KernelBuildError:
                    health.release_probe(attempt)
                    raise
                except Exception as exc:
                    failed("launch", lo, hi, exc)
        chunks.append((lo, hi, out))
        prepped = prep_or_none(*bounds[ci + 1]) if ci + 1 < len(bounds) else None

    results = np.ones(m, dtype=bool)
    fallback_lanes = 0
    device_chunks_ok = 0
    for lo, hi, out in chunks:
        ok = None
        if out is not None:
            try:
                with tracing.span("collect_chunk", stage="collect", engine="sr25519",
                                  lanes=hi - lo):
                    ok = out.cpu().numpy()
                device_chunks_ok += 1
            except Exception as exc:
                in_flight(-(hi - lo))
                failed("collect", lo, hi, exc)
            else:
                in_flight(-(hi - lo))
        if ok is None:
            ok = np.ones(hi - lo, dtype=bool)
            top = min(hi, n)  # pad lanes need no host verify
            if lo < top:
                fallback_lanes += top - lo
                with tracing.span("host_fallback", stage="fallback", engine="sr25519",
                                  lanes=top - lo):
                    ok[: top - lo] = [sr.verify(pubkeys[i], msgs[i], sigs[i])
                                      for i in range(lo, top)]
        results[lo:hi] = ok
    if fallback_lanes:
        health.count_fallback("sr25519", fallback_lanes)
    if attempt is not None and device_chunks_ok:
        health.record_success(attempt)
    return [bool(v) for v in np.logical_and(results[:n], host_ok)]


_PAD: Optional[Tuple[np.ndarray, ...]] = None


def _pad_entry() -> Tuple[np.ndarray, ...]:
    """A known-good (A, R, s, k) row quadruple for pad lanes, signed with
    fixed entropy so it is the same in every process."""
    global _PAD
    if _PAD is None:
        priv = sr.Sr25519PrivKey.from_secret(b"tendermint-tpu-sr-pad")
        msg = b"sr25519-pad"
        sig = priv.sign(msg, entropy=bytes(32))
        pub = priv.pub_key().bytes()
        s_raw = bytearray(sig[32:64])
        s_raw[31] &= 0x7F
        _PAD = (
            np.frombuffer(pub, dtype=np.uint8),
            np.frombuffer(sig[:32], dtype=np.uint8),
            np.frombuffer(bytes(s_raw), dtype=np.uint8),
            _challenge_row(msg, pub, sig[:32]),
        )
    return _PAD
