"""Wrappers of the three Ed25519 verification kernels and the sr25519 one.

Counterpart of ``tendermint_tpu/ops/pallas_verify.py``, of the resident
graph of ``tendermint_tpu/ops/ed25519_batch.py`` and of the sr25519 graph
of ``tendermint_tpu/ops/sr25519_batch.py``. The kernels
live in ``csrc/ed25519_verify.cu`` (its header note gives the design and
the bound) and are built by :mod:`._build`:

- :func:`verify` (K1, replaces ``pallas_verify._verify_kernel``):
  (N, 32) uint8 A, R, s, k -> (N,) bool; decompresses A and R and
  builds each lane's [1..8](-A) table.
- :func:`verify_tables` (K2, replaces
  ``pallas_verify._verify_tables_kernel``): takes the gathered
  (8, 4, 32, N) uint8 tables and the (N,) uint8 a_ok instead of A.
- :func:`verify_resident` (K3, replaces
  ``ed25519_batch.verify_kernel_resident``): K2 with lane i's table read
  from column ``idx[i]`` of the resident (8, 4, 32, K) store.
- :func:`verify_sr` (K5, replaces ``sr25519_batch.verify_kernel_sr``):
  (N, 32) uint8 A, R, s, k -> (N,) bool; K1's body with ristretto255
  DECODE for A and R and the identity-coset test for the finish.

For CUDA tensors a wrapper launches its kernel on the current stream,
or raises; for CPU tensors it runs the plain PyTorch version in
:mod:`.ed25519_batch` (:mod:`.sr25519_batch` for K5). ``LAUNCHES`` counts kernel launches only.
A kernel's first launch in the process (its library's build or load
included) is a compile event of ``ops/introspect.py`` under the
reference's engine names (:data:`COMPILE_ENGINES`), inside
``kernel_compile`` spans.
:func:`kernel_attributes` reports each kernel's registers, stack, shared
memory and occupancy on the current CUDA device.
"""

from __future__ import annotations

import contextlib
import ctypes
import threading
from typing import Dict, Set

import numpy as np
import torch

from tendermint_tpu_torch.crypto import ed25519_ref as ref
from tendermint_tpu_torch.ops import _build, ed25519_batch as plain, field as F, introspect
from tendermint_tpu_torch.ops import sr25519_batch as plain_sr

LAUNCHES: Dict[str, int] = {"verify": 0, "verify_tables": 0, "verify_resident": 0, "verify_sr": 0}
# The kernels of kernel_attributes, in the order of the C function's index.
KERNELS = ("verify", "verify_tables", "verify_resident", "verify_sr")
# The engines a kernel's first launch is a compile event of: K1 and K2
# are the ports of the reference's Pallas kernels, so ``pallas`` too.
COMPILE_ENGINES = {
    "verify": ("ed25519", "pallas"),
    "verify_tables": ("ed25519", "pallas"),
    "verify_resident": ("ed25519",),
    "verify_sr": ("sr25519",),
}
_first_lock = threading.Lock()
_launched: Set[str] = set()  # guarded-by: _first_lock; kernels launched once


def first_launch(key: str, engines, lanes: int):
    """The context of ``key``'s launch: the compile event when it is the
    first in the process (then it is marked launched), else nothing."""
    with _first_lock:
        if key in _launched:
            return contextlib.nullcontext()
        _launched.add(key)
    return introspect.first_launch(engines, key, lanes)

COMB_ROWS = 32


def _comb_niels() -> np.ndarray:
    """(32, 8, 3, 32) f32: row j holds (e + 1) 256^j B for e < 8 in Niels
    form (Y+X, Y-X, 2dT; Z = 1), the fixed-base comb the kernels compute
    [s]B with."""
    rows = []
    base = ref.B_POINT
    for j in range(COMB_ROWS):
        if j:
            for _ in range(8):
                base = ref.pt_double(base)
        rows.append(plain._build_b_niels_table(8, base))
    return np.stack(rows)


COMB_NIELS = _comb_niels()

# Field constants the kernels load into shared memory, as canonical
# radix-2^8 byte rows: [1..8]B in Niels form (rows 0..23, entry-major),
# then d, sqrt(-1), 2d (rows 24..26), then the comb (row 27 + (j * 8 + e)
# * 3 + component). The first 27 rows are the layout the kernels of
# earlier versions of csrc/ed25519_verify.cu read.
CONSTS = np.concatenate(
    [
        plain.B_NIELS.reshape(3 * 8, F.NLIMBS),
        np.array([F.int_to_limbs(c) for c in (F.D, F.SQRT_M1, F.D2)], dtype=np.float32),
        COMB_NIELS.reshape(COMB_ROWS * 8 * 3, F.NLIMBS),
    ]
).astype(np.uint8)

_P = ctypes.c_void_p
_ARGTYPES = {
    "ed25519_verify_launch": [_P, _P, _P, _P, _P, _P, ctypes.c_int, _P],
    "ed25519_verify_tables_launch": [_P, _P, _P, _P, _P, _P, _P, ctypes.c_int, _P],
    "ed25519_verify_resident_launch": [_P] * 8 + [ctypes.c_int, ctypes.c_int, _P],
    "sr25519_verify_launch": [_P, _P, _P, _P, _P, _P, ctypes.c_int, _P],
    "ed25519_kernel_attributes": [ctypes.c_int, ctypes.POINTER(ctypes.c_int)],
}
# What ed25519_kernel_attributes writes, in order.
ATTRIBUTE_KEYS = (
    "registers", "local_bytes", "shared_bytes", "threads_per_block", "lanes_per_block",
    "resident_blocks_per_sm",
)


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _launcher(name: str):
    fn = getattr(_build.load("ed25519_verify"), name)
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


def _check(name: str, t: torch.Tensor, shape, device: torch.device) -> None:
    if t.dtype != torch.uint8:
        raise TypeError(f"{name}: expected uint8, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _launch(name: str, key: str, args, n: int, device: torch.device, *ints: int) -> torch.Tensor:
    """Launch C function ``name`` on tensors ``args`` (then the constants,
    the output, n and ``ints``); count it under ``LAUNCHES[key]``."""
    out = torch.empty(n, dtype=torch.uint8, device=device)
    if n:
        with first_launch(key, COMPILE_ENGINES[key], n), torch.cuda.device(device):
            consts = F.on(CONSTS, out)
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = _launcher(name)(
                *[a.data_ptr() for a in args], consts.data_ptr(), out.data_ptr(), n, *ints, stream
            )
        if rc != 0:
            raise _build.CudaError(name, rc)
        LAUNCHES[key] += 1
    return out.view(torch.bool)


def verify(pk: torch.Tensor, r: torch.Tensor, s: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """K1: (N, 32) uint8 A, R, s, k -> (N,) bool (not ANDed with s < L)."""
    n = pk.shape[0]
    for name, t in (("pk", pk), ("r", r), ("s", s), ("k", k)):
        _check(name, t, (n, 32), pk.device)
    if pk.device.type == "cpu":
        return plain.verify_kernel(pk, r, s, k)
    if pk.device.type != "cuda":
        raise ValueError(f"verify: unsupported device {pk.device}")
    return _launch("ed25519_verify_launch", "verify", (pk, r, s, k), n, pk.device)


def verify_sr(pk: torch.Tensor, r: torch.Tensor, s: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """K5: (N, 32) uint8 A, R, s, k -> (N,) bool, the sr25519 verdicts
    (not ANDed with the engine's host checks). An encoding is read as
    its value mod p."""
    n = pk.shape[0]
    for name, t in (("pk", pk), ("r", r), ("s", s), ("k", k)):
        _check(name, t, (n, 32), pk.device)
    if pk.device.type == "cpu":
        return plain_sr.verify_kernel_sr(pk, r, s, k)
    if pk.device.type != "cuda":
        raise ValueError(f"verify_sr: unsupported device {pk.device}")
    return _launch("sr25519_verify_launch", "verify_sr", (pk, r, s, k), n, pk.device)


def verify_tables(
    tab: torch.Tensor, a_ok: torch.Tensor, r: torch.Tensor, s: torch.Tensor, k: torch.Tensor
) -> torch.Tensor:
    """K2: (8, 4, 32, N) uint8 tables, (N,) uint8 a_ok, (N, 32) uint8
    R, s, k -> (N,) bool."""
    n = r.shape[0]
    _check("tab", tab, (8, 4, 32, n), r.device)
    _check("a_ok", a_ok, (n,), r.device)
    for name, t in (("r", r), ("s", s), ("k", k)):
        _check(name, t, (n, 32), r.device)
    if r.device.type == "cpu":
        return plain.verify_kernel_tables(tab, a_ok, r, s, k)
    if r.device.type != "cuda":
        raise ValueError(f"verify_tables: unsupported device {r.device}")
    return _launch("ed25519_verify_tables_launch", "verify_tables", (tab, a_ok, r, s, k), n, r.device)


def verify_resident(
    store: torch.Tensor,
    idx: torch.Tensor,
    a_ok: torch.Tensor,
    r: torch.Tensor,
    s: torch.Tensor,
    k: torch.Tensor,
) -> torch.Tensor:
    """K3: (8, 4, 32, K) uint8 store, (N,) int32 column indices, (N,)
    uint8 a_ok, (N, 32) uint8 R, s, k -> (N,) bool.

    ``idx`` is the host-built index, a CPU tensor: the wrapper checks
    0 <= idx < K on it and uploads it with the launch.
    """
    n = r.shape[0]
    if store.dim() != 4:
        raise ValueError(f"store: expected shape (8, 4, 32, K), got {tuple(store.shape)}")
    cols = store.shape[3]
    _check("store", store, (8, 4, 32, cols), r.device)
    _check("a_ok", a_ok, (n,), r.device)
    for name, t in (("r", r), ("s", s), ("k", k)):
        _check(name, t, (n, 32), r.device)
    if idx.dtype != torch.int32:
        raise TypeError(f"idx: expected int32, got {idx.dtype}")
    if tuple(idx.shape) != (n,) or not idx.is_contiguous():
        raise ValueError(f"idx: expected contiguous shape ({n},), got {tuple(idx.shape)}")
    if idx.device.type != "cpu":
        raise ValueError(f"idx: the host-built index must be a CPU tensor, got {idx.device}")
    if n and (int(idx.min()) < 0 or int(idx.max()) >= cols):
        raise ValueError(f"idx: values must lie in [0, {cols})")
    if r.device.type == "cpu":
        return plain.verify_kernel_resident(store, idx, a_ok, r, s, k)
    if r.device.type != "cuda":
        raise ValueError(f"verify_resident: unsupported device {r.device}")
    idx_dev = F.upload(idx, r.device)
    return _launch(
        "ed25519_verify_resident_launch", "verify_resident", (store, idx_dev, a_ok, r, s, k),
        n, r.device, cols,
    )


def kernel_attributes(kernels=KERNELS) -> Dict[str, Dict[str, int]]:
    """{kernel: {key: value}} for K1 ("verify"), K2 ("verify_tables"),
    K3 ("verify_resident") and K5 ("verify_sr"), or those of ``kernels``,
    on the current CUDA device: ``cudaFuncGetAttributes`` (registers a
    thread, local bytes a thread, static shared bytes a block), the launch
    shape, and ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``."""
    fn = _launcher("ed25519_kernel_attributes")
    out = {}
    for name in kernels:
        buf = (ctypes.c_int * len(ATTRIBUTE_KEYS))()
        rc = fn(KERNELS.index(name), buf)
        if rc != 0:
            raise _build.CudaError(f"ed25519_kernel_attributes({name})", rc)
        out[name] = dict(zip(ATTRIBUTE_KEYS, buf))
    return out
