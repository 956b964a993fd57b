"""Wrappers of the SHA-512 challenge kernel (K4).

The kernel lives in ``csrc/sha512_challenge.cu`` (its header note gives
the design and the bound) and is built by :mod:`._build`. It replaces
the reference's XLA graph ``tendermint_tpu/ops/hash512.py::_challenge_kernel``.

:func:`challenge`: (n, B*128) uint8 padded blocks -> (m, 32) uint8
``SHA-512 mod L`` of each row, then m - n copies of a pad row.

For CUDA tensors the wrapper launches the kernel on the current stream,
or raises; for CPU tensors it runs the plain PyTorch version in
:mod:`.hash512`. ``LAUNCHES`` counts kernel launches only; the first
launch in the process is a compile event of the ``ed25519`` engine
(``cuda_verify.first_launch``).
:func:`challenge_attributes` reports the challenge kernel's registers,
stack, shared memory and occupancy on the current CUDA device.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from tendermint_tpu_torch.ops import _build, hash512 as plain
from tendermint_tpu_torch.ops.cuda_verify import ATTRIBUTE_KEYS, first_launch

LAUNCHES: Dict[str, int] = {"challenge": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = {
    "sha512_challenge_launch": [_P, _I, _I, _P, _P, _I, _P],
    "sha512_challenge_attributes": [ctypes.POINTER(_I)],
}


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _launcher(name: str):
    fn = getattr(_build.load("sha512_challenge"), name)
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


def _check_blocks(blocks: torch.Tensor) -> int:
    """Validate (n, B*128) uint8 blocks; returns B."""
    if blocks.dtype != torch.uint8:
        raise TypeError(f"blocks: expected uint8, got {blocks.dtype}")
    if blocks.dim() != 2 or blocks.shape[1] == 0 or blocks.shape[1] % 128:
        raise ValueError(f"blocks: expected shape (n, B*128), got {tuple(blocks.shape)}")
    if not blocks.is_contiguous():
        raise ValueError("blocks: must be contiguous")
    if blocks.device.type not in ("cpu", "cuda"):
        raise ValueError(f"blocks: unsupported device {blocks.device}")
    if blocks.device.type == "cuda" and blocks.data_ptr() % 16:
        raise ValueError("blocks: must be 16-byte aligned")
    return blocks.shape[1] // 128


def _run(name: str, key: str, args, device: torch.device) -> None:
    with first_launch(key, ("ed25519",), args[2]), torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = _launcher(name)(*args, stream)
    if rc != 0:
        raise _build.CudaError(name, rc)
    LAUNCHES[key] += 1


def challenge(
    blocks: torch.Tensor, pad_row: Optional[torch.Tensor] = None, m: Optional[int] = None
) -> torch.Tensor:
    """K4: (n, B*128) uint8 -> (m, 32) uint8 (m defaults to n; rows past
    n are ``pad_row``, a (32,) uint8 tensor on the same device)."""
    nblocks = _check_blocks(blocks)
    n = blocks.shape[0]
    m = n if m is None else m
    if m < n:
        raise ValueError(f"challenge: m = {m} < n = {n}")
    if m > n:
        if pad_row is None:
            raise ValueError("challenge: pad rows need pad_row")
        if pad_row.dtype != torch.uint8 or tuple(pad_row.shape) != (32,):
            raise ValueError("pad_row: expected (32,) uint8")
        if pad_row.device != blocks.device or not pad_row.is_contiguous():
            raise ValueError(f"pad_row: must be contiguous on {blocks.device}")
    if blocks.device.type == "cpu":
        return plain.challenge_kernel(blocks, pad_row, m)
    out = torch.empty((m, 32), dtype=torch.uint8, device=blocks.device)
    if m:
        pad_ptr = pad_row.data_ptr() if m > n else None
        _run("sha512_challenge_launch", "challenge",
             (blocks.data_ptr(), nblocks, n, pad_ptr, out.data_ptr(), m), blocks.device)
    return out


def challenge_attributes() -> Dict[str, int]:
    """The challenge kernel's registers, stack and shared bytes, launch
    shape and resident blocks per SM on the current CUDA device (keys as
    ``cuda_verify.ATTRIBUTE_KEYS``)."""
    buf = (ctypes.c_int * len(ATTRIBUTE_KEYS))()
    rc = _launcher("sha512_challenge_attributes")(buf)
    if rc != 0:
        raise _build.CudaError("sha512_challenge_attributes", rc)
    return dict(zip(ATTRIBUTE_KEYS, buf))
