"""The port's device challenge hash (ops/hash512.py, ops/cuda_hash.py)
against hashlib and the JAX package's ``ops/hash512.py``, on the CPU.

Forced on (it serves CUDA devices only), the device path runs K4's plain
PyTorch version here. Digests and challenge scalars are bytes, so every
comparison is exact (tolerance 0): at every SHA-512 padding boundary
(0/55/56/64/111/112/128 bytes), on a (9, 73) matrix, on prefixed
challenge inputs, and for the literal constants of
``csrc/sha512_challenge.cu``. ``verify_batch``'s verdicts with the device
hash on equal the oracle's and the JAX package's.
"""

import hashlib
import os
import re

import pytest

torch = pytest.importorskip("torch")
# The plain versions run thousands of tiny tensor ops: one intra-op thread
# is fastest, and keeps parallel test workers from oversubscribing cores.
torch.set_num_threads(1)

import jax
import numpy as np

from tendermint_tpu.ops import ed25519_batch as jeb, hash512 as jh
from tendermint_tpu_torch.crypto import ed25519_ref as ref
from tendermint_tpu_torch.crypto.hashing import L, reduce_mod_l, sha512_batch_prefixed
from tendermint_tpu_torch.ops import cuda_hash, ed25519_batch as teb, hash512 as th

ENABLED_BY_DEVICE = th.device_hash_enabled
BOUNDARY_LENGTHS = (0, 55, 56, 64, 111, 112, 128)
SOURCE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "tendermint_tpu_torch", "csrc", "sha512_challenge.cu",
)


@pytest.fixture(autouse=True)
def _device_hash_on(monkeypatch):
    monkeypatch.setattr(th, "device_hash_enabled", lambda device: device is not None)
    monkeypatch.setenv(jh._ENV, "on")
    monkeypatch.setattr(jh, "_BROKEN", False)
    th.reset_stats()
    yield
    th.reset_stats()


def _digests(msgs):
    return np.stack([np.frombuffer(hashlib.sha512(m).digest(), dtype=np.uint8) for m in msgs])


def _challenge_case(n, msg_len, seed):
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, 256, size=(n, 64), dtype=np.uint8)
    msgs = [rng.integers(0, 256, size=msg_len, dtype=np.uint8).tobytes() for _ in range(n)]
    return prefix, msgs


def _plain_digests(mat):
    blocks = th._pack(mat)
    np.testing.assert_array_equal(blocks, jh._pack(mat))
    got = th.sha512_blocks(torch.from_numpy(blocks)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax.jit(jh._sha512_blocks)(blocks)))
    return got


@pytest.mark.parametrize("length", BOUNDARY_LENGTHS)
def test_sha512_boundary_lengths_match_hashlib_and_jax(length):
    mat = np.random.default_rng(1000 + length).integers(0, 256, size=(5, length), dtype=np.uint8)
    got = _plain_digests(mat)
    assert got.shape == (5, 64) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, _digests([r.tobytes() for r in mat]))


def test_sha512_matrix_input_and_empty_batch():
    rng = np.random.default_rng(7)
    mat = rng.integers(0, 256, size=(9, 73), dtype=np.uint8)
    np.testing.assert_array_equal(_plain_digests(mat), _digests([r.tobytes() for r in mat]))
    prefix = rng.integers(0, 256, size=(9, 64), dtype=np.uint8)
    out = th.try_challenge_device(prefix, mat, "cpu")  # messages as one matrix
    want = reduce_mod_l(sha512_batch_prefixed(prefix, [r.tobytes() for r in mat]))
    np.testing.assert_array_equal(out.numpy(), want)
    assert th.sha512_blocks(torch.zeros((0, 128), dtype=torch.uint8)).shape == (0, 64)


@pytest.mark.parametrize("length", BOUNDARY_LENGTHS)
def test_challenge_boundary_lengths_match_host_and_jax(length):
    prefix, msgs = _challenge_case(6, length, 2000 + length)
    out = th.try_challenge_device(prefix, msgs, "cpu")
    assert isinstance(out, torch.Tensor) and out.shape == (6, 32) and out.dtype == torch.uint8
    want = reduce_mod_l(sha512_batch_prefixed(prefix, msgs))
    np.testing.assert_array_equal(out.numpy(), want)
    blocks = jh._pack(np.concatenate([prefix, th._matrix(msgs)], axis=1))
    np.testing.assert_array_equal(out.numpy(), np.asarray(jax.jit(jh._challenge_kernel)(blocks)))


def test_plain_kernel_pieces_match_jax():
    """sha512_blocks and reduce_mod_l_bytes against the JAX graphs, the
    reduction on digests at and around multiples of L and 2^512 - 1."""
    rng = np.random.default_rng(11)
    blocks = th._pack(rng.integers(0, 256, size=(8, 150), dtype=np.uint8))
    got = th.sha512_blocks(torch.from_numpy(blocks)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax.jit(jh._sha512_blocks)(blocks)))
    vals = [0, 1, L - 1, L, 2 * L, 3 * L - 1, (1 << 512) - 1, ((1 << 512) // L) * L]
    vals += [int.from_bytes(rng.integers(0, 256, 64, dtype=np.uint8).tobytes(), "little")
             for _ in range(8)]
    digests = np.stack([np.frombuffer(v.to_bytes(64, "little"), np.uint8) for v in vals])
    got = th.reduce_mod_l_bytes(torch.from_numpy(digests)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax.jit(jh._reduce_mod_l_bytes)(digests)))
    for row, v in zip(got, vals):
        assert int.from_bytes(row.tobytes(), "little") == v % L


def test_challenge_pads_rows_and_counts_device_lanes():
    prefix, msgs = _challenge_case(11, 32, 3)
    pad_row = teb._pad_rows()[3]
    out = th.try_challenge_device(prefix, msgs, "cpu", pad_to=16, pad_row=pad_row)
    assert out.shape == (16, 32)
    np.testing.assert_array_equal(out[:11].numpy(), reduce_mod_l(sha512_batch_prefixed(prefix, msgs)))
    assert (out[11:].numpy() == pad_row).all()
    assert th.stats()["device_lanes"] == 11


def test_challenge_k_prefers_the_device_and_equals_host_hashing():
    prefix, msgs = _challenge_case(8, 40, 4)
    want = reduce_mod_l(sha512_batch_prefixed(prefix, msgs))
    got = teb._challenge_k(prefix, msgs, "cpu", 8)
    assert isinstance(got, torch.Tensor)
    np.testing.assert_array_equal(got.numpy(), want)
    host = teb._challenge_k(prefix, msgs)  # no device: host hashing
    assert isinstance(host, np.ndarray)
    np.testing.assert_array_equal(host, want)
    msgs[1] += b"x"  # mixed lengths: host hashing, same function
    np.testing.assert_array_equal(
        teb._challenge_k(prefix, msgs, "cpu", 8), reduce_mod_l(sha512_batch_prefixed(prefix, msgs))
    )


@pytest.mark.parametrize("case", ["mixed_lengths", "off", "empty"])
def test_eligibility_rules_send_chunks_to_the_host(monkeypatch, case):
    prefix, msgs = _challenge_case(4, 32, 5)
    if case == "mixed_lengths":
        msgs[2] += b"x"
    elif case == "off":
        monkeypatch.setattr(th, "device_hash_enabled", ENABLED_BY_DEVICE)  # the CPU is not CUDA
    else:
        prefix, msgs = prefix[:0], []
    assert th.try_challenge_device(prefix, msgs, "cpu") is None
    counts = th.stats()
    assert counts[f"declined_{case}"] == 1 and counts["device_lanes"] == 0


@pytest.mark.parametrize("device, on", [("cuda", True), ("cuda:0", True), ("cpu", False),
                                        (None, False)])
def test_device_hash_follows_the_device_type(device, on):
    assert ENABLED_BY_DEVICE(device) is on


def test_long_messages_take_the_device_path():
    """K4 takes the block count as an argument: no length cap."""
    prefix, msgs = _challenge_case(3, 1000, 6)
    out = th.try_challenge_device(prefix, msgs, "cpu")
    np.testing.assert_array_equal(out.numpy(), reduce_mod_l(sha512_batch_prefixed(prefix, msgs)))
    assert th.stats()["device_lanes"] == 3


def test_kernel_error_propagates_and_there_is_no_sticky_fallback(monkeypatch):
    assert not hasattr(th, "_BROKEN")

    def boom(blocks, pad_row=None, m=None):
        raise RuntimeError("sha512_challenge_launch failed: CUDA error 719")

    monkeypatch.setattr(cuda_hash, "challenge", boom)
    prefix, msgs = _challenge_case(4, 32, 9)
    with pytest.raises(RuntimeError, match="CUDA error 719"):
        th.try_challenge_device(prefix, msgs, "cpu")
    priv, pub = ref.keypair_from_seed(b"\x09" * 32)
    ms = [b"hash lane %02d" % i for i in range(4)]
    with pytest.raises(RuntimeError, match="CUDA error 719"):
        teb.verify_batch([pub] * 4, ms, [ref.sign(priv, m) for m in ms], device="cpu")
    assert th.stats()["device_lanes"] == 0


def test_verify_batch_with_the_device_hash_matches_the_oracle():
    pks, msgs, sigs = [], [], []
    for i in range(8):
        sk, pk = ref.keypair_from_seed(bytes([i + 40]) * 32)
        m = b"device-hash lane %03d" % i
        pks.append(pk)
        msgs.append(m)
        sigs.append(ref.sign(sk, m))
    sigs[5] = bytes(64)
    oks = teb.verify_batch(pks, msgs, sigs, device="cpu")
    assert oks == [ref.verify_zip215(p, m, s) for p, m, s in zip(pks, msgs, sigs)]
    assert not oks[5] and sum(oks) == 7
    assert th.stats()["device_lanes"] == 8
    # The JAX package, its fused hash on too, gives the same verdicts.
    assert oks == jeb.verify_batch(pks, msgs, sigs)


def _literals(name):
    with open(SOURCE) as fh:
        body = re.search(rf"uint64_t {name}\[\d+\] = \{{(.*?)\}};", fh.read(), re.S).group(1)
    return [int(h, 16) for h in re.findall(r"0x([0-9a-f]+)ull", body)]


def _limbs(v, n):
    return [(v >> (64 * i)) & ((1 << 64) - 1) for i in range(n)]


def test_kernel_literals_equal_the_derived_constants():
    assert th.K64 == jh._K64 and th.H64 == jh._H64 and th.MU == jh._MU
    assert _literals("kRound") == th.K64
    assert _literals("kInit") == th.H64
    assert _literals("kL") == _limbs(L, 4)
    assert _literals("kMu") == _limbs(th.MU, 5)


@pytest.mark.parametrize(
    "bad, err",
    [
        (lambda b: b.to(torch.int32), TypeError),
        (lambda b: b[:, :100].contiguous(), ValueError),
        (lambda b: b.t().contiguous().t(), ValueError),
        (lambda b: b.to("meta"), ValueError),
    ],
    ids=["dtype", "shape", "contiguity", "device"],
)
def test_wrappers_reject_bad_blocks(bad, err):
    blocks = torch.from_numpy(th._pack(np.zeros((4, 40), dtype=np.uint8)))
    with pytest.raises(err):
        cuda_hash.challenge(bad(blocks))


def test_challenge_wrapper_needs_a_pad_row_for_pad_rows():
    blocks = torch.from_numpy(th._pack(np.zeros((4, 40), dtype=np.uint8)))
    with pytest.raises(ValueError, match="pad_row"):
        cuda_hash.challenge(blocks, None, 8)
    with pytest.raises(ValueError):
        cuda_hash.challenge(blocks, torch.zeros(32, dtype=torch.uint8), 3)
    before = dict(cuda_hash.LAUNCHES)
    out = cuda_hash.challenge(blocks, torch.full((32,), 7, dtype=torch.uint8), 8)
    assert out.shape == (8, 32) and (out[4:] == 7).all()
    assert cuda_hash.LAUNCHES == before  # the plain version launches nothing
