"""The port's sr25519 engine against the JAX package's, on the CPU.

The plain ``ristretto_decompress`` must equal the JAX one limb for limb
(float32 integers, tolerance 0); ``verify_kernel_sr``,
``verify_batch_sr``, a mixed 24-validator ``verify_commit`` and
``MultiBatchVerifier`` must give the JAX package's verdict on every lane
(tolerance 0), on seeded lanes with the planted faults of
``chip_smoke.py``'s phase 2. One JAX compile serves the module: every
JAX call runs the 64-lane sr25519 graph.
"""

import hashlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# The plain versions run thousands of tiny tensor ops: one intra-op thread
# is fastest, and keeps parallel test workers from oversubscribing cores.
torch.set_num_threads(1)

import jax.numpy as jnp

import tendermint_tpu_torch
from chip_smoke import SR_FAULT_KINDS, plant_sr_faults, sr_edge_encodings
from tendermint_tpu import types as jtypes
from tendermint_tpu.crypto import batch as jbatch, keys as jkeys, sr25519 as jsr
from tendermint_tpu.ops import ed25519_batch as jeb, precompute as jpc, sr25519_batch as jsb
from tendermint_tpu.types import validation as jval
from tendermint_tpu_torch.crypto import batch as tbatch, ristretto, sr25519 as tsr
from tendermint_tpu_torch.crypto.keys import Ed25519PrivKey, Ed25519PubKey
from tendermint_tpu_torch.encoding.canonical import Timestamp
from tendermint_tpu_torch.ops import cuda_verify, device_policy, precompute as tpc
from tendermint_tpu_torch.ops import sr25519_batch as tsb
from tendermint_tpu_torch.types import block as tblock, validation as tval
from tendermint_tpu_torch.types.validator import Validator
from tendermint_tpu_torch.types.validator_set import ValidatorSet
from tests import helpers

LANES = 64  # one padded bucket: the JAX graph compiles once
SIGNERS = 6


@pytest.fixture(autouse=True)
def _cpu_and_clean(monkeypatch):
    monkeypatch.setattr(tendermint_tpu_torch, "DEFAULT_DEVICE", "cpu")
    device_policy.shared.reset()
    tpc.reset()
    jpc.reset()
    yield
    device_policy.shared.reset()
    tpc.reset()
    jpc.reset()


def fault_lanes(n=24, seed=5):
    """n sr25519 lanes from SIGNERS keys, signed with entropy from a numpy
    seed; every odd lane carries one of SR_FAULT_KINDS. Returns pks,
    msgs, sigs and {lane: kind}."""
    rng = np.random.default_rng(seed)
    privs = [tsr.Sr25519PrivKey(rng.bytes(32)) for _ in range(SIGNERS)]
    pks = [privs[i % SIGNERS].pub_key().bytes() for i in range(n)]
    msgs = [rng.bytes(int(rng.integers(60, 120))) for _ in range(n)]
    sigs = [privs[i % SIGNERS].sign(msgs[i], entropy=rng.bytes(32)) for i in range(n)]
    return pks, msgs, sigs, plant_sr_faults(pks, msgs, sigs, range(1, n, 2))


@pytest.fixture(scope="module")
def lanes():
    return fault_lanes()


def _jax_kernel():
    """The JAX engine's own compiled 64-lane graph (the one its
    verify_batch_sr dispatches to on the CPU)."""
    mul_impl = jeb._mul_impl_for_chunk(jeb.active_impl(None), None, LANES)
    return jsb._compiled_kernel_sr(LANES, None, mul_impl)


def test_plain_ristretto_decompress_equals_jax_limb_for_limb():
    """Generator multiples, the identity, the encodings DECODE rejects at
    each step, and seeded bytes (odd, >= p, bit 255 set): 64 lanes."""
    encs = [ristretto.compress(ristretto.pt_mul(k, ristretto.B_POINT)) for k in range(9)]
    encs += list(sr_edge_encodings().values())
    rng = np.random.default_rng(7)
    encs += [rng.bytes(32) for _ in range(LANES - len(encs))]
    raw = np.stack([np.frombuffer(e, dtype=np.uint8) for e in encs])
    got_pt, got_ok = tsb.ristretto_decompress(torch.from_numpy(raw).to(torch.float32).T.contiguous())
    want_pt, want_ok = jsb.ristretto_decompress(jnp.asarray(raw).astype(jnp.float32).T)
    for g, w in zip(got_pt, want_pt):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(got_ok.numpy(), np.asarray(want_ok))
    host = [ristretto.decompress(e) is not None for e in encs]
    # The host also rejects odd encodings and those >= p, which the
    # device leaves to the host checks.
    even_canonical = [int.from_bytes(e, "little") < ristretto.P and not e[0] & 1 for e in encs]
    assert [bool(o) for o, ec in zip(got_ok.numpy(), even_canonical) if ec] == [
        h for h, ec in zip(host, even_canonical) if ec]
    assert got_ok.numpy()[:9].all() and not got_ok.numpy()[9:12].any()


def test_verify_kernel_sr_equals_jax_and_the_host_oracle(lanes):
    pks, msgs, sigs, kinds = lanes
    inputs, host_ok = tsb.prepare_batch_sr(pks, msgs, sigs, pad_to=LANES)
    args = [torch.from_numpy(inputs[k]) for k in ("pk", "r", "s", "k")]
    got = cuda_verify.verify_sr(*args).numpy()  # CPU tensors: the plain version
    np.testing.assert_array_equal(got, tsb.verify_kernel_sr(*args).numpy())
    want = np.asarray(_jax_kernel()(*(jnp.asarray(inputs[k]) for k in ("pk", "r", "s", "k"))))
    np.testing.assert_array_equal(got, want)
    oracle = [tsr.verify(p, m, s) for p, m, s in zip(pks, msgs, sigs)]
    np.testing.assert_array_equal(got[: len(pks)] & host_ok, oracle)
    assert got[len(pks):].all()  # pad lanes verify
    assert not any(oracle[i] for i, kind in kinds.items() if kind != "identity_a")
    assert set(kinds.values()) == set(SR_FAULT_KINDS)


def test_verify_batch_sr_equals_jax(lanes):
    pks, msgs, sigs, kinds = lanes
    got = tsb.verify_batch_sr(pks, msgs, sigs, device="cpu")
    assert got == list(map(bool, jsb.verify_batch_sr(pks, msgs, sigs)))
    assert [i for i, ok in enumerate(got) if not ok] == sorted(
        i for i, kind in kinds.items() if kind != "identity_a")
    assert tsb.verify_batch_sr([], [], [], device="cpu") == []
    snap = device_policy.shared.snapshot()
    assert snap["fallback_lanes"] == {"ed25519": 0, "sr25519": 0} and snap["transitions"] == []


# --- the mixed commit ------------------------------------------------------------

N_ED, N_SR = 8, 16  # 24 validators; the sr25519 half takes the device tier
HEIGHT = 7
TIME_NS = 1_700_000_000_000_000_000


def _mixed_sets():
    """The same 24 validators in both packages' types, and the port's
    private keys in canonical order."""
    privs = [Ed25519PrivKey.from_seed(i.to_bytes(32, "big")) for i in range(N_ED)]
    privs += [tsr.Sr25519PrivKey.from_secret(b"mixed-%d" % i) for i in range(N_SR)]
    vset = ValidatorSet([Validator(p.pub_key(), 10) for p in privs])
    by_addr = {p.pub_key().address(): p for p in privs}
    jvals = []
    for p in privs:
        raw = p.pub_key().bytes()
        jpub = (jsr.Sr25519PubKey(raw) if p.type == "sr25519" else jkeys.Ed25519PubKey(raw))
        jvals.append(jtypes.Validator(jpub, 10))
    return [by_addr[v.address] for v in vset.validators], vset, jtypes.ValidatorSet(jvals)


def _commits(privs, vset, jvset, bad=None):
    """One commit signed by every validator (sr25519 with seeded
    entropy), in both packages' types with the same signature bytes."""
    block_id = tblock.BlockID(hashlib.sha256(b"mixed").digest(),
                              tblock.PartSetHeader(1, hashlib.sha256(b"mixed-parts").digest()))
    jblock_id = helpers.make_block_id(b"mixed")  # the same hashes
    commit = tblock.Commit(height=HEIGHT, round=0, block_id=block_id)
    jcommit = jtypes.Commit(height=HEIGHT, round=0, block_id=jblock_id)
    for i, (v, jv) in enumerate(zip(vset.validators, jvset.validators)):
        assert v.address == jv.address
        ts = Timestamp.from_unix_ns(TIME_NS + i)
        commit.signatures.append(tblock.CommitSig(tblock.BLOCK_ID_FLAG_COMMIT, v.address, ts, b""))
        jts = helpers.Timestamp.from_unix_ns(TIME_NS + i)
        jcommit.signatures.append(jtypes.CommitSig(jtypes.BLOCK_ID_FLAG_COMMIT, jv.address, jts, b""))
    for i, priv in enumerate(privs):
        msg = commit.vote_sign_bytes(helpers.CHAIN_ID, i)
        assert msg == jcommit.vote_sign_bytes(helpers.CHAIN_ID, i)
        sig = (priv.sign(msg, entropy=bytes([i]) * 32) if priv.type == "sr25519"
               else priv.sign(msg))
        if i == bad:
            sig = sig[:33] + bytes([sig[33] ^ 1]) + sig[34:]
        commit.signatures[i].signature = jcommit.signatures[i].signature = sig
    return block_id, commit, jblock_id, jcommit


def _outcome(fn):
    try:
        fn()
    except Exception as exc:  # the verdict is the error and its message
        return type(exc).__name__, str(exc)
    return None


@pytest.mark.parametrize("bad_type", [None, "sr25519", "ed25519"])
def test_mixed_commit_equals_jax(monkeypatch, bad_type):
    privs, vset, jvset = _mixed_sets()
    bad = None if bad_type is None else next(
        i for i, v in enumerate(vset.validators) if v.pub_key.type == bad_type)
    block_id, commit, jblock_id, jcommit = _commits(privs, vset, jvset, bad)
    calls = []
    real = tsb.verify_batch_sr
    monkeypatch.setattr(tsb, "verify_batch_sr", lambda *a, **k: calls.append(len(a[0])) or real(*a, **k))
    got = _outcome(lambda: tval.verify_commit(helpers.CHAIN_ID, vset, block_id, HEIGHT, commit))
    want = _outcome(lambda: jval.verify_commit(helpers.CHAIN_ID, jvset, jblock_id, HEIGHT, jcommit))
    assert got == want
    assert (got is None) == (bad is None)
    if bad is not None:
        assert got[0] == "InvalidCommitError" and f"(#{bad})" in got[1]
    assert calls == [N_SR]  # the sr25519 sub-batch took the engine


def test_validator_set_with_sr25519_keys_equals_jax():
    _, vset, jvset = _mixed_sets()
    assert [v.address for v in vset.validators] == [v.address for v in jvset.validators]
    assert vset.get_proposer().address == jvset.get_proposer().address
    for v in vset.validators[::5]:
        assert vset.get_by_address(v.address)[1] is v
        assert v.address == hashlib.sha256(v.pub_key.bytes()).digest()[:20]
    assert {v.pub_key.type for v in vset.validators} == {"ed25519", "sr25519"}


def test_multibatch_merges_in_submission_order_as_jax():
    ed = Ed25519PrivKey.from_seed(b"\x01" * 32)
    sr = tsr.Sr25519PrivKey.from_secret(b"\x02" * 32)
    mb, jmb = tbatch.MultiBatchVerifier(), jbatch.MultiBatchVerifier()
    for i in range(6):
        priv = ed if i % 2 == 0 else sr
        m = b"interleave %d" % i
        sig = priv.sign(m, entropy=bytes(32)) if i % 2 else priv.sign(m)
        if i == 3:  # one bad sr25519 entry
            sig = sig[:34] + bytes([sig[34] ^ 1]) + sig[35:]
        raw = priv.pub_key().bytes()
        mb.add(priv.pub_key(), m, sig)
        jmb.add(jsr.Sr25519PubKey(raw) if i % 2 else jkeys.Ed25519PubKey(raw), m, sig)
    assert mb.verify() == jmb.verify() == (False, [True, True, True, False, True, True])
    assert len(mb) == 6
    assert tbatch.MultiBatchVerifier().verify() == jbatch.MultiBatchVerifier().verify() == (False, [])


class _UnbatchedKey(Ed25519PubKey):
    """An ed25519 key that reports a type with no batch verifier."""

    @property
    def type(self) -> str:
        return "secp256k1"


def test_unsupported_key_raises_on_add_and_the_commit_goes_single(monkeypatch):
    priv = Ed25519PrivKey.from_seed(b"\x03" * 32)
    with pytest.raises(ValueError, match="does not support batching"):
        tbatch.MultiBatchVerifier().add(_UnbatchedKey(priv.pub_key().bytes()), b"m", priv.sign(b"m"))
    assert not tbatch.supports_batch_verifier(_UnbatchedKey(priv.pub_key().bytes()))
    assert tbatch.supports_batch_verifier(tsr.Sr25519PrivKey(bytes(32)).pub_key())
    # A set whose proposer batches but one member does not: add raises and
    # the whole commit is verified one signature at a time.
    privs, vset, jvset = _mixed_sets()
    block_id, commit, _, _ = _commits(privs, vset, jvset)
    last = next(v for v in reversed(vset.validators)
                if v.pub_key.type == "ed25519" and v is not vset.get_proposer())
    last.pub_key = _UnbatchedKey(last.pub_key.bytes())
    monkeypatch.setattr(tbatch.MultiBatchVerifier, "verify", lambda self: pytest.fail("batched"))
    tval.verify_commit(helpers.CHAIN_ID, vset, block_id, HEIGHT, commit)
