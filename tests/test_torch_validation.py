"""The port's commit verification against the JAX package, on the CPU.

A 24-validator commit (at least 16 signatures up to +2/3, so both
packages take their device tier, the light variant too) is built twice from the same seeds, once from each
package's types, and ``verify_commit`` / ``verify_commit_light`` must
pass or raise the same error with the same message in both. Then
``verify_batch``: a batch that mixes lanes with activated keys and lanes
without, so both plain kernels run in one call, with the same verdicts
as the JAX package's; and the edge cases of its contract.
"""

import pytest

torch = pytest.importorskip("torch")
# The plain versions run thousands of tiny tensor ops: one intra-op thread
# is fastest, and keeps parallel test workers from oversubscribing cores.
torch.set_num_threads(1)

import tendermint_tpu_torch
from tendermint_tpu import types as jtypes
from tendermint_tpu.ops import ed25519_batch as jeb, precompute as jpc
from tendermint_tpu_torch.crypto import batch as tbatch, ed25519_ref as ref
from tendermint_tpu_torch.crypto.keys import Ed25519PrivKey
from tendermint_tpu_torch.encoding.canonical import Timestamp
from tendermint_tpu_torch.ops import ed25519_batch as teb, precompute as tpc, verify_batch
from tendermint_tpu_torch.types import block as tblock, validation as tval
from tendermint_tpu_torch.types.validator import Validator
from tendermint_tpu_torch.types.validator_set import ValidatorSet
from tests import helpers

N_VALS = 24
HEIGHT = 5
TIME_NS = 1_700_000_000_000_000_000


@pytest.fixture(autouse=True)
def _cpu_and_clean_caches(monkeypatch):
    monkeypatch.setattr(tendermint_tpu_torch, "DEFAULT_DEVICE", "cpu")
    tpc.reset()
    jpc.reset()
    yield
    tpc.reset()
    jpc.reset()


def _port_validators(n):
    """Port-side twin of tests.helpers.make_validators."""
    privs = [Ed25519PrivKey.from_seed(i.to_bytes(32, "big")) for i in range(n)]
    vset = ValidatorSet([Validator(p.pub_key(), 10) for p in privs])
    by_addr = {p.pub_key().address(): p for p in privs}
    return [by_addr[v.address] for v in vset.validators], vset


def _port_block_id(seed=b"block"):
    import hashlib

    return tblock.BlockID(
        hashlib.sha256(seed).digest(),
        tblock.PartSetHeader(1, hashlib.sha256(seed + b"-parts").digest()),
    )


def _port_commit(block_id, vset, privs, absent=(), nil_votes=()):
    """Port-side twin of tests.helpers.make_commit."""
    commit = tblock.Commit(height=HEIGHT, round=0, block_id=block_id)
    commit.signatures = [
        tblock.CommitSig.absent() if i in absent
        else tblock.CommitSig(
            tblock.BLOCK_ID_FLAG_NIL if i in nil_votes else tblock.BLOCK_ID_FLAG_COMMIT,
            v.address, Timestamp.from_unix_ns(TIME_NS + i), b"",
        )
        for i, v in enumerate(vset.validators)
    ]
    for i, cs in enumerate(commit.signatures):
        if i not in absent:
            cs.signature = privs[i].sign(commit.vote_sign_bytes(helpers.CHAIN_ID, i))
    return commit


@pytest.fixture(scope="module")
def nets():
    jprivs, jvset = helpers.make_validators(N_VALS)
    tprivs, tvset = _port_validators(N_VALS)
    assert [v.address for v in jvset.validators] == [v.address for v in tvset.validators]
    assert tvset.total_voting_power() == jvset.total_voting_power()
    assert tvset.get_proposer().address == jvset.get_proposer().address
    for v in jvset.validators[::5]:
        assert tvset.get_by_address(v.address)[0] == jvset.get_by_address(v.address)[0]
    assert tvset.get_by_address(b"\x00" * 20) == (-1, None)
    return (jprivs, jvset), (tprivs, tvset)


def _bad_sig(commit, idx):
    commit.signatures[idx].signature = b"\x01" * 64


CASES = {
    "valid": dict(),
    "bad_signature": dict(mutate=lambda c: _bad_sig(c, 5)),
    # past +2/3: the light variant stops before it, the full one does not
    "bad_signature_past_two_thirds": dict(mutate=lambda c: _bad_sig(c, N_VALS - 1)),
    "too_little_power": dict(absent={0, 3, 4, 8, 11, 15, 19, 23}),  # 160 of 240 power
    # a nil vote is checked by the full variant and ignored by the light one
    "nil_vote": dict(nil_votes={3}),
    "nil_vote_bad_signature": dict(nil_votes={3}, mutate=lambda c: _bad_sig(c, 3)),
    "wrong_height": dict(height=HEIGHT + 1),
    "wrong_block_id": dict(block_seed=b"other"),
}


def _outcome(fn, *args, **kwargs):
    try:
        fn(*args, **kwargs)
    except Exception as exc:  # the outcome under comparison
        return type(exc).__name__, str(exc)
    return "ok", ""


@pytest.mark.parametrize("light", [False, True], ids=["verify_commit", "verify_commit_light"])
@pytest.mark.parametrize("case", list(CASES))
def test_verify_commit_outcome_matches_jax(nets, case, light):
    (jprivs, jvset), (tprivs, tvset) = nets
    spec = CASES[case]
    absent, nil_votes = spec.get("absent", set()), spec.get("nil_votes", set())
    jbid, tbid = helpers.make_block_id(), _port_block_id()
    jcommit = helpers.make_commit(
        jbid, HEIGHT, 0, jvset, jprivs, absent=absent, nil_votes=nil_votes, time_ns=TIME_NS
    )
    tcommit = _port_commit(tbid, tvset, tprivs, absent=absent, nil_votes=nil_votes)
    for i in range(N_VALS):
        if i not in absent:
            assert tcommit.vote_sign_bytes(helpers.CHAIN_ID, i) == jcommit.vote_sign_bytes(
                helpers.CHAIN_ID, i
            )
            assert tcommit.signatures[i].signature == jcommit.signatures[i].signature
    if "mutate" in spec:
        spec["mutate"](jcommit)
        spec["mutate"](tcommit)
    height = spec.get("height", HEIGHT)
    if "block_seed" in spec:
        jbid, tbid = helpers.make_block_id(spec["block_seed"]), _port_block_id(spec["block_seed"])
    jfn = jtypes.verify_commit_light if light else jtypes.verify_commit
    tfn = tval.verify_commit_light if light else tval.verify_commit
    want = _outcome(jfn, helpers.CHAIN_ID, jvset, jbid, height, jcommit)
    got = _outcome(tfn, helpers.CHAIN_ID, tvset, tbid, height, tcommit)
    assert got == want
    if case == "valid":
        assert got == ("ok", "")
    # Both packages activated the set for per-validator tables.
    if got[0] == "ok" or "wrong signature" in got[1]:
        assert tpc.tables.builds > 0


def _count_calls(monkeypatch, name):
    calls = []
    real = getattr(teb, name)

    def counted(*args):
        calls.append(args[-1].shape[0])
        return real(*args)

    monkeypatch.setattr(teb, name, counted)
    return calls


def test_mixed_batch_runs_both_plain_kernels(nets, monkeypatch):
    (_, jvset), (tprivs, tvset) = nets
    tbatch.note_validator_set(tvset)  # these keys get tables
    others = [Ed25519PrivKey.from_seed(bytes([200 + i]) * 32) for i in range(12)]
    signers = tprivs[:12] + others
    msgs = [b"mixed %d" % i for i in range(len(signers))]
    pks = [p.pub_key().bytes() for p in signers]
    sigs = [p.sign(m) for p, m in zip(signers, msgs)]
    sigs[3] = sigs[3][:32] + bytes(32)  # a bad table lane
    msgs[15] = b"tampered"  # a bad legacy lane
    k1 = _count_calls(monkeypatch, "verify_kernel")
    k2 = _count_calls(monkeypatch, "verify_kernel_tables")
    got = verify_batch(pks, msgs, sigs)
    want = [ref.verify_zip215(p, m, s) for p, m, s in zip(pks, msgs, sigs)]
    assert got == want and got.count(False) == 2
    assert k1 == [64] and k2 == [64]  # one padded chunk each
    assert tpc.tables.builds == 12
    # The same lanes again: the result cache answers, nothing launches.
    assert verify_batch(pks, msgs, sigs) == want
    assert k1 == [64] and k2 == [64]
    # The JAX package, the same set activated, gives the same verdicts.
    jpc.activate_validator_set(jvset)
    assert jeb.verify_batch(pks, msgs, sigs) == want
    assert jpc.tables.builds == 12


def test_verify_batch_contract_edges(nets):
    (_, _), (tprivs, _) = nets
    assert verify_batch([], [], []) == []
    msgs = [b"edge %d" % i for i in range(16)]
    pks = [p.pub_key().bytes() for p in tprivs[:16]]
    sigs = [p.sign(m) for p, m in zip(tprivs[:16], msgs)]
    pks[1] = pks[1][:31]
    pks[2] = pks[2] + b"\x00"
    sigs[4] = sigs[4][:63]
    sigs[5] = sigs[5] + b"\x00"
    want = [True] * 16
    for i in (1, 2, 4, 5):
        want[i] = False
    assert verify_batch(pks, msgs, sigs) == want


def test_batch_verifier_tiers(nets, monkeypatch):
    (_, _), (tprivs, _) = nets
    k1 = _count_calls(monkeypatch, "verify_kernel")
    msgs = [b"tier %d" % i for i in range(tbatch.DEVICE_THRESHOLD)]
    pairs = [(p.pub_key(), m, p.sign(m)) for p, m in zip(tprivs, msgs)]
    small = tbatch.Ed25519BatchVerifier()
    for entry in pairs[:3]:
        small.add(*entry)
    assert small.verify() == (True, [True] * 3)
    assert k1 == []  # below the threshold: the host oracle
    big = tbatch.Ed25519BatchVerifier()
    for entry in pairs:
        big.add(*entry)
    assert big.verify() == (True, [True] * tbatch.DEVICE_THRESHOLD)
    assert k1 == [64]
    assert tbatch.Ed25519BatchVerifier().verify() == (False, [])
    with pytest.raises(ValueError):
        big.add(pairs[0][0], b"m", b"short")
    assert tbatch.supports_batch_verifier(pairs[0][0])
    assert not tbatch.supports_batch_verifier(None)
    pks = [p.bytes() for p, _, _ in pairs]
    sigs = [s for _, _, s in pairs]
    assert tbatch.tiered_verify_ed25519(pks[:2], msgs[:2], sigs[:2]) == [True, True]
    assert k1 == [64]
    assert tbatch.tiered_verify_ed25519(pks, msgs, sigs) == [True] * tbatch.DEVICE_THRESHOLD
    assert k1 == [64]  # the result cache answered the repeated lanes
