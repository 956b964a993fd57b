"""The port's one-super-batch bisection round (``light/batch.py``
``evaluate_candidates``) against the JAX package's, on the CPU.

One chain of 6 signed headers under 24 validators is built with the JAX
package's types (``bench/workload.py``'s ``build_header_chain``) and
carried to the port (``types/carry.py``). Each round's candidates cover
every kind of outcome: accepted (adjacent and skipping), a bad signature
found by the trusting pass and one found by the +2/3 pass, a malformed
signature the planner cannot express (resolved by the sequential
verifier), a header that is not newer, and, from a trusted set that
holds too little of the new commit's power, bisect. The JAX round runs
on a host-verify scheduler; the port's on its own shared scheduler and
engine. Kind, exception type and message must be equal, and equal to
the port's sequential ``light.verifier.verify``; each round is one
``submit_many`` and, with the shared scheduler's ``max_batch`` cut to
16 lanes, still one flush. A device fault in the round's flush raises,
as it does in the sequential verifier, instead of reading as bad
signatures.
"""

import copy

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import tendermint_tpu_torch
from bench.workload import build_header_chain
from tendermint_tpu.crypto.ed25519_ref import verify_zip215
from tendermint_tpu.crypto.scheduler import VerifyScheduler as JScheduler
from tendermint_tpu.encoding.canonical import Timestamp as JTimestamp
from tendermint_tpu.light import batch as jlb
from tendermint_tpu.ops import precompute as jpc
from tendermint_tpu.types import Fraction as JFraction
from tendermint_tpu.types.light import LightBlock as JLightBlock
from tendermint_tpu_torch.crypto import batch as tbatch
from tendermint_tpu_torch.encoding.canonical import Timestamp
from tendermint_tpu_torch.light import batch as tlb
from tendermint_tpu_torch.light import verifier as tverifier
from tendermint_tpu_torch.ops import device_policy, fault_injection
from tendermint_tpu_torch.ops import precompute as tpc
from tendermint_tpu_torch.types import carry
from tendermint_tpu_torch.types.light import LightBlock
from tendermint_tpu_torch.types.validation import Fraction
from tests import helpers

N_HEADERS = 6
N_VALS = 24
PERIOD = 86400.0
DRIFT = 10.0
WAIT = 10.0  # each round's verdict wait (the module's default is 30 s)


@pytest.fixture(scope="module")
def chain():
    jchain, jvset, chain_id = build_header_chain(N_HEADERS, N_VALS)
    # 6 of the 24 validators (seeds 18-23): 60 of the 240 power, not more
    # than the 1/3 trust level's 80
    jpartial = helpers.make_validators(
        N_VALS, key_factory=lambda i: helpers.Ed25519PrivKey.from_seed((i + 18).to_bytes(32, "big"))
    )[1]
    return jchain, jvset, jpartial, chain_id


@pytest.fixture()
def port(monkeypatch):
    monkeypatch.setattr(tendermint_tpu_torch, "DEFAULT_DEVICE", "cpu")
    monkeypatch.setattr(tbatch, "_shared_scheduler", None)
    monkeypatch.setattr(device_policy, "shared", device_policy.DeviceHealth())
    tpc.reset()
    jpc.reset()
    tlb.reset_stats()
    yield
    if tbatch._shared_scheduler is not None:
        tbatch._shared_scheduler.stop()
    tpc.reset()
    jpc.reset()


def _bad_sig(sh, idx):
    s = sh.commit.signatures[idx].signature
    sh.commit.signatures[idx].signature = s[:40] + bytes([s[40] ^ 1]) + s[41:]


def _candidates(jchain):
    """(name, signed header) of every candidate, the JAX objects."""
    trusting_bad = copy.deepcopy(jchain[4])
    _bad_sig(trusting_bad, 5)  # inside the 9 signatures of the 1/3 pass
    full_bad = copy.deepcopy(jchain[4])
    _bad_sig(full_bad, 12)  # past the 1/3 pass, inside the +2/3 pass's 17
    malformed = copy.deepcopy(jchain[2])
    malformed.commit.signatures[2].signature = malformed.commit.signatures[2].signature[:63]
    return [
        ("skip_to_6", jchain[5]),
        ("skip_to_4", jchain[3]),
        ("adjacent_2", jchain[1]),
        ("bad_in_trusting_pass", trusting_bad),
        ("bad_in_full_pass", full_bad),
        ("malformed_signature", malformed),
        ("not_newer", jchain[0]),
    ]


def _shape(outcome):
    err = outcome.error
    return outcome.kind, None if err is None else (type(err).__name__, str(err))


def _round(chain, trusted_key):
    jchain, jvset, jpartial, chain_id = chain
    jtrusted_vals = {"set": jvset, "partial": jpartial}[trusted_key]
    cands = _candidates(jchain)
    secs = jchain[-1].header.time.seconds + 2
    # the JAX round, on a scheduler backed by the host oracle
    jsched = JScheduler(lambda p, m, s: [verify_zip215(*lane) for lane in zip(p, m, s)], max_delay=0.01)
    jsched.start()
    try:
        jout = jlb.evaluate_candidates(
            chain_id, JLightBlock(jchain[0], jtrusted_vals), [JLightBlock(sh, jvset) for _, sh in cands],
            PERIOD, JTimestamp(secs, 0), DRIFT, JFraction(1, 3), scheduler=jsched, timeout=WAIT)
    finally:
        jsched.stop()
    # the port's round, on its shared scheduler
    vset, trusted_vals = carry.validator_set(jvset), carry.validator_set(jtrusted_vals)
    base = LightBlock(carry.signed_header(jchain[0]), trusted_vals)
    tcands = [LightBlock(carry.signed_header(sh), vset) for _, sh in cands]
    sched = tbatch.get_shared_scheduler()
    sched.max_batch = 16  # the round's lanes are several times this
    submit_many, calls = sched.submit_many, []
    sched.submit_many = lambda lanes, **kw: (calls.append(len(lanes)), submit_many(lanes, **kw))[1]
    tout = tlb.evaluate_candidates(chain_id, base, tcands, PERIOD, Timestamp(secs, 0), DRIFT, Fraction(1, 3),
                                   timeout=WAIT)
    names = [name for name, _ in cands]
    got = {name: (_shape(j), _shape(t)) for name, j, t in zip(names, jout, tout)}
    for name, (j, t) in got.items():
        assert j == t, name
    # the contract: each outcome is what the sequential verifier gives
    for name, cand, t in zip(names, tcands, tout):
        seq = tlb._resolve_sequential(chain_id, base, cand, PERIOD, Timestamp(secs, 0), DRIFT, Fraction(1, 3))
        assert _shape(seq) == _shape(t), name
    return {name: t for name, (_, t) in got.items()}, calls


@pytest.fixture()
def round_outcomes(chain, port):
    return lambda key: _round(chain, key)


def test_round_outcomes_match_the_reference_and_the_sequential_verifier(round_outcomes):
    got, calls = round_outcomes("set")
    assert got["skip_to_6"] == got["skip_to_4"] == got["adjacent_2"] == ("ok", None)
    assert got["bad_in_trusting_pass"][1][0] == "InvalidHeaderError"
    assert got["bad_in_trusting_pass"][1][1].startswith("wrong signature (#5): ")
    assert got["bad_in_full_pass"][1][1].startswith("wrong signature (#12): ")
    assert got["malformed_signature"][1][1].startswith("wrong signature (#2): ")
    assert got["not_newer"] == ("error", (
        "InvalidHeaderError", "expected new header height 1 to be greater than one of old header 1"))
    # one submit_many for the round; the malformed candidate went to the
    # sequential verifier, the not-newer one was settled on the host
    assert len(calls) == 1
    stats = tlb.stats()
    assert (stats["rounds"], stats["super_batches"], stats["sequential"], stats["decided_on_host"],
            stats["timed_out"]) == (1, 1, 1, 1, 0)
    assert stats["lanes"] == calls[0] > 16
    sched = tbatch.get_shared_scheduler().stats()
    assert sched["flushes"] == 1  # one_flush: not cut at max_batch
    assert sched["flush_errors"] == sched["fallback_flushes"] == 0
    assert sched["entries_coalesced"] > 0  # the 1/3 pass's lanes are a prefix of the +2/3 pass's


def test_too_little_trusted_power_bisects_alike(round_outcomes):
    got, calls = round_outcomes("partial")
    for name in ("skip_to_6", "skip_to_4", "bad_in_trusting_pass", "bad_in_full_pass"):
        kind, (etype, msg) = got[name]
        assert (kind, etype) == ("bisect", "NewValSetCantBeTrustedError"), name
        assert msg == "invalid commit -- insufficient voting power: got 60, needed more than 80"
    assert got["adjacent_2"] == ("ok", None)  # the adjacent check does not read the trusted set
    assert len(calls) == 1


def test_an_empty_round_and_a_device_the_shared_scheduler_does_not_use(port, monkeypatch, chain):
    jchain, jvset, _, chain_id = chain
    base = LightBlock(carry.signed_header(jchain[0]), carry.validator_set(jvset))
    assert tlb.evaluate_candidates(chain_id, base, [], PERIOD, Timestamp(0, 0), DRIFT, Fraction(1, 3)) == []
    assert tlb.stats()["super_batches"] == 0
    # the shared scheduler verifies on the package's device (the CPU
    # here): a round asked to run elsewhere is refused, not moved
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="shared scheduler verifies on the package's device cpu, not cuda"):
        tlb.evaluate_candidates(chain_id, base, [], PERIOD, Timestamp(0, 0), DRIFT, Fraction(1, 3),
                                device="cuda")


def test_a_device_fault_in_the_round_raises_as_the_sequential_verifier_does(port, chain):
    """Host fallback is off: the faulted flush fails closed, and the
    round raises the engine's fault where its all-False verdicts would
    otherwise read as a wrong signature on a valid header."""
    jchain, jvset, _, chain_id = chain
    vset = carry.validator_set(jvset)
    base = LightBlock(carry.signed_header(jchain[0]), vset)
    cand = LightBlock(carry.signed_header(jchain[5]), vset)
    now = Timestamp(jchain[-1].header.time.seconds + 2, 0)
    args = (PERIOD, now, DRIFT, Fraction(1, 3))
    try:
        with fault_injection.inject(site="ed25519.chunk", fail_calls=(1,)):
            with pytest.raises(fault_injection.DeviceFault):
                tlb.evaluate_candidates(chain_id, base, [cand], *args, timeout=WAIT)
        assert tlb.stats()["failed_closed"] == 1
        assert tbatch.get_shared_scheduler().stats()["flush_errors"] == 1
        with fault_injection.inject(site="ed25519.chunk", fail_calls=(1,)):
            with pytest.raises(fault_injection.DeviceFault):
                tverifier.verify(base.signed_header, vset, cand.signed_header, vset, *args, device="cpu")
    finally:
        fault_injection.uninstall()
    # the fault was transient: the next round is answered, and accepts
    assert [o.kind for o in tlb.evaluate_candidates(chain_id, base, [cand], *args, timeout=WAIT)] == ["ok"]


def test_the_round_raises_without_cuda_by_default(monkeypatch, chain):
    monkeypatch.setattr(tendermint_tpu_torch, "DEFAULT_DEVICE", "cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    jchain, jvset, _, chain_id = chain
    base = LightBlock(carry.signed_header(jchain[0]), carry.validator_set(jvset))
    with pytest.raises(RuntimeError, match="cuda"):
        tlb.evaluate_candidates(chain_id, base, [], PERIOD, Timestamp(0, 0), DRIFT, Fraction(1, 3))
