"""The port's light-client verifier (``light/verifier.py``) against the
JAX package's, on the CPU.

One chain of 4 signed headers under 24 validators is built with the JAX
package's types (``bench/workload.py``'s ``build_header_chain``) and
carried to the port (``types/carry.py``); each case mutates the JAX
objects, carries them again, and ``verify_adjacent``,
``verify_non_adjacent``, ``verify`` and ``verify_backwards`` must give
the same outcome, exception type and message in both packages. A commit
check takes at most 17 lanes (the +2/3 stop), padded to 64.
"""

import copy

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import tendermint_tpu_torch
from bench.workload import build_header_chain
from tendermint_tpu.encoding.canonical import Timestamp as JTimestamp
from tendermint_tpu.light import verifier as jver
from tendermint_tpu.ops import precompute as jpc
from tendermint_tpu.types import Fraction as JFraction
from tendermint_tpu_torch.encoding.canonical import Timestamp
from tendermint_tpu_torch.light import verifier as tver
from tendermint_tpu_torch.ops import precompute as tpc
from tendermint_tpu_torch.types import carry
from tendermint_tpu_torch.types.validation import Fraction
from tests import helpers

N_HEADERS = 4
N_VALS = 24
PERIOD = 86400.0
DRIFT = 10.0


@pytest.fixture(autouse=True)
def _cpu_and_clean_caches(monkeypatch):
    monkeypatch.setattr(tendermint_tpu_torch, "DEFAULT_DEVICE", "cpu")
    tpc.reset()
    jpc.reset()
    yield
    tpc.reset()
    jpc.reset()


@pytest.fixture(scope="module")
def chain():
    jchain, jvset, chain_id = build_header_chain(N_HEADERS, N_VALS)
    # A set that shares 6 of the 24 validators (seeds 18-23): 60 of its
    # 240 power signs, not more than the 1/3 trust level's 80.
    jpartial = helpers.make_validators(
        N_VALS, key_factory=lambda i: helpers.Ed25519PrivKey.from_seed((i + 18).to_bytes(32, "big"))
    )[1]
    jother = helpers.make_validators(N_VALS, key_factory=lambda i: helpers.Ed25519PrivKey.from_seed(
        (i + 1000).to_bytes(32, "big")))[1]
    return jchain, {"set": jvset, "partial": jpartial, "other": jother}, chain_id


def _flip(sig: bytes) -> bytes:
    return sig[:40] + bytes([sig[40] ^ 1]) + sig[41:]


def _tamper(sh):
    sh.commit.signatures[5].signature = _flip(sh.commit.signatures[5].signature)


def _double_vote(sh):
    # Signature 3 claims validator 1's address: by index it still checks
    # out, by address it is validator 1's second vote.
    sh.commit.signatures[3].validator_address = sh.commit.signatures[1].validator_address


# Each case: a mutation of the untrusted signed header, and overrides of
# the call's arguments.
CASES = {
    "valid": {},
    "tampered_signature": {"mutate": _tamper},
    "expired": {"period": 1.0},
    "header_from_the_future": {"now_from_untrusted_s": -DRIFT - 5},
    "wrong_validators_hash": {"untrusted_vals": "other"},
    "trust_level_out_of_range": {"trust_level": (1, 4)},
    "double_vote_by_address": {"mutate": _double_vote},
    "too_little_trusted_power": {"trusted_vals": "partial"},
}

# entry point: (trusted height index, untrusted height index)
STEPS = {"verify_adjacent": (1, 2), "verify_non_adjacent": (0, 2), "verify": (0, 3)}


def _outcome(fn, *args, **kwargs):
    try:
        fn(*args, **kwargs)
    except Exception as exc:  # the outcome under comparison
        return type(exc).__name__, str(exc)
    return "ok", ""


def _args(chain, entry, spec, port):
    """The call's arguments for one package: the JAX objects, or their
    carried copies."""
    jchain, sets, _ = chain
    t_i, u_i = STEPS[entry]
    trusted = jchain[t_i]
    untrusted = copy.deepcopy(jchain[u_i])
    if "mutate" in spec:
        spec["mutate"](untrusted)
    secs = untrusted.header.time.seconds + spec.get("now_from_untrusted_s", 2)
    trusted_vals = sets[spec.get("trusted_vals", "set")]
    untrusted_vals = sets[spec.get("untrusted_vals", "set")]
    lvl = spec.get("trust_level", (1, 3))
    if port:
        trusted, untrusted = carry.signed_header(trusted), carry.signed_header(untrusted)
        trusted_vals, untrusted_vals = carry.validator_set(trusted_vals), carry.validator_set(untrusted_vals)
        now, lvl = Timestamp(secs, 0), Fraction(*lvl)
    else:
        now, lvl = JTimestamp(secs, 0), JFraction(*lvl)
    period = spec.get("period", PERIOD)
    if entry == "verify_adjacent":
        return (trusted, untrusted, untrusted_vals, period, now, DRIFT)
    return (trusted, trusted_vals, untrusted, untrusted_vals, period, now, DRIFT, lvl)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("entry", list(STEPS))
def test_outcome_matches_jax(chain, entry, case):
    spec = CASES[case]
    want = _outcome(getattr(jver, entry), *_args(chain, entry, spec, port=False))
    got = _outcome(getattr(tver, entry), *_args(chain, entry, spec, port=True))
    assert got == want
    if case == "valid":
        assert got == ("ok", "")
    if case == "expired":
        assert got[0] == "HeaderExpiredError"
    if entry != "verify_adjacent" and case in ("double_vote_by_address", "too_little_trusted_power"):
        assert got[0] in ("InvalidHeaderError", "NewValSetCantBeTrustedError")


def _older(h):
    h.time = type(h.time)(h.time.seconds + 100, 0)


BACKWARDS = {
    "valid": None,
    "invalid_header": lambda h: setattr(h, "proposer_address", b"\x01" * 19),
    "other_chain": lambda h: setattr(h, "chain_id", "other-chain"),
    "not_older": _older,
    "hash_mismatch": lambda h: setattr(h, "app_hash", b"\x07" * 32),
}


@pytest.mark.parametrize("case", list(BACKWARDS))
def test_verify_backwards_matches_jax(chain, case):
    jchain, _, _ = chain
    untrusted, trusted = copy.deepcopy(jchain[1].header), jchain[2].header
    if BACKWARDS[case]:
        BACKWARDS[case](untrusted)
    want = _outcome(jver.verify_backwards, untrusted, trusted)
    got = _outcome(tver.verify_backwards, carry.header(untrusted), carry.header(trusted))
    assert got == want
    assert (got == ("ok", "")) == (case == "valid")


def test_trust_level_and_expiry_helpers_match_jax(chain):
    for lvl in ((1, 3), (2, 3), (1, 4), (1, 1), (3, 2), (0, 0), (1, 0)):
        assert _outcome(tver.validate_trust_level, Fraction(*lvl)) == _outcome(
            jver.validate_trust_level, JFraction(*lvl))
    jsh = chain[0][0]
    tsh = carry.signed_header(jsh)
    t = jsh.header.time.seconds
    for period, secs in ((10.0, t + 9), (10.0, t + 10), (0.5, t), (86400.0, t + 86399)):
        assert tver.header_expired(tsh, period, Timestamp(secs, 0)) == jver.header_expired(
            jsh, period, JTimestamp(secs, 0))


def test_entry_points_default_to_cuda(chain, monkeypatch):
    """device=None is the card: without CUDA the walk raises instead of
    running on the CPU."""
    monkeypatch.setattr(tendermint_tpu_torch, "DEFAULT_DEVICE", "cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for entry in STEPS:
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            getattr(tver, entry)(*_args(chain, entry, {}, port=True))
