"""Model-based light-client conformance traces through the port.

The 9 TLA+-generated traces in ``tests/mbt_json/`` (the reference's
light/mbt/json, real ed25519 signatures over canonical sign-bytes) are
driven through the port's ``light.verifier.verify`` as
``tests/test_light_mbt.py`` drives the JAX one (the upstream light/mbt harness):
each input block must give the trace's verdict (SUCCESS,
NOT_ENOUGH_TRUST, or INVALID), and the trusted state advances only on
success. The traces are read with the port's ``rpc/encoding``
``parse_rfc3339`` and types; at every step the JAX verifier runs on the
same step too, and the error class and message must be equal. Each
trace's sets hold 4 validators, so both verifiers stay on their host
tiers.
"""

import base64
import glob
import json
import os

import pytest

torch = pytest.importorskip("torch")

import tendermint_tpu_torch
from tendermint_tpu.light import verifier as jverifier
from tendermint_tpu_torch.crypto.keys import Ed25519PubKey
from tendermint_tpu_torch.light import verifier
from tendermint_tpu_torch.light.verifier import HeaderExpiredError, InvalidHeaderError, NewValSetCantBeTrustedError
from tendermint_tpu_torch.rpc.encoding import parse_rfc3339
from tendermint_tpu_torch.types.block import BlockID, Commit, CommitSig, Consensus, Header, PartSetHeader
from tendermint_tpu_torch.types.light import SignedHeader
from tendermint_tpu_torch.types.validator import Validator
from tendermint_tpu_torch.types.validator_set import ValidatorSet
from tests import test_light_mbt as jmbt

JSON_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "mbt_json")
MAX_CLOCK_DRIFT = 1.0  # the upstream light/mbt harness's drift


@pytest.fixture(autouse=True)
def cpu(monkeypatch):
    monkeypatch.setattr(tendermint_tpu_torch, "DEFAULT_DEVICE", "cpu")


def _b(hex_or_none):
    return bytes.fromhex(hex_or_none) if hex_or_none else b""


def _block_id(d) -> BlockID:
    if not d:
        return BlockID()
    parts = d.get("parts") or {}
    return BlockID(_b(d.get("hash")), PartSetHeader(int(parts.get("total", 0)), _b(parts.get("hash"))))


def _header(d) -> Header:
    return Header(
        version=Consensus(block=int(d["version"]["block"]), app=int(d["version"].get("app", 0))),
        chain_id=d["chain_id"],
        height=int(d["height"]),
        time=parse_rfc3339(d["time"]),
        last_block_id=_block_id(d.get("last_block_id")),
        last_commit_hash=_b(d.get("last_commit_hash")),
        data_hash=_b(d.get("data_hash")),
        validators_hash=_b(d["validators_hash"]),
        next_validators_hash=_b(d["next_validators_hash"]),
        consensus_hash=_b(d.get("consensus_hash")),
        app_hash=_b(d.get("app_hash")),
        last_results_hash=_b(d.get("last_results_hash")),
        evidence_hash=_b(d.get("evidence_hash")),
        proposer_address=_b(d.get("proposer_address")),
    )


def _commit(d) -> Commit:
    return Commit(
        height=int(d["height"]),
        round=int(d["round"]),
        block_id=_block_id(d.get("block_id")),
        signatures=[
            CommitSig(
                block_id_flag=int(s["block_id_flag"]),
                validator_address=_b(s.get("validator_address")),
                timestamp=parse_rfc3339(s["timestamp"] if s.get("timestamp") else "1970-01-01T00:00:00"),
                signature=base64.b64decode(s["signature"]) if s.get("signature") else b"",
            )
            for s in d["signatures"]
        ],
    )


def _valset(d):
    """The set as the trace lists it: its order and priorities, the
    proposer the highest priority (as the upstream harness restores it)."""
    vals = [
        Validator(Ed25519PubKey(base64.b64decode(v["pub_key"]["value"])), int(v["voting_power"]),
                  proposer_priority=int(v["proposer_priority"] or 0))
        for v in d.get("validators") or []
    ]
    return ValidatorSet.restore(vals) if vals else None


def _signed_header(d) -> SignedHeader:
    return SignedHeader(header=_header(d["header"]), commit=_commit(d["commit"]))


def _trace_files():
    return sorted(glob.glob(os.path.join(JSON_DIR, "*.json")))


def _load(path):
    with open(path) as fh:
        return json.load(fh)


def _run(fn, *args):
    try:
        fn(*args)
    except Exception as e:  # classified by the caller
        return e
    return None


def _shape(err):
    return None if err is None else (type(err).__name__, str(err))


@pytest.mark.parametrize("path", _trace_files(), ids=[os.path.basename(p) for p in _trace_files()])
def test_mbt_trace(path):
    tc = _load(path)
    trusted_sh = _signed_header(tc["initial"]["signed_header"])
    trusted_next_vals = _valset(tc["initial"]["next_validator_set"])
    jtrusted_sh = jmbt._signed_header(tc["initial"]["signed_header"])
    jtrusted_next_vals = jmbt._valset(tc["initial"]["next_validator_set"])
    trusting_period = int(tc["initial"]["trusting_period"]) / 1e9  # ns -> s
    assert trusted_sh.header.hash() == jtrusted_sh.header.hash()

    for step, inp in enumerate(tc["input"]):
        new_sh = _signed_header(inp["block"]["signed_header"])
        new_vals = _valset(inp["block"]["validator_set"])
        now = parse_rfc3339(inp["now"])
        err = _run(verifier.verify, trusted_sh, trusted_next_vals, new_sh, new_vals,
                   trusting_period, now, MAX_CLOCK_DRIFT)
        jnew_sh = jmbt._signed_header(inp["block"]["signed_header"])
        jerr = _run(jverifier.verify, jtrusted_sh, jtrusted_next_vals, jnew_sh,
                    jmbt._valset(inp["block"]["validator_set"]), trusting_period,
                    jmbt.parse_rfc3339(inp["now"]), MAX_CLOCK_DRIFT)

        verdict = inp["verdict"]
        ctx = f"{os.path.basename(path)} step {step}"
        assert _shape(err) == _shape(jerr), ctx
        if verdict == "SUCCESS":
            assert err is None, f"{ctx}: expected SUCCESS, got {err!r}"
        elif verdict == "NOT_ENOUGH_TRUST":
            assert isinstance(err, NewValSetCantBeTrustedError), f"{ctx}: expected NOT_ENOUGH_TRUST, got {err!r}"
        elif verdict == "INVALID":
            assert isinstance(err, (InvalidHeaderError, HeaderExpiredError)), f"{ctx}: expected INVALID, got {err!r}"
        else:
            pytest.fail(f"{ctx}: unknown verdict {verdict!r}")

        if err is None:  # advance, as the upstream harness does
            trusted_sh, jtrusted_sh = new_sh, jnew_sh
            trusted_next_vals = _valset(inp["block"]["next_validator_set"])
            jtrusted_next_vals = jmbt._valset(inp["block"]["next_validator_set"])


def test_traces_present():
    assert len(_trace_files()) == 9


def _first_success(name):
    tc = _load(os.path.join(JSON_DIR, name))
    inp = next(i for i in tc["input"] if i["verdict"] == "SUCCESS")
    return (_signed_header(tc["initial"]["signed_header"]), _valset(tc["initial"]["next_validator_set"]),
            _signed_header(inp["block"]["signed_header"]), _valset(inp["block"]["validator_set"]),
            int(tc["initial"]["trusting_period"]) / 1e9, parse_rfc3339(inp["now"]))


def test_expired_trust_root_rejected():
    """verifier.go:47/116: expiry gates on the TRUSTED header's age. The
    traces cannot tell (their times differ by seconds against a 1400 s
    period): trusted header at t = 1 s, now 1 s past expiry -> reject."""
    trusted_sh, trusted_vals, new_sh, new_vals, period, _ = _first_success("MC4_4_faulty_TestSuccess.json")
    with pytest.raises(HeaderExpiredError):
        verifier.verify(trusted_sh, trusted_vals, new_sh, new_vals, period,
                        parse_rfc3339("1970-01-01T00:23:22Z"), MAX_CLOCK_DRIFT)


def test_harness_not_vacuous():
    """Corrupting one commit signature of a SUCCESS step flips the
    verdict: the traces exercise signature verification."""
    trusted_sh, trusted_vals, new_sh, new_vals, period, now = _first_success("MC4_4_faulty_TestSuccess.json")
    verifier.verify(trusted_sh, trusted_vals, new_sh, new_vals, period, now, MAX_CLOCK_DRIFT)
    cs = next(cs for cs in new_sh.commit.signatures if cs.signature)
    cs.signature = bytes([cs.signature[0] ^ 1]) + cs.signature[1:]
    with pytest.raises(InvalidHeaderError, match="wrong signature"):
        verifier.verify(trusted_sh, trusted_vals, new_sh, new_vals, period, now, MAX_CLOCK_DRIFT)
