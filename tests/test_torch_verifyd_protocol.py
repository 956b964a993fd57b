"""The port's verifyd wire codec against the JAX package's, on the CPU.

The same seeded requests and responses, fields 1-10 included, encode to
the same bytes in both packages and decode across; old frames (no
tenant, trace, SLO or routing fields) and zero-omission hold in both;
malformed and oversized frames are rejected by both with the same
messages.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

from tendermint_tpu.verifyd import protocol as jp
from tendermint_tpu_torch.verifyd import protocol as tp

SEED = 20261017


def _lanes(rng, n):
    pks = [rng.bytes(32) for _ in range(n)]
    msgs = [rng.bytes(int(rng.integers(0, 200))) for _ in range(n)]
    sigs = [rng.bytes(64) for _ in range(n)]
    return pks, msgs, sigs


def _request_fields(seed):
    """A seeded request's fields, every one of 1-10 set (or at its
    zero/default, depending on the seed)."""
    rng = np.random.default_rng(seed)
    pks, msgs, sigs = _lanes(rng, int(rng.integers(0, 6)))
    full = seed % 2 == 0
    return dict(
        kind=int(rng.integers(1, 4)),
        klass=int(rng.integers(0, 4)),
        deadline_ms=int(rng.integers(1, jp.MAX_DEADLINE_MS)) if full else 0,
        algo=int(rng.integers(0, 2)),
        pks=pks, msgs=msgs, sigs=sigs,
        tenant="chain-%d" % seed if full else jp.DEFAULT_TENANT,
        trace=rng.bytes(17) if full else b"",
        slo_ms=int(rng.integers(1, jp.MAX_SLO_MS)) if full else 0,
        shard_id=int(rng.integers(0, jp.MAX_SHARD_ID)) if full else -1,
        route_epoch=int(rng.integers(1, jp.MAX_ROUTE_EPOCH)) if full else 0,
    )


@pytest.mark.parametrize("seed", range(8))
def test_requests_encode_to_the_same_bytes_and_decode_across(seed):
    fields = _request_fields(seed)
    jreq, treq = jp.VerifyRequest(**fields), tp.VerifyRequest(**fields)
    jwire, twire = jp.encode_request(jreq), tp.encode_request(treq)
    assert jwire == twire
    assert tp.encoded_request_size(treq) == jp.encoded_request_size(jreq) == len(twire)
    assert vars(tp.decode_request(jwire)) == vars(jp.decode_request(twire)) == vars(jreq)


@pytest.mark.parametrize("seed", range(6))
def test_responses_encode_to_the_same_bytes_and_decode_across(seed):
    rng = np.random.default_rng(SEED + seed)
    n = int(rng.integers(0, 9))
    fields = dict(
        status=int(rng.integers(0, 5)),
        verdicts=[bool(b) for b in rng.integers(0, 2, size=n)],
        message="detail %d" % seed if seed % 2 else "",
        queue_depth=int(rng.integers(0, 5000)),
        stages=tp.pack_stages({s: float(rng.random()) for s in tp.STAGE_NAMES}) if seed % 3 else b"",
        shard_id=int(rng.integers(-1, 8)),
    )
    jresp, tresp = jp.VerifyResponse(**fields), tp.VerifyResponse(**fields)
    jwire, twire = jp.encode_response(jresp), tp.encode_response(tresp)
    assert jwire == twire
    assert vars(tp.decode_response(jwire)) == vars(jp.decode_response(twire)) == vars(jresp)


def test_stage_vectors_pack_alike():
    stages = {"wire_wait": 0.001, "device": 0.25, "collect": 0.5}
    assert tp.STAGE_NAMES == jp.STAGE_NAMES
    assert tp.pack_stages(stages) == jp.pack_stages(stages)
    assert tp.unpack_stages(jp.pack_stages(stages)) == jp.unpack_stages(jp.pack_stages(stages))
    assert tp.unpack_stages(b"\x00" * 3) == jp.unpack_stages(b"\x00" * 3) == {}


def test_old_frames_and_zero_omission():
    """A request at every default (default tenant, no trace, no SLO,
    unrouted) is the frame of a client that predates fields 6-10, in
    both packages, and decodes back to the defaults; consensus (class
    0) and shard 0 survive zero-omission through the +1 shift."""
    pks, msgs, sigs = _lanes(np.random.default_rng(SEED), 2)
    lanes = dict(pks=pks, msgs=msgs, sigs=sigs)
    old = tp.encode_request(tp.VerifyRequest(**lanes))
    for tenant in (tp.DEFAULT_TENANT, ""):
        assert tp.encode_request(tp.VerifyRequest(tenant=tenant, **lanes)) == old
        assert jp.encode_request(jp.VerifyRequest(tenant=tenant, **lanes)) == old
    assert tp.encode_string_field(6, tp.DEFAULT_TENANT) not in old
    for mod in (tp, jp):
        got = mod.decode_request(old)
        assert (got.tenant, got.trace, got.slo_ms, got.shard_id, got.route_epoch) == (
            mod.DEFAULT_TENANT, b"", 0, -1, 0)
        assert got.msgs == msgs and got.klass == mod.CLASS_RPC
    edge = dict(klass=tp.CLASS_CONSENSUS, shard_id=0, msgs=[b"", msgs[1]], pks=pks, sigs=sigs)
    twire = tp.encode_request(tp.VerifyRequest(**edge))
    assert twire == jp.encode_request(jp.VerifyRequest(**edge))
    got = tp.decode_request(twire)
    assert (got.klass, got.shard_id, got.msgs[0]) == (tp.CLASS_CONSENSUS, 0, b"")
    # an empty OK response is the empty frame; an old server's response
    # (no stages, no shard) decodes to the defaults
    assert tp.encode_response(tp.VerifyResponse()) == jp.encode_response(jp.VerifyResponse()) == b""
    assert vars(tp.decode_response(b"")) == vars(jp.decode_response(b""))


def _bad_requests():
    pks, msgs, sigs = _lanes(np.random.default_rng(SEED + 1), 1)
    lanes = dict(pks=pks, msgs=msgs, sigs=sigs)
    over = {
        "deadline": dict(deadline_ms=jp.MAX_DEADLINE_MS + 1, **lanes),
        "slo": dict(slo_ms=jp.MAX_SLO_MS + 1, **lanes),
        "epoch": dict(route_epoch=jp.MAX_ROUTE_EPOCH + 1, **lanes),
        "shard": dict(shard_id=jp.MAX_SHARD_ID + 1, **lanes),
        "tenant": dict(tenant="x" * (jp.MAX_TENANT_LEN + 1), **lanes),
        "trace": dict(trace=b"t" * (jp.MAX_TRACE_LEN + 1), **lanes),
        "kind": dict(kind=9, **lanes),
        "class": dict(klass=9, **lanes),
        "algo": dict(algo=7, **lanes),
        "pubkey": dict(pks=[b"short"], msgs=msgs, sigs=sigs),
        "signature": dict(pks=pks, msgs=msgs, sigs=[b"s" * 63]),
        "message": dict(pks=pks, msgs=[b"m" * (jp.MAX_MSG_SIZE + 1)], sigs=sigs),
        "lanes": dict(pks=pks * (jp.MAX_LANES + 1), msgs=msgs * (jp.MAX_LANES + 1),
                      sigs=sigs * (jp.MAX_LANES + 1)),
    }
    frames = {k: jp.encode_request(jp.VerifyRequest(**v)) for k, v in over.items()}
    frames["torn_varint"] = b"\xff\xff\xff"
    frames["lane_without_sig"] = jp.encode_bytes_field(5, jp.encode_bytes_field(1, pks[0]))
    frames["truncated_lane"] = jp.encode_request(jp.VerifyRequest(**lanes))[:-5]
    return frames


BAD = _bad_requests()


@pytest.mark.parametrize("case", sorted(BAD))
def test_malformed_and_oversized_requests_are_rejected_alike(case):
    frame = BAD[case]
    with pytest.raises(ValueError) as jerr:
        jp.decode_request(frame)
    with pytest.raises(ValueError) as terr:
        tp.decode_request(frame)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("frame", [b"\x08\x09", b"\x12\x05ab", b"\x30\x80\x40", b"\xff"],
                         ids=["status", "verdicts", "shard", "torn"])
def test_malformed_responses_are_rejected_alike(frame):
    with pytest.raises(ValueError) as jerr:
        jp.decode_response(frame)
    with pytest.raises(ValueError) as terr:
        tp.decode_response(frame)
    assert str(terr.value) == str(jerr.value)


def test_constants_are_the_reference_s():
    names = ("VERIFY_PATH", "STATS_PATH", "MAX_LANES", "MAX_MSG_SIZE", "MAX_TENANT_LEN",
             "MAX_TRACE_LEN", "MAX_SLO_MS", "MAX_DEADLINE_MS", "MAX_SHARD_ID", "MAX_ROUTE_EPOCH",
             "DEFAULT_TENANT", "KIND_NAMES", "CLASS_NAMES", "ALGO_NAMES", "STATUS_NAMES",
             "SHEDDABLE_CLASSES", "PUBKEY_SIZE", "SIG_SIZE")
    for name in names:
        assert getattr(tp, name) == getattr(jp, name), name
    assert tp.MAX_LANES == 4096
