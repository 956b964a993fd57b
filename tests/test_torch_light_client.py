"""The port's light client (``light/client.py``) against the JAX
package's, on the CPU.

Chains are built with the JAX package's types (``tests/test_light.py``'s
constant-set chain with its fork, ``tests/test_lightd.py``'s rotating
chain, ``bench/workload.py``'s 24-validator chain) and carried to the
port (``types/carry.py``). The JAX client runs its one-verify-per-pivot
skipping loop (``bisect_batching=False``) or its sequential walk, so
every JAX verification stays on its host tier (its device verifier's
first trace takes longer than any wait here); the JAX package's own
``tests/test_lightd.py::TestBatchParity`` holds its two skipping modes
equal. The port's client runs all three of its modes, the batched one
on a fresh shared scheduler on the CPU. Stored heights, returned block
hashes, error classes and messages, and the evidence of a fork must be
equal; a device fault inside a round must escape the client as it is.
"""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import tendermint_tpu_torch
from bench.workload import build_header_chain
from tendermint_tpu.light import LightClient as JLightClient
from tendermint_tpu.light import MemoryProvider as JMemoryProvider
from tendermint_tpu.light import TrustOptions as JTrustOptions
from tendermint_tpu.light import client as jclient_mod
from tendermint_tpu.light import verifier as jverifier
from tendermint_tpu.light.client import DivergedHeaderError as JDivergedHeaderError
from tendermint_tpu.ops import precompute as jpc
from tendermint_tpu.types.light import LightBlock as JLightBlock
from tendermint_tpu_torch.crypto import batch as tbatch
from tendermint_tpu_torch.light import LightClient, MemoryProvider, TrustOptions
from tendermint_tpu_torch.light import batch as tlb
from tendermint_tpu_torch.light import client as tclient_mod
from tendermint_tpu_torch.light import verifier as tverifier
from tendermint_tpu_torch.light.client import DivergedHeaderError
from tendermint_tpu_torch.ops import device_policy, fault_injection
from tendermint_tpu_torch.ops import precompute as tpc
from tendermint_tpu_torch.types import carry
from tests.helpers import CHAIN_ID
from tests.test_light import build_light_chain, now_at
from tests.test_lightd import build_rotating_chain

HOUR = 3600.0
PORT_MODES = ("batched", "skipping", "sequential")
SKIPPING_MODES = ("batched", "skipping")


@pytest.fixture()
def port(monkeypatch):
    monkeypatch.setattr(tendermint_tpu_torch, "DEFAULT_DEVICE", "cpu")
    monkeypatch.setattr(tbatch, "_shared_scheduler", None)
    monkeypatch.setattr(device_policy, "shared", device_policy.DeviceHealth())
    tpc.reset()
    jpc.reset()
    tlb.reset_stats()
    yield
    tbatch.shutdown_shared_scheduler()
    fault_injection.uninstall()
    tpc.reset()
    jpc.reset()


def jclient(blocks, sequential=False, height=1, witness_blocks=None):
    primary = JMemoryProvider(CHAIN_ID, blocks)
    witnesses = [] if witness_blocks is None else [JMemoryProvider(CHAIN_ID, witness_blocks)]
    return JLightClient(
        CHAIN_ID, JTrustOptions(period=10 * HOUR, height=height, hash=blocks[height - 1].hash()),
        primary, witnesses, sequential=sequential, bisect_batching=False, now=now_at)


def tclient(jblocks, mode, height=1, witness_jblocks=None):
    """The port's client over the carried chain, in ``mode``."""
    blocks = [carry.light_block(b) for b in jblocks]
    primary = MemoryProvider(CHAIN_ID, blocks)
    witnesses = [] if witness_jblocks is None else [
        MemoryProvider(CHAIN_ID, [carry.light_block(b) for b in witness_jblocks])]
    return LightClient(
        CHAIN_ID, TrustOptions(period=10 * HOUR, height=height, hash=blocks[height - 1].hash()),
        primary, witnesses, sequential=mode == "sequential", bisect_batching=mode == "batched",
        now=lambda: carry.timestamp(now_at()))


def outcome(make, height):
    """What ``verify_light_block_at_height`` gives: the block's hash and
    the stored heights, or the error's class and message."""
    try:
        client = make()
        lb = client.verify_light_block_at_height(height)
    except Exception as e:
        return type(e).__name__, str(e)
    return "ok", lb.hash(), client.store.heights()


def jmode(mode):
    return mode == "sequential"


@pytest.mark.parametrize("mode", SKIPPING_MODES)
def test_rotating_chain_bisects_through_the_same_pivots(port, mode):
    blocks = build_rotating_chain(17)
    want = outcome(lambda: jclient(blocks), 17)
    got = outcome(lambda: tclient(blocks, mode), 17)
    assert got == want
    assert len(got[2]) > 3  # real multi-pivot bisection
    if mode == "batched":
        stats = tlb.stats()
        assert stats["rounds"] >= 2 and stats["super_batches"] >= 1 and stats["failed_closed"] == 0


@pytest.mark.parametrize("mode", PORT_MODES)
def test_constant_chain_matches(port, mode):
    blocks, _, _ = build_light_chain(20 if mode != "sequential" else 6)
    top = len(blocks)
    want = outcome(lambda: jclient(blocks, sequential=jmode(mode)), top)
    assert outcome(lambda: tclient(blocks, mode), top) == want
    assert want[2] == ([1, top] if mode != "sequential" else list(range(1, top + 1)))


@pytest.mark.parametrize("mode", PORT_MODES)
def test_backwards_and_update(port, mode):
    blocks, _, _ = build_light_chain(10)
    # anchored at 8, height 3 goes down the hash chain
    assert outcome(lambda: tclient(blocks, mode, height=8), 3) == outcome(
        lambda: jclient(blocks, sequential=jmode(mode), height=8), 3)
    jc, tc = jclient(blocks[:7], sequential=jmode(mode)), tclient(blocks[:7], mode)
    jlb, tlb_ = jc.update(), tc.update()
    assert (tlb_.height, tlb_.hash()) == (jlb.height, jlb.hash()) == (7, blocks[6].hash())
    assert tc.store.heights() == jc.store.heights()
    assert tc.update() is None and jc.update() is None  # nothing newer
    assert tc.verify_light_block_at_height(5).hash() == jc.verify_light_block_at_height(5).hash()


def test_wrong_anchor_hash_is_rejected_alike(port):
    blocks, _, _ = build_light_chain(3)
    errors = []
    for make, prov, opts in ((JLightClient, JMemoryProvider, JTrustOptions),
                             (LightClient, MemoryProvider, TrustOptions)):
        chain = blocks if make is JLightClient else [carry.light_block(b) for b in blocks]
        with pytest.raises(Exception) as exc:
            make(CHAIN_ID, opts(period=10 * HOUR, height=1, hash=b"\x01" * 32),
                 prov(CHAIN_ID, chain), [], now=now_at)
        errors.append((type(exc.value).__name__, str(exc.value)))
    assert errors[0] == errors[1]
    assert errors[1][0] == "LightClientError" and "expected header's hash 0101" in errors[1][1]


@pytest.mark.parametrize("mode", PORT_MODES)
def test_forged_target_gives_the_same_error(port, mode):
    blocks = build_rotating_chain(17 if mode != "sequential" else 5)
    top = len(blocks)
    blocks[top - 1].signed_header.commit.signatures[0].signature = bytes(64)
    blocks[top - 1].signed_header.commit._hash = None
    want = outcome(lambda: jclient(blocks, sequential=jmode(mode)), top)
    assert outcome(lambda: tclient(blocks, mode), top) == want
    assert want[0] == "InvalidHeaderError" and "wrong signature" in want[1]


@pytest.mark.parametrize("mode", SKIPPING_MODES)
def test_forged_commit_below_the_accepted_pivot_is_never_read(port, mode):
    """The batched ladder evaluates deeper candidates than the one it
    accepts; a forged commit below the accepted pivot must not poison
    the round (the sequential descent never visits it)."""
    blocks = build_rotating_chain(17)
    blocks[1].signed_header.commit.signatures[0].signature = bytes(64)
    want = outcome(lambda: jclient(blocks), 17)
    got = outcome(lambda: tclient(blocks, mode), 17)
    assert got == want and got[0] == "ok"
    assert 2 not in got[2]


@pytest.mark.parametrize("mode", SKIPPING_MODES)
def test_exact_third_of_trusted_power_bisects(port, mode):
    """Window 6, power 10: height 5 shares 2 validators with height 1,
    exactly the 1/3 trust level's 20, which is not more than it: the
    jump bisects to 3, which shares 3."""
    blocks = build_rotating_chain(8)
    want = outcome(lambda: jclient(blocks), 5)
    assert outcome(lambda: tclient(blocks, mode), 5) == want
    assert want[2] == [1, 3, 5]


@pytest.mark.parametrize("mode", SKIPPING_MODES)
def test_a_missing_pivot_stops_the_descent_alike(port, mode):
    blocks = build_rotating_chain(17)
    del blocks[8]  # height 9, the first pivot
    want = outcome(lambda: jclient(blocks), 17)
    assert outcome(lambda: tclient(blocks, mode), 17) == want
    assert want == ("LightBlockNotFoundError", "no light block at height 9")


@pytest.mark.parametrize("mode", SKIPPING_MODES)
def test_cannot_split_further(port, monkeypatch, mode):
    """The bottom of the descent. An adjacent header never bisects, so
    no honest chain reaches it: every verification is made to ask for a
    deeper pivot, in both packages."""
    blocks = build_rotating_chain(6)

    def jbisect(*args, **kwargs):
        raise jverifier.NewValSetCantBeTrustedError("stub")

    monkeypatch.setattr(jclient_mod.verifier, "verify", jbisect)
    want = outcome(lambda: jclient(blocks), 6)
    if mode == "batched":
        monkeypatch.setattr(tclient_mod.light_batch, "evaluate_candidates",
                            lambda chain_id, base, cands, *a, **kw: [
                                tlb.Outcome(tlb.BISECT, tverifier.NewValSetCantBeTrustedError("stub"))
                                for _ in cands])
    else:
        def tbisect(*args, **kwargs):
            raise tverifier.NewValSetCantBeTrustedError("stub")

        monkeypatch.setattr(tclient_mod.verifier, "verify", tbisect)
    assert outcome(lambda: tclient(blocks, mode), 6) == want == (
        "LightClientError", "bisection failed: cannot split further")


@pytest.mark.parametrize("mode", PORT_MODES)
def test_forked_witness_is_an_attack_with_the_same_evidence(port, mode):
    blocks, _, _ = build_light_chain(10)
    forked, _, _ = build_light_chain(10, fork_at=6)
    jc = jclient(blocks, sequential=jmode(mode), witness_blocks=forked)
    tc = tclient(blocks, mode, witness_jblocks=forked)
    with pytest.raises(JDivergedHeaderError) as jexc:
        jc.verify_light_block_at_height(10)
    with pytest.raises(DivergedHeaderError) as texc:
        tc.verify_light_block_at_height(10)
    jev, tev = jexc.value.evidence, texc.value.evidence
    assert str(texc.value) == str(jexc.value)
    assert texc.value.witness_index == jexc.value.witness_index == 0
    assert tev.hash() == jev.hash()
    assert tev.bytes() == jev.bytes()
    assert (tev.common_height, tev.total_voting_power) == (jev.common_height, jev.total_voting_power)
    assert tev.conflicting_block.height == 10
    # reported to the primary, not to the witness that sent it
    assert [e.hash() for e in tc.primary.evidence] == [e.hash() for e in jc.primary.evidence] == [jev.hash()]
    assert not tc.witnesses[0].evidence
    assert tc.store.heights() == jc.store.heights()  # the target is not saved


@pytest.mark.parametrize("mode", PORT_MODES)
def test_unverifiable_witness_is_dropped_not_an_attack(port, mode):
    blocks, _, _ = build_light_chain(10)
    garbage, _, _ = build_light_chain(10, fork_at=2)
    for lb in garbage:
        for cs in lb.signed_header.commit.signatures:
            cs.signature = bytes(64)
        lb.signed_header.commit._hash = None
    jc = jclient(blocks, sequential=jmode(mode), witness_blocks=garbage)
    tc = tclient(blocks, mode, witness_jblocks=garbage)
    assert tc.verify_light_block_at_height(10).hash() == jc.verify_light_block_at_height(10).hash()
    assert tc.witnesses == [] and jc.witnesses == []
    assert not tc.primary.evidence and not jc.primary.evidence
    assert tc.store.heights() == jc.store.heights()


@pytest.mark.parametrize("mode", SKIPPING_MODES)
def test_honest_witness_adds_no_evidence(port, mode):
    blocks, _, _ = build_light_chain(10)
    tc = tclient(blocks, mode, witness_jblocks=blocks)
    assert tc.verify_light_block_at_height(10).hash() == blocks[9].hash()
    assert len(tc.witnesses) == 1 and not tc.primary.evidence and not tc.witnesses[0].evidence


@pytest.mark.parametrize("mode", PORT_MODES)
def test_a_device_fault_escapes_the_client(port, mode):
    """Host fallback is off: a fault at ``ed25519.chunk`` inside the
    verification (a round's flush, or the sequential verifier's batch)
    raises out of ``verify_light_block_at_height`` as the fault, never as
    an invalid header, and leaves the store as it was. 24 validators, so
    the flushes reach the device tier."""
    jchain, jvset, chain_id = build_header_chain(6, 24)
    jblocks = [JLightBlock(sh, jvset) for sh in jchain]
    client = tclient(jblocks, mode)
    top = 6 if mode != "sequential" else 3
    with fault_injection.inject(site="ed25519.chunk", fail_calls=(1,)):
        with pytest.raises(fault_injection.DeviceFault):
            client.verify_light_block_at_height(top)
    assert client.store.heights() == [1]
    assert device_policy.shared.snapshot()["fallback_batches"] == 0
    # transient: the next verification is answered
    assert client.verify_light_block_at_height(top).hash() == jchain[top - 1].hash()


def test_rounds_run_on_the_package_device_only(port, monkeypatch):
    """Bisection rounds ride the shared scheduler, which verifies on the
    package's device: a client asked to bisect in rounds elsewhere is
    refused when it is made, not when its first round would read as a
    verification failure."""
    blocks, _, _ = build_light_chain(3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="shared scheduler verifies on the package's device cpu, not cuda"):
        LightClient(CHAIN_ID, TrustOptions(period=10 * HOUR, height=1, hash=blocks[0].hash()),
                    MemoryProvider(CHAIN_ID, [carry.light_block(b) for b in blocks]), [], device="cuda")
    # the one-verify-per-pivot loop takes any device; the package's is fine
    for kw in ({"bisect_batching": False, "device": "cpu"}, {"device": "cpu"}):
        c = LightClient(CHAIN_ID, TrustOptions(period=10 * HOUR, height=1, hash=blocks[0].hash()),
                        MemoryProvider(CHAIN_ID, [carry.light_block(b) for b in blocks]), [],
                        now=lambda: carry.timestamp(now_at()), **kw)
        assert c.verify_light_block_at_height(3).hash() == blocks[2].hash()
