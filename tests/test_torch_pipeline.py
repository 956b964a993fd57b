"""The port's blocksync pipeline (``parallel/pipeline.py``) against the
JAX package, on the CPU.

A window of 3 blocks under 24 validators is built with the JAX
package's types and carried to the port (``types/carry.py``). On an
ed25519 set, the verdicts and messages of ``verify_commits_pipelined``
must equal the JAX package's, through its default device path and on
the host (``use_device=False``). A window takes at most 3 x 17 = 51
lanes.

On a mixed ed25519 + sr25519 set the port diverges from the JAX
pipeline on purpose: the reference sends every key to the ed25519
verifier, so a valid mixed commit fails there. The port routes each lane
by its key type, and every block's verdict must equal the JAX
``verify_commit_light`` of that block.
"""

import copy
import hashlib

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import tendermint_tpu_torch
from bench.workload import build_header_chain, mixed_key_factory
from tendermint_tpu import types as jtypes
from tendermint_tpu.ops import precompute as jpc
from tendermint_tpu.parallel import pipeline as jpipe
from tendermint_tpu_torch.ops import precompute as tpc, sr25519_batch as tsb
from tendermint_tpu_torch.parallel import pipeline as tpipe
from tendermint_tpu_torch.types import carry
from tests import helpers

N_BLOCKS = 3
N_VALS = 24


@pytest.fixture(autouse=True)
def _cpu_and_clean_caches(monkeypatch):
    monkeypatch.setattr(tendermint_tpu_torch, "DEFAULT_DEVICE", "cpu")
    tpc.reset()
    jpc.reset()
    yield
    tpc.reset()
    jpc.reset()


@pytest.fixture(scope="module")
def ed_chain():
    return build_header_chain(N_BLOCKS, N_VALS)


def _flip(sig: bytes) -> bytes:
    return sig[:40] + bytes([sig[40] ^ 1]) + sig[41:]


def _bad_signature(tasks):
    cs = tasks[1].commit.signatures[5]
    cs.signature = _flip(cs.signature)


def _short_of_power(tasks):
    # 8 absent of 24: 160 of 240 power, not more than 2/3.
    sigs = tasks[2].commit.signatures
    for i in (0, 3, 4, 8, 11, 15, 19, 23):
        sigs[i] = type(sigs[i]).absent()


def _wrong_height(tasks):
    tasks[0].height += 1  # fails _verify_basic_vals_and_commit


def _malformed_signature(tasks):
    cs = tasks[0].commit.signatures[2]
    cs.signature = cs.signature[:63]


CASES = {
    "valid": [],
    "bad_signature": [_bad_signature],
    "short_of_power": [_short_of_power],
    "wrong_height": [_wrong_height],
    "malformed_signature": [_malformed_signature],
    "all_at_once": [_bad_signature, _short_of_power, _wrong_height],
}


def _tasks(jmod, chain, chain_id, vset, mutations=()):
    """The window's tasks of ``jmod`` (a pipeline module) over copies of
    the JAX chain's commits."""
    tasks = [
        jmod.CommitTask(chain_id, vset, sh.commit.block_id, sh.commit.height, copy.deepcopy(sh.commit))
        for sh in chain
    ]
    for mutate in mutations:
        mutate(tasks)
    return tasks


def _carried(tasks):
    return [
        tpipe.CommitTask(t.chain_id, carry.validator_set(t.vals), carry.block_id(t.block_id), t.height,
                         carry.commit(t.commit))
        for t in tasks
    ]


def _verdicts(vs):
    return [(v.ok, type(v.error).__name__ if v.error else None, str(v.error) if v.error else "")
            for v in vs]


@pytest.mark.parametrize("use_device", [None, False], ids=["device", "host"])
@pytest.mark.parametrize("case", list(CASES))
def test_ed25519_window_matches_jax(ed_chain, case, use_device):
    chain, vset, chain_id = ed_chain
    jtasks = _tasks(jpipe, chain, chain_id, vset, CASES[case])
    want = _verdicts(jpipe.verify_commits_pipelined(jtasks, use_device=use_device))
    got = _verdicts(tpipe.verify_commits_pipelined(_carried(jtasks), use_device=use_device))
    assert got == want
    assert len(got) == N_BLOCKS
    assert (case == "valid") == all(ok for ok, _, _ in got)
    if case == "all_at_once":
        assert [name for _, name, _ in got] == [
            "InvalidCommitError", "InvalidCommitError", "NotEnoughVotingPowerError"]
        assert "(#5)" in got[1][2] and "wrong height" in got[0][2]


def _jax_mixed_chain(n_blocks, n_vals):
    """A JAX-package header chain under a set whose keys alternate
    ed25519 / sr25519 (``mixed_key_factory``); the fields of
    ``build_header_chain``."""
    from tendermint_tpu.encoding.canonical import Timestamp

    privs, vset = helpers.make_validators(n_vals, key_factory=mixed_key_factory)
    base_ns = 1_700_000_000_000_000_000
    chain = []
    for h in range(1, n_blocks + 1):
        bid = jtypes.BlockID(hashlib.sha256(b"mixed%d" % h).digest(),
                             jtypes.PartSetHeader(1, hashlib.sha256(b"p%d" % h).digest()))
        commit = helpers.make_commit(bid, h, 0, vset, privs, time_ns=base_ns + h * 1_000_000_000)
        chain.append(jtypes.SignedHeader(header=None, commit=commit))
    return chain, vset, helpers.CHAIN_ID


@pytest.fixture(scope="module")
def mixed_chain():
    return _jax_mixed_chain(2, N_VALS)


@pytest.mark.parametrize("use_device", [None, False], ids=["device", "host"])
@pytest.mark.parametrize("case", ["valid", "bad_sr25519_signature"])
def test_mixed_window_matches_verify_commit_light_per_block(mixed_chain, monkeypatch, case,
                                                            use_device):
    """Diverges from the JAX ``verify_commits_pipelined`` on purpose (it
    checks sr25519 lanes as ed25519, ``parallel/pipeline.py:84-115``):
    each block is held to the JAX ``verify_commit_light`` instead."""
    chain, vset, chain_id = mixed_chain
    jtasks = _tasks(jpipe, chain, chain_id, vset)
    sr_idx = [i for i, v in enumerate(vset.validators) if v.pub_key.type == "sr25519"]
    if case == "bad_sr25519_signature":
        cs = jtasks[1].commit.signatures[sr_idx[2]]
        cs.signature = _flip(cs.signature)
    want = []
    for t in jtasks:
        try:
            jtypes.verify_commit_light(t.chain_id, t.vals, t.block_id, t.height, t.commit)
        except Exception as exc:  # the outcome under comparison
            want.append((False, type(exc).__name__, str(exc)))
        else:
            want.append((True, None, ""))
    calls = []
    real = tsb.verify_kernel_sr
    monkeypatch.setattr(tsb, "verify_kernel_sr", lambda *a: calls.append(a[0].shape[0]) or real(*a))
    got = _verdicts(tpipe.verify_commits_pipelined(_carried(jtasks), use_device=use_device))
    assert got == want
    assert want[0] == (True, None, "")
    if case == "bad_sr25519_signature":
        assert not want[1][0] and f"(#{sr_idx[2]})" in want[1][2]
    else:
        assert want[1] == (True, None, "")
    # The window's sr25519 lanes (about half of 2 x 17) ride one sr25519
    # sub-batch: one padded chunk on the engine, none on the host path.
    assert calls == ([64] if use_device is None else [])
    if case == "valid":
        # The divergence: the JAX pipeline rejects the valid mixed window.
        jv = jpipe.verify_commits_pipelined(jtasks, use_device=False)
        assert not jv[0].ok and "wrong signature" in str(jv[0].error)


def test_mesh_is_not_ported(ed_chain):
    chain, vset, chain_id = ed_chain
    tasks = _carried(_tasks(jpipe, chain, chain_id, vset))
    with pytest.raises(NotImplementedError, match="item 10"):
        tpipe.verify_commits_pipelined(tasks, mesh=object())


def test_empty_window_and_cuda_default(ed_chain, monkeypatch):
    assert tpipe.verify_commits_pipelined([]) == []
    monkeypatch.setattr(tendermint_tpu_torch, "DEFAULT_DEVICE", "cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    chain, vset, chain_id = ed_chain
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        tpipe.verify_commits_pipelined(_carried(_tasks(jpipe, chain, chain_id, vset)))
