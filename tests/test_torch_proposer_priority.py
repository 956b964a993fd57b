"""Proposer rotation in the port beside the JAX package's: the twin of
``tests/test_proposer_priority.py``, and seeded random increments and
change sets held to the JAX ``ValidatorSet`` after every step
(priorities, order, proposer, hash, and each error's message).
Consensus-critical integer math (SURVEY.md section 7): equality is
exact."""

from collections import Counter

import numpy as np
import pytest

pytest.importorskip("torch")

from tendermint_tpu.crypto.keys import Ed25519PrivKey as JEd25519PrivKey
from tendermint_tpu.types.validator import Validator as JValidator
from tendermint_tpu.types.validator_set import ValidatorSet as JValidatorSet
from tendermint_tpu_torch.crypto.keys import Ed25519PrivKey
from tendermint_tpu_torch.types.validator import Validator
from tendermint_tpu_torch.types.validator_set import (
    MAX_TOTAL_VOTING_POWER,
    PRIORITY_WINDOW_SIZE_FACTOR,
    ValidatorSet,
    go_div,
)


def _vals(powers):
    return [Validator(Ed25519PrivKey.from_seed(bytes([i + 1]) * 32).pub_key(), p)
            for i, p in enumerate(powers)]


def _spin(vset, rounds):
    """One proposer per consensus round (increment once per round)."""
    seq = []
    for _ in range(rounds):
        seq.append(vset.get_proposer().address)
        vset.increment_proposer_priority(1)
    return seq


class TestRoundRobin:
    def test_equal_power_rotates_fairly(self):
        seq = _spin(ValidatorSet(_vals([10, 10, 10, 10])), 40)
        assert sorted(Counter(seq).values()) == [10, 10, 10, 10]
        for i in range(0, 40, 4):
            assert len(set(seq[i:i + 4])) == 4

    def test_single_validator_always_proposes(self):
        assert len(set(_spin(ValidatorSet(_vals([5])), 7))) == 1


class TestWeightedSelection:
    def test_frequency_proportional_to_power(self):
        vset = ValidatorSet(_vals([1, 2, 3]))
        by_addr = {v.address: v.voting_power for v in vset.validators}
        counts = Counter(_spin(vset, 6 * 100))
        for addr, n in counts.items():
            assert abs(n - by_addr[addr] * 100) <= 1

    def test_dominant_validator_majority(self):
        assert max(Counter(_spin(ValidatorSet(_vals([100, 1, 1])), 102)).values()) == 100


class TestPriorityInvariants:
    def test_priorities_centered_after_increment(self):
        vset = ValidatorSet(_vals([3, 7, 11]))
        for _ in range(50):
            vset.increment_proposer_priority(1)
            assert abs(sum(v.proposer_priority for v in vset.validators)) < len(vset.validators)

    def test_rescale_window_bound(self):
        vset = ValidatorSet(_vals([1, 1000]))
        cap = PRIORITY_WINDOW_SIZE_FACTOR * vset.total_voting_power()
        for _ in range(100):
            vset.increment_proposer_priority(1)
            prios = [v.proposer_priority for v in vset.validators]
            assert max(prios) - min(prios) <= cap

    def test_increment_times_equals_repeated_single(self):
        a = ValidatorSet(_vals([2, 5, 9]))
        b = ValidatorSet(_vals([2, 5, 9]))
        a.increment_proposer_priority(5)
        for _ in range(5):
            b.increment_proposer_priority(1)
        assert [v.proposer_priority for v in a.validators] == [v.proposer_priority for v in b.validators]
        assert a.get_proposer().address == b.get_proposer().address


class TestSetUpdates:
    def test_new_validator_pays_entry_penalty(self):
        vset = ValidatorSet(_vals([10, 10]))
        vset.increment_proposer_priority(3)
        newcomer = _vals([1, 1, 10])[2]
        vset.update_with_change_set([newcomer])
        joined = next(v for v in vset.validators if v.address == newcomer.address)
        assert joined.proposer_priority < 0
        vset.increment_proposer_priority(1)
        assert vset.get_proposer().address != joined.address

    def test_deterministic_across_copies(self):
        vset = ValidatorSet(_vals([4, 4, 4]))
        assert _spin(vset, 12) == _spin(vset.copy(), 12)


def test_go_division_truncates_toward_zero():
    assert [go_div(a, b) for a, b in ((7, 2), (-7, 2), (7, -2), (-7, -2))] == [3, -3, -3, 3]


# --- seeded random parity with the JAX package ---------------------------------

N_KEYS = 36  # a pool of keys; a set holds up to 30 of them


def _state(tset, jset):
    t = [(v.address, v.voting_power, v.proposer_priority) for v in tset.validators]
    j = [(v.address, v.voting_power, v.proposer_priority) for v in jset.validators]
    return t, j


def _apply_both(tset, jset, fn_t, fn_j):
    """Run a step on both sets: both succeed, or both raise the same
    message (the sets then stay as they were in both)."""
    terr = jerr = None
    try:
        fn_t(tset)
    except ValueError as e:
        terr = str(e)
    try:
        fn_j(jset)
    except ValueError as e:
        jerr = str(e)
    assert terr == jerr
    return terr


@pytest.mark.parametrize("seed", range(6))
def test_random_increments_and_change_sets_match_the_reference(seed):
    rng = np.random.default_rng(1000 + seed)
    seeds = [bytes([7, seed, i]) + bytes(29) for i in range(N_KEYS)]
    tpubs = [Ed25519PrivKey.from_seed(s).pub_key() for s in seeds]
    jpubs = [JEd25519PrivKey.from_seed(s).pub_key() for s in seeds]
    n0 = int(rng.integers(1, 31))
    # powers from 1 to 10^12, so the rescale and the average shift divide
    powers = [int(10 ** rng.uniform(0, 12)) for _ in range(n0)]
    tset = ValidatorSet([Validator(tpubs[i], p) for i, p in enumerate(powers)])
    jset = JValidatorSet([JValidator(jpubs[i], p) for i, p in enumerate(powers)])
    for step in range(20):
        t, j = _state(tset, jset)
        assert t == j, step
        assert tset.hash() == jset.hash()
        assert tset.get_proposer().address == jset.get_proposer().address
        times = int(rng.integers(1, 9))
        _apply_both(tset, jset, lambda s: s.increment_proposer_priority(times),
                    lambda s: s.increment_proposer_priority(times))
        # a change set: updates of members, newcomers, removals (power 0),
        # and now and then a duplicate, a negative or an oversized power
        k = int(rng.integers(1, 6))
        idx = [int(i) for i in rng.choice(N_KEYS, size=k, replace=False)]
        pw = [int(10 ** rng.uniform(0, 12)) if rng.random() < 0.8 else 0 for _ in idx]
        fault = rng.random()
        if fault < 0.05:
            idx.append(idx[0])
            pw.append(5)
        elif fault < 0.1:
            pw[0] = -1
        elif fault < 0.12:
            pw[0] = MAX_TOTAL_VOTING_POWER + 1
        _apply_both(
            tset, jset,
            lambda s: s.update_with_change_set([Validator(tpubs[i], p) for i, p in zip(idx, pw)]),
            lambda s: s.update_with_change_set([JValidator(jpubs[i], p) for i, p in zip(idx, pw)]),
        )
        t, j = _state(tset, jset)
        assert t == j, (step, "after the change set")
    assert _state(tset, jset)[0] == _state(tset, jset)[1]
    assert ValidatorSet.from_proto_bytes(tset.to_proto_bytes()).hash() == jset.hash()
