"""Carry chain state into the port's types, and build a header chain.

The port imports nothing of the JAX package, so state made there (a
validator set, commits, signed headers) comes across by duck typing:
each function here reads the reference's attribute names
(``validators``, ``pub_key.type``, ``pub_key.bytes()``, ``signatures``,
``block_id.part_set_header`` ...) of any object and builds the port's
type; votes come across the same way. Tests build one chain with the JAX package's types, carry it over,
and feed the same chain to both packages.

:func:`build_header_chain` is the port-side twin of the benchmark's
fixture (``bench/workload.py`` ``build_header_chain``): a signed-header
chain under one validator set, the shape of
light/client_benchmark_test.go's fixture. :func:`build_rotating_chain`
is the twin of the light-client serving tests' chain
(``tests/test_lightd.py`` ``build_rotating_chain``), whose set slides
along a pool of keys, so a skipping walk must bisect through real
pivots.
"""

from __future__ import annotations

import hashlib
from typing import Callable, List, Optional, Sequence, Tuple

from tendermint_tpu_torch.crypto.keys import ED25519_KEY_TYPE, SR25519_KEY_TYPE, Ed25519PubKey, PubKey
from tendermint_tpu_torch.encoding.canonical import Timestamp
from tendermint_tpu_torch.types.block import (
    BLOCK_ID_FLAG_COMMIT,
    BlockID,
    Commit,
    CommitSig,
    Consensus,
    Header,
    PartSetHeader,
    Vote,
)
from tendermint_tpu_torch.types.light import LightBlock, SignedHeader
from tendermint_tpu_torch.types.validator import Validator
from tendermint_tpu_torch.types.validator_set import ValidatorSet

CHAIN_ID = "test-chain"  # the chain id of the reference's test helpers
BASE_NS = 1_700_000_000_000_000_000  # the fixture's genesis time


def pub_key(obj) -> PubKey:
    """A public key of type ``obj.type`` with bytes ``obj.bytes()``."""
    if obj.type == ED25519_KEY_TYPE:
        return Ed25519PubKey(obj.bytes())
    if obj.type == SR25519_KEY_TYPE:
        from tendermint_tpu_torch.crypto.sr25519 import Sr25519PubKey

        return Sr25519PubKey(obj.bytes())
    raise ValueError(f"unknown key type {obj.type}")


def timestamp(obj) -> Timestamp:
    return Timestamp(obj.seconds, obj.nanos)


def block_id(obj) -> BlockID:
    psh = obj.part_set_header
    return BlockID(bytes(obj.hash), PartSetHeader(psh.total, bytes(psh.hash)))


def validator(obj) -> Validator:
    return Validator(pub_key(obj.pub_key), obj.voting_power, bytes(obj.address),
                     obj.proposer_priority)


def validator_set(obj) -> ValidatorSet:
    """The set as it stands: order, priorities and proposer kept."""
    return ValidatorSet.restore(
        [validator(v) for v in obj.validators],
        None if obj.proposer is None else validator(obj.proposer),
    )


def commit(obj) -> Commit:
    return Commit(
        height=obj.height,
        round=obj.round,
        block_id=block_id(obj.block_id),
        signatures=[
            CommitSig(cs.block_id_flag, bytes(cs.validator_address), timestamp(cs.timestamp),
                      bytes(cs.signature))
            for cs in obj.signatures
        ],
    )


def vote(obj) -> Vote:
    """A vote's fields (its pre-verification tags are not carried)."""
    return Vote(
        type=obj.type,
        height=obj.height,
        round=obj.round,
        block_id=block_id(obj.block_id),
        timestamp=timestamp(obj.timestamp),
        validator_address=bytes(obj.validator_address),
        validator_index=obj.validator_index,
        signature=bytes(obj.signature),
        extension=bytes(obj.extension),
        extension_signature=bytes(obj.extension_signature),
    )


def header(obj) -> Header:
    return Header(
        version=Consensus(obj.version.block, obj.version.app),
        chain_id=obj.chain_id,
        height=obj.height,
        time=timestamp(obj.time),
        last_block_id=block_id(obj.last_block_id),
        **{name: bytes(getattr(obj, name)) for name in (
            "last_commit_hash", "data_hash", "validators_hash", "next_validators_hash",
            "consensus_hash", "app_hash", "last_results_hash", "evidence_hash",
            "proposer_address",
        )},
    )


def signed_header(obj) -> SignedHeader:
    return SignedHeader(
        header=None if obj.header is None else header(obj.header),
        commit=None if obj.commit is None else commit(obj.commit),
    )


def light_block(obj) -> LightBlock:
    return LightBlock(
        signed_header=None if obj.signed_header is None else signed_header(obj.signed_header),
        validator_set=None if obj.validator_set is None else validator_set(obj.validator_set),
    )


def _sign_chain(
    sets: Sequence[ValidatorSet],
    secret_of: dict,
    parts_tag: bytes,
    sign_many: Optional[Callable[[List[object], List[bytes]], List[bytes]]],
    chain_id: str,
) -> List[SignedHeader]:
    """``len(sets) - 1`` signed headers; height h under ``sets[h - 1]``,
    whose next set is ``sets[h]``, every validator signing. The fields
    and times of the reference's fixtures; the part-set hash of height h
    is SHA-256(``parts_tag % h``). Every signature is made in one
    ``sign_many(secrets, messages)`` call (default: each secret's
    ``sign``)."""
    hashes = {}
    for vs in sets:
        if id(vs) not in hashes:
            hashes[id(vs)] = vs.hash()
    chain: List[SignedHeader] = []
    last_bid = BlockID()
    for h in range(1, len(sets)):
        vset = sets[h - 1]
        time_ns = BASE_NS + h * 1_000_000_000
        hdr = Header(
            version=Consensus(block=11),
            chain_id=chain_id,
            height=h,
            time=Timestamp.from_unix_ns(time_ns),
            last_block_id=last_bid,
            last_commit_hash=hashlib.sha256(b"lc%d" % h).digest(),
            data_hash=hashlib.sha256(b"d%d" % h).digest(),
            validators_hash=hashes[id(vset)],
            next_validators_hash=hashes[id(sets[h])],
            consensus_hash=hashlib.sha256(b"cp").digest(),
            app_hash=hashlib.sha256(b"app%d" % h).digest(),
            proposer_address=vset.validators[0].address,
        )
        bid = BlockID(hdr.hash(), PartSetHeader(1, hashlib.sha256(parts_tag % h).digest()))
        cmt = Commit(height=h, round=0, block_id=bid, signatures=[
            CommitSig(BLOCK_ID_FLAG_COMMIT, v.address, Timestamp.from_unix_ns(time_ns + i), b"")
            for i, v in enumerate(vset.validators)
        ])
        chain.append(SignedHeader(header=hdr, commit=cmt))
        last_bid = bid
    secrets = [secret_of[v.address] for vs in sets[:-1] for v in vs.validators]
    msgs = [sh.commit.vote_sign_bytes(chain_id, i) for sh in chain
            for i in range(len(sh.commit.signatures))]
    if sign_many is None:
        sigs = [s.sign(m) for s, m in zip(secrets, msgs)]
    else:
        sigs = sign_many(secrets, msgs)
    it = iter(sigs)
    for sh in chain:
        for cs in sh.commit.signatures:
            cs.signature = next(it)
    return chain


def build_header_chain(
    n_heights: int,
    keys: Sequence[Tuple[object, PubKey]],
    sign_many: Optional[Callable[[List[object], List[bytes]], List[bytes]]] = None,
    chain_id: str = CHAIN_ID,
    power: int = 10,
) -> Tuple[List[SignedHeader], ValidatorSet, str]:
    """``n_heights`` signed headers under one set of ``keys``
    (``(secret, public key)`` pairs, each of power ``power``), every
    validator signing every height; the fields and times of
    ``bench/workload.py``'s ``build_header_chain``.

    ``sign_many(secrets, messages)`` signs in bulk (a process pool, for
    a large chain); by default each secret's ``sign``. Every signature of
    the chain is made in one call. Returns (chain, set, chain id).
    """
    vset = ValidatorSet([Validator(pub, power) for _, pub in keys])
    secret_of = {pub.address(): secret for secret, pub in keys}
    chain = _sign_chain([vset] * (n_heights + 1), secret_of, b"p%d", sign_many, chain_id)
    return chain, vset, chain_id


def build_rotating_chain(
    n_heights: int,
    keys: Sequence[Tuple[object, PubKey]],
    window: int = 6,
    slide: int = 1,
    sign_many: Optional[Callable[[List[object], List[bytes]], List[bytes]]] = None,
    chain_id: str = CHAIN_ID,
    power: int = 10,
) -> List[LightBlock]:
    """``n_heights`` light blocks whose set slides ``slide`` keys a
    height along ``keys`` (``(secret, public key)`` pairs, at least
    ``n_heights * slide + window``): height h is signed by keys
    ``[(h - 1) * slide, (h - 1) * slide + window)``, each of power
    ``power``, so heights h and h + k share ``window - k * slide``
    validators. With ``window=6, slide=1`` and the keys of seeds 7000,
    7001, ... it is ``tests/test_lightd.py``'s chain, block for block."""
    if len(keys) < n_heights * slide + window:
        raise ValueError(f"{len(keys)} keys, need {n_heights * slide + window}")
    sets = [
        ValidatorSet([Validator(pub, power) for _, pub in keys[(h - 1) * slide:(h - 1) * slide + window]])
        for h in range(1, n_heights + 2)
    ]
    secret_of = {pub.address(): secret for secret, pub in keys}
    chain = _sign_chain(sets, secret_of, b"parts%d", sign_many, chain_id)
    return [LightBlock(sh, vs) for sh, vs in zip(chain, sets)]
