"""Crypto layer of the port: ed25519 and sr25519 keys, batch dispatch,
host oracles, Merlin and ristretto255.

Counterpart of :mod:`tendermint_tpu.crypto`, reduced to the paths that
commit verification takes.
"""
