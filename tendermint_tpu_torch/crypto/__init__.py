"""Crypto layer of the port: ed25519 keys, batch dispatch, host oracle.

Counterpart of :mod:`tendermint_tpu.crypto`, reduced to the ed25519
path that commit verification takes.
"""
