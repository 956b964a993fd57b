"""ABCI++: the application boundary; counterpart of :mod:`tendermint_tpu.abci`
(reference: abci/), cut to the in-process client and the kvstore app."""
