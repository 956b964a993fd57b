"""verifyd: the verification service; counterpart of
:mod:`tendermint_tpu.verifyd` without the shared-memory ingress and the
federation.

One process owns the card; nodes, light clients and RPC front-ends send
pk/msg/sig lanes over gRPC, and the daemon funnels every connection into
one shared ``VerifyScheduler`` per algorithm, so batches form across
clients.

- ``protocol`` — the request/response codec, byte-identical to the
  reference's, and the priority classes
- ``server`` — the daemon (priority classes, deadlines, admission,
  brownout ladder, tenants)
- ``client`` — the pooled client and the process-wide remote backend
"""
