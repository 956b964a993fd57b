#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

Run from the repository root on a machine with a CUDA GPU:

    python3 chip_smoke.py

It imports only ``tendermint_tpu_torch`` (never jax or the JAX package)
and, in order:

0. set-up: makes every key, message and signature of the run from one
   numpy seed, signing with the port's pure-Python RFC 8032 signer in a
   pool of worker processes (before any CUDA work; timed on its own);
1. device: prints the card and builds the kernels with nvcc (one process
   per source, in parallel);
2. kernels: runs each verify kernel (K1 ``verify``, K2 ``verify_tables``,
   K3 ``verify_resident``) on 1,024 seeded lanes with planted faults and
   ZIP-215 edge cases, on the card, and requires its verdicts to equal
   its plain PyTorch version's lane for lane and, on the faulty lanes and
   a sample of the rest, the host oracle's; then checks kernel against
   plain version again on 1,001 and 4,095 lanes (ragged edges), a
   4,096-lane chunk (the main path's shape: the 1,024 lanes four times,
   each copy rotated) and 16,384 lanes (K2 also on the same tables scaled
   to Z != 1; K3 on a store of the lanes' keys, with its columns in order
   and shuffled); times the kernel at 4,096 and 16,384 lanes and the
   plain version at 4,096 (CUDA events around back-to-back launches; K3
   and K4 through their C launchers, without the wrappers' host work; K3
   also on a store with one column a lane, indices consecutive and
   shuffled, beside ``index_select`` then K2); and prints each kernel's
   registers, stack and shared bytes, and its resident and launched
   warps per SM. K4 (``challenge``) is held to hashlib and
   ``reduce_mod_l`` at the SHA-512 padding boundaries and on prefixed
   challenges of 1-3 blocks at 1,024, 1,001, 4,095 (padded), 4,096 and
   16,384 lanes, and to its plain version; it is timed at 4,096 and
   16,384 lanes of the phase-3 shape. K5 (``verify_sr``, sr25519) runs
   the same checks on 1,024 seeded sr25519 lanes whose k challenges were
   made in the set-up pool, with planted faults (a mutated s, a wrong
   key, a swapped R, the encodings that DECODE rejects at each step, an
   odd R, the identity key, a cleared marker bit, s >= L), against its
   plain version and, on the faulty lanes and a sample of the rest, the
   host ``sr25519.verify``; it is timed at 4,096 and 16,384 lanes;
3. verify_batch: 8,192 lanes from 256 signers with 8 planted bad lanes and
   no activated validator set (K1 and K4, two chunks each), and its
   sigs/s;
4. verify_commit with the resident store on (the default on CUDA): a
   10,000-validator commit (activates the set, builds the tables on the
   host, uploads the store once, K3 over three chunks), a second commit
   at the next height (the steady state: no table builds, no upload),
   its p50 latency, and a third commit with one bad signature, which must
   be rejected at that index. K4 hashes the chunks whose sign-bytes have
   one length; 4b. the same steady commit with the store off (K2 over
   three chunks, the tables shipped each commit), its runs alternating
   with store-on runs, and both p50s;
5. the mixed commit: 10,000 validators whose keys alternate ed25519 /
   sr25519 (the mix of ``bench/workload.py``'s ``mixed_key_factory``),
   through ``verify_commit`` and its ``MultiBatchVerifier``: the ed25519
   half on K3 (and K4 where a chunk's messages share one length), the
   sr25519 half on K5 with its Merlin challenges on the host. One cold
   commit, the p50 of at least 3 steady ones (as many as fit the phase's
   time budget at the Merlin rate measured there), the Merlin share of
   the host time, a host profile, and a copy with one bad sr25519
   signature, which must be rejected at its index;
5c. the three-type commit: 1,000 validators whose keys alternate
   ed25519, sr25519 and secp256k1 (BASELINE config 5 with its third key
   type), through ``verify_commit``: secp256k1 has no batch verifier, so
   the whole commit is verified on the host one signature at a time, as
   in the reference, with no launch; the p50 of 3, and a copy with one
   bad secp256k1 signature, whose message must be the same on the card's
   device and on the CPU;
7. blocksync: a 32-block window under 500 validators through
   ``verify_commits_pipelined`` (K3), every verdict checked, then a small
   mixed window (K5);
8. the light client: ``verify_adjacent`` walks over 16 headers under
   1,000 validators, one non-adjacent ``verify``, and a tampered, an
   expired and an unlinked header;
9. vote ingest through ``VotePreverifier``, the shared scheduler (its
   defaults) and a ``VoteSet``: after verifying height 2's commit (so the
   node holds the 10,000-validator set's tables), 9a delivers height 3's
   10,000 precommits from 4 peer threads, each in its own seeded order
   and held back while the pre-verifier's queue is over half full, with
   3 bad signatures that must be forwarded untagged and rejected; 9b a
   150-validator round with vote extensions, each step's arrivals spread
   over 100 ms. Each part's warm-up must launch a kernel, every valid
   vote must come tagged and reach its ``VoteSet`` (+2/3 for the block),
   and no flush may fail or fall back; it prints time to +2/3 and to
   all, verifier lanes/s, per-vote latency p50/p99, flushes, coalesced
   and cache-answered lanes, the host and device tiers, and launches;
10. the light client's bisection round: ``evaluate_candidates`` from
   header 1 of phase 8's chain to headers 16, 8, 4, 2 and a copy of 8
   with a bad signature, one ``submit_many`` and one flush; each outcome
   must equal the sequential verifier's; a cold round and the p50 of 5,
   beside the p50 of 5 sequential walks over the same candidates;
11. the light client and its serving tier over 16 heights of 1,000
   validators whose set slides 100 a height (so a jump of more than 6
   heights cannot be trusted at 1/3): 11a, ``LightClient`` syncs from
   height 1 to 16 (``MemoryProvider`` primary behind ``RetryingProvider``,
   one honest witness, an empty store) in its three modes, bisection
   rounds (3 rounds, stored heights 1, 4, 10, 16), one verify a pivot
   (the same heights) and the sequential walk (all 16), each cold and 5
   more times with the verdict cache emptied, with rounds, flushes,
   lanes, table builds, store decodes, launches and a host profile; 11b,
   a bad signature on 16 must give one error in all three modes; 11c,
   a ``LightServer`` on 127.0.0.1 answers ``light_header`` over HTTP: a
   cold miss (3 rounds), a hit with the same bytes, 1,024 hits from 8
   threads (latency p50/p99, hits/s) on its event loop (the default
   transport) and 1,024 on a ``ThreadingHTTPServer`` over the same client
   and cache (``evloop=False``), in two turns each, 8 threads on a fresh
   server's cold
   16 (one verification), bad heights (``INVALID_PARAMS``),
   ``light_status`` and ``/metrics``; 11d, a witness with a conflicting
   16 gives ``DivergedHeaderError`` with its evidence at the primary,
   and through lightd ``INTERNAL_ERROR`` with the chain's cache dropped;
12. the main path observed: the port's tracer in ``ring`` mode, one
   ``OpsMetrics`` (and lightd's ``LightMetrics``) in one registry bound
   to every unit, the stage observer and the kernel profiler installed.
   12a, the steady 10,000-validator commit (phase 4's set, its tables
   built in the set-up's pool) with the verdict cache emptied, then
   warm: the span tree (``verify_commit`` > ``verify_batch`` >
   ``cache_lookup`` with 0 then 10,000 hits, one ``prep_chunk``,
   ``dispatch_chunk`` and ``collect_chunk`` a K3 chunk, no
   ``host_fallback``), the stage
   histogram against the stage spans, the store and cache counters
   against ``stats()``, and the byte ledger against the store tensor,
   ``memstats()`` and ``torch.cuda.memory_allocated()``; 12f, 5 steady
   commits with the instruments off against 5 with them on, in turns;
   12e, ``torch.profiler`` (CPU and CUDA) over one steady commit and
   one 8,192-lane batch: the kernels it saw against the launches
   counted, the device-busy share of the wall, the top device
   operations and the longest idle gaps with the tracer span open on
   the host at each, the Chrome traces written under ``--trace-dir``
   (default ``build``); 12b, the mixed commit once (sr25519 spans
   against K5 launches); 12c, a fault on one chunk with host fallback
   off (it escapes) and on (``host_fallback`` span lanes, the fallback
   counter and ``snapshot()`` agree; the transition instants equal the
   counter); 12d, phase 11's lightd with the ops metrics in its
   registry: a cold ``light_header`` whose request carries a ``trace``
   member, ``/metrics``, ``/debug/traces?format=chrome`` (the serve's
   ``verify_batch`` spans in the request's trace under
   ``rpc_dispatch``) and ``/debug/memstats``;
13. verifyd on the card (``verifyd/server.py`` and its client): 13a, an
   in-process ``VerifydServer`` with the reference's defaults and
   ``vclient.set_remote_addr``: phase 4's 10,000-validator commit through
   ``verify_commit`` over the zero-copy shm ingress (``shm.set_shm_mode
   ("on")``) and over TCP (``"off"``), three requests of at most 4,096
   lanes each way, one cold TCP run then 3 of each in turns with
   the in-process path, the bad commit rejected with the in-process
   error's message over both; every lane sent over shm counted by the
   server and the client, no torn slab, no shm fallback, K3 on both
   transports; 13b,
   four clients at once on a server with room for the mix (admission
   cap, ``max_pending`` and tenant cap 16,384, service budget 60 s; the
   reference's defaults shed a 667-lane light request outright):
   consensus (phase 4's
   commits, 10,000 lanes a call), blocksync (phase 7's blocks, 334 lanes
   a request), light (phase 8's headers, 667) and sr25519 (phase 7's
   mixed window, 64, K5), each with planted bad lanes; every verdict
   must equal the in-process one, some flush must mix clients, and
   nothing may be shed, answered on the host or fail; per-class p50/p99
   and the lanes/s the server verified; 13c, ``brownout.force(1..5)``:
   rpc, light and blocksync shed in that order, consensus never, and
   host-direct (counted) at rungs 4 and 5; after ``force(None)``
   consensus launches again; a fault at ``ed25519.chunk`` with host
   fallback off reaches the client as ``STATUS_INTERNAL``, not as
   verdicts; 13d, set-less traffic from phase 3's 256 signers seen 3
   times under two tenants of 128 pins: K1, then the store (K3), pins
   within quota and the ledger's tenant rows summing to the store's
   bytes; 13e, ``python -m tendermint_tpu_torch verifyd --shard-id 0
   --shards A,B`` as a child process, started beside 13f's shard 1 (the
   two share the card): phase 8's header commits (its verdicts equal
   the in-process ones; three warm-ups over TCP, which pin the set's keys
   and build their tables, then 3 over shm and 3 over TCP in turns) and ``verify_commit`` from this process (2 over each, in
   turns), its STATS_PATH snapshot (with its own launch counts and shm
   counters), ``/metrics``, and, after 13f, SIGTERM, which must leave a
   flight-recorder dump (``tendermint-tpu-flightrec/1``) holding its
   served ``verifyd_*`` spans; 13f, federation: a ``FederationClient``
   over both shards (TCP hops, so every response carries its shard id)
   routes phase 7's 500-validator committee (config 4), phase 8's 1,000
   (config 3) and 16 of phase 3's set-less signers a round (32 lanes
   each), 3 rounds: every verdict right, the shard ids, the pinned
   slices each round's traffic added disjoint and inside their routes,
   each shard's lanes and K1/K3 launches; ``verifyd stats --shards``
   prints both shards and the fleet roll-up; then shard 1 is SIGKILLed
   and the next round fails over (``failovers`` >= 1, ``route_epoch``
   bumped, no lane on the host). One card: this is placement and
   failover, not a speed-up;
14. a node syncing (BASELINE config 4 as a node runs it): a source chain
   of 65 heights under 500 validators (powers from the seed in [1, 100],
   200 kvstore txs a block, 10 powers changed at height 33, each commit
   signed by the first 90% of the set), built and signed height by
   height in the set-up; then fresh followers (state from the genesis
   JSON, fresh stores and app) sync 64 blocks through
   ``BlockSyncer(device=)`` and ``BlockExecutor`` onto the kvstore app:
   one cold run, 3 timed runs (blocks/s against 90, the split across the
   pipeline, ``validate_block`` and its ``verify_commit`` with its
   verdict-cache hits, FinalizeBlock and the saves, launches a block),
   each checked against the source (block IDs, the app hash, validator
   sets and proposers from height 33), and a run with two faulty peers,
   each of which must be banned while the follower still converges: one
   corrupts a signature of block 20's LastCommit (the window refuses
   it), the other serves block 40 with a forged AppHash that its set
   signed (the window passes it; ``validate_block`` refuses it, and it
   is never saved);
15. a validator of BASELINE config 2 committing blocks: 150 ed25519
   validators of power 10 on the kvstore app, Tendermint's default
   timeouts, vote extensions from height 1, 200 kvstore txs a block. The
   node under test (a ``FilePV`` and a ``WAL`` in a temporary directory,
   ``MemDB`` stores, ``LocalClient`` over ``KVStoreApplication``, a
   ``TxMempool`` a client thread feeds each height's txs at the block
   rate, with a repeat and a tx the app refuses, an ``EvidencePool``,
   ``BlockExecutor(device=)``, ``ConsensusState`` behind a
   ``VotePreverifier``) proposes height 2 from its mempool; a harness
   plays the other 149 as honest, reactive peers: it proposes their
   rounds from the node's committed state, answers each of the node's
   votes with 134 votes of the same type and block (signed in a spawn
   pool of its own, submitted through the pre-verifier over 100 ms in a
   seeded order, precommits with the app's extension), leaves 15
   validators silent, sends a
   corrupted precommit every height, and withholds the proposal of
   height 9's round 0, which then commits in round 1. One validator
   sends two prevotes at height 4: the node's pool builds and verifies
   that evidence through the shared scheduler once 4 commits, and height
   5's proposal carries it; height 6's carries an equivocation at 5 the
   node never saw (``check_evidence`` verifies it); a round-0 proposal
   from height 10 on repeats the committed evidence and draws a nil
   prevote. 16 heights, a restart from the stores, the WAL and the
   ``FilePV`` with the caches emptied (the ``Handshaker`` replaying the
   blocks to a fresh app), and 2 more. Checked: the commit rounds, the
   mempool's answers, the evidence carried, verified once each,
   committed and given to FinalizeBlock, every stored commit on the card,
   a fresh executor replaying the chain to the same app and validator
   hashes, no corrupted precommit in a vote set or a commit, the WAL's
   end-height markers, no second signature at an (height, round, step),
   the device tier and K3 or K1 after the restart. It prints per height
   the commit round, the decision time and the launches and tiers, and
   the block interval, the finalize split, the vote latencies, the
   pre-verifier's and the scheduler's counts, the step durations, the
   harness's signing seconds, the client's check_tx latency and the
   pool's verify times;
16. evidence and the mempool: 16a, phase 11d's light client attack into
   fresh ``EvidencePool``s over stores filled from phase 11's honest
   light blocks (5 runs, the verdict cache emptied, 1,000-validator lanes
   on K3 or K1; K4 declines their chunks, whose sign-bytes have two
   lengths; three tampered copies refused; a second node's
   pool passes a block carrying it); 16b, validators of just over 1/3 of
   the power of phase 14's chain double-sign a precommit, their
   evidence delivered to one pool from 8 threads (one more with a bad
   signature, refused), then all of it in one block through a fresh
   node's ``validate_block``; 16c, a ``TxMempool`` with the reference's
   defaults filled with 5,000 45-byte kvstore txs from 4 threads, reaped
   at the default block max_bytes, updated with 2,000 and the other
   3,000 rechecked (no launch);
17. nodes on the port's p2p stack: 17a, cluster-4 (the e2e CI manifest
   cut to what the port has): four validators of power 10 with the
   default consensus params and a full node that starts at height 4 and
   block-syncs in, each a ``Node`` with a ``LocalClient`` kvstore on one
   ``MemoryNetwork``, found through one persistent peer and PEX; kvstore
   txs through ``Node.submit_tx`` at 3 a second on the connected nodes
   in turn until height 10; checked: the five stores agree on every block
   and app hash, every tx committed once, the full node synced through
   its ``BlockSyncReactor`` and switched to consensus, no ``Node.failed``;
   it prints the block interval (mean, σ, min, max), the
   submit-to-committed latency and the launches and tiers. 17b,
   node-p2p-sync-64x500 (BASELINE config 4 as a node joins): phase 14's
   source chain served by two peers, each in a process of its own (a
   ``Router`` over ``TCPTransport``, SecretConnection and MConnection at
   the default rates, a ``BlockSyncReactor(syncer=None)`` over a copy of
   the source's store) to fresh ``Node``s (non-validator, block sync,
   memdb, no WAL, a new node key) that sync 64 blocks and switch to
   consensus: one cold run (table builds, store uploads), 3 timed runs
   with the verdict cache emptied (blocks/s from ``Node.start()`` to the
   caught-up event, beside phase 14's in-process rate; the handshakes,
   the node's and the peers' seal and open, fetch and decode, the
   pipeline, ``validate_block``, FinalizeBlock and the saves; bytes by
   channel; no table build), a run with a third peer that corrupts a
   signature of one block (banned, the block never saved), the health
   machine checked, and a run with a permanent device fault after the
   first window (the ``DeviceFault`` in ``Node.failed``, raised by
   ``Node.stop()``, no later block saved, the health machine showing
   that failure alone; reset after, as phase 6 does); then a block's
   store load, proto encode and decode and its frames' seal and open,
   timed on one thread; each node indexes its blocks (``tx_index``, the
   default), and the split has the kv sink's seconds (``index``);
18. the node's RPC: 18b, rpc-cluster-4, runs inside 17a while its five
   nodes are up, each serving its RPC: four client threads send
   ``broadcast_tx_commit`` over HTTP, one validator each, at 3 txs/s
   together for 10 more heights (every answer must carry the height its
   tx was committed at), a websocket client subscribed to NewBlock on
   the full node must see every height from its subscription on once,
   in order, and ``tx_search("tx.height=h")`` on every node must find
   each block's txs once and ``tx?hash=`` with ``prove=true`` every tx of
   18b, its proof checking against the block's DataHash (no kernel: the
   commits stay on the host tier); 18a, rpc-light-proxy-64x500
   (BASELINE config 4 as a light client follows a full node): two of
   17b's fresh nodes, which synced phase 14's chain with their RPC on
   (its last timed run's and its corrupting-peer run's), stay up as the
   primary and a witness; a ``LightProxy`` in this process
   (``HTTPProvider`` primary and witness, trust at height 1 from the
   primary's ``/commit``, the default bisection) answers
   ``/commit?height=h`` for h = 2 ... 64 in order over HTTP, each checked
   against the primary's header and commit and verified on the card
   inside its own request (a K3 launch, lanes verified and none answered
   by the verdict cache, which is emptied first, no lane on the host
   tier, device-tier lanes where the proxy's verification is tiered), then
   ``/validators`` at 64 (500, with the change at 33) and
   ``/abci_query`` of the last key block 64 wrote; answers/s, p50, p99
   and the split of a request (the primary's HTTP and decode, the
   verification, the witness check); the same walk with ``sequential``
   over heights 2-9, checked the same way; the health machine checked;
   a wrapper over the witness's RPC serving phase 14's
   forged block 40 (the height is refused, ``LightClientAttackEvidence``
   reaches the primary's pool, which verifies it on the card); a device
   fault at ``ed25519.chunk`` (an ``INTERNAL_ERROR`` naming
   ``DeviceFault``, never the header; the health machine reset after, as
   phase 6 does); then ``python -m tendermint_tpu_torch light`` and
   ``lightd`` in processes of their own on the card, each answering
   height 64 with the primary's header;
19. the node's files, state sync, remote signers and app processes:
   19a, statesync-join-64x500: two port nodes in processes of their own
   (started while the kernels build and ready before phase 2, so that
   their start overlaps no measured phase; idle until phase 19), each
   reopening a home of ``filedb-c`` stores written from phase 14's
   source chain (its handshake replays the 65 blocks into a kvstore app
   that takes a snapshot every 40 heights), serve over encrypted TCP on
   the CPU (serving verifies nothing); a fresh node on
   ``filedb-c`` with state sync on (trust anchor: height 1 and its header
   hash, backfill on) restores the snapshot at 40 after its light walk
   1 -> 40 -> 41 -> 42 across the change at 33 (verified on the card:
   K1 for a set not yet activated, K3 after, K4; no lane on the host
   tier), then block-syncs 41-64 and converges with the source; its
   seconds to caught up beside phase 14's block-sync time, the walk's
   lanes and launches, the snapshot's bytes and chunks, blocks/s after
   the join; 19b, restart-rollback-64x500: a node on ``filedb-c``
   block-syncs to 32 from a peer process serving 33 blocks and stops;
   ``rollback_state`` takes its stores back to 31; a new ``Node`` on the
   home and a fresh app replays 1-31 and re-applies 32 through
   ``apply_block`` (its LastCommit verified on the card), then syncs
   33-64 from 19a's servers and converges;
20. the operator's way into a node, every node a process of its own
   started from the shell: 20a, cli-start-64x500: ``python -m
   tendermint_tpu_torch --home H init``, config 4's genesis in place of
   init's, ``[p2p] persistent_peers`` set to 19a's two servers and
   ``[rpc] laddr`` to a free port (``init`` runs beside 19b; ``filedb``,
   state sync off: init's
   defaults), then ``start`` with no ``--device``: it block-syncs 64
   heights over encrypted TCP; the seconds from spawn to 64 on its RPC's
   ``/status`` and blocks/s beside 17b's rate; block hash and app hash at
   64 over the RPC equal the source's, its ``/metrics`` show no fallback
   lane, a healthy card and ed25519 dispatches and first launches, and
   the ``kernel launches`` line it prints when SIGTERM stops it (exit 0)
   counts K3 and K4; 20b, stopped-home-tools: ``rollback`` (state at 63,
   the source's app hash), ``inspect`` (63), ``start`` again (the
   handshake re-applies 64 on the card: K3 or K1, and K4, in its printed
   launches; its state back at the source's 64), ``debug dump`` against
   it, SIGTERM (exit 0), then on the stopped home ``compact-db``,
   ``key-migrate`` to ``filedb-py`` (``inspect`` of the copy prints the
   same JSON), ``reindex-event`` after the kv index is deleted
   (``tx_search`` over ``inspect --serve`` answers as the running node
   did) and ``wal2json``; the tools run in this process through
   ``cli.main`` (19a's servers stop after 20a, 19b's peer after 19b);
   20c, e2e-ci, in a thread beside 20b (so 20b's times are taken beside
   its processes): the port's e2e runner on
   ``tendermint_tpu_torch/e2e/networks/ci.toml`` (``wait_heights`` cut
   from 6 to 2, the tx load to 1 s before and after the perturbations)
   with every node on the card (``--device cuda``): four
   validators (validator1 signing
   through the socket signer in a process of its own and killed,
   validator2 through the gRPC signer with its app behind the gRPC ABCI
   transport and paused, validator3 on ``filedb`` with the persistent
   kvstore, restarted and disconnected) and a full node starting at 4;
   ``Runner.test()``'s checks, then 19c's (which 20c replaces) over the
   last 50 heights: the last 8 agreed on by all four validators and
   every validator's signature in a commit; the block interval beside
   17a's and each
   perturbation's recovery seconds (4-lane commits go to the host tier
   by policy; each node's vote pre-verifier warm-up probe launches K1
   and K4);
6. faults, after the main path, on batches of 256 ed25519 and 128
   sr25519 lanes with bad lanes among them. With host fallback off (the
   default), a transient fault injected at ``ed25519.chunk``,
   ``ed25519.collect`` and ``sr25519.chunk`` must escape the engine after
   the health machine recorded it, with no lane answered on the host and
   the next batch back on the card; a sticky ``CudaError`` 719 must
   disable the card and both engines must then refuse. With host fallback
   on, the same transient faults and a permanent one: every verdict must
   stay right, the host-fallback lanes counted must be the chunk's, and
   the health machine must come back to healthy after the next success
   (or stay disabled, with the batch answered on the host); a hand-built
   ``CudaError`` 700 must classify permanent and 2 transient. Last, the
   flight recorder installed in this process: transient faults on the
   retry budget's worth of batches escalate the card to cooldown, and
   the transition dumps the ring with reason ``device_cooldown``.

Phases 15-18 ride the RPC's default transport, the event loop, as the
reference's nodes do; their lines name it.

Kernel launch counts are reset just before phase 3 and read just after
phase 4b (K1-K4), and again around each of phases 5 (K5, and the
ed25519 kernels of the mixed commit), 5c, 7, 8, 9, 10, 11, 12, 13 (whose
count is that of the served requests only: each sub-phase's deltas around
what a server answered, without the in-process references, plus the
shard daemons' own of 13e and 13f), 14 and 15, around 16a-c together, around 17a-b
together (less 18b's, which runs inside 17a), around 18 (18a's from
its walk on, after its nodes' sync, and 18b's) and around each of 19a
and 19b; phase 20's are its child processes' own, from the line each
``start`` prints when it stops (their sum is the table's
``launches_cli``). After each
of these the health machine
must show no host fallback, no transition and the healthy state (in
phase 13 after 13b, and after 13c has reset it). Each phase prints one JSON line; then the kernel table,
the card's ``nvidia-smi`` name and power limit, and last
``{"ok": true, "device": {...}}``. Any failure exits non-zero before the
last line. Without CUDA it exits with code 2 and prints no result.
"""

from __future__ import annotations

import copy
import hashlib
import json
import multiprocessing
import os
import queue
import shutil
import signal
import statistics
import subprocess
import sys
import threading
import time

import numpy as np

SEED = 20261016
KERNEL_LANES = 1024
KERNEL_SIGNERS = 64
TIMING_LANES = 4096
WIDE_TIMING_LANES = 16384
RAGGED_LANES = (1001, TIMING_LANES - 1)
BATCH_LANES = 8192
BATCH_SIGNERS = 256
COMMIT_VALIDATORS = 10_000
COMMIT_HEIGHTS = (1, 2, 3)  # cold, steady state, bad signature
BAD_COMMIT_INDEX = 4321
CHAIN_ID = "chip-smoke"
P50_REPS = 9
STORE_OFF_REPS = 7
BATCH_REPS = 5
TABLE_BYTES = 8 * 4 * 32  # one key's (8, 4, 32) uint8 table column
HASH_LENGTHS = (0, 55, 56, 64, 111, 112, 128)  # SHA-512 padding boundaries
HASH_MSG_LEN_BY_BLOCKS = {1: 40, 2: 120, 3: 250}  # after the 64-byte R || A prefix
MIXED_VALIDATORS = 10_000
MIXED_MIN_REPS = 3  # steady mixed commits, at least
MIXED_MAX_REPS = 9
MIXED_BUDGET_S = 60.0  # phase 5's wall time the repetitions are sized to (so the script keeps its time limit)
FAULT_ED_LANES = 256
FAULT_SR_LANES = 128
# Phase 7, bench/sections.py run_blocksync's shape: a 32-block window
# under 500 validators of equal power.
SYNC_BLOCKS = 32
SYNC_VALIDATORS = 500
SYNC_REPS = 5
SYNC_BAD_BLOCK, SYNC_BAD_INDEX = 9, 200  # a bad signature among the first 334 signers
SYNC_SHORT_BLOCK = 20  # a block short of +2/3
MIXED_SYNC_BLOCKS = 2
MIXED_SYNC_VALIDATORS = 64
# Phase 8, bench/sections.py run_light_client's shape: 16 headers under
# 1,000 validators, walked with verify_adjacent.
LIGHT_HEADERS = 16
LIGHT_VALIDATORS = 1000
LIGHT_REPS = 5
LIGHT_TRUSTING_PERIOD_S = 86400.0
LIGHT_MAX_CLOCK_DRIFT_S = 10.0
LIGHT_BAD_HEADER, LIGHT_BAD_INDEX = 5, 100
# Phase 9, vote ingest. 9a: the precommits of phase 4's 10,000 validators
# for height 3 (the signatures of its third commit), each delivered by
# VOTE_PEERS peer threads in their own seeded order, three of them bad.
# 9b: one round of BASELINE config 2's size, 150 validators with vote
# extensions on, the arrivals of each step spread over ROUND_SPREAD_S.
VOTE_PEERS = 4
VOTE_EXTRA_BAD = 17  # beside BAD_COMMIT_INDEX and COMMIT_VALIDATORS - VOTE_EXTRA_BAD
VOTE_WAIT_S = 300.0  # the longest a part may take before it fails
ROUND_VALIDATORS = 150
ROUND_HEIGHT = 7
ROUND_SPREAD_S = 0.1
# Phase 10: phase 8's chain, one evaluate_candidates round from header 1
# to headers 16, 8, 4 and 2 and a copy of header 8 with one bad signature
# in the trusting pass.
LIGHT_ROUND_CANDIDATES = (16, 8, 4, 2)
LIGHT_ROUND_BAD_INDEX = 200
LIGHT_ROUND_REPS = 5
# Phase 11: the light client and its serving tier (BASELINE config 3 as
# users run it, through light/client.py and light/lightd.py): 16 heights
# of 1,000 validators whose set slides 100 validators a height, so
# heights h and h + k share 1,000 - 100k validators and the 1/3 trust
# level trusts a jump of at most 6: skipping from 1 to 16 bisects in 3
# rounds and stores heights 1, 4, 10 and 16.
LIGHTD_HEADERS = 16
LIGHTD_VALIDATORS = 1000
LIGHTD_SLIDE = 100
LIGHTD_STORE_HEIGHTS = [1, 4, 10, 16]
LIGHTD_ROUNDS = 3
LIGHTD_REPS = 5
LIGHTD_BAD_INDEX = 300  # inside the +2/3 pass of every mode
LIGHTD_HERD = 8  # threads asking for one cold height at once
LIGHTD_HIT_THREADS = 8
# A transport's hits: the event loop's, then the threaded server's; a
# multiple of LIGHTD_HIT_TURNS x LIGHTD_HIT_THREADS, and few enough that,
# with phase 19, the whole script stays well inside its time limit.
LIGHTD_HIT_REQUESTS = 1024
LIGHTD_HIT_TURNS = 2  # 11c's hits alternate between the transports in this many turns each

# Phase 5c: BASELINE config 5 with its third key type, a commit of
# THREE_TYPE_VALIDATORS validators whose keys alternate ed25519, sr25519
# and secp256k1. secp256k1 has no batch verifier, so the whole commit is
# verified on the host, one signature at a time, as in the reference.
THREE_TYPE_VALIDATORS = 1000
THREE_TYPE_REPS = 3
THREE_TYPE_BAD_FROM = 100  # the bad copy's secp256k1 signature, early so its run stops soon
# Phase 14: BASELINE config 4 as a node runs it, through BlockSyncer and
# BlockExecutor onto the kvstore app: NODE_VALIDATORS validators, powers
# from the seed in [1, 100], a source chain of NODE_HEIGHTS heights (so
# NODE_SYNC_TO blocks can be synced), NODE_TXS kvstore txs a block of 45
# bytes over NODE_ACCOUNTS keys, a val: tx for each of NODE_CHANGED
# validators at NODE_CHANGE_HEIGHT, each commit signed by the first
# NODE_SIGN_SHARE of the set by index. Cut from 10,000 blocks.
NODE_VALIDATORS = 500
NODE_HEIGHTS = 65
NODE_SYNC_TO = NODE_HEIGHTS - 1
NODE_TXS = 200
NODE_ACCOUNTS = 4096
NODE_CHANGE_HEIGHT = 33
NODE_CHANGED = 10
NODE_SIGN_SHARE = 0.9
NODE_REPS = 3
NODE_CORRUPT_HEIGHT = 20  # a peer corrupts signature 0 of this block's LastCommit
NODE_FORK_HEIGHT = 40  # a peer serves this block with a forged AppHash, signed by its set
NODE_GENESIS_NS = 1_700_000_000_000_000_000
NODE_BLOCKS_PER_S_LIMIT = 90.0  # phase 7's limit, the Go CPU rate
NODE_MAX_STEPS = 20_000
# Phase 15: BASELINE config 2 as a validator runs it: CONSENSUS_VALIDATORS
# ed25519 validators of power 10 on the kvstore app, ConsensusParams()
# defaults (Tendermint's timeouts) with vote extensions from height 1,
# CONSENSUS_TXS kvstore txs a block over CONSENSUS_ACCOUNTS keys. The node
# under test proposes height 2; the harness plays the rest, the last
# CONSENSUS_SILENT by index silent, one sending a corrupted precommit
# every height, and the proposer of CONSENSUS_NIL_HEIGHT's round 0
# withholding its proposal. CONSENSUS_HEIGHTS heights, a restart, then
# CONSENSUS_RESTART_HEIGHTS more. Cut from an open-ended chain. The node
# runs a TxMempool (a client thread submits each height's txs, one
# repeat and one the app refuses) and an EvidencePool: a harness
# validator sends two prevotes at CONSENSUS_EQUIVOCATION_HEIGHT and the
# next height's proposal carries the evidence, made as the node's pool
# makes it; the proposal of CONSENSUS_UNSEEN_HEIGHT carries an
# equivocation at the height before that the node never saw; the first
# height from CONSENSUS_REPEAT_FROM whose rounds 0 and 1 a harness
# validator proposes repeats the committed evidence in round 0.
CONSENSUS_VALIDATORS = 150
CONSENSUS_SILENT = 15
CONSENSUS_HEIGHTS = 16
CONSENSUS_RESTART_HEIGHTS = 2
CONSENSUS_NIL_HEIGHT = 9
CONSENSUS_TXS = 200
CONSENSUS_ACCOUNTS = 4096
CONSENSUS_SPREAD_S = ROUND_SPREAD_S  # a step's votes arrive over this, as in 9b
CONSENSUS_SIGNERS = 4  # the harness's spawn pool
CONSENSUS_TIMEOUTS = None  # a TimeoutParams, or None for the defaults
CONSENSUS_HEIGHT_WAIT_S = 120.0  # the longest a height may take
CONSENSUS_EQUIVOCATION_HEIGHT = 4
CONSENSUS_UNSEEN_HEIGHT = 6
CONSENSUS_REPEAT_FROM = 10

# Phases 16a-c: evidence and the mempool. 16a (BASELINE config 3): phase
# 11d's light client attack into fresh pools over stores filled from
# phase 11's honest light blocks, ATTACK_REPS times, then three tampered
# copies and a second node's pool. 16b (config 4): validators holding
# just over 1/3 of the power of phase 14's chain double-sign a precommit
# at EQUIVOCATION_HEIGHT; their evidence (and one with a bad signature)
# reaches one pool from EQUIVOCATION_THREADS threads, then all of it one
# block through a fresh node's validate_block. 16c: the reference's
# mempool defaults filled with MEMPOOL_TXS of phase 14's 45-byte kvstore
# txs from MEMPOOL_THREADS threads, reaped at BlockParams' max_bytes, and
# updated with MEMPOOL_COMMITTED of them (the rest rechecked).
ATTACK_REPS = 5
EQUIVOCATION_HEIGHT = NODE_SYNC_TO - 4
EQUIVOCATION_THREADS = 8
MEMPOOL_TXS = 5000
MEMPOOL_THREADS = 4
MEMPOOL_COMMITTED = 2000
MEMPOOL_REAP_BYTES = 22_020_096
# Phase 17a, cluster-4: the e2e CI manifest (tendermint_tpu/e2e/networks/
# ci.toml) cut to what the port has: four validators and a full node that
# starts at height 4, kvstore txs at the manifest's load_tx_per_sec, on
# the port's MemoryNetwork, until height 10 (so that, with phases 19 and 20, the
# whole script stays well inside its time limit). Default consensus params.
CLUSTER_CHAIN_ID = "ci-e2e"
CLUSTER_VALIDATORS = 4
CLUSTER_POWER = 10
CLUSTER_START_AT = 4
CLUSTER_HEIGHTS = 10
CLUSTER_TX_PER_S = 3.0
CLUSTER_WAIT_S = 120.0  # the longest a wait of the phase may take
# Phase 17b, node-p2p-sync-64x500: phase 14's source chain served over
# encrypted TCP by two peers to fresh nodes (BASELINE config 4 as a node
# joins its network).
P2P_SYNC_PEERS = 2
P2P_SYNC_REPS = 3
P2P_SYNC_WAIT_S = 120.0
# Phase 18a, rpc-light-proxy-64x500: two fresh nodes hold phase 14's chain
# (BASELINE config 4) and serve their RPC; a light proxy follows them.
# 18b, rpc-cluster-4: phase 17a's nodes with their RPC on.
RPC_TRUSTING_PERIOD_S = 10 * 365 * 86400.0  # the chain's genesis time is in 2023
RPC_CLI_WAIT_S = 300.0  # a command's start on the card: torch, CUDA, its first verification
RPC_SEQUENTIAL_TO = 9  # the sequential walk's last height (the default walk's runs to NODE_SYNC_TO)
RPC_CLUSTER_THREADS = 4
RPC_CLUSTER_HEIGHTS = 10
# Phase 19a, statesync-join-64x500: phase 14's chain (BASELINE config 4)
# served by nodes whose apps snapshot every 40 heights; 19b,
# restart-rollback-64x500: a node synced to 32, rolled back to 31 and
# restarted from its files.
STATESYNC_SERVERS = 2
STATESYNC_SNAPSHOT_INTERVAL = 40
STATESYNC_BACKFILL = 10  # headers below the snapshot, verified backwards (the change at 33 among them)
ROLLBACK_SYNC_TO = 32
PHASE19_WAIT_S = 120.0  # the longest a wait of the phase may take
PHASE19_BUDGET_S = 60.0  # the seconds the phase may add to the script
# Phase 20a, cli-start-64x500: a node made by `init` and run by `start`
# from the shell, block-syncing phase 14's chain (BASELINE config 4) from
# 19a's servers; 20b, stopped-home-tools: its rollback, inspect, restart
# and the stopped home's tools; 20c, e2e-ci: the port's runner on
# networks/ci.toml (in place of 19c: its four validators, with the
# manifest's late full node and perturbations).
CLI_WAIT_S = 180.0  # the longest a wait of 20a-b may take: a process's start on the card, its sync
CLI_STOP_S = 60.0
E2E_WAIT_HEIGHTS = 2  # cut from ci.toml's 6 to hold phase 20's budget
E2E_LOAD_S = (1.0, 1.0)  # the runner's tx load before and after the perturbations (its own run(): 3 s, 2 s)
E2E_CHECK_HEIGHTS = 8  # heights the four validators must agree on (19c's)
E2E_WINDOW = 50  # the heights below the tip whose commits and times 20c reads
PHASE20_BUDGET_S = 90.0  # the seconds the phase may add to the script

# Field squarings and multiplies per lane, as counted in the source note
# of csrc/ed25519_verify.cu. A multiply is 100 32x32->64-bit products and
# a squaring 55, each product two 32-bit integer multiplies.
SQS_PER_LANE = {"verify": 1546, "verify_tables": 1291, "verify_resident": 1291, "verify_sr": 1538}
MULS_PER_LANE = {"verify": 2107, "verify_tables": 1960, "verify_resident": 1960, "verify_sr": 2103}
INT32_MULS_PER_FE_SQ = 110
INT32_MULS_PER_FE_MUL = 200
INT32_OPS_PER_SM_CLOCK = 64  # CUDA programming guide, compute capability 9.0
# 32-bit integer instructions a SHA-512 block, as counted in the source
# note of csrc/sha512_challenge.cu.
INT32_OPS_PER_SHA512_BLOCK = 3696
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
# Bytes a lane must move: each input row read once, the verdict written once.
BYTES_PER_LANE = {
    "verify": 4 * 32 + 1,
    "verify_tables": TABLE_BYTES + 1 + 3 * 32 + 1,
    "verify_resident": 4 + TABLE_BYTES + 1 + 3 * 32 + 1,
    "verify_sr": 4 * 32 + 1,
}
REPLACES = {
    "verify": "tendermint_tpu/ops/pallas_verify.py:443",
    "verify_tables": "tendermint_tpu/ops/pallas_verify.py:498",
    "verify_resident": "tendermint_tpu/ops/ed25519_batch.py:341",
    "challenge": "tendermint_tpu/ops/hash512.py:298",
    "verify_sr": "tendermint_tpu/ops/sr25519_batch.py:122",
}
SOURCES = {
    "verify": "tendermint_tpu_torch/csrc/ed25519_verify.cu",
    "verify_tables": "tendermint_tpu_torch/csrc/ed25519_verify.cu",
    "verify_resident": "tendermint_tpu_torch/csrc/ed25519_verify.cu",
    "challenge": "tendermint_tpu_torch/csrc/sha512_challenge.cu",
    "verify_sr": "tendermint_tpu_torch/csrc/ed25519_verify.cu",
}


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def host_profile(fn, top: int = 30) -> dict:
    """One call of ``fn`` under cProfile: the functions with the largest
    cumulative time, as {"file:function": ms}, and the profiled wall ms.
    The profiler slows Python code, so read the shares, not the sums."""
    import cProfile
    import pstats

    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    fn()
    prof.disable()
    wall_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(pstats.Stats(prof).stats.items(), key=lambda kv: -kv[1][3])
    out = {}
    for (path, _, func), (_, _, _, cum, _) in rows:
        label = f"{os.path.basename(path)}:{func}" if path != "~" else func
        if label not in out and "chip_smoke" not in path and "cProfile" not in label:
            out[label] = cum * 1e3
        if len(out) == top:
            break
    return {"profiled_wall_ms": wall_ms, "cumulative_ms": out}


def cuda_ms(fn, reps: int, rounds: int = 3) -> float:
    """Device time of one ``fn()``: CUDA events around ``reps`` calls
    back to back (so the host's time between calls hides behind the
    device's), divided by ``reps``; the median of ``rounds`` such runs."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


# --- set-up: keys, messages, signatures ---------------------------------------


def _keypair(seed: bytes):
    from tendermint_tpu_torch.crypto import ed25519_ref as ref

    return ref.keypair_from_seed(seed)


def _sign(job):
    from tendermint_tpu_torch.crypto import ed25519_ref as ref

    priv, msg = job
    return ref.sign(priv, msg)


def _sr_keypair(seed: bytes):
    """An sr25519 seed's expanded secret (scalar, nonce, public key) and
    its public key."""
    from tendermint_tpu_torch.crypto import sr25519 as sr

    scalar, nonce = sr.expand_seed(seed)
    pub = sr.compress(sr.pt_mul(scalar, sr.B_POINT))
    return (scalar, nonce, pub), pub


def _sign_sr(job):
    from tendermint_tpu_torch.crypto import sr25519 as sr

    expanded, msg, entropy = job
    return sr.sign(b"", msg, _expanded=expanded, entropy=entropy)


def _sr_challenge(job):
    from tendermint_tpu_torch.ops import sr25519_batch as tsb

    msg, pub, r = job
    return tsb._challenge_row(msg, pub, r).tobytes()


def _secp_keypair(seed: bytes):
    """A secp256k1 secret from 32 seed bytes, and its compressed key."""
    from tendermint_tpu_torch.crypto import secp256k1

    secret = int.from_bytes(seed, "big") % (secp256k1.N - 1) + 1
    return secret, secp256k1.public_key(secret)


def _sign_secp(job):
    from tendermint_tpu_torch.crypto import secp256k1

    secret, msg = job
    return secp256k1.sign(secret, msg)


def _table(pk: bytes):
    from tendermint_tpu_torch.ops import precompute

    return (pk, *precompute.build_table(pk))


class Signer:
    """Pure-Python key generation and signing spread over a process pool."""

    def __init__(self, pool):
        self.pool = pool

    def keys(self, rng, n):
        seeds = [bytes(rng.integers(0, 256, 32, dtype=np.uint8)) for _ in range(n)]
        return self.pool.map(_keypair, seeds, chunksize=64)

    def sign(self, privs, msgs):
        return self.pool.map(_sign, list(zip(privs, msgs)), chunksize=64)

    def sr_keys(self, rng, n):
        seeds = [bytes(rng.integers(0, 256, 32, dtype=np.uint8)) for _ in range(n)]
        return self.pool.map(_sr_keypair, seeds, chunksize=64)

    def sr_sign(self, rng, expanded, msgs):
        """sr25519 signatures, the RNG's entropy of each drawn from ``rng``."""
        jobs = [(e, m, bytes(rng.integers(0, 256, 32, dtype=np.uint8)))
                for e, m in zip(expanded, msgs)]
        return self.pool.map(_sign_sr, jobs, chunksize=64)

    def sr_challenges(self, msgs, pks, rs):
        """The Merlin challenge rows k of sr25519 lanes, as 32 bytes each."""
        return self.pool.map(_sr_challenge, list(zip(msgs, pks, rs)), chunksize=64)

    def secp_keys(self, rng, n):
        seeds = [bytes(rng.integers(0, 256, 32, dtype=np.uint8)) for _ in range(n)]
        return self.pool.map(_secp_keypair, seeds, chunksize=64)

    def secp_sign(self, secrets, msgs):
        return self.pool.map(_sign_secp, list(zip(secrets, msgs)), chunksize=64)

    def tables(self, vset):
        """The host tables ``(pk, table, ok)`` of ``vset``'s keys, built as
        ``precompute.build_table`` builds them."""
        return self.pool.map(_table, [v.pub_key.bytes() for v in vset.validators], chunksize=64)


def fault_lanes(rng, signer):
    """KERNEL_LANES lanes from KERNEL_SIGNERS signers; every 8th lane
    carries one of eight faults or ZIP-215 edge cases. Returns pks, msgs,
    sigs and the faulty lane indices."""
    from tendermint_tpu_torch.crypto import ed25519_ref as ref

    keys = signer.keys(rng, KERNEL_SIGNERS)
    pks = [keys[i % KERNEL_SIGNERS][1] for i in range(KERNEL_LANES)]
    msgs = [bytes(rng.integers(0, 256, 100, dtype=np.uint8)) for _ in range(KERNEL_LANES)]
    sigs = signer.sign([keys[i % KERNEL_SIGNERS][0] for i in range(KERNEL_LANES)], msgs)
    ident = (1).to_bytes(32, "little")
    s0 = 12345
    r0 = ref.pt_compress(ref.pt_mul(s0, ref.B_POINT))
    sig215 = r0 + s0.to_bytes(32, "little")
    faulty = list(range(3, KERNEL_LANES, 8))
    for j, i in enumerate(faulty):
        kind = j % 8
        if kind == 0:  # bad s (still canonical)
            s = (int.from_bytes(sigs[i][32:], "little") + 1) % ref.L
            sigs[i] = sigs[i][:32] + s.to_bytes(32, "little")
        elif kind == 1:  # tampered message
            msgs[i] = msgs[i][:-1] + bytes([msgs[i][-1] ^ 1])
        elif kind == 2:  # R replaced by another lane's
            sigs[i] = sigs[i - 1][:32] + sigs[i][32:]
        elif kind == 3:  # wrong key
            pks[i] = pks[i - 1]
        elif kind == 4:  # identity key: R = [s]B verifies for any message
            pks[i], msgs[i], sigs[i] = ident, b"x", sig215
        elif kind == 5:  # non-canonical encoding P + 1 of the identity
            pks[i], msgs[i], sigs[i] = (ref.P + 1).to_bytes(32, "little"), b"x", sig215
        elif kind == 6:  # s >= L: the host check rejects it
            pks[i], msgs[i], sigs[i] = ident, b"x", r0 + (s0 + ref.L).to_bytes(32, "little")
        else:  # off-curve R (y = 2)
            sigs[i] = bytes([2] + [0] * 31) + sigs[i][32:]
    return pks, msgs, sigs, faulty


# The faults planted in sr25519 lanes, in the order plant_sr_faults cycles
# through them.
SR_FAULT_KINDS = (
    "mutated_s", "wrong_key", "swapped_r", "non_square_a", "odd_r", "t_negative_a",
    "y_zero_a", "identity_a", "marker_cleared", "s_not_below_l",
)


def sr_edge_encodings():
    """Encodings below p and even that ristretto255 DECODE rejects, one
    for each step that can reject: {"non_square_a", "t_negative_a",
    "y_zero_a": 32 bytes}. p - 1 gives y = 0; the others are the first
    of a fixed hash sequence that fails at that step."""
    from tendermint_tpu_torch.crypto import ristretto as rist

    p = rist.P
    found = {"y_zero_a": (p - 1).to_bytes(32, "little")}
    i = 0
    while len(found) < 3:
        s = int.from_bytes(hashlib.sha256(b"sr-edge-%d" % i).digest(), "little")
        s = (s & ((1 << 255) - 1)) & ~1
        i += 1
        if s >= p:
            continue
        ss = s * s % p
        u1, u2 = (1 - ss) % p, (1 + ss) % p
        v = (-(rist.D * u1 * u1) - u2 * u2) % p
        square, inv = rist.invsqrt(v * u2 * u2 % p)
        if not square:
            found.setdefault("non_square_a", s.to_bytes(32, "little"))
            continue
        x = rist._abs(2 * s * inv * u2)
        y = u1 * (inv * inv * u2 * v) % p
        if rist._is_negative(x * y) and y:
            found.setdefault("t_negative_a", s.to_bytes(32, "little"))
    return found


def plant_sr_faults(pks, msgs, sigs, lanes):
    """Plant SR_FAULT_KINDS, cycled, into sr25519 lanes ``lanes`` (in
    place; lane i - 1 must be a valid lane of another signer). Returns
    {lane: kind}. Every kind is rejected but "identity_a": the identity
    key with R = [s]B verifies for any message."""
    from tendermint_tpu_torch.crypto import ristretto as rist

    edges = sr_edge_encodings()

    def marked(s: int) -> bytes:
        return (s | 1 << 255).to_bytes(32, "little")

    s0 = 12345
    kinds = {}
    for j, i in enumerate(lanes):
        kind = SR_FAULT_KINDS[j % len(SR_FAULT_KINDS)]
        s = int.from_bytes(sigs[i][32:], "little") & ((1 << 255) - 1)
        if kind == "mutated_s":
            sigs[i] = sigs[i][:32] + marked((s + 1) % rist.L)
        elif kind == "wrong_key":
            pks[i] = pks[i - 1]
        elif kind == "swapped_r":
            sigs[i] = sigs[i - 1][:32] + sigs[i][32:]
        elif kind == "odd_r":
            sigs[i] = bytes([sigs[i][0] ^ 1]) + sigs[i][1:]
        elif kind == "identity_a":
            pks[i] = bytes(32)
            sigs[i] = rist.compress(rist.pt_mul(s0, rist.B_POINT)) + marked(s0)
        elif kind == "marker_cleared":
            sigs[i] = sigs[i][:32] + s.to_bytes(32, "little")
        elif kind == "s_not_below_l":
            sigs[i] = sigs[i][:32] + marked(s + rist.L)
        else:
            pks[i] = edges[kind]
        kinds[i] = kind
    return kinds


def batch_lanes(rng, signer):
    """BATCH_LANES lanes, signers cycled as in bench/workload.py, with 8
    planted bad lanes. Returns pks, msgs, sigs and the expected verdicts."""
    keys = signer.keys(rng, BATCH_SIGNERS)
    msgs = [bytes(rng.integers(0, 256, 120, dtype=np.uint8)) for _ in range(BATCH_LANES)]
    pks = [keys[i % BATCH_SIGNERS][1] for i in range(BATCH_LANES)]
    sigs = signer.sign([keys[i % BATCH_SIGNERS][0] for i in range(BATCH_LANES)], msgs)
    bad = sorted(rng.choice(BATCH_LANES, 8, replace=False).tolist())
    for j, i in enumerate(bad):
        if j % 2:
            msgs[i] = msgs[i][:-1] + bytes([msgs[i][-1] ^ 0x80])
        else:
            sigs[i] = sigs[i][:40] + bytes([sigs[i][40] ^ 1]) + sigs[i][41:]
    want = np.ones(BATCH_LANES, dtype=bool)
    want[bad] = False
    return pks, msgs, sigs, want


def commit_workload(rng, signer):
    """A COMMIT_VALIDATORS-validator set and one fully signed commit per
    height in COMMIT_HEIGHTS; the last one gets a bad signature at
    BAD_COMMIT_INDEX."""
    from tendermint_tpu_torch.crypto.keys import Ed25519PubKey
    from tendermint_tpu_torch.encoding.canonical import Timestamp
    from tendermint_tpu_torch.types.block import (
        BLOCK_ID_FLAG_COMMIT,
        BlockID,
        Commit,
        CommitSig,
        PartSetHeader,
    )
    from tendermint_tpu_torch.types.validator import Validator
    from tendermint_tpu_torch.types.validator_set import ValidatorSet

    keys = signer.keys(rng, COMMIT_VALIDATORS)
    vset = ValidatorSet([Validator(Ed25519PubKey(pub), 10) for _, pub in keys])
    priv_by_addr = {Ed25519PubKey(pub).address(): priv for priv, pub in keys}
    privs = [priv_by_addr[v.address] for v in vset.validators]
    block_id = BlockID(hashlib.sha256(b"block").digest(),
                       PartSetHeader(1, hashlib.sha256(b"parts").digest()))
    commits = []
    for height in COMMIT_HEIGHTS:
        ns = 1_700_000_000_000_000_000 + height * 10**9
        commit = Commit(height=height, round=0, block_id=block_id)
        commit.signatures = [
            CommitSig(BLOCK_ID_FLAG_COMMIT, v.address, Timestamp.from_unix_ns(ns + i), b"")
            for i, v in enumerate(vset.validators)
        ]
        msgs = [commit.vote_sign_bytes(CHAIN_ID, i) for i in range(COMMIT_VALIDATORS)]
        for cs, sig in zip(commit.signatures, signer.sign(privs, msgs)):
            cs.signature = sig
        commits.append(commit)
    bad = commits[-1].signatures[BAD_COMMIT_INDEX]
    bad.signature = bad.signature[:40] + bytes([bad.signature[40] ^ 1]) + bad.signature[41:]
    return vset, block_id, commits


def sr_fault_lanes(rng, signer):
    """KERNEL_LANES sr25519 lanes from KERNEL_SIGNERS signers; every 8th
    lane carries one of SR_FAULT_KINDS. The k challenges are made in the
    pool. Returns pks, msgs, sigs, {faulty lane: kind} and the k rows."""
    keys = signer.sr_keys(rng, KERNEL_SIGNERS)
    pks = [keys[i % KERNEL_SIGNERS][1] for i in range(KERNEL_LANES)]
    msgs = [bytes(rng.integers(0, 256, 100, dtype=np.uint8)) for _ in range(KERNEL_LANES)]
    sigs = signer.sr_sign(rng, [keys[i % KERNEL_SIGNERS][0] for i in range(KERNEL_LANES)], msgs)
    kinds = plant_sr_faults(pks, msgs, sigs, range(3, KERNEL_LANES, 8))
    ks = signer.sr_challenges(msgs, pks, [sig[:32] for sig in sigs])
    return pks, msgs, sigs, kinds, ks


def mixed_commit_workload(rng, signer):
    """A MIXED_VALIDATORS-validator set whose keys alternate ed25519 /
    sr25519 in the order they are made (bench/workload.py's
    mixed_key_factory), one commit signed by all, and a copy of it with a
    bad signature at the first sr25519 validator from BAD_COMMIT_INDEX on.
    Returns the set, the block id, the commit, the bad copy and its bad
    index."""
    from tendermint_tpu_torch.crypto.keys import Ed25519PubKey
    from tendermint_tpu_torch.crypto.sr25519 import Sr25519PubKey
    from tendermint_tpu_torch.encoding.canonical import Timestamp
    from tendermint_tpu_torch.types.block import (
        BLOCK_ID_FLAG_COMMIT,
        BlockID,
        Commit,
        CommitSig,
        PartSetHeader,
    )
    from tendermint_tpu_torch.types.validator import Validator
    from tendermint_tpu_torch.types.validator_set import ValidatorSet

    ed = signer.keys(rng, MIXED_VALIDATORS // 2)
    sr = signer.sr_keys(rng, MIXED_VALIDATORS - MIXED_VALIDATORS // 2)
    secret_of = {}  # address -> ed25519 private key or sr25519 expanded secret
    vals = []
    for i in range(MIXED_VALIDATORS):
        secret, raw = ed[i // 2] if i % 2 == 0 else sr[i // 2]
        pub = Ed25519PubKey(raw) if i % 2 == 0 else Sr25519PubKey(raw)
        secret_of[pub.address()] = secret
        vals.append(Validator(pub, 10))
    vset = ValidatorSet(vals)
    block_id = BlockID(hashlib.sha256(b"mixed-block").digest(),
                       PartSetHeader(1, hashlib.sha256(b"mixed-parts").digest()))
    commit = Commit(height=1, round=0, block_id=block_id)
    ns = 1_700_000_000_000_000_000
    commit.signatures = [
        CommitSig(BLOCK_ID_FLAG_COMMIT, v.address, Timestamp.from_unix_ns(ns + i), b"")
        for i, v in enumerate(vset.validators)
    ]
    is_sr = [v.pub_key.type == "sr25519" for v in vset.validators]
    msgs = [commit.vote_sign_bytes(CHAIN_ID, i) for i in range(MIXED_VALIDATORS)]
    for want_sr, sign in ((False, signer.sign), (True, lambda e, m: signer.sr_sign(rng, e, m))):
        idx = [i for i in range(MIXED_VALIDATORS) if is_sr[i] == want_sr]
        sigs = sign([secret_of[vset.validators[i].address] for i in idx], [msgs[i] for i in idx])
        for i, sig in zip(idx, sigs):
            commit.signatures[i].signature = sig
    bad_index = next(i for i in range(BAD_COMMIT_INDEX, MIXED_VALIDATORS) if is_sr[i])
    bad = copy.deepcopy(commit)
    sig = bad.signatures[bad_index].signature
    bad.signatures[bad_index].signature = sig[:40] + bytes([sig[40] ^ 1]) + sig[41:]
    return vset, block_id, commit, bad, bad_index


def chain_workload(rng, signer, n_heights, n_vals, mixed=False):
    """A signed-header chain of ``n_heights`` under ``n_vals`` validators
    (``types/carry.py``'s twin of bench/workload.py's build_header_chain),
    signed in the pool. With ``mixed`` the keys alternate ed25519 /
    sr25519 as they are made (bench/workload.py's mixed_key_factory)."""
    from tendermint_tpu_torch.crypto.keys import Ed25519PubKey
    from tendermint_tpu_torch.crypto.sr25519 import Sr25519PubKey
    from tendermint_tpu_torch.types import carry

    if mixed:
        ed = signer.keys(rng, n_vals - n_vals // 2)
        sr = signer.sr_keys(rng, n_vals // 2)
        keys = [(ed[i // 2][0], Ed25519PubKey(ed[i // 2][1])) if i % 2 == 0
                else (sr[i // 2][0], Sr25519PubKey(sr[i // 2][1])) for i in range(n_vals)]
    else:
        keys = [(priv, Ed25519PubKey(pub)) for priv, pub in signer.keys(rng, n_vals)]

    def sign_many(secrets, msgs):
        """ed25519 secrets are private-key bytes, sr25519 ones expanded tuples."""
        sigs = [None] * len(msgs)
        for is_ed, sign in ((True, signer.sign), (False, lambda e, m: signer.sr_sign(rng, e, m))):
            idx = [i for i, sec in enumerate(secrets) if isinstance(sec, bytes) == is_ed]
            if idx:
                for i, sig in zip(idx, sign([secrets[i] for i in idx], [msgs[i] for i in idx])):
                    sigs[i] = sig
        return sigs

    return carry.build_header_chain(n_heights, keys, sign_many, chain_id=CHAIN_ID)


def three_type_workload(rng, signer):
    """BASELINE config 5 with secp256k1: THREE_TYPE_VALIDATORS validators
    whose keys alternate ed25519, sr25519 and secp256k1 in the order they
    are made, one commit signed by all, and a copy of it with a bad
    signature at the first secp256k1 validator from THREE_TYPE_BAD_FROM
    on. Returns the set, the block id, the commit, the bad copy and its
    bad index."""
    from tendermint_tpu_torch.crypto.keys import Ed25519PubKey, Secp256k1PubKey
    from tendermint_tpu_torch.crypto.sr25519 import Sr25519PubKey
    from tendermint_tpu_torch.encoding.canonical import Timestamp
    from tendermint_tpu_torch.types.block import (
        BLOCK_ID_FLAG_COMMIT,
        BlockID,
        Commit,
        CommitSig,
        PartSetHeader,
    )
    from tendermint_tpu_torch.types.validator import Validator
    from tendermint_tpu_torch.types.validator_set import ValidatorSet

    n = THREE_TYPE_VALIDATORS
    made = {
        "ed25519": (signer.keys(rng, (n + 2) // 3), Ed25519PubKey, signer.sign),
        "sr25519": (signer.sr_keys(rng, (n + 1) // 3), Sr25519PubKey,
                    lambda e, m: signer.sr_sign(rng, e, m)),
        "secp256k1": (signer.secp_keys(rng, n // 3), Secp256k1PubKey, signer.secp_sign),
    }
    order = ("ed25519", "sr25519", "secp256k1")
    secret_of = {}
    vals = []
    for i in range(n):
        keys, cls, _ = made[order[i % 3]]
        secret, raw = keys[i // 3]
        pub = cls(raw)
        secret_of[pub.address()] = secret
        vals.append(Validator(pub, 10))
    vset = ValidatorSet(vals)
    block_id = BlockID(hashlib.sha256(b"three-type-block").digest(),
                       PartSetHeader(1, hashlib.sha256(b"three-type-parts").digest()))
    commit = Commit(height=1, round=0, block_id=block_id)
    commit.signatures = [
        CommitSig(BLOCK_ID_FLAG_COMMIT, v.address, Timestamp.from_unix_ns(NODE_GENESIS_NS + i), b"")
        for i, v in enumerate(vset.validators)
    ]
    msgs = [commit.vote_sign_bytes(CHAIN_ID, i) for i in range(n)]
    for key_type in order:
        idx = [i for i, v in enumerate(vset.validators) if v.pub_key.type == key_type]
        sigs = made[key_type][2]([secret_of[vset.validators[i].address] for i in idx], [msgs[i] for i in idx])
        for i, sig in zip(idx, sigs):
            commit.signatures[i].signature = sig
    bad_index = next(i for i in range(THREE_TYPE_BAD_FROM, n)
                     if vset.validators[i].pub_key.type == "secp256k1")
    bad = copy.deepcopy(commit)
    sig = bad.signatures[bad_index].signature
    bad.signatures[bad_index].signature = sig[:40] + bytes([sig[40] ^ 1]) + sig[41:]
    return vset, block_id, commit, bad, bad_index


class _TxSource:
    """The mempool contract BlockExecutor reaps a block's txs from
    (``state/execution.py`` ``Mempool``): one height's txs."""

    def __init__(self, txs):
        self.txs = txs

    def lock(self):
        pass

    def unlock(self):
        pass

    def reap_max_bytes_max_gas(self, max_bytes, max_gas):
        return self.txs

    def update(self, *args, **kwargs):
        pass

    def remove_tx_by_key(self, key):
        pass


def node_env(genesis_json, dev):
    """A node from a genesis document: its state, fresh ``MemDB`` block and
    state stores, a fresh kvstore app behind ``LocalClient`` (InitChain
    run), and a ``BlockExecutor`` on ``dev`` whose block times step one
    second from the genesis time."""
    from tendermint_tpu_torch.abci import types as abci
    from tendermint_tpu_torch.abci.client import LocalClient
    from tendermint_tpu_torch.abci.kvstore import KVStoreApplication
    from tendermint_tpu_torch.encoding.canonical import Timestamp
    from tendermint_tpu_torch.state import StateStore, state_from_genesis
    from tendermint_tpu_torch.state.execution import BlockExecutor
    from tendermint_tpu_torch.storage.blockstore import BlockStore
    from tendermint_tpu_torch.storage.kv import MemDB
    from tendermint_tpu_torch.types.genesis import GenesisDoc

    state = state_from_genesis(GenesisDoc.from_json(genesis_json))
    client = LocalClient(KVStoreApplication())
    client.start()
    state.app_hash = client.init_chain(abci.RequestInitChain(chain_id=state.chain_id, initial_height=1)).app_hash
    state_store = StateStore(MemDB())
    state_store.save(state)
    clock = [state.last_block_time.to_unix_ns()]

    def now():
        clock[0] += 10**9
        return Timestamp.from_unix_ns(clock[0])

    return BlockExecutor(state_store, client, BlockStore(MemDB()), now=now, device=dev), state


def node_chain_workload(rng, signer):
    """Phase 14's source chain, built as a proposing node builds it and
    signed in the pool, height by height (a block's hash covers the
    previous commit's signatures): ``create_proposal_block`` from
    NODE_TXS kvstore txs (plus the val: txs at NODE_CHANGE_HEIGHT),
    ``apply_block`` onto the source's kvstore app (the source made the
    block, so it marks it validated, as ``validate_block`` marks a block
    it checked: nothing is verified here, before CUDA), and a commit
    signed by the first NODE_SIGN_SHARE of the height's set by index, the
    rest absent. Beside it, a fork: block NODE_FORK_HEIGHT with a forged
    AppHash, committed by the same signers, and the next block carrying
    that commit, so the pair passes the window and only
    ``validate_block`` can refuse it. Returns the genesis JSON, the
    source's executor, its state at NODE_SYNC_TO, the changed validators,
    the fork's blocks as proto bytes by height and the private keys by
    address."""
    import base64

    from tendermint_tpu_torch.crypto.keys import Ed25519PubKey
    from tendermint_tpu_torch.encoding.canonical import Timestamp
    from tendermint_tpu_torch.types.block import (
        BLOCK_ID_FLAG_COMMIT,
        BLOCK_PART_SIZE_BYTES,
        Block,
        BlockID,
        Commit,
        CommitSig,
        ExtendedCommit,
    )
    from tendermint_tpu_torch.types.genesis import GenesisDoc, GenesisValidator
    from tendermint_tpu_torch.types.part_set import PartSet

    keys = signer.keys(rng, NODE_VALIDATORS)
    powers = [int(p) for p in rng.integers(1, 101, NODE_VALIDATORS)]
    priv_of = {Ed25519PubKey(pub).address(): priv for priv, pub in keys}
    genesis_json = GenesisDoc(
        chain_id=CHAIN_ID,
        genesis_time=Timestamp.from_unix_ns(NODE_GENESIS_NS),
        validators=[GenesisValidator(Ed25519PubKey(pub), p) for (_, pub), p in zip(keys, powers)],
    ).to_json()
    changed = {int(i): (powers[i] + int(rng.integers(1, 99))) % 100 + 1
               for i in rng.choice(NODE_VALIDATORS, NODE_CHANGED, replace=False)}
    val_txs = [b"val:%s!%d" % (base64.b64encode(keys[i][1]), p) for i, p in changed.items()]
    executor, state = node_env(genesis_json, "cpu")

    def signed_commit(h, block_id, vset, ns):
        n_sign = int(len(vset) * NODE_SIGN_SHARE)
        commit = Commit(height=h, round=0, block_id=block_id, signatures=[
            CommitSig(BLOCK_ID_FLAG_COMMIT, v.address, Timestamp.from_unix_ns(ns + 1 + i), b"")
            if i < n_sign else CommitSig.absent()
            for i, v in enumerate(vset.validators)
        ])
        msgs = [commit.vote_sign_bytes(CHAIN_ID, i) for i in range(n_sign)]
        sigs = signer.sign([priv_of[v.address] for v in vset.validators[:n_sign]], msgs)
        for cs, sig in zip(commit.signatures, sigs):
            cs.signature = sig
        return commit

    ec = ExtendedCommit()
    state_at = None
    fork = {}
    for h in range(1, NODE_HEIGHTS + 1):
        accts = rng.integers(0, NODE_ACCOUNTS, NODE_TXS)
        txs = [b"acct-%05d=%s" % (a, rng.bytes(17).hex().encode()) for a in accts]
        if h == NODE_CHANGE_HEIGHT:
            txs[:len(val_txs)] = val_txs
        executor.mempool = _TxSource(txs)
        block = executor.create_proposal_block(h, state, ec, state.validators.get_proposer().address)
        parts = PartSet.from_data(block.to_proto_bytes(), BLOCK_PART_SIZE_BYTES)
        block_id = BlockID(block.hash(), parts.header())
        executor._validate_cache.add(block.hash())
        state = executor.apply_block(state, block_id, block)
        vset = state.last_validators
        ns = block.header.time.to_unix_ns()
        commit = signed_commit(h, block_id, vset, ns)
        if h == NODE_FORK_HEIGHT:
            forged = Block.from_proto_bytes(block.to_proto_bytes())
            forged.header.app_hash = hashlib.sha256(b"forged" + forged.header.app_hash).digest()
            forged_parts = PartSet.from_data(forged.to_proto_bytes(), BLOCK_PART_SIZE_BYTES)
            forged_commit = signed_commit(h, BlockID(forged.hash(), forged_parts.header()), vset, ns)
            fork[h] = forged.to_proto_bytes()
        elif h == NODE_FORK_HEIGHT + 1:
            successor = Block.from_proto_bytes(block.to_proto_bytes())
            successor.last_commit = forged_commit
            fork[h] = successor.to_proto_bytes()
        executor.block_store.save_block(block, parts, commit)
        ec = ExtendedCommit.wrap_commit(commit)
        if h == NODE_SYNC_TO:
            state_at = state
    return genesis_json, executor, state_at, changed, fork, priv_of


def equivocation_workload(rng, signer, source):
    """Phase 16b's votes, signed in the pool: at EQUIVOCATION_HEIGHT of
    phase 14's source chain, validators in a seeded order until their
    power passes a third of the set's, each with a precommit for the
    height's block and one for another block; and one more validator's
    pair whose second signature is corrupted. Returns the height, the
    pairs, the bad pair and the equivocators' power."""
    from tendermint_tpu_torch.encoding.canonical import SIGNED_MSG_TYPE_PRECOMMIT, Timestamp
    from tendermint_tpu_torch.types.block import BlockID, PartSetHeader, Vote

    _, src_exec, _, _, _, priv_of = source
    h = EQUIVOCATION_HEIGHT
    vset = src_exec.state_store.load_validators(h)
    meta = src_exec.block_store.load_block_meta(h)
    order = [int(i) for i in rng.permutation(len(vset))]
    chosen, power = [], 0
    while 3 * power <= vset.total_voting_power():
        chosen.append(order[len(chosen)])
        power += vset.validators[chosen[-1]].voting_power
    pairs = []
    for k, i in enumerate(chosen + [order[len(chosen)]]):
        other = BlockID(hashlib.sha256(b"equivocation %d" % i).digest(),
                        PartSetHeader(1, hashlib.sha256(b"equivocation parts %d" % i).digest()))
        ts = Timestamp.from_unix_ns(meta.header.time.to_unix_ns() + 1 + k)
        pairs.append([Vote(type=SIGNED_MSG_TYPE_PRECOMMIT, height=h, round=0, block_id=bid, timestamp=ts,
                           validator_address=vset.validators[i].address, validator_index=i)
                      for bid in (meta.block_id, other)])
    votes = [v for pair in pairs for v in pair]
    sigs = signer.sign([priv_of[v.validator_address] for v in votes], [v.sign_bytes(CHAIN_ID) for v in votes])
    for v, sig in zip(votes, sigs):
        v.signature = sig
    bad = pairs.pop()
    bad[1].signature = bad[1].signature[:40] + bytes([bad[1].signature[40] ^ 1]) + bad[1].signature[41:]
    return h, pairs, bad, power


def round_workload(rng, signer):
    """BASELINE config 2's round: ROUND_VALIDATORS validators, a prevote
    and a non-nil precommit with a signed vote extension from each, for
    one block at ROUND_HEIGHT. Returns the set, the block id, the
    prevotes and the precommits (the port's votes, in validator order)."""
    from tendermint_tpu_torch.crypto.keys import Ed25519PubKey
    from tendermint_tpu_torch.encoding.canonical import (
        SIGNED_MSG_TYPE_PRECOMMIT,
        SIGNED_MSG_TYPE_PREVOTE,
        Timestamp,
    )
    from tendermint_tpu_torch.types.block import BlockID, PartSetHeader, Vote
    from tendermint_tpu_torch.types.validator import Validator
    from tendermint_tpu_torch.types.validator_set import ValidatorSet

    keys = signer.keys(rng, ROUND_VALIDATORS)
    vset = ValidatorSet([Validator(Ed25519PubKey(pub), 10) for _, pub in keys])
    priv_by_addr = {Ed25519PubKey(pub).address(): priv for priv, pub in keys}
    privs = [priv_by_addr[v.address] for v in vset.validators]
    block_id = BlockID(hashlib.sha256(b"round-block").digest(),
                       PartSetHeader(1, hashlib.sha256(b"round-parts").digest()))
    ns = 1_700_000_000_000_000_000 + ROUND_HEIGHT * 10**9
    votes = {}
    for t, msg_type in enumerate((SIGNED_MSG_TYPE_PREVOTE, SIGNED_MSG_TYPE_PRECOMMIT)):
        votes[msg_type] = [
            Vote(type=msg_type, height=ROUND_HEIGHT, round=0, block_id=block_id,
                 timestamp=Timestamp.from_unix_ns(ns + t * 10**8 + i), validator_address=v.address,
                 validator_index=i,
                 extension=b"oracle-price/%d" % i if msg_type == SIGNED_MSG_TYPE_PRECOMMIT else b"")
            for i, v in enumerate(vset.validators)
        ]
    prevotes, precommits = votes[SIGNED_MSG_TYPE_PREVOTE], votes[SIGNED_MSG_TYPE_PRECOMMIT]
    msgs = ([v.sign_bytes(CHAIN_ID) for v in prevotes] + [v.sign_bytes(CHAIN_ID) for v in precommits]
            + [v.extension_sign_bytes(CHAIN_ID) for v in precommits])
    sigs = signer.sign(privs * 3, msgs)
    n = ROUND_VALIDATORS
    for i in range(n):
        prevotes[i].signature = sigs[i]
        precommits[i].signature = sigs[n + i]
        precommits[i].extension_signature = sigs[2 * n + i]
    return vset, block_id, prevotes, precommits


def lightd_workload(rng, signer):
    """Phase 11's chain: ``LIGHTD_HEADERS`` light blocks whose set of
    ``LIGHTD_VALIDATORS`` slides ``LIGHTD_SLIDE`` keys a height
    (``types/carry.py`` ``build_rotating_chain``), a copy of the last
    block with one bad signature, and a conflicting last block (the same
    set, another app hash, signed anew), all signed in the pool."""
    from tendermint_tpu_torch.crypto.keys import Ed25519PubKey
    from tendermint_tpu_torch.types import carry
    from tendermint_tpu_torch.types.block import BlockID, Commit, CommitSig, PartSetHeader
    from tendermint_tpu_torch.types.light import LightBlock, SignedHeader

    keys = [(priv, Ed25519PubKey(pub))
            for priv, pub in signer.keys(rng, LIGHTD_HEADERS * LIGHTD_SLIDE + LIGHTD_VALIDATORS)]
    chain = carry.build_rotating_chain(LIGHTD_HEADERS, keys, window=LIGHTD_VALIDATORS,
                                       slide=LIGHTD_SLIDE, sign_many=signer.sign, chain_id=CHAIN_ID)
    top = chain[-1]
    bad = copy.deepcopy(top)
    cs = bad.signed_header.commit.signatures[LIGHTD_BAD_INDEX]
    cs.signature = cs.signature[:40] + bytes([cs.signature[40] ^ 1]) + cs.signature[41:]
    header = copy.deepcopy(top.header)
    header.app_hash = hashlib.sha256(b"conflicting app state").digest()
    block_id = BlockID(header.hash(), PartSetHeader(1, hashlib.sha256(b"conflicting parts").digest()))
    sigs = [CommitSig(c.block_id_flag, c.validator_address, c.timestamp, b"")
            for c in top.signed_header.commit.signatures]
    commit = Commit(height=top.height, round=0, block_id=block_id, signatures=sigs)
    secret_of = {pub.address(): priv for priv, pub in keys}
    for c, sig in zip(sigs, signer.sign([secret_of[c.validator_address] for c in sigs],
                                        [commit.vote_sign_bytes(CHAIN_ID, i) for i in range(len(sigs))])):
        c.signature = sig
    fork = LightBlock(SignedHeader(header, commit), top.validator_set)
    return chain, bad, fork


# --- phase 2 -------------------------------------------------------------------


def projective(tab: np.ndarray, lam: int) -> np.ndarray:
    """A (8, 4, 32) lane table with X, Y, Z and T of every entry scaled by
    ``lam``: the same points, with Z != 1."""
    from tendermint_tpu_torch.crypto import ed25519_ref as ref

    out = np.empty_like(tab)
    for t in range(tab.shape[0]):
        for c in range(tab.shape[1]):
            v = int.from_bytes(tab[t, c].tobytes(), "little") * lam % ref.P
            out[t, c] = np.frombuffer(v.to_bytes(32, "little"), dtype=np.uint8)
    return out


def lane_subset(args, keys, idx):
    """The lanes ``idx`` (a CPU index) of a kernel's inputs: the table's
    lane axis is its last, the resident store is shared by every lane,
    and the resident index stays on the host."""
    out = []
    for key, a in zip(keys, args):
        if key == "store":
            out.append(a)
        else:
            dim = a.dim() - 1 if key == "tab" else 0
            out.append(a.index_select(dim, idx.to(a.device)).contiguous())
    return out


def rotated_lanes(lanes: int):
    """A ``lanes``-lane index into the KERNEL_LANES lanes: the lanes
    ``lanes // KERNEL_LANES`` times, each copy rotated differently so no
    lane sits where its copy does."""
    return np.concatenate([np.roll(np.arange(KERNEL_LANES), 37 * b)
                           for b in range(lanes // KERNEL_LANES)])


def kernel_args(inputs, keys, dev):
    """A kernel's arguments on the card; the resident index stays on the
    host, where its wrapper checks it."""
    import torch

    return [torch.as_tensor(inputs[k]).to("cpu" if k == "idx" else dev) for k in keys]


def signer_store(pks, tabs, shuffle_rng=None):
    """A resident store of the lanes' distinct keys: column 0 the pad
    table, then one column a key, in the order of first appearance (or
    shuffled). Returns the (8, 4, 32, K) store and the lanes' columns."""
    from tendermint_tpu_torch.ops import ed25519_batch as eb

    keys = list(dict.fromkeys(pks))
    order = np.arange(len(keys)) if shuffle_rng is None else shuffle_rng.permutation(len(keys))
    col_of = {keys[j]: 1 + c for c, j in enumerate(order)}
    cols = [eb._pad_table()] + [None] * len(keys)
    for pk, tab in zip(pks, tabs):
        cols[col_of[pk]] = tab
    store = np.ascontiguousarray(np.stack(cols).transpose(1, 2, 3, 0))
    return store, np.array([col_of[pk] for pk in pks], dtype=np.int32)


def compare_rows(got, want):
    """(rows of ``got`` that differ from ``want``, max |got - want|), for
    two arrays of one shape whose first axis is the lane."""
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32)).reshape(len(got), -1)
    return int(diff.any(axis=1).sum()), int(diff.max(initial=0))


def check_lane_sets(name, kernel, plain, args, keys, got, lane_sets):
    """Kernel against plain version on every lane set, and against the
    1,024-lane verdicts; returns ({lanes: mismatches}, max |error|,
    {lanes: arguments})."""
    import torch

    by_lanes, err, subsets = {}, 0, {}
    for n_lanes, idx_np in lane_sets.items():
        sub = lane_subset(args, keys, torch.from_numpy(idx_np))
        got_sub = kernel(*sub).cpu().numpy()
        plain_sub = plain(*sub).cpu().numpy()
        by_lanes[n_lanes], e = compare_rows(got_sub, plain_sub)
        check(by_lanes[n_lanes] == 0,
              f"{name}: {by_lanes[n_lanes]} of {n_lanes} lanes differ from the plain version")
        check(np.array_equal(got_sub, got[idx_np]),
              f"{name}: {n_lanes}-lane verdicts differ from the {KERNEL_LANES}-lane ones")
        err = max(err, e)
        subsets[n_lanes] = sub
    return by_lanes, err, subsets


def launch_facts(a, lanes, sms):
    warps_per_block = a["threads_per_block"] // 32
    blocks = -(-lanes // a["lanes_per_block"])
    return {
        "registers": a["registers"],
        "local_bytes": a["local_bytes"],
        "shared_bytes_per_block": a["shared_bytes"],
        "threads_per_block": a["threads_per_block"],
        "resident_warps_per_sm": a["resident_blocks_per_sm"] * warps_per_block,
        "launched_warps_per_sm_at_4096_max": -(-blocks // sms) * warps_per_block,
        "launched_warps_per_sm_at_4096_mean": blocks * warps_per_block / sms,
    }


def resident_timing(k2_subsets, dev, rng):
    """K3 on a store with one column a lane (as a commit's store is), its
    indices consecutive and shuffled, beside ``index_select`` then K2, at
    TIMING_LANES and WIDE_TIMING_LANES. Every variant's verdicts must equal
    K2's on the same lanes."""
    import torch

    from tendermint_tpu_torch.ops import cuda_verify, ed25519_batch as eb

    pad = torch.from_numpy(eb._pad_table()).to(dev)[..., None]
    out = {}
    for n_lanes in (TIMING_LANES, WIDE_TIMING_LANES):
        tab, ok, r, s, k = k2_subsets[n_lanes]
        want = cuda_verify.verify_tables(tab, ok, r, s, k).cpu().numpy()
        consec = torch.cat([pad, tab], dim=3).contiguous()
        idx_c = torch.arange(1, n_lanes + 1, dtype=torch.int32)
        perm = torch.from_numpy(rng.permutation(n_lanes).astype(np.int64))
        shuffled = torch.empty_like(consec)
        shuffled[..., 0] = pad[..., 0]
        shuffled[..., 1 + perm.to(dev)] = tab
        idx_s = (1 + perm).to(torch.int32)
        idx_c_dev, idx_s_dev, idx_l_dev = idx_c.to(dev), idx_s.to(dev), idx_c.to(dev).long()
        variants = {
            "consecutive": lambda: launch_resident(consec, idx_c_dev, ok, r, s, k),
            "shuffled": lambda: launch_resident(shuffled, idx_s_dev, ok, r, s, k),
            "index_select_then_k2": lambda: cuda_verify.verify_tables(
                consec.index_select(3, idx_l_dev), ok, r, s, k),
            "wrapper_consecutive": lambda: cuda_verify.verify_resident(consec, idx_c, ok, r, s, k),
        }
        for label, fn in variants.items():
            check(np.array_equal(fn().cpu().numpy(), want),
                  f"verify_resident ({label}, {n_lanes} lanes) differs from K2")
            out[f"ms_{label}_at_{n_lanes}"] = cuda_ms(fn, reps=20 if n_lanes == TIMING_LANES else 10)
    return out


def launch_resident(store, idx_dev, ok, r, s, k):
    """K3 launched with its index already on the card: the kernel's own
    time, without the wrapper's host check and index upload."""
    from tendermint_tpu_torch.ops import cuda_verify

    return cuda_verify._launch("ed25519_verify_resident_launch", "verify_resident",
                               (store, idx_dev, ok, r, s, k), r.shape[0], r.device, store.shape[3])


def sr_case(sr_lanes):
    """K5's entry of phase_kernels' cases: its inputs from the pool's k
    rows (checked equal to the engine's prep on the first 64 lanes), and
    the host sr25519.verify on the faulty lanes and every 16th."""
    from tendermint_tpu_torch.crypto import sr25519 as sr
    from tendermint_tpu_torch.ops import cuda_verify, sr25519_batch as tsb

    pks, msgs, sigs, kinds, ks = sr_lanes
    pk, r, s, host_ok, has_fields = tsb._host_checks(pks, sigs)
    k = np.stack([np.frombuffer(row, dtype=np.uint8) for row in ks])
    k[~has_fields] = 0
    inputs = dict(pk=pk, r=r, s=s, k=k)
    prep, prep_ok = tsb.prepare_batch_sr(pks[:64], msgs[:64], sigs[:64], pad_to=64)
    check(all(np.array_equal(inputs[key][:64], prep[key]) for key in prep)
          and np.array_equal(host_ok[:64], prep_ok),
          "verify_sr: the pool's inputs differ from prepare_batch_sr's")
    checked = sorted(kinds) + list(range(0, KERNEL_LANES, 16))
    want = {i: sr.verify(pks[i], msgs[i], sigs[i]) for i in checked}
    return (cuda_verify.verify_sr, tsb.verify_kernel_sr, ("pk", "r", "s", "k"), inputs, host_ok, want)


def phase_kernels(lanes, dev, challenge=True, sr_lanes=None):
    """K1-K3 (and K4 with ``challenge``, K5 with ``sr_lanes``) against
    their plain versions and the host oracle, timed; returns the
    ``kernels`` rows by name."""
    import torch

    from tendermint_tpu_torch.crypto import ed25519_ref as ref
    from tendermint_tpu_torch.ops import cuda_verify, ed25519_batch as eb, precompute

    pks, msgs, sigs, faulty = lanes
    checked = faulty + list(range(0, KERNEL_LANES, 16))
    want = {i: ref.verify_zip215(pks[i], msgs[i], sigs[i]) for i in checked}
    inp, host_ok = eb.prepare_batch(pks, msgs, sigs, pad_to=KERNEL_LANES)
    tabs, oks = zip(*(precompute.build_table(pk) for pk in pks))
    inp_t, host_ok_t = eb._prep_table_chunk(pks, msgs, sigs, list(tabs), list(oks), KERNEL_LANES)
    # The same points with Z != 1: K2's general (non-mixed) table add.
    proj_tabs = [projective(t, 2 + i) for i, t in enumerate(tabs)]
    inp_p, _ = eb._prep_table_chunk(pks, msgs, sigs, proj_tabs, list(oks), KERNEL_LANES)
    # K3: a store of the lanes' keys, columns in order of appearance, and
    # the same store with its columns shuffled.
    rng = np.random.default_rng(SEED + 1)
    stores = [signer_store(pks, tabs), signer_store(pks, tabs, rng)]
    inp_r = [dict(inp_t, store=st, idx=ix) for st, ix in stores]
    k3_keys = ("store", "idx", "ok", "r", "s", "k")
    cases = {
        "verify": (cuda_verify.verify, eb.verify_kernel, ("pk", "r", "s", "k"), inp, host_ok, want),
        "verify_tables": (
            cuda_verify.verify_tables, eb.verify_kernel_tables,
            ("tab", "ok", "r", "s", "k"), inp_t, host_ok_t, want,
        ),
        "verify_resident": (
            cuda_verify.verify_resident, eb.verify_kernel_resident, k3_keys, inp_r[0], host_ok_t,
            want,
        ),
    }
    if sr_lanes is not None:
        cases["verify_sr"] = sr_case(sr_lanes)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clock_hz = float(nvidia_smi("clocks.max.sm").split()[0]) * 1e6
    attrs = cuda_verify.kernel_attributes(tuple(cases))
    # Lane sets beyond the 1,024: ragged counts (a block and a chunk cut
    # short), the main path's 4,096-lane chunk, and a 16,384-lane launch
    # that can hold more warps on each SM.
    big_np = rotated_lanes(TIMING_LANES)
    lane_sets = {
        RAGGED_LANES[0]: np.arange(RAGGED_LANES[0]),
        RAGGED_LANES[1]: big_np[:RAGGED_LANES[1]],
        TIMING_LANES: big_np,
        WIDE_TIMING_LANES: rotated_lanes(WIDE_TIMING_LANES),
    }
    rows, all_subsets = {}, {}
    for name, (kernel, plain, keys, inputs, ok, want) in cases.items():
        checked = sorted(want)
        args = kernel_args(inputs, keys, dev)
        got = kernel(*args).cpu().numpy()
        ref_out = plain(*args).cpu().numpy()
        mismatches, err_1024 = compare_rows(got, ref_out)
        check(mismatches == 0, f"{name}: {mismatches} lanes differ from the plain version")
        bad = [i for i in checked if bool(got[i] and ok[i]) != want[i]]
        check(not bad, f"{name}: lanes {bad} differ from the host oracle")
        check(any(want.values()) and got[[i for i in checked if want[i]]].all(),
              f"{name}: valid lanes rejected")
        extra = {}
        if name == "verify_tables":
            pargs = kernel_args(inp_p, keys, dev)
            got_p = kernel(*pargs).cpu().numpy()
            proj_mismatches, err_p = compare_rows(got_p, plain(*pargs).cpu().numpy())
            check(proj_mismatches == 0 and np.array_equal(got_p, got),
                  f"{name}: projective tables give {proj_mismatches} mismatches")
            by_proj, err_pl, _ = check_lane_sets(name, kernel, plain, pargs, keys, got, lane_sets)
            by_proj[KERNEL_LANES] = proj_mismatches
            extra["projective_mismatches"] = proj_mismatches
            extra["mismatches_by_lanes_projective"] = {str(k): v for k, v in sorted(by_proj.items())}
            err_1024 = max(err_1024, err_p, err_pl)
        by_lanes, err, subsets = check_lane_sets(name, kernel, plain, args, keys, got, lane_sets)
        by_lanes[KERNEL_LANES] = mismatches
        err = max(err, err_1024)
        all_subsets[name] = subsets
        if name == "verify_resident":
            check(np.array_equal(got, rows["verify_tables"]["_got"]), "verify_resident differs from K2")
            sargs = kernel_args(inp_r[1], keys, dev)
            got_s = kernel(*sargs).cpu().numpy()
            plain_s = plain(*sargs).cpu().numpy()
            by_shuffled, err_s, _ = check_lane_sets(name, kernel, plain, sargs, keys, got, lane_sets)
            by_shuffled[KERNEL_LANES], err_1024 = compare_rows(got_s, plain_s)
            check(by_shuffled[KERNEL_LANES] == 0 and np.array_equal(got_s, got),
                  f"verify_resident with shuffled store columns: {by_shuffled[KERNEL_LANES]} lanes "
                  "differ from the plain version")
            err = max(err, err_s, err_1024)
            extra["mismatches_by_lanes_shuffled_store"] = {
                str(k): v for k, v in sorted(by_shuffled.items())}
            extra["store_columns"] = int(stores[0][0].shape[3])
            extra.update(resident_timing(all_subsets["verify_tables"], dev, rng))
        big, wide = subsets[TIMING_LANES], subsets[WIDE_TIMING_LANES]
        if name == "verify_resident":  # the kernel alone; the wrapper's time is in `extra`
            big, wide = ([a.to(dev) for a in sub] for sub in (big, wide))
            kernel_t = launch_resident
        else:
            kernel_t = kernel
        ms = cuda_ms(lambda: kernel_t(*big), reps=20)
        ms_wide = cuda_ms(lambda: kernel_t(*wide), reps=10)
        plain_ms = cuda_ms(lambda: plain(*big), reps=1)
        ops_s = TIMING_LANES * (
            SQS_PER_LANE[name] * INT32_MULS_PER_FE_SQ + MULS_PER_LANE[name] * INT32_MULS_PER_FE_MUL
        ) / (sms * INT32_OPS_PER_SM_CLOCK * clock_hz)
        bytes_s = TIMING_LANES * BYTES_PER_LANE[name] / HBM_BYTES_PER_S
        bound_ms = max(ops_s, bytes_s) * 1e3
        launch = launch_facts(attrs[name], TIMING_LANES, sms)
        rows[name] = {
            "name": name,
            "route": "cuda",
            "source": SOURCES[name],
            "replaces": REPLACES[name],
            "max_abs_err": float(err),
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "operations" if ops_s >= bytes_s else "bytes",
            "library_ms": None,
            "match_plain": True,
            "timing_lanes": TIMING_LANES,
            "bound_share": bound_ms / ms,
            "ms_at_16384": ms_wide,
            "mismatches": mismatches,
            "mismatches_at_timing_lanes": by_lanes[TIMING_LANES],
            "mismatches_by_lanes": {str(k): v for k, v in sorted(by_lanes.items())},
            **launch,
            **extra,
            "_got": got,
        }
        emit({"phase": "kernel", "name": name, "lanes": KERNEL_LANES, "match_plain": True,
              "lanes_checked_vs_oracle": len(checked), "timing_lanes": TIMING_LANES,
              "mismatches_by_lanes": rows[name]["mismatches_by_lanes"], **extra,
              "ms": ms, "ms_at_16384": ms_wide, "plain_ms": plain_ms, "bound_ms": bound_ms,
              "bound_share": bound_ms / ms, **launch, "sms": sms, "max_sm_clock_hz": clock_hz})
    for row in rows.values():
        del row["_got"]
    if challenge:
        rows["challenge"] = phase_challenge(dev, sms, clock_hz)
    return rows


def phase_challenge(dev, sms, clock_hz):
    """K4 against hashlib and reduce_mod_l, and against its plain version;
    its time at TIMING_LANES of the phase-3 shape."""
    import torch

    from tendermint_tpu_torch.crypto.hashing import reduce_mod_l, sha512_batch, sha512_batch_prefixed
    from tendermint_tpu_torch.ops import cuda_hash, ed25519_batch as eb, hash512

    rng = np.random.default_rng(SEED + 2)
    err = 0
    by_length = {}
    for length in HASH_LENGTHS:  # the SHA-512 padding boundaries
        mat = rng.integers(0, 256, size=(64, length), dtype=np.uint8)
        blocks = torch.from_numpy(hash512._pack(mat)).to(dev)
        want = reduce_mod_l(sha512_batch([row.tobytes() for row in mat]))
        by_length[str(length)], e = compare_rows(cuda_hash.challenge(blocks).cpu().numpy(), want)
        check(by_length[str(length)] == 0,
              f"challenge: {by_length[str(length)]} rows differ from hashlib mod L at {length} bytes")
        err = max(err, e)
    pad_row_np = eb._pad_rows()[3].reshape(32)
    pad_row = torch.from_numpy(pad_row_np).to(dev)
    vs_host, vs_plain = {}, {}
    for n_lanes, pad_to in ((KERNEL_LANES, KERNEL_LANES), (RAGGED_LANES[0], RAGGED_LANES[0]),
                            (TIMING_LANES - 1, TIMING_LANES), (TIMING_LANES, TIMING_LANES),
                            (WIDE_TIMING_LANES, WIDE_TIMING_LANES)):
        for nblocks, msg_len in HASH_MSG_LEN_BY_BLOCKS.items():
            prefix = rng.integers(0, 256, size=(n_lanes, 64), dtype=np.uint8)
            mat = rng.integers(0, 256, size=(n_lanes, msg_len), dtype=np.uint8)
            blocks = torch.from_numpy(hash512._pack(np.concatenate([prefix, mat], axis=1))).to(dev)
            check(blocks.shape[1] == 128 * nblocks, "challenge: block count")
            got = cuda_hash.challenge(blocks, pad_row, pad_to).cpu().numpy()
            want = reduce_mod_l(sha512_batch_prefixed(prefix, [r.tobytes() for r in mat]))
            want = np.concatenate([want, np.tile(pad_row_np, (pad_to - n_lanes, 1))])
            plain = hash512.challenge_kernel(blocks, pad_row, pad_to).cpu().numpy()
            key = f"{n_lanes}x{nblocks}"
            vs_host[key], e_host = compare_rows(got, want)
            vs_plain[key], e_plain = compare_rows(got, plain)
            check(vs_host[key] == 0 and vs_plain[key] == 0,
                  f"challenge: {n_lanes} lanes, {nblocks} blocks: {vs_host[key]} rows differ "
                  f"from hashlib mod L, {vs_plain[key]} from the plain version")
            err = max(err, e_host, e_plain)
    nblocks = 2  # phase 3: R || A || a 120-byte message
    timed = {}
    for n_lanes in (TIMING_LANES, WIDE_TIMING_LANES):
        prefix = rng.integers(0, 256, size=(n_lanes, 64), dtype=np.uint8)
        mat = rng.integers(0, 256, size=(n_lanes, HASH_MSG_LEN_BY_BLOCKS[nblocks]), dtype=np.uint8)
        blocks = torch.from_numpy(hash512._pack(np.concatenate([prefix, mat], axis=1))).to(dev)
        # The kernel's own time: its C launcher back to back (the wrapper's
        # Python takes longer than the kernel); the wrapper's time beside it.
        out = torch.empty((n_lanes, 32), dtype=torch.uint8, device=dev)
        launcher = cuda_hash._launcher("sha512_challenge_launch")
        stream = torch.cuda.current_stream(dev).cuda_stream
        raw = (blocks.data_ptr(), nblocks, n_lanes, None, out.data_ptr(), n_lanes, stream)
        check(launcher(*raw) == 0, "challenge: raw launch failed")
        check(torch.equal(out, cuda_hash.challenge(blocks)), "challenge: raw launch differs")
        timed[n_lanes] = cuda_ms(lambda: launcher(*raw), reps=200)
        if n_lanes == TIMING_LANES:
            ms_wrapper = cuda_ms(lambda: cuda_hash.challenge(blocks), reps=200)
            plain_ms = cuda_ms(lambda: hash512.challenge_kernel(blocks), reps=1)
    ms = timed[TIMING_LANES]
    ops_s = TIMING_LANES * nblocks * INT32_OPS_PER_SHA512_BLOCK / (
        sms * INT32_OPS_PER_SM_CLOCK * clock_hz)
    bytes_s = TIMING_LANES * (128 * nblocks + 32) / HBM_BYTES_PER_S
    bound_ms = max(ops_s, bytes_s) * 1e3
    launch = launch_facts(cuda_hash.challenge_attributes(), TIMING_LANES, sms)
    row = {
        "name": "challenge",
        "route": "cuda",
        "source": SOURCES["challenge"],
        "replaces": REPLACES["challenge"],
        "max_abs_err": float(err),
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "operations" if ops_s >= bytes_s else "bytes",
        "library_ms": None,
        "match_plain": True,
        "timing_lanes": TIMING_LANES,
        "timing_blocks": nblocks,
        "ms_at_16384": timed[WIDE_TIMING_LANES],
        "ms_wrapper": ms_wrapper,
        "bound_share": bound_ms / ms,
        "mismatches_by_boundary_length": by_length,
        "mismatches_by_lanes_x_blocks": vs_host,
        "plain_mismatches_by_lanes_x_blocks": vs_plain,
        **launch,
    }
    emit({"phase": "kernel", **row})
    return row


# --- phase 3 -------------------------------------------------------------------


def chunk_sizes(lanes):
    """The padded sizes of the chunks ``lanes`` lanes are verified in."""
    from tendermint_tpu_torch.ops import ed25519_batch as eb

    return [eb._bucket(min(eb.CHUNK, lanes - lo)) for lo in range(0, lanes, eb.CHUNK)]


def launches():
    """Every kernel's launch count so far."""
    from tendermint_tpu_torch.ops import cuda_hash, cuda_verify

    return {**cuda_verify.LAUNCHES, **cuda_hash.LAUNCHES}


def delta(before):
    return {k: v - before[k] for k, v in launches().items() if v != before[k]}


def add_launches(*counts):
    """The sum of launch-count dicts, by kernel."""
    out = {}
    for c in counts:
        for k, v in c.items():
            out[k] = out.get(k, 0) + v
    return out


def phase_verify_batch(lanes, dev):
    from tendermint_tpu_torch.ops import hash512, precompute, resident, verify_batch

    pks, msgs, sigs, want = lanes
    precompute.reset()  # no activated set: every lane takes K1
    check(resident.stats()["resident_keys"] == 0, "precompute.reset() left the store")
    before = launches()
    lanes_before = hash512.stats()["device_lanes"]
    times = []
    for _ in range(BATCH_REPS):
        precompute.results.clear()
        t0 = time.perf_counter()
        got = verify_batch(pks, msgs, sigs, device=dev)
        times.append(time.perf_counter() - t0)
        check(np.array_equal(np.asarray(got), want), "verify_batch verdicts wrong")
    d = delta(before)
    device_lanes = hash512.stats()["device_lanes"] - lanes_before
    want_n = len(chunk_sizes(BATCH_LANES)) * BATCH_REPS
    check(d == {"verify": want_n, "challenge": want_n},
          f"verify_batch launches {d}, expected K1 and K4 {want_n} times each")
    check(device_lanes == BATCH_LANES * BATCH_REPS,
          f"device hash took {device_lanes} lanes, expected {BATCH_LANES * BATCH_REPS}")
    precompute.results.clear()
    profile = host_profile(lambda: verify_batch(pks, msgs, sigs, device=dev))
    emit({"phase": "verify_batch", "lanes": BATCH_LANES, "bad_lanes_rejected": int((~want).sum()),
          "seconds": times, "sigs_per_s_median": BATCH_LANES / statistics.median(times),
          "launches": d, "device_hash_lanes": device_lanes, "host_profile": profile})


# --- phase 4 -------------------------------------------------------------------


def sign_bytes_lengths(commit):
    """The distinct sign-bytes lengths of a commit, over all lanes and per
    chunk."""
    from tendermint_tpu_torch.ops import ed25519_batch as eb

    lens = [len(commit.vote_sign_bytes(CHAIN_ID, i)) for i in range(COMMIT_VALIDATORS)]
    return sorted(set(lens)), [sorted(set(lens[lo:lo + eb.CHUNK])) for lo in range(0, len(lens), eb.CHUNK)]


def phase_commit(workload, dev):
    from tendermint_tpu_torch.ops import hash512, precompute, resident
    from tendermint_tpu_torch.types.validation import InvalidCommitError, verify_commit

    vset, block_id, commits = workload
    chunks = len(chunk_sizes(COMMIT_VALIDATORS))
    lengths, chunk_lengths = sign_bytes_lengths(commits[1])
    # The device hash takes the chunks whose messages share one length.
    hashed = sum(len(c) == 1 for c in chunk_lengths)

    def run(commit, kernel):
        before = launches()
        mixed = hash512.stats()["declined_mixed_lengths"]
        builds = precompute.tables.builds
        t = time.perf_counter()
        verify_commit(CHAIN_ID, vset, block_id, commit.height, commit, device=dev)
        secs = time.perf_counter() - t
        d = delta(before)
        want = {kernel: chunks, **({"challenge": hashed} if hashed else {})}
        check(d == want, f"commit launches {d}, expected {want}")
        check(hash512.stats()["declined_mixed_lengths"] - mixed == chunks - hashed,
              "chunks of mixed sign-bytes lengths not sent to host hashing")
        return secs, precompute.tables.builds - builds

    def steady(kernel, reps):
        out = []
        for _ in range(reps):  # the same commit with the verdict cache emptied
            precompute.results.clear()
            secs, builds = run(commits[1], kernel)
            check(builds == 0, "table builds in the steady state")
            out.append(secs)
        return out

    resident.reset()
    cold_s, cold_builds = run(commits[0], "verify_resident")
    check(cold_builds == COMMIT_VALIDATORS, f"first commit built {cold_builds} tables")
    store = resident.stats()
    check(store["uploads"] == 1 and store["resident_keys"] == COMMIT_VALIDATORS
          and store["h2d_bytes"] == (COMMIT_VALIDATORS + 1) * TABLE_BYTES,
          f"cold commit store {store}")
    steady_s, steady_builds = run(commits[1], "verify_resident")
    check(steady_builds == 0, f"steady-state commit built {steady_builds} tables")
    reps = steady("verify_resident", P50_REPS)
    precompute.results.clear()
    profile = host_profile(lambda: run(commits[1], "verify_resident"))
    after = resident.stats()
    check(after["uploads"] == 1 and after["gathered_h2d_bytes"] == 0,
          f"steady commits moved table bytes: {after}")
    try:
        verify_commit(CHAIN_ID, vset, block_id, commits[2].height, commits[2], device=dev)
    except InvalidCommitError as exc:
        check(f"(#{BAD_COMMIT_INDEX})" in str(exc), f"bad commit rejected wrongly: {exc}")
    else:
        raise SmokeFailure("commit with a bad signature was accepted")
    emit({"phase": "verify_commit", "resident_store": "on", "validators": COMMIT_VALIDATORS,
          "cold_ms": cold_s * 1e3, "table_builds_cold": cold_builds,
          "steady_first_ms": steady_s * 1e3, "steady_ms": [r * 1e3 for r in reps],
          "steady_p50_ms": statistics.median(reps) * 1e3, "k3_launches_per_commit": chunks,
          "k4_launches_per_commit": hashed, "sign_bytes_lengths": lengths,
          "sign_bytes_lengths_by_chunk": chunk_lengths,
          "host_hashed_chunks_per_commit": chunks - hashed, "host_hash_reason": "mixed lengths",
          "store": resident.stats(), "bad_signature_index": BAD_COMMIT_INDEX,
          "host_profile": profile})

    # 4b: the store off, the same steady commit: K2 and the tables shipped.
    # Off and on runs alternate, so the host's drift falls on both.
    off_reps, on_reps = [], []
    gathered = resident.stats()["gathered_h2d_bytes"]
    for _ in range(STORE_OFF_REPS):
        resident.configure("off")
        try:
            off_reps += steady("verify_tables", 1)
        finally:
            resident.configure(None)
        on_reps += steady("verify_resident", 1)
    per_commit = (resident.stats()["gathered_h2d_bytes"] - gathered) / STORE_OFF_REPS
    padded = sum(chunk_sizes(COMMIT_VALIDATORS))
    check(per_commit == padded * TABLE_BYTES,
          f"store off: {per_commit} table bytes a commit, expected {padded * TABLE_BYTES}")
    check(resident.stats()["uploads"] == 1, "the store was uploaded again")
    resident.configure("off")
    try:
        precompute.results.clear()
        off_profile = host_profile(lambda: run(commits[1], "verify_tables"))
    finally:
        resident.configure(None)
    emit({"phase": "verify_commit", "resident_store": "off", "validators": COMMIT_VALIDATORS,
          "steady_ms": [r * 1e3 for r in off_reps],
          "steady_p50_ms": statistics.median(off_reps) * 1e3,
          "interleaved_store_on_ms": [r * 1e3 for r in on_reps],
          "interleaved_store_on_p50_ms": statistics.median(on_reps) * 1e3,
          "phase4_store_on_p50_ms": statistics.median(reps) * 1e3,
          "k2_launches_per_commit": chunks, "gathered_table_bytes_per_commit": per_commit,
          "host_profile": off_profile})
    precompute.reset()
    check(resident.stats()["resident_keys"] == 0, "precompute.reset() left the store")


# --- health ---------------------------------------------------------------------


def check_healthy(where: str) -> dict:
    """The health machine after a stretch of the main path: no host
    fallback in either engine, no transition, healthy. Returns the
    snapshot."""
    from tendermint_tpu_torch.ops import device_policy

    snap = device_policy.shared.snapshot()
    check(snap["state"] == "healthy" and not snap["transitions"] and snap["fallback_batches"] == 0
          and not any(snap["fallback_lanes"].values()),
          f"host fallback or a health transition on the main path ({where}): {snap}")
    return snap


# --- phase 5 -------------------------------------------------------------------


def phase_mixed_commit(workload, dev):
    """The mixed ed25519 + sr25519 commit; returns the launch counts of the
    phase (which starts with every count at 0)."""
    from tendermint_tpu_torch.ops import precompute, resident, sr25519_batch as tsb
    from tendermint_tpu_torch.ops import ed25519_batch as eb
    from tendermint_tpu_torch.types.validation import InvalidCommitError, verify_commit

    vset, block_id, commit, bad, bad_index = workload
    is_sr = [v.pub_key.type == "sr25519" for v in vset.validators]
    n_sr = sum(is_sr)
    n_ed = MIXED_VALIDATORS - n_sr
    ed_lens = [len(commit.vote_sign_bytes(CHAIN_ID, i)) for i in range(MIXED_VALIDATORS) if not is_sr[i]]
    ed_chunk_lengths = [sorted(set(ed_lens[lo:lo + eb.CHUNK])) for lo in range(0, n_ed, eb.CHUNK)]
    hashed = sum(len(c) == 1 for c in ed_chunk_lengths)
    want = {"verify_resident": len(chunk_sizes(n_ed)), "verify_sr": len(chunk_sizes(n_sr)),
            **({"challenge": hashed} if hashed else {})}
    merlin = [0.0]
    challenge_row = tsb._challenge_row

    def timed_challenge_row(*args):
        t = time.perf_counter()
        try:
            return challenge_row(*args)
        finally:
            merlin[0] += time.perf_counter() - t

    def run(c):
        """One verify_commit of ``c`` with the verdict cache emptied:
        (seconds, Merlin seconds)."""
        precompute.results.clear()
        before = launches()
        merlin[0] = 0.0
        t = time.perf_counter()
        verify_commit(CHAIN_ID, vset, block_id, c.height, c, device=dev)
        secs = time.perf_counter() - t
        d = delta(before)
        check(d == want, f"mixed commit launches {d}, expected {want}")
        return secs, merlin[0]

    t_phase = time.perf_counter()
    tsb._challenge_row = timed_challenge_row
    try:
        resident.reset()
        builds = precompute.tables.builds
        cold_s, cold_merlin = run(commit)
        cold_builds = precompute.tables.builds - builds
        check(cold_builds == n_ed, f"mixed cold commit built {cold_builds} tables, expected {n_ed}")
        steady = [run(commit)]
        # As many steady commits as fit the phase's budget at this host's
        # rate, leaving room for the profiled run (about two commits under
        # cProfile) and the bad commit.
        left = MIXED_BUDGET_S - (time.perf_counter() - t_phase)
        reps = max(MIXED_MIN_REPS, min(MIXED_MAX_REPS, int(left / steady[0][0]) - 3))
        steady += [run(commit) for _ in range(reps - 1)]
        check(precompute.tables.builds - builds == n_ed, "table builds in the mixed steady state")
    finally:
        tsb._challenge_row = challenge_row
    precompute.results.clear()
    profile = host_profile(lambda: verify_commit(CHAIN_ID, vset, block_id, commit.height, commit,
                                                 device=dev))
    try:
        verify_commit(CHAIN_ID, vset, block_id, bad.height, bad, device=dev)
    except InvalidCommitError as exc:
        check(f"(#{bad_index})" in str(exc), f"bad mixed commit rejected wrongly: {exc}")
    else:
        raise SmokeFailure("mixed commit with a bad sr25519 signature was accepted")
    counts = launches()
    secs = [r[0] for r in steady]
    shares = [r[1] / r[0] for r in steady]
    emit({"phase": "mixed_commit", "validators": MIXED_VALIDATORS, "ed25519_lanes": n_ed,
          "sr25519_lanes": n_sr, "cold_ms": cold_s * 1e3, "cold_merlin_ms": cold_merlin * 1e3,
          "table_builds_cold": cold_builds, "steady_ms": [x * 1e3 for x in secs],
          "steady_p50_ms": statistics.median(secs) * 1e3,
          "steady_merlin_ms": [r[1] * 1e3 for r in steady],
          "merlin_share_of_steady": shares, "merlin_share_p50": statistics.median(shares),
          "merlin_ms_per_sr25519_lane_p50": statistics.median(r[1] for r in steady) * 1e3 / n_sr,
          "engine_split_launches_per_commit": want,
          "ed25519_sign_bytes_lengths_by_chunk": ed_chunk_lengths,
          "bad_signature_index": bad_index, "launches": counts, "store": resident.stats(),
          "phase_s": time.perf_counter() - t_phase, "host_profile": profile})
    precompute.reset()
    return counts


# --- phase 5c ------------------------------------------------------------------


def phase_three_type(workload, dev):
    """BASELINE config 5 with secp256k1: the three-type commit through
    ``verify_commit`` on the card's device. secp256k1 has no batch
    verifier, so ``MultiBatchVerifier.add`` raises and the commit goes to
    single verification on the host, the reference's own path: no kernel
    launches. Returns the phase's launch counts (which start at 0)."""
    from tendermint_tpu_torch.ops import precompute
    from tendermint_tpu_torch.types.validation import InvalidCommitError, verify_commit

    vset, block_id, commit, bad, bad_index = workload
    by_type = {}
    for v in vset.validators:
        by_type[v.pub_key.type] = by_type.get(v.pub_key.type, 0) + 1
    before = launches()
    times = []
    for _ in range(THREE_TYPE_REPS):
        precompute.results.clear()
        t = time.perf_counter()
        verify_commit(CHAIN_ID, vset, block_id, commit.height, commit, device=dev)
        times.append(time.perf_counter() - t)
    got = []
    for where in (dev, "cpu"):
        try:
            verify_commit(CHAIN_ID, vset, block_id, bad.height, bad, device=where)
        except InvalidCommitError as exc:
            got.append(str(exc))
        else:
            raise SmokeFailure(f"three-type commit with a bad secp256k1 signature accepted on {where}")
    check(got[0] == got[1] and got[0].startswith(f"wrong signature (#{bad_index})"),
          f"bad three-type commit rejected differently on {dev} and the CPU: {got}")
    d = delta(before)
    check(d == {}, f"three-type commit launched kernels {d}; the reference's path verifies it on the host")
    counts = launches()
    emit({"phase": "three_type_commit", "validators": THREE_TYPE_VALIDATORS, "by_key_type": by_type,
          "ms": [x * 1e3 for x in times], "p50_ms": statistics.median(times) * 1e3,
          "ms_per_signature_p50": statistics.median(times) * 1e3 / THREE_TYPE_VALIDATORS,
          "bad_index": bad_index, "rejection": got[0][:40], "launches": d,
          "expected_launches": "none: MultiBatchVerifier.add raises for secp256k1, so the commit is "
                               "verified one signature at a time on the host, as in the reference"})
    return counts


# --- phase 7 -------------------------------------------------------------------


def sync_tasks(chain, vset, commits=None):
    from tendermint_tpu_torch.parallel.pipeline import CommitTask

    commits = commits or [sh.commit for sh in chain]
    return [CommitTask(CHAIN_ID, vset, c.block_id, c.height, c) for c in commits]


def lanes_and_chunks(tasks):
    """The lanes a window verifies (each block stops past +2/3, every
    signature here a commit one) and their sign-bytes lengths by chunk."""
    from tendermint_tpu_torch.ops import ed25519_batch as eb

    lens = []
    for t in tasks:
        needed, tallied = t.vals.total_voting_power() * 2 // 3, 0
        for i, v in enumerate(t.vals.validators):
            lens.append(len(t.commit.vote_sign_bytes(CHAIN_ID, i)))
            tallied += v.voting_power
            if tallied > needed:
                break
    return len(lens), [sorted(set(lens[lo:lo + eb.CHUNK])) for lo in range(0, len(lens), eb.CHUNK)]


def phase_blocksync(sync, mixed_sync, dev):
    """BASELINE config 4: a 32-block window through
    ``verify_commits_pipelined``, every verdict checked; then a small
    mixed ed25519 + sr25519 window. Returns the phase's launch counts
    (which start at 0)."""
    from tendermint_tpu_torch.ops import hash512, precompute, resident
    from tendermint_tpu_torch.parallel.pipeline import verify_commits_pipelined
    from tendermint_tpu_torch.types.block import CommitSig
    from tendermint_tpu_torch.types.validation import InvalidCommitError, NotEnoughVotingPowerError

    chain, vset, _ = sync
    tasks = sync_tasks(chain, vset)
    n_lanes, chunk_lengths = lanes_and_chunks(tasks)
    check(n_lanes == SYNC_BLOCKS * (SYNC_VALIDATORS * 2 // 3 + 1),
          f"blocksync window of {n_lanes} lanes")
    hashed = sum(len(c) == 1 for c in chunk_lengths)
    chunks = len(chunk_sizes(n_lanes))
    want_launches = {"verify_resident": chunks, **({"challenge": hashed} if hashed else {})}

    def run(window):
        precompute.results.clear()  # new blocks: no verdict is cached
        before = launches()
        mixed = hash512.stats()["declined_mixed_lengths"]
        t = time.perf_counter()
        verdicts = verify_commits_pipelined(window, device=dev)
        secs = time.perf_counter() - t
        d = delta(before)
        check(d == want_launches, f"blocksync launches {d}, expected {want_launches}")
        check(hash512.stats()["declined_mixed_lengths"] - mixed == chunks - hashed,
              "blocksync chunks of mixed sign-bytes lengths not sent to host hashing")
        return secs, verdicts

    precompute.reset()
    builds = precompute.tables.builds
    cold_s, verdicts = run(tasks)
    check(all(v.ok for v in verdicts), f"blocksync window rejected: {verdicts}")
    # A table for each validator that signs before its block's stop.
    cold_builds = precompute.tables.builds - builds
    check(cold_builds == n_lanes // SYNC_BLOCKS, f"blocksync warm-up built {cold_builds} tables")
    reps = []
    for _ in range(SYNC_REPS):
        secs, verdicts = run(tasks)
        check(all(v.ok for v in verdicts), "blocksync window rejected")
        reps.append(secs)
    check(precompute.tables.builds - builds == cold_builds, "table builds in the steady window")
    profile = host_profile(lambda: run(tasks))

    # Every verdict: a bad signature among a block's first 334 signers,
    # and a block with a third of its validators absent.
    commits = [sh.commit for sh in chain]
    commits[SYNC_BAD_BLOCK] = copy.deepcopy(commits[SYNC_BAD_BLOCK])
    cs = commits[SYNC_BAD_BLOCK].signatures[SYNC_BAD_INDEX]
    cs.signature = cs.signature[:40] + bytes([cs.signature[40] ^ 1]) + cs.signature[41:]
    commits[SYNC_SHORT_BLOCK] = copy.deepcopy(commits[SYNC_SHORT_BLOCK])
    short = commits[SYNC_SHORT_BLOCK].signatures
    n_absent = SYNC_VALIDATORS - SYNC_VALIDATORS * 2 // 3
    for i in range(SYNC_VALIDATORS - n_absent, SYNC_VALIDATORS):
        short[i] = CommitSig.absent()
    precompute.results.clear()
    verdicts = verify_commits_pipelined(sync_tasks(chain, vset, commits), device=dev)
    for b, v in enumerate(verdicts):
        if b == SYNC_BAD_BLOCK:
            check(not v.ok and isinstance(v.error, InvalidCommitError)
                  and f"(#{SYNC_BAD_INDEX})" in str(v.error), f"bad block verdict {v}")
        elif b == SYNC_SHORT_BLOCK:
            check(not v.ok and isinstance(v.error, NotEnoughVotingPowerError), f"short block verdict {v}")
        else:
            check(v.ok, f"block {b} rejected: {v.error!r}")
    rejections = {"bad": str(verdicts[SYNC_BAD_BLOCK].error)[:40],
                  "short": str(verdicts[SYNC_SHORT_BLOCK].error)}

    # The mixed window: sr25519 lanes go to K5, ed25519 ones to K3. The
    # JAX package's pipeline rejects this valid window.
    mchain, mvset, _ = mixed_sync
    mtasks = sync_tasks(mchain, mvset)
    precompute.results.clear()
    before = launches()
    t = time.perf_counter()
    mverdicts = verify_commits_pipelined(mtasks, device=dev)
    mixed_s = time.perf_counter() - t
    mixed_launches = delta(before)
    check(all(v.ok for v in mverdicts), f"mixed blocksync window rejected: {mverdicts}")
    check(mixed_launches.get("verify_sr", 0) >= 1 and mixed_launches.get("verify_resident", 0) >= 1,
          f"mixed blocksync window launches {mixed_launches}")
    sr_idx = [i for i, v in enumerate(mvset.validators) if v.pub_key.type == "sr25519"]
    mcommits = [sh.commit for sh in mchain]
    mcommits[1] = copy.deepcopy(mcommits[1])
    cs = mcommits[1].signatures[sr_idx[3]]
    cs.signature = cs.signature[:40] + bytes([cs.signature[40] ^ 1]) + cs.signature[41:]
    precompute.results.clear()
    bad_mixed = verify_commits_pipelined(sync_tasks(mchain, mvset, mcommits), device=dev)
    check(bad_mixed[0].ok and not bad_mixed[1].ok and f"(#{sr_idx[3]})" in str(bad_mixed[1].error),
          f"mixed window with a bad sr25519 signature: {bad_mixed}")
    counts = launches()
    emit({"phase": "blocksync", "blocks": SYNC_BLOCKS, "validators": SYNC_VALIDATORS,
          "lanes_per_call": n_lanes, "chunks_per_call": chunk_sizes(n_lanes),
          "sign_bytes_lengths_by_chunk": chunk_lengths, "launches_per_call": want_launches,
          "cold_ms": cold_s * 1e3, "table_builds_cold": cold_builds,
          "seconds": reps, "blocksync_blocks_per_s_v500": SYNC_BLOCKS / statistics.median(reps),
          "window_p50_ms": statistics.median(reps) * 1e3,
          "bad_block": SYNC_BAD_BLOCK, "bad_index": SYNC_BAD_INDEX, "short_block": SYNC_SHORT_BLOCK,
          "rejections": rejections, "mixed_window": {
              "blocks": MIXED_SYNC_BLOCKS, "validators": MIXED_SYNC_VALIDATORS, "ms": mixed_s * 1e3,
              "launches": mixed_launches, "bad_sr25519_index": sr_idx[3]},
          "launches": counts, "store": resident.stats(), "host_profile": profile})
    precompute.reset()
    return counts


# --- phase 8 -------------------------------------------------------------------


def phase_light(light, dev):
    """BASELINE config 3: walks of ``verify_adjacent`` over a 16-header
    chain, one non-adjacent ``verify`` from the first header to the last,
    and the outcomes of a tampered signature, an expired trusted header
    and a broken validators-hash link. Returns the phase's launch counts
    (which start at 0)."""
    from tendermint_tpu_torch.encoding.canonical import Timestamp
    from tendermint_tpu_torch.light import verifier
    from tendermint_tpu_torch.ops import precompute, resident

    chain, vset, _ = light
    now = Timestamp.from_unix_ns(chain[-1].header.time.to_unix_ns() + 2 * 10**9)
    period, drift = LIGHT_TRUSTING_PERIOD_S, LIGHT_MAX_CLOCK_DRIFT_S
    step_lanes = LIGHT_VALIDATORS * 2 // 3 + 1
    per_walk = {"verify_resident": (LIGHT_HEADERS - 1) * len(chunk_sizes(step_lanes))}

    def walk():
        precompute.results.clear()  # each header is new: no verdict is cached
        before = launches()
        t = time.perf_counter()
        for i in range(1, len(chain)):
            verifier.verify_adjacent(chain[i - 1], chain[i], vset, period, now, drift, device=dev)
        secs = time.perf_counter() - t
        d = delta(before)
        check(d == per_walk, f"light walk launches {d}, expected {per_walk}")
        return secs

    precompute.reset()
    builds = precompute.tables.builds
    cold_s = walk()
    cold_builds = precompute.tables.builds - builds
    check(cold_builds == step_lanes, f"light warm-up built {cold_builds} tables")
    reps = [walk() for _ in range(LIGHT_REPS)]
    check(precompute.tables.builds - builds == step_lanes, "table builds in the steady walks")
    profile = host_profile(walk)
    # Header 1 to header 16: the trusting pass (1/3 of the trusted set,
    # looked up by address) and the +2/3 pass of the new set.
    precompute.results.clear()
    before = launches()
    t = time.perf_counter()
    verifier.verify(chain[0], vset, chain[-1], vset, period, now, drift, device=dev)
    skip_s = time.perf_counter() - t
    skip_launches = delta(before)
    # The +2/3 pass finds the trusting pass's lanes in the verdict cache;
    # the rest have one sign-bytes length, so K4 hashes them.
    check(skip_launches == {"verify_resident": 2, "challenge": 1},
          f"non-adjacent verify launches {skip_launches}")

    def outcome(fn, *args, **kwargs):
        precompute.results.clear()
        try:
            fn(*args, **kwargs, device=dev)
        except (verifier.InvalidHeaderError, verifier.HeaderExpiredError) as exc:
            return type(exc).__name__, str(exc)
        return "ok", ""

    bad = copy.deepcopy(chain[LIGHT_BAD_HEADER])
    cs = bad.commit.signatures[LIGHT_BAD_INDEX]
    cs.signature = cs.signature[:40] + bytes([cs.signature[40] ^ 1]) + cs.signature[41:]
    unlinked = copy.deepcopy(chain[2])
    unlinked.header.next_validators_hash = hashlib.sha256(b"another set").digest()
    outcomes = {
        "tampered_signature": outcome(verifier.verify_adjacent, chain[LIGHT_BAD_HEADER - 1], bad,
                                      vset, period, now, drift),
        "expired": outcome(verifier.verify_adjacent, chain[0], chain[1], vset, 1.0, now, drift),
        "broken_next_validators_link": outcome(verifier.verify_adjacent, unlinked, chain[3], vset,
                                               period, now, drift),
    }
    check(outcomes["tampered_signature"][0] == "InvalidHeaderError"
          and f"(#{LIGHT_BAD_INDEX})" in outcomes["tampered_signature"][1],
          f"tampered header: {outcomes['tampered_signature']}")
    check(outcomes["expired"][0] == "HeaderExpiredError", f"expired header: {outcomes['expired']}")
    check(outcomes["broken_next_validators_link"] == (
        "InvalidHeaderError", "expected old header's next validators to match those from new header"),
        f"broken link: {outcomes['broken_next_validators_link']}")
    counts = launches()
    walk_p50 = statistics.median(reps)
    emit({"phase": "light_client", "headers": LIGHT_HEADERS, "validators": LIGHT_VALIDATORS,
          "lanes_per_step": step_lanes, "chunks_per_step": chunk_sizes(step_lanes),
          "launches_per_walk": per_walk, "cold_walk_ms": cold_s * 1e3,
          "table_builds_cold": cold_builds, "walk_ms": [r * 1e3 for r in reps],
          "walk_p50_ms": walk_p50 * 1e3, "step_p50_ms": walk_p50 * 1e3 / (LIGHT_HEADERS - 1),
          "light_client_headers_per_s_v1000": (LIGHT_HEADERS - 1) / walk_p50,
          "non_adjacent_1_to_16_ms": skip_s * 1e3, "non_adjacent_launches": skip_launches,
          "outcomes": {k: v[0] for k, v in outcomes.items()}, "launches": counts,
          "store": resident.stats(), "host_profile": profile})
    precompute.reset()
    return counts


# --- phase 9 -------------------------------------------------------------------


class ConsensusStandIn:
    """The slice of ``ConsensusState`` that ``VotePreverifier`` reads
    (``consensus/reactor.py`` ``ConsensusView``): the round state's height
    and validators, the chain id, and ``add_vote_from_peer``, which adds
    the vote to the ``VoteSet`` of its type. Records, per delivery, the
    time from submit to forward, whether the vote came tagged, and what
    the vote set made of it."""

    def __init__(self, height, vset, vote_sets, bad, want_block):
        from types import SimpleNamespace

        self.rs = SimpleNamespace(height=height, validators=vset)
        self.state = SimpleNamespace(chain_id=CHAIN_ID)
        self.vote_sets = vote_sets  # signed message type -> VoteSet
        self.bad = bad  # (type, validator index) of the bad votes
        self.want_block = want_block  # the block every vote set must reach +2/3 for
        self.lock = threading.Lock()
        self.sent = {}  # id(vote) -> perf_counter at submit  # guarded-by: lock
        self.latencies = []
        self.forwarded = self.added = self.duplicates = 0
        self.untagged_valid = 0
        self.bad_outcomes = []  # (index, tagged, error type, message)
        self.errors = []  # anything else the vote sets raised
        self.t_quorum = {}  # type -> perf_counter when +2/3 was reached
        self.t_all = {}  # type -> perf_counter when every valid vote was in

    def submitting(self, vote) -> None:
        with self.lock:
            self.sent[id(vote)] = time.perf_counter()

    def add_vote_from_peer(self, vote, peer_id) -> None:
        from tendermint_tpu_torch.types.block import VoteError

        t = time.perf_counter()
        tagged = vote._pre_verified is not None
        vs = self.vote_sets[vote.type]
        err = None
        try:
            added = vs.add_vote(vote)
        except VoteError as exc:
            added, err = None, exc
        except Exception as exc:  # recorded and failed by the phase
            added, err = None, exc
        with self.lock:
            self.latencies.append(t - self.sent.pop(id(vote)))
            self.forwarded += 1
            key = (vote.type, vote.validator_index)
            if key in self.bad:
                self.bad_outcomes.append((vote.validator_index, tagged, type(err).__name__, str(err)))
                return
            if err is not None:
                self.errors.append(repr(err))
                return
            self.untagged_valid += not tagged
            if added:
                self.added += 1
                if vote.type not in self.t_quorum and vs.has_two_thirds_majority():
                    self.t_quorum[vote.type] = t
                valid = vs.size() - sum(1 for ty, _ in self.bad if ty == vote.type)
                if vs.sum == valid * vs.val_set.validators[0].voting_power:
                    self.t_all[vote.type] = t
            else:
                self.duplicates += 1

    def wait_forwarded(self, n, timeout) -> bool:
        deadline = time.perf_counter() + timeout
        while time.perf_counter() < deadline:
            with self.lock:
                if self.forwarded >= n:
                    return True
            time.sleep(0.002)
        return False


def percentile(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))]


def ingest_counters():
    """The counters a vote-ingest run is read by: the shared scheduler's,
    the verdict cache's, the tiers' and the kernels'."""
    from tendermint_tpu_torch.crypto import batch as crypto_batch
    from tendermint_tpu_torch.ops import precompute

    sched = crypto_batch.get_shared_scheduler().stats()
    return {"sched": sched, "cache": precompute.results.stats(), "tiers": dict(crypto_batch.tier_lanes),
            "tier_s": dict(crypto_batch.tier_seconds), "launches": launches()}


def ingest_delta(before):
    after = ingest_counters()
    sched = {k: after["sched"][k] - before["sched"][k] for k in after["sched"] if k != "flush_reasons"}
    sched["flush_reasons"] = {k: v - before["sched"]["flush_reasons"][k]
                              for k, v in after["sched"]["flush_reasons"].items()}
    return {
        "sched": sched,
        "cache": {k: after["cache"][k] - before["cache"][k] for k in ("hits", "misses")},
        "tiers": {k: after["tiers"][k] - before["tiers"][k] for k in after["tiers"]},
        "tier_s": {k: after["tier_s"][k] - before["tier_s"][k] for k in after["tier_s"]},
        "launches": {k: v - before["launches"][k] for k, v in after["launches"].items()
                     if v != before["launches"][k]},
    }


def start_preverifier(cs):
    """A started, warm pre-verifier over ``cs``; checks that its warm-up
    kept no error and launched a kernel. Returns it and the warm-up's
    launches."""
    from tendermint_tpu_torch.consensus.reactor import VotePreverifier

    before = launches()
    pv = VotePreverifier(cs)
    pv.start()
    warm = pv.wait_warmup(timeout=pv.WARMUP_TIMEOUT + 10)
    check(pv.warmup_error is None and warm, f"vote pre-verifier warm-up: {pv.warmup_error!r}")
    warm_launches = delta(before)
    check(sum(warm_launches.values()) > 0, "the warm-up's flush launched no kernel")
    return pv, warm_launches


def ingest_summary(cs, counts, wall):
    sched = counts["sched"]
    lat = cs.latencies
    return {
        "deliveries": cs.forwarded, "added": cs.added, "duplicates": cs.duplicates,
        "latency_p50_ms": percentile(lat, 0.5) * 1e3, "latency_p99_ms": percentile(lat, 0.99) * 1e3,
        "latency_max_ms": max(lat) * 1e3, "flushes": sched["flushes"],
        "lanes_submitted": sched["entries_verified"], "coalesced_lanes": sched["entries_coalesced"],
        "mean_lanes_per_flush": sched["entries_verified"] / max(1, sched["flushes"]),
        "flush_reasons": sched["flush_reasons"], "flush_errors": sched["flush_errors"],
        "fallback_flushes": sched["fallback_flushes"],
        "verdict_cache_answered": counts["cache"]["hits"], "verifier_lanes": counts["cache"]["misses"],
        "host_tier_lanes": counts["tiers"]["host"], "host_tier_cached": counts["tiers"]["host_cached"],
        "device_tier_lanes": counts["tiers"]["device"], "host_tier_s": counts["tier_s"]["host"],
        "device_tier_s": counts["tier_s"]["device"], "launches": counts["launches"],
        "wall_s": wall,
    }


def check_ingest(part, cs, pv, counts, n_valid_deliveries):
    sched = counts["sched"]
    check(not cs.errors, f"{part}: vote set errors {cs.errors[:3]}")
    check(cs.untagged_valid == 0, f"{part}: {cs.untagged_valid} valid votes forwarded untagged")
    check(pv.passthrough == len(cs.bad_outcomes),
          f"{part}: passthrough {pv.passthrough}, bad deliveries {len(cs.bad_outcomes)}")
    check(pv.batched == n_valid_deliveries, f"{part}: batched {pv.batched} of {n_valid_deliveries}")
    check(sched["flush_errors"] == 0 and sched["fallback_flushes"] == 0,
          f"{part}: flush errors {sched['flush_errors']}, fallback flushes {sched['fallback_flushes']}")
    for vs in cs.vote_sets.values():
        maj, ok = vs.two_thirds_majority()
        check(ok and maj == cs.want_block, f"{part}: no +2/3 for the block")
        valid = [i for i in range(vs.size()) if (vs.signed_msg_type, i) not in cs.bad]
        check(all(vs.get_by_index(i) is not None for i in valid), f"{part}: a valid vote is missing")


def phase_votes(commit_wl, round_wl, dev):
    """Vote ingest through ``VotePreverifier`` and the shared scheduler
    into a ``VoteSet``: 9a, the 10,000-validator flood; 9b, one round of
    150 validators with extensions. Returns the launch counts of both
    parts (warm-ups included; they start at 0)."""
    from tendermint_tpu_torch.encoding.canonical import (
        SIGNED_MSG_TYPE_PRECOMMIT,
        SIGNED_MSG_TYPE_PREVOTE,
    )
    from tendermint_tpu_torch.ops import cuda_hash, cuda_verify, precompute, resident
    from tendermint_tpu_torch.types.block import Vote
    from tendermint_tpu_torch.types.validation import verify_commit
    from tendermint_tpu_torch.types.vote_set import VoteSet

    vset, block_id, commits = commit_wl
    # A node that verified height 2's commit holds its set's tables.
    precompute.reset()
    t = time.perf_counter()
    verify_commit(CHAIN_ID, vset, block_id, commits[1].height, commits[1], device=dev)
    hold_s = time.perf_counter() - t
    check(resident.stats()["resident_keys"] == COMMIT_VALIDATORS, "phase 9: the store does not hold the set")
    precompute.results.clear()
    cuda_verify.reset_launches()  # the vote-ingest path starts here
    cuda_hash.reset_launches()

    # 9a: the flood.
    commit = commits[2]
    height = commit.height
    bad = {BAD_COMMIT_INDEX, VOTE_EXTRA_BAD, COMMIT_VALIDATORS - VOTE_EXTRA_BAD}
    sigs = [cs.signature for cs in commit.signatures]
    for i in bad - {BAD_COMMIT_INDEX}:  # commits[2] is already bad at BAD_COMMIT_INDEX
        sigs[i] = sigs[i][:40] + bytes([sigs[i][40] ^ 1]) + sigs[i][41:]

    def vote(i):
        cs = commit.signatures[i]
        return Vote(type=SIGNED_MSG_TYPE_PRECOMMIT, height=height, round=0, block_id=block_id,
                    timestamp=cs.timestamp, validator_address=cs.validator_address, validator_index=i,
                    signature=sigs[i])

    order_rng = np.random.default_rng(SEED + 9)
    deliveries = [[vote(int(i)) for i in order_rng.permutation(COMMIT_VALIDATORS)]
                  for _ in range(VOTE_PEERS)]
    vs = VoteSet(CHAIN_ID, height, 0, SIGNED_MSG_TYPE_PRECOMMIT, vset)
    cs = ConsensusStandIn(height, vset, {SIGNED_MSG_TYPE_PRECOMMIT: vs},
                          {(SIGNED_MSG_TYPE_PRECOMMIT, i) for i in bad}, block_id)
    pv, warm_launches = start_preverifier(cs)
    high_water = pv.QUEUE_MAX // 2

    def peer(k):
        # A peer connection's receive routine: it blocks while the
        # pre-verifier holds more than half its queue, as a Go reactor's
        # receive blocks on a full message queue and TCP holds the peer
        # back, so no valid vote is pushed to the inline path.
        for v in deliveries[k]:
            while pv.queue_depth() > high_water:
                time.sleep(0.0005)
            cs.submitting(v)
            pv.submit(v, f"peer{k}")

    before = ingest_counters()
    t0 = time.perf_counter()
    peers = [threading.Thread(target=peer, args=(k,), name=f"peer{k}") for k in range(VOTE_PEERS)]
    for th in peers:
        th.start()
    n = VOTE_PEERS * COMMIT_VALIDATORS
    done = cs.wait_forwarded(n, VOTE_WAIT_S)
    wall = time.perf_counter() - t0
    for th in peers:
        th.join(timeout=10)
    pv.stop()
    check(done, f"9a: {cs.forwarded} of {n} deliveries forwarded in {VOTE_WAIT_S} s")
    counts = ingest_delta(before)
    check_ingest("9a", cs, pv, counts, VOTE_PEERS * (COMMIT_VALIDATORS - len(bad)))
    check(sorted({i for i, *_ in cs.bad_outcomes}) == sorted(bad)
          and len(cs.bad_outcomes) == VOTE_PEERS * len(bad)
          and all(not tagged and err == "VoteError" and msg == "invalid signature"
                  for _, tagged, err, msg in cs.bad_outcomes),
          f"9a: bad votes {cs.bad_outcomes[:4]}")
    check("verify_resident" in counts["launches"], f"9a: K3 never launched: {counts['launches']}")
    flood = ingest_summary(cs, counts, wall)
    flood.update({
        "validators": COMMIT_VALIDATORS, "peers": VOTE_PEERS, "bad_votes": sorted(bad),
        "hold_commit_ms": hold_s * 1e3, "warmup_launches": warm_launches,
        "to_two_thirds_ms": (cs.t_quorum[SIGNED_MSG_TYPE_PRECOMMIT] - t0) * 1e3,
        "to_all_ms": (cs.t_all[SIGNED_MSG_TYPE_PRECOMMIT] - t0) * 1e3,
        "lanes_per_s": counts["cache"]["misses"] / (cs.t_all[SIGNED_MSG_TYPE_PRECOMMIT] - t0),
        "passthrough": pv.passthrough, "batched": pv.batched,
    })
    emit({"phase": "votes_flood", **flood})

    # 9b: one round of 150 validators, extensions on.
    rvset, rblock, prevotes, precommits = round_wl
    precompute.activate_validator_set(rvset)
    precompute.tables.gather([v.pub_key.bytes() for v in rvset.validators])  # a node holds these tables
    precompute.results.clear()
    sets = {SIGNED_MSG_TYPE_PREVOTE: VoteSet(CHAIN_ID, ROUND_HEIGHT, 0, SIGNED_MSG_TYPE_PREVOTE, rvset),
            SIGNED_MSG_TYPE_PRECOMMIT: VoteSet.extended(CHAIN_ID, ROUND_HEIGHT, 0,
                                                        SIGNED_MSG_TYPE_PRECOMMIT, rvset)}
    rcs = ConsensusStandIn(ROUND_HEIGHT, rvset, sets, set(), rblock)
    rpv, rwarm_launches = start_preverifier(rcs)
    arrival_rng = np.random.default_rng(SEED + 10)
    before = ingest_counters()
    t0 = time.perf_counter()
    step_ms = {}
    for name, votes in (("prevotes", prevotes), ("precommits", precommits)):
        # one gossip round-trip: the step's votes arrive uniformly over
        # ROUND_SPREAD_S, in a seeded order
        at = np.sort(arrival_rng.uniform(0.0, ROUND_SPREAD_S, len(votes)))
        order = arrival_rng.permutation(len(votes))
        start = time.perf_counter()
        for when, i in zip(at, order):
            wait = start + when - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            v = copy.copy(votes[int(i)])
            rcs.submitting(v)
            rpv.submit(v, "peer0")
        check(rcs.wait_forwarded(len(votes) * (1 + (name == "precommits")), VOTE_WAIT_S),
              f"9b: {name} not all forwarded")
        step_ms[name] = (time.perf_counter() - start) * 1e3
    wall = time.perf_counter() - t0
    rpv.stop()
    counts = ingest_delta(before)
    check_ingest("9b", rcs, rpv, counts, 2 * ROUND_VALIDATORS)
    rnd = ingest_summary(rcs, counts, wall)
    rnd.update({"validators": ROUND_VALIDATORS, "spread_ms": ROUND_SPREAD_S * 1e3,
                "step_ms": step_ms, "warmup_launches": rwarm_launches,
                "passthrough": rpv.passthrough, "batched": rpv.batched})
    emit({"phase": "votes_round", **rnd})
    counts = launches()
    precompute.reset()
    return counts


# --- phase 10 ------------------------------------------------------------------


def phase_light_round(light, dev):
    """BASELINE config 3 as one bisection round: ``evaluate_candidates``
    from header 1 to headers 16, 8, 4 and 2 and a copy of header 8 with a
    bad signature, one ``submit_many`` and one flush on the shared
    scheduler. Each outcome must equal the sequential
    ``light.verifier.verify``'s; the sequential walk over the same
    candidates is timed after the round's counts are read. Returns the
    round's launch counts (which start at 0)."""
    from tendermint_tpu_torch.crypto import batch as crypto_batch
    from tendermint_tpu_torch.encoding.canonical import Timestamp
    from tendermint_tpu_torch.light import batch as light_batch
    from tendermint_tpu_torch.light import verifier
    from tendermint_tpu_torch.ops import precompute
    from tendermint_tpu_torch.types.light import LightBlock
    from tendermint_tpu_torch.types.validation import Fraction

    chain, vset, _ = light
    now = Timestamp.from_unix_ns(chain[-1].header.time.to_unix_ns() + 2 * 10**9)
    period, drift, level = LIGHT_TRUSTING_PERIOD_S, LIGHT_MAX_CLOCK_DRIFT_S, Fraction(1, 3)
    bad = copy.deepcopy(chain[7])
    cs = bad.commit.signatures[LIGHT_ROUND_BAD_INDEX]
    cs.signature = cs.signature[:40] + bytes([cs.signature[40] ^ 1]) + cs.signature[41:]
    names = [f"header_{h}" for h in LIGHT_ROUND_CANDIDATES] + ["header_8_bad_signature"]
    base = LightBlock(chain[0], vset)
    cands = [LightBlock(chain[h - 1], vset) for h in LIGHT_ROUND_CANDIDATES] + [LightBlock(bad, vset)]
    sched = crypto_batch.get_shared_scheduler()

    def shape(outcome):
        err = outcome.error
        return outcome.kind, None if err is None else [type(err).__name__, str(err)]

    def one_round():
        precompute.results.clear()
        before = ingest_counters()
        stats0 = light_batch.stats()
        t = time.perf_counter()
        out = light_batch.evaluate_candidates(CHAIN_ID, base, cands, period, now, drift, level,
                                              device=dev)
        secs = time.perf_counter() - t
        stats = {k: v - stats0[k] for k, v in light_batch.stats().items()}
        delta = ingest_delta(before)
        check(stats["super_batches"] == 1 and stats["sequential"] == 0 and stats["timed_out"] == 0
              and stats["failed_closed"] == 0 and delta["sched"]["flushes"] == 1,
              f"light round: {stats}, {delta['sched']['flushes']} flushes")
        return secs, [shape(o) for o in out], delta, stats

    cold_s, outcomes, cold_counts, stats = one_round()  # the set's tables are built here
    reps = [one_round() for _ in range(LIGHT_ROUND_REPS)]
    counts = launches()
    for _, got, _, _ in reps:
        check(got == outcomes, "light round outcomes differ between runs")
    # The sequential verifier's outcome for each candidate, and the time
    # of the walk over all of them, with the verdict cache emptied
    # before each walk as it is before each round.
    walks = []
    for _ in range(LIGHT_ROUND_REPS):
        precompute.results.clear()
        t = time.perf_counter()
        want = [shape(light_batch._resolve_sequential(CHAIN_ID, base, cand, period, now, drift,
                                                      level, dev)) for cand in cands]
        walks.append(time.perf_counter() - t)
        check(outcomes == want, f"light round {outcomes} != sequential {want}")
    check([o[0] for o in outcomes] == ["ok"] * len(LIGHT_ROUND_CANDIDATES) + ["error"]
          and f"(#{LIGHT_ROUND_BAD_INDEX})" in outcomes[-1][1][1], f"light round outcomes {outcomes}")
    check("verify_resident" in counts, f"light round: K3 never launched: {counts}")
    steady = reps[-1][2]
    emit({"phase": "light_round", "headers": LIGHT_HEADERS, "validators": LIGHT_VALIDATORS,
          "candidates": names, "outcomes": dict(zip(names, outcomes)), "lanes": stats["lanes"],
          "cold_ms": cold_s * 1e3, "cold_launches": cold_counts["launches"],
          "round_ms": [r[0] * 1e3 for r in reps],
          "round_p50_ms": statistics.median(r[0] for r in reps) * 1e3,
          "sequential_walk_ms": [w * 1e3 for w in walks],
          "sequential_walk_p50_ms": statistics.median(walks) * 1e3,
          "flushes": steady["sched"]["flushes"], "coalesced_lanes": steady["sched"]["entries_coalesced"],
          "verifier_lanes": steady["cache"]["misses"], "verdict_cache_answered": steady["cache"]["hits"],
          "flush_reasons": steady["sched"]["flush_reasons"],
          "launches_per_round": steady["launches"], "launches": counts,
          "sched_flush_errors": sched.stats()["flush_errors"]})
    precompute.reset()
    return counts


# --- phase 11 ------------------------------------------------------------------


def profile_shares(fn) -> dict:
    """One call of ``fn`` under cProfile: the cumulative ms of the host
    costs the light client's path is read by, and each one's share of
    the profiled wall time. On Python 3.12 the profiler sees every
    thread, so the scheduler's flush thread is in it too; its time
    overlaps the calling thread's wait for it (``scheduler_wait``), so
    the shares can add up to more than 1."""
    import cProfile
    import pstats

    names = {
        "store_decode": ("light.py", "from_proto_bytes"),  # LightBlock's (the largest)
        "store_encode": ("light.py", "to_proto_bytes"),
        "validator_set_hash": ("validator_set.py", "hash"),
        "address_lookups": ("validator_set.py", "get_by_address"),
        "sign_bytes": ("canonical.py", "vote_sign_bytes"),
        "table_builds": ("precompute.py", "build_table"),
        "verify_batch": ("ed25519_batch.py", "verify_batch"),
        "round_plan": ("batch.py", "_plan_candidate"),
        "scheduler_wait": ("scheduler.py", "wait_many"),
        "verify_adjacent": ("verifier.py", "verify_adjacent"),
    }
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    try:
        fn()
    finally:
        prof.disable()
    wall_ms = (time.perf_counter() - t0) * 1e3
    stats = pstats.Stats(prof).stats
    out = {"profiled_wall_ms": wall_ms}
    for label, (base, func) in names.items():
        cum = max([c for (path, _, f), (_, _, _, c, _) in stats.items()
                   if f == func and os.path.basename(path) == base] or [0.0]) * 1e3
        out[label] = {"ms": cum, "share": cum / wall_ms}
    return out


def phase_lightd(workload, dev):
    """BASELINE config 3 as users run it: the light client
    (``light/client.py``) and its serving tier (``light/lightd.py``) over
    16 heights of 1,000 validators that slide 100 a height. 11a syncs
    from height 1 to 16 in the three modes (bisection rounds, the
    one-verify-per-pivot loop, the sequential walk); 11b the same with a
    bad signature on 16; 11c serves ``light_header`` over HTTP (a cold
    miss, hits, a herd on a cold height, bad parameters, status,
    metrics); 11d gives a witness a conflicting 16. Returns the phase's
    launch counts (which start at 0) and 11d's light client attack
    evidence."""
    import urllib.request

    from tendermint_tpu_torch.crypto import batch as crypto_batch
    from tendermint_tpu_torch.encoding.canonical import Timestamp
    from tendermint_tpu_torch.libs.metrics import LightMetrics, Registry
    from tendermint_tpu_torch.light import batch as light_batch
    from tendermint_tpu_torch.light.client import DivergedHeaderError, LightClient, TrustOptions
    from tendermint_tpu_torch.light.lightd import LightServer
    from tendermint_tpu_torch.light.provider import MemoryProvider, RetryingProvider
    from tendermint_tpu_torch.light.store import LightStore
    from tendermint_tpu_torch.ops import precompute
    from tendermint_tpu_torch.rpc.server import INTERNAL_ERROR, INVALID_PARAMS

    chain, bad_top, fork_top = workload
    top = LIGHTD_HEADERS
    now = Timestamp.from_unix_ns(chain[-1].header.time.to_unix_ns() + 2 * 10**9)
    sched = crypto_batch.get_shared_scheduler()
    flush_errors0 = sched.stats()["flush_errors"]
    failed_closed0 = light_batch.stats()["failed_closed"]

    class CountingStore(LightStore):
        """The client's store, counting the blocks it decodes."""

        decodes = 0

        def _counted(self, lb):
            if lb is not None:
                self.decodes += 1
            return lb

        def light_block(self, height):
            return self._counted(super().light_block(height))

        def latest_light_block(self):
            return self._counted(super().latest_light_block())

        def first_light_block(self):
            return self._counted(super().first_light_block())

        def light_block_before(self, height):
            return self._counted(super().light_block_before(height))

    modes = {
        "batched": {"bisect_batching": True},
        "skipping": {"bisect_batching": False},
        "sequential": {"sequential": True},
    }

    def client(blocks, mode, witness_blocks=None, metrics=None):
        witness = MemoryProvider(CHAIN_ID, chain if witness_blocks is None else witness_blocks)
        return LightClient(
            CHAIN_ID, TrustOptions(period=LIGHT_TRUSTING_PERIOD_S, height=1, hash=blocks[0].hash()),
            RetryingProvider(MemoryProvider(CHAIN_ID, blocks)), [witness], store=CountingStore(),
            max_clock_drift=LIGHT_MAX_CLOCK_DRIFT_S, now=lambda: now, metrics=metrics, device=dev,
            **modes[mode])

    def sync(mode, blocks=chain):
        """A fresh client over ``blocks`` with the verdict cache emptied,
        and its timed ``verify_light_block_at_height(16)``: the block (or
        the error) and the run's counters."""
        precompute.results.clear()
        c = client(blocks, mode)
        decodes0 = c.store.decodes
        before, stats0 = ingest_counters(), light_batch.stats()
        builds0 = precompute.tables.builds
        t = time.perf_counter()
        try:
            got = c.verify_light_block_at_height(top)
        except Exception as exc:  # 11b compares what escaped
            got = exc
        secs = time.perf_counter() - t
        d = ingest_delta(before)
        counts = {
            "ms": secs * 1e3, "rounds": light_batch.stats()["rounds"] - stats0["rounds"],
            "round_lanes": light_batch.stats()["lanes"] - stats0["lanes"],
            "flushes": d["sched"]["flushes"], "verifier_lanes": d["cache"]["misses"],
            "verdict_cache_answered": d["cache"]["hits"],
            "table_builds": precompute.tables.builds - builds0,
            "store_decodes": c.store.decodes - decodes0, "store_heights": c.store.heights(),
            "launches": d["launches"],
        }
        return got, counts

    # 11a: skipping sync, three ways
    want_heights = {"batched": LIGHTD_STORE_HEIGHTS, "skipping": LIGHTD_STORE_HEIGHTS,
                    "sequential": list(range(1, top + 1))}
    syncs = {}
    for mode in modes:
        precompute.reset()  # cold: no table, no verdict
        lb, cold = sync(mode)
        check(not isinstance(lb, Exception), f"phase 11a {mode}: {lb!r}")
        runs = []
        for _ in range(LIGHTD_REPS):
            got, counts = sync(mode)
            check(not isinstance(got, Exception) and got.hash() == chain[-1].hash(),
                  f"phase 11a {mode}: {got!r}")
            runs.append(counts)
        for counts in [cold] + runs:
            check(counts["store_heights"] == want_heights[mode],
                  f"phase 11a {mode}: stored heights {counts['store_heights']}")
            check(counts["rounds"] == (LIGHTD_ROUNDS if mode == "batched" else 0)
                  and counts["flushes"] == (LIGHTD_ROUNDS if mode == "batched" else 0),
                  f"phase 11a {mode}: {counts['rounds']} rounds, {counts['flushes']} flushes")
            check(counts["launches"].get("verify_resident", 0) > 0, f"phase 11a {mode}: K3 never launched")
        check(lb.hash() == chain[-1].hash(), f"phase 11a {mode}: trusted block 16 differs")
        syncs[mode] = {"cold": cold, "runs_ms": [r["ms"] for r in runs],
                       "p50_ms": statistics.median(r["ms"] for r in runs), "steady": runs[-1]}
    profiles = {}
    for name, mode in (("batched_cold", "batched"), ("sequential", "sequential")):
        if name == "batched_cold":
            precompute.reset()
        precompute.results.clear()
        profiles[name] = profile_shares(lambda: client(chain, mode).verify_light_block_at_height(top))
    emit({"phase": "light_sync", "headers": LIGHTD_HEADERS, "validators": LIGHTD_VALIDATORS,
          "slide": LIGHTD_SLIDE, "modes": syncs, "host_profile": profiles})

    # 11b: a bad signature on the target
    bad_chain = chain[:-1] + [bad_top]
    errors = {}
    for mode in modes:
        got, _ = sync(mode, bad_chain)
        check(isinstance(got, Exception), f"phase 11b {mode}: a bad target was accepted")
        errors[mode] = [type(got).__name__, str(got)]
    check(len({tuple(e) for e in errors.values()}) == 1 and errors["batched"][0] == "InvalidHeaderError"
          and errors["batched"][1].startswith(f"wrong signature (#{LIGHTD_BAD_INDEX}): "),
          f"phase 11b: the modes disagree: {errors}")
    emit({"phase": "light_bad_target", "errors": errors})

    # 11c: lightd
    def get(url):
        with urllib.request.urlopen(url, timeout=60) as resp:
            return resp.read()

    def serve(witness_blocks=None):
        reg = Registry()
        metrics = LightMetrics(reg)
        srv = LightServer(client(chain, "batched", witness_blocks, metrics), metrics=metrics, registry=reg)
        srv.start()
        return srv

    srv = serve()
    try:
        url = srv.url + f"/light_header?height={top}"
        precompute.results.clear()
        before, stats0 = ingest_counters(), light_batch.stats()
        t = time.perf_counter()
        miss = get(url)
        cold_ms = (time.perf_counter() - t) * 1e3
        cold_counts = ingest_delta(before)
        cold_rounds = light_batch.stats()["rounds"] - stats0["rounds"]
        result = json.loads(miss)["result"]
        check(result["hash"] == chain[-1].hash().hex().upper()
              and result["trust_path"] == [str(h) for h in LIGHTD_STORE_HEIGHTS[1:]]
              and cold_rounds == LIGHTD_ROUNDS and cold_counts["launches"],
              f"phase 11c: cold serve {result.get('trust_path')}, {cold_rounds} rounds")
        check(get(url) == miss, "phase 11c: the hit's payload differs from the miss's")
        # the same client and cache behind a threaded server, for the
        # hits in turns with the event loop
        threaded = LightServer(srv.client, cache=srv.cache, metrics=srv.metrics,
                               registry=srv.server.metrics_registry, evloop=False)
        threaded.start()
        check(srv.server.transport == "evloop" and threaded.server.transport == "threaded",
              f"phase 11c: transports {srv.server.transport}, {threaded.server.transport}")
        lat = {"evloop": [], "threaded": []}
        hit_wall = {"evloop": 0.0, "threaded": 0.0}
        lat_mtx = threading.Lock()

        def hits(turl, side, n):
            mine = []
            for _ in range(n):
                t = time.perf_counter()
                body = get(turl)
                mine.append(time.perf_counter() - t)
                check(body == miss, "phase 11c: a hit's payload differs")
            with lat_mtx:
                lat[side].extend(mine)

        try:
            per_thread = LIGHTD_HIT_REQUESTS // LIGHTD_HIT_TURNS // LIGHTD_HIT_THREADS
            for _ in range(LIGHTD_HIT_TURNS):
                for side, server in (("evloop", srv), ("threaded", threaded)):
                    turl = server.url + f"/light_header?height={top}"
                    threads = [threading.Thread(target=hits, args=(turl, side, per_thread))
                               for _ in range(LIGHTD_HIT_THREADS)]
                    t = time.perf_counter()
                    for th in threads:
                        th.start()
                    for th in threads:
                        th.join(300)
                    hit_wall[side] += time.perf_counter() - t
        finally:
            threaded.stop()
        check(all(len(v) == LIGHTD_HIT_REQUESTS for v in lat.values()),
              f"phase 11c: {[len(v) for v in lat.values()]} hits answered")
        bad_params = {h: json.loads(get(srv.url + f"/light_header?height={h}"))["error"]["code"]
                      for h in ("0", "x")}
        check(set(bad_params.values()) == {INVALID_PARAMS}, f"phase 11c: bad params {bad_params}")
        status = json.loads(get(srv.url + "/light_status"))["result"]
        check(status["trusted_height"] == str(top) and status["cache"]["entries"] == 1,
              f"phase 11c: status {status}")
        metrics_text = get(srv.url + "/metrics").decode()
        families = sorted({line.split()[2] for line in metrics_text.splitlines()
                           if line.startswith("# TYPE tendermint_light_")})
        hits_line = f"tendermint_light_cache_hits_total {2 * LIGHTD_HIT_REQUESTS + 1}"
        check(len(families) == 5 and hits_line in metrics_text, f"phase 11c: metrics families {families}")
    finally:
        srv.stop()
    # the herd: LIGHTD_HERD threads ask a fresh server for its cold 16 at once
    srv = serve()
    try:
        precompute.results.clear()
        gate = threading.Barrier(LIGHTD_HERD)
        answers = []

        def herd():
            gate.wait(60)
            answers.append(get(srv.url + f"/light_header?height={top}"))

        heights0, stats0 = srv.client.store.heights(), light_batch.stats()
        threads = [threading.Thread(target=herd) for _ in range(LIGHTD_HERD)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(300)
        herd_rounds = light_batch.stats()["rounds"] - stats0["rounds"]
        new_heights = sorted(set(srv.client.store.heights()) - set(heights0))
        check(len(answers) == LIGHTD_HERD and len(set(answers)) == 1
              and json.loads(answers[0])["result"]["hash"] == chain[-1].hash().hex().upper(),
              "phase 11c: the herd's answers differ")
        check(herd_rounds == LIGHTD_ROUNDS and new_heights == LIGHTD_STORE_HEIGHTS[1:],
              f"phase 11c: the herd verified {herd_rounds} rounds, stored {new_heights}")
    finally:
        srv.stop()
    # one miss of a fresh server under the profiler, called in-process
    srv = serve()
    try:
        precompute.results.clear()
        miss_profile = profile_shares(lambda: srv.light_header(height=top))
    finally:
        srv.stop()
    emit({"phase": "lightd", "cold_serve_ms": cold_ms, "cold_launches": cold_counts["launches"],
          "cold_rounds": cold_rounds, "cold_flushes": cold_counts["sched"]["flushes"],
          "hit_requests": LIGHTD_HIT_REQUESTS, "hit_threads": LIGHTD_HIT_THREADS, "hit_turns": LIGHTD_HIT_TURNS,
          "hit_p50_ms": statistics.median(lat["evloop"]) * 1e3,
          "hit_p99_ms": percentile(lat["evloop"], 0.99) * 1e3,
          "hits_per_s": LIGHTD_HIT_REQUESTS / hit_wall["evloop"],
          "threaded": {"hit_p50_ms": statistics.median(lat["threaded"]) * 1e3,
                       "hit_p99_ms": percentile(lat["threaded"], 0.99) * 1e3,
                       "hits_per_s": LIGHTD_HIT_REQUESTS / hit_wall["threaded"]},
          "herd_threads": LIGHTD_HERD,
          "herd_rounds": herd_rounds, "herd_new_store_heights": new_heights,
          "bad_params": bad_params, "status": status, "metrics_families": families,
          "host_profile_miss": miss_profile})

    # 11d: a witness with a conflicting 16
    forked = chain[:-1] + [fork_top]
    precompute.results.clear()
    c = client(chain, "batched", forked)
    try:
        c.verify_light_block_at_height(top)
        check(False, "phase 11d: the fork was not detected")
    except DivergedHeaderError as exc:
        evidence = exc.evidence
    reported = c.primary.inner.evidence
    check([e.hash() for e in reported] == [evidence.hash()]
          and evidence.conflicting_block.hash() == fork_top.hash()
          and evidence.common_height == LIGHTD_STORE_HEIGHTS[-2] and top not in c.store.heights(),
          f"phase 11d: evidence {len(reported)}, common height {evidence.common_height}")
    srv = serve(forked)
    try:
        precompute.results.clear()
        below = json.loads(get(srv.url + "/light_header?height=4"))["result"]
        check(below["height"] == "4" and len(srv.cache) == 1, "phase 11d: height 4 not served")
        err = json.loads(get(srv.url + f"/light_header?height={top}"))["error"]
        check(err["code"] == INTERNAL_ERROR and "light client attack" in err["message"]
              and err["data"] == "invalidated 1 cached headers" and len(srv.cache) == 0,
              f"phase 11d: lightd answered {err}")
    finally:
        srv.stop()
    emit({"phase": "light_fork", "evidence_hash": evidence.hash().hex(),
          "common_height": evidence.common_height, "reported_to_primary": len(reported),
          "lightd_error": {k: err[k] for k in ("code", "message", "data")}})
    check(sched.stats()["flush_errors"] == flush_errors0
          and light_batch.stats()["failed_closed"] == failed_closed0, "phase 11: a flush failed")
    counts = launches()
    check(counts.get("verify_resident", 0) > 0, f"phase 11: K3 never launched: {counts}")
    precompute.reset()
    return counts, evidence


# --- phase 6 -------------------------------------------------------------------


def phase_faults(ed_lanes, sr_lanes, dev):
    """Injected faults on small batches of both engines (see the module
    note); leaves the health machine reset."""
    import warnings

    from tendermint_tpu_torch.crypto import ed25519_ref as ref, sr25519 as sr
    from tendermint_tpu_torch.libs import flightrec
    from tendermint_tpu_torch.ops import _build, device_policy, fault_injection, precompute
    from tendermint_tpu_torch.ops import verify_batch
    from tendermint_tpu_torch.ops.sr25519_batch import verify_batch_sr

    health = device_policy.shared
    ed = [x[:FAULT_ED_LANES] for x in ed_lanes[:3]]
    srl = [x[:FAULT_SR_LANES] for x in sr_lanes[:3]]
    wants = {"ed25519": [ref.verify_zip215(*lane) for lane in zip(*ed)],
             "sr25519": [sr.verify(*lane) for lane in zip(*srl)]}
    check(not all(wants["ed25519"]) and not all(wants["sr25519"]), "fault phase: no bad lane")

    def run_ed():
        precompute.results.clear()  # the device, not the verdict cache, answers
        return verify_batch(*ed, device=dev)

    runs = {"ed25519": run_ed, "sr25519": lambda: verify_batch_sr(*srl, device=dev)}

    def injected(engine, **plan):
        with warnings.catch_warnings(record=True) as warned:
            warnings.simplefilter("always")
            with fault_injection.inject(**plan) as p:
                t = time.perf_counter()
                got = runs[engine]()
                secs = time.perf_counter() - t
        return got, p, secs, len(warned)

    def raised(engine, **plan):
        """The error ``engine``'s batch raised under ``plan``, or None."""
        with fault_injection.inject(**plan) as p:
            try:
                runs[engine]()
            except Exception as exc:  # the phase checks what escaped
                return exc, p
        return None, p

    precompute.reset()
    strict = {}
    check(not health.host_fallback, "host fallback is on by default")
    for site in ("ed25519.chunk", "ed25519.collect", "sr25519.chunk"):
        engine = site.split(".")[0]
        health.reset()
        exc, plan = raised(engine, site=site, fail_calls=(1,))
        snap = health.snapshot()
        check(isinstance(exc, fault_injection.DeviceFault) and plan.faults_raised == 1
              and snap["state"] == "degraded" and snap["failures"]["transient"] == 1
              and snap["fallback_batches"] == 0,
              f"{site}: without host fallback the fault must be recorded and raised: {exc!r} {snap}")
        check(runs[engine]() == wants[engine] and health.state == "healthy",
              f"{site}: the next batch did not use the card again")
        strict[site] = {"raised": type(exc).__name__, "fallback_lanes": 0}
    health.reset()
    exc, _ = raised("sr25519", site="sr25519.chunk", fail_calls=(1,),
                    error_factory=lambda: _build.CudaError("sr25519_verify_launch", 719))
    check(isinstance(exc, _build.CudaError) and health.state == "disabled",
          f"sticky CudaError 719: {exc!r}, state {health.state}")
    refused = [type(raised(e, fail_from=1, fail_count=10**6)[0]).__name__ for e in ("ed25519", "sr25519")]
    check(refused == ["DeviceRefused"] * 2 and not any(health.snapshot()["fallback_lanes"].values()),
          f"disabled card without host fallback: {refused} {health.snapshot()}")
    strict["sticky_719"] = {"raised": type(exc).__name__, "then": refused}

    health.host_fallback = True
    try:
        cases = fallback_cases(health, wants, runs, injected)
    finally:
        health.host_fallback = False
    typed = {code: device_policy.classify_failure(_build.CudaError("sr25519_verify_launch", code))
             for code in (700, 2)}
    check(typed == {700: "permanent", 2: "transient"}, f"CudaError classes {typed}")
    # the flight recorder, installed in this process: transient faults
    # on the retry budget's worth of batches escalate the card to
    # cooldown, and the transition's instant dumps the ring
    root = os.path.dirname(os.path.abspath(__file__))
    rec = flightrec.FlightRecorder(dump_dir=os.path.join(root, "build", "flightrec"))
    health.reset()
    rec.install(signals=False)
    try:
        for _ in range(health.retry_budget):
            exc, _ = raised("ed25519", site="ed25519.chunk", fail_calls=(1,))
            check(isinstance(exc, fault_injection.DeviceFault), f"flight recorder: {exc!r} escaped")
        state, path = health.state, rec.last_dump_path()
    finally:
        rec.uninstall()
        health.reset()
    check(state == "cooldown" and path is not None, f"flight recorder: state {state}, dump {path}")
    with open(path) as f:
        doc = json.load(f)
    check(doc["schema"] == flightrec.DUMP_SCHEMA and doc["reason"] == "device_cooldown"
          and any(r["name"] == "device_health_transition" and r["fields"].get("to_state") == "cooldown"
                  for r in doc["records"]),
          f"flight recorder: dump {doc.get('schema')} {doc.get('reason')}")
    dumped = {"path": path, "reason": doc["reason"], "records": len(doc["records"]),
              "kinds": sorted({r["kind"] for r in doc["records"]})}
    emit({"phase": "faults", "ed25519_lanes": FAULT_ED_LANES, "sr25519_lanes": FAULT_SR_LANES,
          "bad_lanes": {e: w.count(False) for e, w in wants.items()}, "without_host_fallback": strict,
          "with_host_fallback": cases, "cuda_error_classes": {str(k): v for k, v in typed.items()},
          "flight_recorder": dumped})


def fallback_cases(health, wants, runs, injected) -> dict:
    """Phase 6 with host fallback on: transient faults at the three
    sites, then a permanent one."""
    cases = {}
    for site in ("ed25519.chunk", "ed25519.collect", "sr25519.chunk"):
        engine = site.split(".")[0]
        n = len(wants[engine])
        health.reset()
        got, plan, secs, warned = injected(engine, site=site, fail_calls=(1,))
        snap = health.snapshot()
        check(got == wants[engine], f"{site}: verdicts wrong under a transient fault")
        check(plan.faults_raised == 1 and warned >= 1 and snap["state"] == "degraded"
              and snap["failures"]["transient"] == 1 and snap["fallback_lanes"][engine] == n,
              f"{site}: transient fault not absorbed as expected: {snap}")
        check(runs[engine]() == wants[engine], f"{site}: verdicts wrong after the fault")
        after = health.snapshot()
        check(after["state"] == "healthy" and after["fallback_lanes"][engine] == n
              and after["transitions"] == [("healthy", "degraded"), ("degraded", "healthy")],
              f"{site}: no recovery after the next success: {after}")
        cases[site] = {"lanes": n, "fallback_lanes": n, "fallback_s": secs,
                       "transitions": after["transitions"]}
    health.reset()
    got, plan, secs, _ = injected("sr25519", site="sr25519.chunk", fail_calls=(1,), permanent=True)
    check(got == wants["sr25519"] and health.state == "disabled",
          f"permanent fault: verdicts or state wrong ({health.state})")
    # Disabled: the other engine answers on the host without a device try.
    got_ed, plan_ed, _, _ = injected("ed25519", fail_from=1, fail_count=10**6)
    snap = health.snapshot()
    check(got_ed == wants["ed25519"] and plan_ed.calls == 0
          and snap["fallback_lanes"] == {"ed25519": FAULT_ED_LANES, "sr25519": FAULT_SR_LANES},
          f"disabled card: {snap}")
    cases["permanent"] = {"state": snap["state"], "fallback_lanes": snap["fallback_lanes"],
                          "sr25519_fallback_s": secs}
    return cases


# --- phase 12 ------------------------------------------------------------------

OBSERVED_RING_CAP = 1 << 17  # spans phase 12 keeps; a lightd cold serve opens about 2,000
OVERHEAD_REPS = 5  # steady commits a side in 12f
PROFILE_TOP_OPS = 10
PROFILE_IDLE_GAPS = 5
PROFILE_SAMPLES = 256  # points a stretch of the trace is sampled at for its host spans
SPAN_COST_REPS = 20_000  # spans timed for 12f's cost a span
# The kernels' function names, as the profiler reports them.
KERNEL_FUNCTIONS = {
    "verify": "ed25519_verify_kernel", "verify_tables": "ed25519_verify_tables_kernel",
    "verify_resident": "ed25519_verify_resident_kernel", "verify_sr": "sr25519_verify_kernel",
    "challenge": "sha512_challenge_kernel",
}


def spans_of(events, name, **tags):
    """The completed spans called ``name`` whose args hold ``tags``."""
    return [e for e in events if e.get("ph") == "X" and e["name"] == name
            and all(e["args"].get(k) == v for k, v in tags.items())]


def stage_spans(events):
    """{(stage, engine): count} of the spans tagged with both."""
    out = {}
    for e in events:
        stage, engine = e["args"].get("stage"), e["args"].get("engine")
        if e.get("ph") == "X" and stage and engine:
            out[(stage, engine)] = out.get((stage, engine), 0) + 1
    return out


def stage_histogram(ops):
    """{(stage, engine): observations} of ``verify_stage_seconds``."""
    return {(dict(k)["stage"], dict(k)["engine"]): n for k, n in ops.verify_stage_seconds.counts().items()}


class Observed:
    """Phase 12's instruments and the readings a part is checked by: the
    tracer's ring in ``ring`` mode, one ``OpsMetrics`` (and the
    ``LightMetrics`` lightd serves) in one registry, bound to every unit,
    the stage observer and the kernel profiler."""

    def __init__(self):
        from tendermint_tpu_torch import ops as tops
        from tendermint_tpu_torch.libs import tracing
        from tendermint_tpu_torch.libs.metrics import LightMetrics, OpsMetrics, Registry
        from tendermint_tpu_torch.ops import introspect

        self.tracing, self.introspect = tracing, introspect
        self.registry = Registry()
        self.ops = OpsMetrics(self.registry)
        self.light = LightMetrics(self.registry)
        tops.bind_metrics(self.ops)
        self.on()

    def on(self):
        self.tracing.configure("ring", cap=OBSERVED_RING_CAP)
        self.tracing.tracer.set_metrics_observer(self.tracing.metrics_observer(ops=self.ops))
        self.introspect.install()

    def off(self):
        self.tracing.configure("off")
        self.tracing.tracer.set_metrics_observer(None)
        self.introspect.uninstall()

    def close(self):
        from tendermint_tpu_torch import ops as tops

        self.off()
        self.tracing.tracer.clear()
        tops.bind_metrics(None)

    def mark(self):
        """What a part's checks are deltas from."""
        from tendermint_tpu_torch.ops import hash512, precompute, resident

        return {"launches": launches(), "resident": resident.stats(),
                "results": precompute.results.stats(), "hash": hash512.stats(),
                "stages": stage_histogram(self.ops), "counters": self.counters(),
                "ring": self.tracing.tracer.recorded}

    def counters(self):
        ops = self.ops
        out = {name: getattr(ops, attr).value() for name, attr in (
            ("table_resident_hits", "table_resident_hits"),
            ("table_resident_misses", "table_resident_misses"),
            ("result_cache_hits", "result_cache_hits"), ("result_cache_misses", "result_cache_misses"),
            ("hash_device_lanes", "hash_device_lanes"), ("precompute_builds", "precompute_builds"))}
        for engine in ("ed25519", "sr25519"):
            out[f"fallback_lanes_{engine}"] = ops.device_fallback_lanes.value(engine=engine)
        for kind in ("transient", "permanent"):
            out[f"failures_{kind}"] = ops.device_failures.value(kind=kind)
        with ops.device_transitions._lock:
            out["transitions"] = sum(ops.device_transitions._values.values())
        return out

    def since(self, mark):
        """The events of the ring since ``mark`` (the ring must not have
        wrapped) and every delta the checks read."""
        from tendermint_tpu_torch.ops import hash512, precompute, resident

        tracer = self.tracing.tracer
        new = tracer.recorded - mark["ring"]
        check(new <= tracer.cap, f"phase 12: {new} events overflowed the ring of {tracer.cap}")
        events = tracer.events()[-new:] if new else []
        sub = lambda a, b: {k: a[k] - b.get(k, 0) for k in a if a[k] - b.get(k, 0)}
        return events, {
            "launches": sub(launches(), mark["launches"]),
            "resident": sub(resident.stats(), mark["resident"]),
            "results": sub(precompute.results.stats(), mark["results"]),
            "hash": sub(hash512.stats(), mark["hash"]),
            "stages": sub(stage_histogram(self.ops), mark["stages"]),
            "counters": sub(self.counters(), mark["counters"]),
        }


def check_engine_spans(part, events, d, engine, kernel, chunks=None, kind=None, parent="verify_batch"):
    """A part's per-chunk spans of ``engine``: one prep, dispatch and
    collect a chunk (``kind`` where given) under ``parent``, as many
    dispatches as ``kernel`` launches, no host fallback."""
    tags = {"engine": engine, **({"kind": kind} if kind else {})}
    counts = {name: len(spans_of(events, name, **tags))
              for name in ("prep_chunk", "dispatch_chunk", "collect_chunk")}
    launched = d["launches"].get(kernel, 0)
    check(counts["dispatch_chunk"] == launched > 0,
          f"{part}: {counts['dispatch_chunk']} dispatch_chunk spans of {engine}, {launched} {kernel} launches")
    check(counts["prep_chunk"] == counts["collect_chunk"] == launched,
          f"{part}: per-chunk spans {counts}, {launched} launches")
    if chunks is not None:
        check(launched == chunks, f"{part}: {launched} {kernel} launches, expected {chunks}")
    check(not spans_of(events, "host_fallback"), f"{part}: a host_fallback span")
    for name in counts:
        for e in spans_of(events, name, **tags):
            check(e["args"]["parent"] == parent, f"{part}: {name} under {e['args']['parent']}")
    return counts


def check_stage_histogram(part, events, d):
    """The stage histogram observed exactly the part's stage spans."""
    check(d["stages"] == stage_spans(events),
          f"{part}: stage histogram {d['stages']} != stage spans {stage_spans(events)}")


def check_ledger(part):
    """The resident store's bytes in the ledger, its gauge and memstats
    equal the store tensor's, within what the card holds."""
    import torch

    from tendermint_tpu_torch.ops import introspect, resident

    nbytes = resident.store.device_nbytes()
    ledger = introspect.accountant.bytes_for("resident_tables")
    mem = introspect.memstats()
    gauge = OBSERVED.ops.device_bytes.value(owner="resident_tables")
    allocated = torch.cuda.memory_allocated()
    check(nbytes == ledger == gauge == mem["device_bytes"].get("resident_tables", 0) <= allocated,
          f"{part}: store {nbytes} B, ledger {ledger}, gauge {gauge}, memstats {mem['device_bytes']}, "
          f"allocated {allocated}")
    return {"store_bytes": nbytes, "ledger_bytes": ledger, "memory_allocated": allocated}


OBSERVED = None  # phase 12's instruments, while it runs


def restore_tables(vset, tables):
    """Activate ``vset`` and put its host tables, built in the set-up's
    pool, into the cache."""
    from tendermint_tpu_torch.ops import precompute

    precompute.activate_validator_set(vset)
    for pk, tab, ok in tables:
        precompute.tables.insert(pk, tab, ok)


def observed_commit(commit_wl, dev):
    """12a: the steady 10,000-validator commit, verdict cache emptied, then
    warm."""
    from tendermint_tpu_torch.ops import precompute
    from tendermint_tpu_torch.types.validation import verify_commit

    vset, block_id, commits = commit_wl
    c = commits[1]
    chunks = len(chunk_sizes(COMMIT_VALIDATORS))
    mark = OBSERVED.mark()
    precompute.results.clear()
    t = time.perf_counter()
    verify_commit(CHAIN_ID, vset, block_id, c.height, c, device=dev)
    cold_s = time.perf_counter() - t
    t = time.perf_counter()
    verify_commit(CHAIN_ID, vset, block_id, c.height, c, device=dev)
    warm_s = time.perf_counter() - t
    events, d = OBSERVED.since(mark)
    part = "phase 12a"
    vcs = spans_of(events, "verify_commit")
    check(len(vcs) == 2 and all(e["args"] == {"height": c.height, "round": c.round,
                                              "sigs": COMMIT_VALIDATORS} for e in vcs),
          f"{part}: verify_commit spans {[e['args'] for e in vcs]}")
    vbs = spans_of(events, "verify_batch", engine="ed25519")
    check(len(vbs) == 2 and all(e["args"]["parent"] == "verify_commit" for e in vbs),
          f"{part}: verify_batch spans {[e['args'] for e in vbs]}")
    hits = [e["args"]["hits"] for e in spans_of(events, "cache_lookup")]
    check(hits == [0, COMMIT_VALIDATORS], f"{part}: cache_lookup hits {hits}")
    counts = check_engine_spans(part, events, d, "ed25519", "verify_resident", chunks, "resident")
    check(not spans_of(events, "dispatch_chunk", kind="tables")
          and not spans_of(events, "dispatch_chunk", kind="legacy"), f"{part}: a K1 or K2 chunk")
    check_stage_histogram(part, events, d)
    k = d["counters"]
    check(k.get("table_resident_hits", 0) == d["resident"].get("hits", 0) == COMMIT_VALIDATORS
          and k.get("table_resident_misses", 0) == d["resident"].get("misses", 0),
          f"{part}: resident counters {k} vs stats {d['resident']}")
    check(k.get("result_cache_hits", 0) == d["results"].get("hits", 0) == COMMIT_VALIDATORS
          and k.get("result_cache_misses", 0) == d["results"].get("misses", 0) == COMMIT_VALIDATORS,
          f"{part}: result-cache counters {k} vs stats {d['results']}")
    check(k.get("hash_device_lanes", 0) == d["hash"].get("device_lanes", 0),
          f"{part}: hash counter {k} vs stats {d['hash']}")
    check(k.get("precompute_builds", 0) == 0, f"{part}: table builds {k}: the saved tables were not used")
    ledger = check_ledger(part)
    check(ledger["store_bytes"] == (COMMIT_VALIDATORS + 1) * TABLE_BYTES, f"{part}: store {ledger}")
    check(OBSERVED.ops.inflight_lanes.value(engine="ed25519") == 0, f"{part}: lanes left in flight")
    uploads = spans_of(events, "resident_upload")
    check(len(uploads) == d["resident"].get("uploads", 0) == 1
          and uploads[0]["args"]["bytes"] == ledger["store_bytes"], f"{part}: uploads {uploads}")
    check_healthy(part)
    return {"cold_ms": cold_s * 1e3, "warm_ms": warm_s * 1e3, "spans": counts,
            "launches": d["launches"], "stage_spans": {f"{s}/{e}": n for (s, e), n in stage_spans(events).items()},
            "counters": k, **ledger}


def observed_mixed(mixed_wl, dev):
    """12b: the mixed commit, once: K5 under sr25519 spans, K3 under
    ed25519 spans."""
    from tendermint_tpu_torch.ops import precompute
    from tendermint_tpu_torch.types.validation import verify_commit

    vset, block_id, commit, _, _ = mixed_wl
    n_sr = sum(v.pub_key.type == "sr25519" for v in vset.validators)
    mark = OBSERVED.mark()
    precompute.results.clear()
    t = time.perf_counter()
    verify_commit(CHAIN_ID, vset, block_id, commit.height, commit, device=dev)
    secs = time.perf_counter() - t
    events, d = OBSERVED.since(mark)
    part = "phase 12b"
    sr = check_engine_spans(part, events, d, "sr25519", "verify_sr", len(chunk_sizes(n_sr)),
                            parent="verify_commit")
    ed = check_engine_spans(part, events, d, "ed25519", "verify_resident",
                            len(chunk_sizes(MIXED_VALIDATORS - n_sr)), "resident")
    check_stage_histogram(part, events, d)
    k = d["counters"]
    check(k.get("hash_device_lanes", 0) == d["hash"].get("device_lanes", 0),
          f"{part}: hash counter {k} vs stats {d['hash']}")
    check(k.get("result_cache_misses", 0) == d["results"].get("misses", 0),
          f"{part}: result-cache counters {k} vs stats {d['results']}")
    check_ledger(part)
    check_healthy(part)
    return {"ms": secs * 1e3, "sr25519_spans": sr, "ed25519_spans": ed, "launches": d["launches"],
            "hash_device_lanes": d["hash"].get("device_lanes", 0), "counters": k}


def observed_faults(ed_lanes, dev):
    """12c: a transient fault on one chunk, with host fallback off (it
    escapes) and on (the host answers the chunk)."""
    import warnings

    from tendermint_tpu_torch.crypto import ed25519_ref as ref
    from tendermint_tpu_torch.ops import device_policy, fault_injection, precompute, verify_batch

    health = device_policy.shared
    ed = [x[:FAULT_ED_LANES] for x in ed_lanes[:3]]
    want = [ref.verify_zip215(*lane) for lane in zip(*ed)]

    def run():
        precompute.results.clear()
        return verify_batch(*ed, device=dev)

    part = "phase 12c"
    health.reset()
    mark = OBSERVED.mark()
    with fault_injection.inject(site="ed25519.chunk", fail_calls=(1,)) as plan:
        try:
            run()
            raised = None
        except fault_injection.DeviceFault as exc:
            raised = exc
    check(raised is not None and plan.faults_raised == 1, f"{part}: the fault did not escape")
    check(OBSERVED.ops.inflight_lanes.value(engine="ed25519") == 0,
          f"{part}: lanes left in flight after the escaped fault")
    check(run() == want and health.state == "healthy", f"{part}: no recovery after the fault")
    check(not spans_of(OBSERVED.since(mark)[0], "host_fallback"),
          f"{part}: a host_fallback span with host fallback off")
    health.host_fallback = True
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with fault_injection.inject(site="ed25519.chunk", fail_calls=(1,)) as plan:
                got = run()
    finally:
        health.host_fallback = False
    check(got == want and plan.faults_raised == 1, f"{part}: verdicts under host fallback")
    check(run() == want and health.state == "healthy", f"{part}: no recovery after the fallback")
    events, d = OBSERVED.since(mark)
    snap = health.snapshot()
    k = d["counters"]
    fb = spans_of(events, "host_fallback", engine="ed25519", stage="fallback")
    fb_lanes = sum(e["args"]["lanes"] for e in fb)
    check(len(fb) == 1 and fb_lanes == k.get("fallback_lanes_ed25519", 0)
          == snap["fallback_lanes"]["ed25519"] == FAULT_ED_LANES,
          f"{part}: host_fallback spans {fb_lanes} lanes, counter {k}, snapshot {snap}")
    instants = [e for e in events if e.get("ph") == "i" and e["name"] == "device_health_transition"]
    edges = [(e["args"]["from_state"], e["args"]["to_state"]) for e in instants]
    check(edges == snap["transitions"] and len(edges) == k.get("transitions", 0) == 4,
          f"{part}: transition instants {edges}, counter {k}, snapshot {snap['transitions']}")
    check(k.get("failures_transient", 0) == snap["failures"]["transient"] == 2,
          f"{part}: failures {k} vs {snap['failures']}")
    check_stage_histogram(part, events, d)
    health.reset()
    return {"lanes": FAULT_ED_LANES, "raised_without_fallback": type(raised).__name__,
            "fallback_span_lanes": fb_lanes, "transitions": edges, "counters": k}


def trace_ancestors(by_id, event):
    """The span ids above ``event`` through its parent_span_id links."""
    out, sid = [], event.get("parent_span_id")
    while sid and sid not in out:
        out.append(sid)
        sid = by_id.get(sid, {}).get("parent_span_id")
    return out


def observed_lightd(lightd_wl, dev):
    """12d: phase 11's server with the ops metrics in its registry: a
    cold ``light_header`` whose request carries a ``trace`` member, then
    ``/metrics``, ``/debug/traces`` and ``/debug/memstats``."""
    import urllib.request

    from tendermint_tpu_torch.encoding.canonical import Timestamp
    from tendermint_tpu_torch.light.client import LightClient, TrustOptions
    from tendermint_tpu_torch.light.lightd import LightServer
    from tendermint_tpu_torch.light.provider import MemoryProvider, RetryingProvider
    from tendermint_tpu_torch.ops import precompute, resident

    chain = lightd_wl[0]
    top = LIGHTD_HEADERS
    now = Timestamp.from_unix_ns(chain[-1].header.time.to_unix_ns() + 2 * 10**9)
    tracing = OBSERVED.tracing
    part = "phase 12d"
    client = LightClient(
        CHAIN_ID, TrustOptions(period=LIGHT_TRUSTING_PERIOD_S, height=1, hash=chain[0].hash()),
        RetryingProvider(MemoryProvider(CHAIN_ID, chain)), [MemoryProvider(CHAIN_ID, chain)],
        max_clock_drift=LIGHT_MAX_CLOCK_DRIFT_S, now=lambda: now, metrics=OBSERVED.light, device=dev)
    srv = LightServer(client, metrics=OBSERVED.light, registry=OBSERVED.registry)
    srv.start()

    def get(path):
        with urllib.request.urlopen(srv.url + path, timeout=60) as resp:
            return resp.read()

    try:
        precompute.results.clear()
        mark = OBSERVED.mark()
        with tracing.span("light_request", height=top) as call:
            body = {"jsonrpc": "2.0", "id": 1, "method": "light_header",
                    "params": {"height": top}, "trace": call.context().to_header()}
            req = urllib.request.Request(srv.url, data=json.dumps(body).encode(),
                                         headers={"Content-Type": "application/json"})
            t = time.perf_counter()
            with urllib.request.urlopen(req, timeout=120) as resp:
                answer = json.loads(resp.read())
            serve_s = time.perf_counter() - t
        check(answer.get("result", {}).get("hash") == chain[-1].hash().hex().upper(),
              f"{part}: light_header answered {str(answer)[:300]}")
        events, d = OBSERVED.since(mark)
        metrics_text = get("/metrics").decode()
        families = {prefix: sorted({line.split()[2] for line in metrics_text.splitlines()
                                    if line.startswith("# TYPE " + prefix)})
                    for prefix in ("tendermint_ops_", "tendermint_light_")}
        check(len(families["tendermint_ops_"]) == 29 and len(families["tendermint_light_"]) == 5,
              f"{part}: /metrics families {families}")
        doc = json.loads(get("/debug/traces?format=chrome"))
        check(set(doc["otherData"]) == {"epoch_unix_us"}, f"{part}: chrome otherData {doc['otherData']}")
        spans = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
        by_id = {e["span_id"]: e for e in spans if "span_id" in e}
        mine = [e for e in spans if e.get("trace_id") == call.trace_id]
        (dispatch,) = [e for e in mine if e["name"] == "rpc_dispatch"]
        check(dispatch["parent_span_id"] == call.span_id and dispatch["args"]["method"] == "light_header",
              f"{part}: rpc_dispatch {dispatch}")
        vbs = [e for e in mine if e["name"] == "verify_batch"]
        check(len(vbs) >= LIGHTD_ROUNDS and all(dispatch["span_id"] in trace_ancestors(by_id, e)
                                                for e in vbs),
              f"{part}: {len(vbs)} verify_batch spans of the request's trace under rpc_dispatch")
        all_vbs = spans_of(events, "verify_batch")
        check(len(all_vbs) == len(vbs), f"{part}: verify_batch spans outside the request's trace")
        launched = sum(d["launches"].values())
        dispatched = len(spans_of(events, "dispatch_chunk"))
        check(dispatched == launched - d["launches"].get("challenge", 0) > 0,
              f"{part}: {dispatched} dispatch_chunk spans, launches {d['launches']}")
        check(not spans_of(events, "host_fallback"), f"{part}: a host_fallback span")
        check_stage_histogram(part, events, d)
        mem = json.loads(get("/debug/memstats"))
        ledger = check_ledger(part)
        check(mem["device_bytes"].get("resident_tables") == ledger["store_bytes"] > 0
              and mem["resident"] == resident.stats()
              and any(key.startswith("ed25519/b") for key in mem["profile"]["kernel"])
              and mem["compile_events"] == {"ed25519": 4, "pallas": 2, "sr25519": 1}
              and mem["exec_cache_entries"] == {"ed25519": 2, "pallas": 1, "sr25519": 1},
              f"{part}: memstats {json.dumps(mem)[:600]}")
    finally:
        srv.stop()
    check_healthy(part)
    return {"cold_serve_ms": serve_s * 1e3, "request_trace_verify_batches": len(vbs),
            "dispatch_chunk_spans": dispatched, "launches": d["launches"], "families": families,
            "memstats": {k: mem[k] for k in ("device_bytes", "compile_events", "exec_cache_entries",
                                             "builds")},
            "profile_kernel_digests": mem["profile"]["kernel"]}


def merged(intervals):
    """Sorted, merged (start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def profiled(label, fn, trace_dir):
    """12e: ``fn`` under ``torch.profiler`` (CPU and CUDA activities): the
    device-busy share of the call's wall, the top device operations, and
    the longest idle gaps, each with the innermost tracer span open on
    the host at its middle. The Chrome trace goes to ``trace_dir``."""
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    name = f"phase12_{label}"
    torch.cuda.synchronize()
    mark = OBSERVED.mark()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(name):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, f"{name}.trace.json")
    prof.export_chrome_trace(path)
    with open(path) as fh:
        trace = json.load(fh)["traceEvents"]
    events, d = OBSERVED.since(mark)
    part = f"phase 12e {label}"
    wins = [e for e in trace if e.get("name") == name and e.get("ph") == "X"
            and e.get("cat") == "user_annotation"]
    check(len(wins) == 1, f"{part}: {len(wins)} windows named {name} in the trace")
    lo, hi = wins[0]["ts"], wins[0]["ts"] + wins[0]["dur"]
    device = [e for e in trace if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    clip = lambda evs: [(max(lo, e["ts"]), min(hi, e["ts"] + e["dur"])) for e in evs
                        if e["ts"] < hi and e["ts"] + e["dur"] > lo]
    busy = merged(clip(device))
    kernel_busy = merged(clip([e for e in device if e["cat"] == "kernel"]))
    span_us = hi - lo
    seen = {key: sum(1 for e in device if e["cat"] == "kernel" and re.search(rf"\b{fn_name}\b", e["name"]))
            for key, fn_name in KERNEL_FUNCTIONS.items()}
    want = {key: d["launches"].get(key, 0) for key in KERNEL_FUNCTIONS}
    check(seen == want, f"{part}: kernels in the trace {seen}, launches counted {want}")
    by_op = {}
    for e in device:
        row = by_op.setdefault(e["name"][:90], [0.0, 0])
        row[0] += e["dur"] / 1e3
        row[1] += 1
    top = sorted(by_op.items(), key=lambda kv: -kv[1][0])[:PROFILE_TOP_OPS]
    # Idle gaps, and the host span open at each gap's middle: the window
    # opened at t0 on the host's clock, so trace time maps to it by one offset.
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i]) for i in range(0, len(edges), 2)), reverse=True)
    tracer = OBSERVED.tracing.tracer
    spans = [(tracer.to_perf_counter(e["ts"]), tracer.to_perf_counter(e["ts"] + e["dur"]), e)
             for e in events if e.get("ph") == "X"]

    def host_span(t_trace):
        """The innermost tracer span open on the host at trace time
        ``t_trace``, as its name and stage tags (None when none is)."""
        t = t0 + (t_trace - lo) / 1e6
        inside = [(b - a, e) for a, b, e in spans if a <= t <= b]
        if not inside:
            return None
        e = min(inside, key=lambda x: x[0])[1]
        return {"name": e["name"], **{k: e["args"][k] for k in ("stage", "kind", "engine") if k in e["args"]}}

    def host_shares(a, b, samples=PROFILE_SAMPLES):
        """Shares of [a, b) (trace time) by the innermost host span."""
        out = {}
        for i in range(samples):
            sp = host_span(a + (b - a) * (i + 0.5) / samples)
            key = "none" if sp is None else "/".join(str(sp.get(k)) for k in ("name", "kind") if sp.get(k))
            out[key] = out.get(key, 0) + 1 / samples
        return dict(sorted(out.items(), key=lambda kv: -kv[1]))

    idle = [{"ms": g / 1e3, "at_ms": (a - lo) / 1e3, "host_span": host_span(a + g / 2),
             "host_shares": host_shares(a, a + g)}
            for g, a in gaps[:PROFILE_IDLE_GAPS]]
    out = {"label": label, "wall_ms": wall * 1e3, "window_ms": span_us / 1e3,
           "device_busy_share": sum(b - a for a, b in busy) / span_us,
           "kernel_busy_share": sum(b - a for a, b in kernel_busy) / span_us,
           "kernel_ms": sum(b - a for a, b in kernel_busy) / 1e3, "launches": d["launches"],
           "top_device_ops": [{"name": k, "ms": v[0], "count": v[1]} for k, v in top],
           "idle_gaps": idle, "host_shares": host_shares(lo, hi, 4 * PROFILE_SAMPLES), "trace": path}
    emit({"phase": "observed_12e", **out})
    return out


def observed_overhead(commit_wl, dev):
    """12f: the steady commit with the tracer off and the profiler
    uninstalled, against ``ring`` with the profiler installed, in turns."""
    from tendermint_tpu_torch.ops import precompute
    from tendermint_tpu_torch.types.validation import verify_commit

    vset, block_id, commits = commit_wl
    c = commits[1]
    times = {"off": [], "on": []}
    for _ in range(OVERHEAD_REPS):
        for side in ("off", "on"):
            OBSERVED.off() if side == "off" else OBSERVED.on()
            precompute.results.clear()
            t = time.perf_counter()
            verify_commit(CHAIN_ID, vset, block_id, c.height, c, device=dev)
            times[side].append(time.perf_counter() - t)
    OBSERVED.on()
    p50 = {side: statistics.median(v) for side, v in times.items()}
    # What the instruments cost a span, on this host: a stage span under
    # the ring, the observer and the profiler, against the no-op span.
    tracing = OBSERVED.tracing
    mark = OBSERVED.mark()
    precompute.results.clear()
    verify_commit(CHAIN_ID, vset, block_id, c.height, c, device=dev)
    spans_per_commit = len([e for e in OBSERVED.since(mark)[0] if e.get("ph") == "X"])
    cost = {}
    for side in ("off", "on"):
        OBSERVED.off() if side == "off" else OBSERVED.on()
        t = time.perf_counter()
        for _ in range(SPAN_COST_REPS):
            with tracing.span("prep_chunk", stage="prep", engine="ed25519", kind="resident", lanes=1):
                pass
        cost[side] = (time.perf_counter() - t) / SPAN_COST_REPS
    OBSERVED.on()
    OBSERVED.tracing.tracer.clear()
    span_us = (cost["on"] - cost["off"]) * 1e6
    return {"off_ms": [x * 1e3 for x in times["off"]], "on_ms": [x * 1e3 for x in times["on"]],
            "off_p50_ms": p50["off"] * 1e3, "on_p50_ms": p50["on"] * 1e3,
            "on_over_off": p50["on"] / p50["off"], "span_cost_us": span_us,
            "spans_per_commit": spans_per_commit,
            "span_cost_share": span_us * spans_per_commit / (p50["off"] * 1e6)}


def phase_observed(commit_wl, commit_tables, mixed_wl, ed_lanes, batch, lightd_wl, dev, trace_dir):
    """Phase 12: the main path with the instruments on (see the module
    note). Returns the phase's launch counts (which start at 0)."""
    global OBSERVED
    from tendermint_tpu_torch.ops import precompute, verify_batch
    from tendermint_tpu_torch.types.validation import verify_commit

    t_phase = time.perf_counter()
    check(len(commit_tables) == COMMIT_VALIDATORS,
          f"phase 12: {len(commit_tables)} tables of the 10,000 set")
    precompute.reset()
    restore_tables(commit_wl[0], commit_tables)
    OBSERVED = Observed()
    vset, block_id, commits = commit_wl
    pks, msgs, sigs, want = batch

    def steady_commit():
        precompute.results.clear()
        verify_commit(CHAIN_ID, vset, block_id, commits[1].height, commits[1], device=dev)

    def batch_8192():
        precompute.results.clear()
        check(np.array_equal(np.asarray(verify_batch(pks, msgs, sigs, device=dev)), want),
              "phase 12e: verify_batch verdicts wrong")

    try:
        parts = [("12a_commit", lambda: observed_commit(commit_wl, dev)),
                 ("12f_overhead", lambda: observed_overhead(commit_wl, dev)),
                 ("12e_profile_commit", lambda: profiled("commit", steady_commit, trace_dir)),
                 ("12e_profile_batch", lambda: profiled("batch", batch_8192, trace_dir)),
                 ("12b_mixed", lambda: observed_mixed(mixed_wl, dev)),
                 ("12c_faults", lambda: observed_faults(ed_lanes, dev)),
                 ("12d_lightd", lambda: observed_lightd(lightd_wl, dev))]
        for label, run in parts:
            t = time.perf_counter()
            out = run()
            if not label.startswith("12e"):
                emit({"phase": f"observed_{label}", "seconds": time.perf_counter() - t, **out})
        check(OBSERVED.tracing.tracer.dropped == 0, "phase 12: the ring dropped events")
    finally:
        OBSERVED.close()
        OBSERVED = None
    precompute.reset()
    counts = launches()
    emit({"phase": "observed", "seconds": time.perf_counter() - t_phase, "launches": counts})
    return counts


# --- phase 13: verifyd -----------------------------------------------------------

VERIFYD_REPS = 3  # 13a: remote and in-process commits, in turns
VERIFYD_CONSENSUS_CALLS = 2  # 13b: 10,000-lane calls of the consensus client (heights 1, 2)
VERIFYD_SR_REQUESTS = 3  # 13b: sr25519 requests
VERIFYD_SR_LANES = 64  # 13b: lanes an sr25519 request (phase 7's mixed window holds 64)
VERIFYD_MIX_CAP = 16384  # 13b's admission cap, max_pending and tenant cap (see PERF.md)
VERIFYD_MIX_SERVICE_BUDGET = 60.0  # 13b's service-time budget, seconds (the default is 0.5)
VERIFYD_LADDER_SHED_LANES = 64  # 13c: a sheddable class's request
VERIFYD_LADDER_LANES = 256  # 13c: consensus, past the default tenant cap's shrunken share (128)
VERIFYD_HOT_SIGNERS = BATCH_SIGNERS  # 13d: phase 3's 256 signers, each seen 3 times
VERIFYD_HOT_SIGHTINGS = 3
VERIFYD_HOT_QUOTA = 128  # 13d: pins a tenant may hold (two tenants of 128 signers)
VERIFYD_CHILD_HEADERS = 3  # 13e: header commits over each transport, in turns, after the warm-ups
VERIFYD_CHILD_WARMUPS = 3  # 13e: a key is pinned at its second sighting, its table built at the third
VERIFYD_CHILD_COMMITS = 2  # 13e: cross-process verify_commit runs over each transport, in turns
VERIFYD_CHILD_WAIT_S = 180.0  # 13e: the daemon's start, its CUDA context and kernel load
VERIFYD_CHILD_STOP_S = 10.0
VERIFYD_PHASE_S = 60.0  # 13a-13e's time limit
VERIFYD_SHARDS = 2  # 13f: shard processes sharing the card (13e's daemon is shard 0)
VERIFYD_FLEET_ROUNDS = 3  # 13f: routed rounds before the kill (a key is pinned at its second sighting)
VERIFYD_FLEET_SIGNERS = 16  # 13f: phase 3's set-less signers a round, their 32 lanes each
VERIFYD_FLEET_PIN_QUOTA = 4096  # 13f: the shards' tenant pin quota (a 1,000-key committee fits)
VERIFYD_FLEET_S = 60.0  # 13f's time limit, the stats command's start included


def commit_lanes(vset, commit, n=None):
    """The (pks, msgs, sigs) lanes of ``commit``'s first ``n`` signatures."""
    n = len(vset.validators) if n is None else n
    return ([v.pub_key.bytes() for v in vset.validators[:n]],
            [commit.vote_sign_bytes(CHAIN_ID, i) for i in range(n)],
            [cs.signature for cs in commit.signatures[:n]])


def plant_bad(lanes, idx):
    """A copy of ``lanes`` with the signatures at ``idx`` corrupted."""
    pks, msgs, sigs = (list(x) for x in lanes)
    for i in idx:
        sigs[i] = sigs[i][:40] + bytes([sigs[i][40] ^ 1]) + sigs[i][41:]
    return pks, msgs, sigs


def in_process(requests, dev, algo="ed25519"):
    """Each request's verdicts from the port's engine in this process (one
    call per class), with the verdict cache emptied after."""
    from tendermint_tpu_torch.ops import precompute, verify_batch
    from tendermint_tpu_torch.ops.sr25519_batch import verify_batch_sr

    flat = [sum((list(r[k]) for r in requests), []) for k in range(3)]
    fn = verify_batch if algo == "ed25519" else verify_batch_sr
    oks = list(fn(*flat, device=dev))
    precompute.results.clear()
    out, lo = [], 0
    for r in requests:
        out.append(oks[lo:lo + len(r[0])])
        lo += len(r[0])
    return out


def verifyd_remote_commit(srv, commit_wl, commit_tables, dev):
    """13a: phase 4's 10,000-validator commit through ``verify_commit``
    with the remote set, over the shm ingress and over TCP, against the
    in-process path, in turns."""
    from tendermint_tpu_torch.ops import precompute
    from tendermint_tpu_torch.types.validation import InvalidCommitError, verify_commit
    from tendermint_tpu_torch.verifyd import client as vclient, protocol, shm

    part = "phase 13a"
    vset, block_id, commits = commit_wl
    addr = "%s:%d" % srv.address
    precompute.reset()
    restore_tables(vset, commit_tables)
    served0 = srv.stats()["requests_served"]
    sched0 = srv.scheduler.stats()
    check(srv.shm_socket_path != "", f"{part}: the server published no shm endpoint")
    remote_client = None
    sides = ("shm", "tcp", "in_process")

    def run(side, commit):
        nonlocal remote_client
        vclient.set_remote_addr("" if side == "in_process" else addr)
        if side != "in_process":
            shm.set_shm_mode("on" if side == "shm" else "off")
            remote_client = vclient.remote_client()
            check(vclient.remote_transport() == side, f"{part}: the client rides {vclient.remote_transport()}")
        precompute.results.clear()
        before = launches()
        t = time.perf_counter()
        try:
            verify_commit(CHAIN_ID, vset, block_id, commit.height, commit, device=dev)
            err = None
        except InvalidCommitError as exc:
            err = str(exc)
        return time.perf_counter() - t, delta(before), err

    try:
        cold_s, cold_d, err = run("tcp", commits[1])
        check(err is None, f"{part}: the cold remote commit failed: {err}")
        times = {side: [] for side in sides}
        per_side = {side: {} for side in sides}
        for _ in range(VERIFYD_REPS):
            for side in sides:
                s, d, err = run(side, commits[1])
                check(err is None, f"{part}: the {side} commit failed: {err}")
                times[side].append(s)
                for k, v in d.items():
                    per_side[side][k] = per_side[side].get(k, 0) + v
        bad = {side: run(side, commits[2]) for side in sides}
    finally:
        vclient.set_remote_addr("")
        shm.set_shm_mode("")
    errors = {side: r[2] for side, r in bad.items()}
    check(errors["shm"] is not None and errors["shm"] == errors["tcp"] == errors["in_process"]
          and f"(#{BAD_COMMIT_INDEX})" in errors["shm"], f"{part}: bad commit {errors}")
    def slabs(commit):
        lanes = commit_lanes(vset, commit)
        sent = protocol.VerifyRequest(pks=lanes[0], msgs=lanes[1], sigs=lanes[2])
        return len(vclient._slab_parts(sent, shm.DEFAULT_SLAB_BYTES))

    per_call = {"tcp": -(-COMMIT_VALIDATORS // protocol.MAX_LANES), "shm": slabs(commits[1])}
    calls = {"tcp": VERIFYD_REPS + 2, "shm": VERIFYD_REPS + 1}
    stats, sched = srv.stats(), srv.scheduler.stats()
    served = stats["requests_served"] - served0
    flushes = sched["flushes"] - sched0["flushes"]
    reasons = {k: sched["flush_reasons"][k] - sched0["flush_reasons"][k] for k in sched["flush_reasons"]}
    cstats = remote_client.stats()
    shm_lanes = calls["shm"] * COMMIT_VALIDATORS
    expected = calls["tcp"] * per_call["tcp"] + VERIFYD_REPS * per_call["shm"] + slabs(commits[2])
    check(served == expected,
          f"{part}: {served} requests served for {calls} commits of {per_call} requests")
    check(stats["shm_lanes"] == cstats["shm_lanes"] == shm_lanes and cstats["shm_calls"] == calls["shm"]
          and stats["shm_torn_slabs"] == 0 and stats["shm_fallbacks"] == 0 and cstats["shm_fallbacks"] == 0,
          f"{part}: shm lanes {stats['shm_lanes']} (client {cstats['shm_lanes']}, sent {shm_lanes}), "
          f"torn {stats['shm_torn_slabs']}, fallbacks {stats['shm_fallbacks']}/{cstats['shm_fallbacks']}")
    check(reasons["size"] + reasons["deadline"] == flushes > 0, f"{part}: flush reasons {reasons}")
    check(sched["flush_errors"] == sched0["flush_errors"]
          and sched["fallback_flushes"] == sched0["fallback_flushes"],
          f"{part}: failed or fallback flushes {sched}")
    check(stats["host_direct_lanes"] == 0 and stats["pin_errors"] == 0 and stats["failed_closed"] == 0
          and cstats["fallback_calls"] == 0, f"{part}: stats {stats} client {cstats}")
    check(cold_d.get("verify_resident", 0) > 0 and set(cold_d) <= {"verify_resident", "challenge"}
          and all(per_side[t].get("verify_resident", 0) > 0 for t in ("shm", "tcp")),
          f"{part}: remote launches cold {cold_d}, steady {per_side}")
    p50 = {side: statistics.median(v) for side, v in times.items()}
    return {"validators": COMMIT_VALIDATORS, "requests_per_commit": per_call,
            "cold_remote_ms": cold_s * 1e3, "cold_remote_launches": cold_d,
            **{f"{side}_ms": [x * 1e3 for x in times[side]] for side in sides},
            **{f"{side}_p50_ms": p50[side] * 1e3 for side in sides},
            "shm_over_in_process": p50["shm"] / p50["in_process"],
            "tcp_over_in_process": p50["tcp"] / p50["in_process"],
            "shm_over_tcp": p50["shm"] / p50["tcp"],
            "launches_per_commit": {side: {k: v / VERIFYD_REPS for k, v in per_side[side].items()}
                                    for side in sides},
            "flushes_per_remote_commit": flushes / sum(calls.values()), "flush_reasons": reasons,
            "bad_commit_error": errors["shm"], "client": cstats,
            "shm": {k: stats[k] for k in ("shm_lanes", "shm_torn_slabs", "shm_fallbacks", "shm_sessions")},
            "scheduler_knobs": stats["scheduler"], "cross_client_flushes": stats["cross_client_flushes"],
            "served_launches": add_launches(cold_d, per_side["shm"], per_side["tcp"], bad["shm"][1],
                                            bad["tcp"][1])}


def verifyd_mix(commit_wl, sync, mixed_sync, light, dev):
    """13b: four clients at once on one server: consensus (phase 4's
    commits), blocksync (phase 7's blocks), light (phase 8's headers) and
    sr25519 (phase 7's mixed window), each with planted bad lanes."""
    from tendermint_tpu_torch.ops import precompute
    from tendermint_tpu_torch.verifyd import protocol
    from tendermint_tpu_torch.verifyd.client import VerifydClient
    from tendermint_tpu_torch.verifyd.server import VerifydServer

    part = "phase 13b"
    vset, _, commits = commit_wl
    chain, bvset, _ = sync
    lchain, lvset, _ = light
    mchain, mvset, _ = mixed_sync
    sync_lanes = SYNC_VALIDATORS * 2 // 3 + 1
    light_lanes = LIGHT_VALIDATORS * 2 // 3 + 1
    requests = {
        "consensus": [plant_bad(commit_lanes(vset, commits[h]), (17 + h, COMMIT_VALIDATORS // 2 + h,
                                                                   COMMIT_VALIDATORS - 1 - h))
                      for h in range(VERIFYD_CONSENSUS_CALLS)],
        "blocksync": [plant_bad(commit_lanes(bvset, sh.commit, sync_lanes),
                                (b % sync_lanes,) if b % 4 == 0 else ())
                      for b, sh in enumerate(chain[:SYNC_BLOCKS])],
        "light": [plant_bad(commit_lanes(lvset, sh.commit, light_lanes),
                            (h * 41 % light_lanes,) if h % 4 == 1 else ())
                  for h, sh in enumerate(lchain[:LIGHT_HEADERS])],
    }
    sr = [(v.pub_key.bytes(), sh.commit.vote_sign_bytes(CHAIN_ID, i), sh.commit.signatures[i].signature)
          for sh in mchain[:MIXED_SYNC_BLOCKS] for i, v in enumerate(mvset.validators)
          if v.pub_key.type == "sr25519"][:VERIFYD_SR_LANES]
    check(len(sr) == VERIFYD_SR_LANES, f"{part}: {len(sr)} sr25519 lanes in phase 7's mixed window")
    requests["sr25519"] = [plant_bad(tuple(zip(*sr)), (r * 7 % VERIFYD_SR_LANES,))
                           for r in range(VERIFYD_SR_REQUESTS)]
    klass = {"consensus": protocol.CLASS_CONSENSUS, "blocksync": protocol.CLASS_BLOCKSYNC,
             "light": protocol.CLASS_LIGHT, "sr25519": protocol.CLASS_BLOCKSYNC}
    t = time.perf_counter()
    want = {name: in_process(reqs, dev, "sr25519" if name == "sr25519" else "ed25519")
            for name, reqs in requests.items()}
    reference_s = time.perf_counter() - t
    planted = {"consensus": 3 * VERIFYD_CONSENSUS_CALLS, "blocksync": -(-SYNC_BLOCKS // 4),
               "light": LIGHT_HEADERS // 4, "sr25519": VERIFYD_SR_REQUESTS}
    falses = {name: sum(not x for w in want[name] for x in w) for name in want}
    check(falses == planted, f"{part}: in-process rejections {falses}, planted {planted}")
    precompute.results.clear()
    srv = VerifydServer(device=dev, admission_cap=VERIFYD_MIX_CAP, max_pending=VERIFYD_MIX_CAP,
                        tenant_cap=VERIFYD_MIX_CAP, service_budget=VERIFYD_MIX_SERVICE_BUDGET)
    srv.start()
    addr = "%s:%d" % srv.address
    results = {name: [] for name in requests}
    errors = []
    barrier = threading.Barrier(len(requests))
    clients = {name: VerifydClient(addr, timeout=60.0) for name in requests}
    t_end = {}

    def run(name):
        try:
            c = clients[name]
            barrier.wait(timeout=30)
            for r in requests[name]:
                t0 = time.perf_counter()
                got = c.verify(*r, klass=klass[name],
                               algo=protocol.ALGO_SR25519 if name == "sr25519" else protocol.ALGO_ED25519)
                results[name].append((time.perf_counter() - t0, got))
            t_end[name] = time.perf_counter()
        except Exception as exc:  # reported below
            errors.append((name, repr(exc)))

    before = launches()
    threads = [threading.Thread(target=run, args=(name,)) for name in requests]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=VERIFYD_PHASE_S)
    wall = max(t_end.values(), default=time.perf_counter()) - t0
    d = delta(before)
    try:
        check(not errors and all(not th.is_alive() for th in threads), f"{part}: clients {errors}")
        for name in requests:
            got = [v for _, v in results[name]]
            check(got == want[name], f"{part}: {name} verdicts differ from the in-process ones")
        stats = srv.stats()
        scheds = srv.scheduler_stats()
        cstats = {name: c.stats() for name, c in clients.items()}
        check(sum(stats["cross_client_flushes"].values()) > 0, f"{part}: no cross-client flush {stats}")
        check(stats["admission_rejections"] == 0 and stats["host_direct_lanes"] == 0
              and stats["pin_errors"] == 0 and stats["failed_closed"] == 0,
              f"{part}: sheds, host-direct lanes or pin errors {stats}")
        check(all(s["fallback_calls"] == 0 and s["shed_retries_used"] == 0 for s in cstats.values()),
              f"{part}: client fallbacks or sheds {cstats}")
        check(all(s["flush_errors"] == 0 and s["fallback_flushes"] == 0 for s in scheds.values()),
              f"{part}: failed or fallback flushes {scheds}")
        check(d.get("verify_sr", 0) > 0 and d.get("verify", 0) + d.get("verify_resident", 0) > 0,
              f"{part}: launches {d}")
    finally:
        for c in clients.values():
            c.close()
        srv.stop()
    lanes = sum(len(r[0]) for reqs in requests.values() for r in reqs)
    per_class = {}
    for name, res in results.items():
        ms = [s * 1e3 for s, _ in res]
        per_class[name] = {"requests": len(ms), "lanes_per_request": len(requests[name][0][0]),
                           "p50_ms": percentile(ms, 0.5), "p99_ms": percentile(ms, 0.99),
                           "max_ms": max(ms)}
    return {"config": {"admission_cap": VERIFYD_MIX_CAP, "max_pending": VERIFYD_MIX_CAP,
                       "tenant_cap": VERIFYD_MIX_CAP, "service_budget_s": VERIFYD_MIX_SERVICE_BUDGET,
                       "tenant": protocol.DEFAULT_TENANT},
            "brownout": srv.brownout.snapshot(),
            "lanes": lanes, "wall_s": wall, "lanes_per_s": lanes / wall, "per_class": per_class,
            "launches": d, "cross_client_flushes": stats["cross_client_flushes"],
            "schedulers": scheds, "scheduler_knobs": stats["scheduler"],
            "in_process_reference_s": reference_s}


def verifyd_ladder(srv, commit_wl, dev):
    """13c: ``brownout.force(1..5)`` on 13a's server (the reference's
    defaults): rpc, light and blocksync shed in that order, consensus
    never, host-direct at rungs 4 and 5; after ``force(None)`` consensus
    launches a kernel again. Then a fault at ``ed25519.chunk`` with host
    fallback off reaches the client as STATUS_INTERNAL."""
    from tendermint_tpu_torch.ops import device_policy, fault_injection, precompute
    from tendermint_tpu_torch.verifyd import protocol
    from tendermint_tpu_torch.verifyd.client import VerifydClient, VerifydRejectedError
    from tendermint_tpu_torch.verifyd.server import LEVEL_NAMES, level_sheds_class

    part = "phase 13c"
    vset, _, commits = commit_wl
    all_lanes = commit_lanes(vset, commits[0])
    cursor = [0]

    def take(n):
        lo = cursor[0]
        cursor[0] += n
        check(cursor[0] <= COMMIT_VALIDATORS, f"{part}: out of lanes")
        lanes = plant_bad(tuple(x[lo:lo + n] for x in all_lanes), (n // 2,))
        return lanes, [i != n // 2 for i in range(n)]

    health = device_policy.shared
    check(not health.host_fallback, f"{part}: host fallback is on")
    c = VerifydClient("%s:%d" % srv.address, shed_retries=0)
    classes = (protocol.CLASS_RPC, protocol.CLASS_LIGHT, protocol.CLASS_BLOCKSYNC, protocol.CLASS_CONSENSUS)
    rows = []
    try:
        for level in range(1, 6):
            srv.brownout.force(level)
            row = {"level": LEVEL_NAMES[level]}
            for klass in classes:
                n = VERIFYD_LADDER_LANES if klass == protocol.CLASS_CONSENSUS else VERIFYD_LADDER_SHED_LANES
                lanes, want = take(n)
                precompute.results.clear()
                host0, before = srv.stats()["host_direct_lanes"], launches()
                try:
                    got = c.verify(*lanes, klass=klass)
                    outcome = "ok"
                except VerifydRejectedError as exc:
                    got, outcome = None, protocol.STATUS_NAMES[exc.status]
                host = srv.stats()["host_direct_lanes"] - host0
                name = protocol.CLASS_NAMES[klass]
                if level_sheds_class(level, klass):
                    check(outcome == "resource_exhausted", f"{part}: {name} at {row['level']}: {outcome}")
                else:
                    check(outcome == "ok" and got == want, f"{part}: {name} at {row['level']}: {outcome}")
                if klass == protocol.CLASS_CONSENSUS:
                    direct = level >= 4
                    check(host == (n if direct else 0) and (not delta(before)) == direct,
                          f"{part}: consensus at {row['level']}: {host} host-direct lanes, "
                          f"launches {delta(before)}")
                row[name] = outcome if not host else f"host_direct ({host} lanes)"
            rows.append(row)
        srv.brownout.force(None)
        snap = health.snapshot()
        direct_lanes = srv.stats()["host_direct_lanes"]
        check(direct_lanes == 2 * VERIFYD_LADDER_LANES
              and snap["fallback_lanes"].get("ed25519", 0) == direct_lanes,
              f"{part}: host-direct lanes {direct_lanes}, health {snap}")
        health.reset()
        lanes, want = take(VERIFYD_LADDER_LANES)
        precompute.results.clear()
        before = launches()
        check(c.verify(*lanes, klass=protocol.CLASS_CONSENSUS) == want, f"{part}: after the ladder")
        after_ladder = delta(before)
        check(after_ladder, f"{part}: no kernel launched after force(None)")
        # a device fault with host fallback off: an error at the client,
        # never a verdict list
        lanes, _ = take(VERIFYD_LADDER_LANES)
        precompute.results.clear()
        failed0 = srv.stats()["failed_closed"]
        with fault_injection.inject(site="ed25519.chunk", fail_calls=(1,)) as plan:
            try:
                got = c.verify(*lanes, klass=protocol.CLASS_CONSENSUS)
            except VerifydRejectedError as exc:
                got, status, message = None, exc.status, str(exc)
            else:
                status, message = protocol.STATUS_OK, ""
        fault_snap = health.snapshot()
        check(got is None and status == protocol.STATUS_INTERNAL and "injected" in message
              and plan.faults_raised == 1 and srv.stats()["failed_closed"] == failed0 + 1,
              f"{part}: the fault reached the client as {status} {message!r} (verdicts {got is not None})")
        check(sum(fault_snap["failures"].values()) == 1 and fault_snap["fallback_batches"] == 0,
              f"{part}: health after the fault {fault_snap}")
    finally:
        srv.brownout.force(None)
        c.close()
        health.reset()
    return {"rungs": rows, "host_direct_lanes": direct_lanes,
            "launches_after_force_none": after_ladder,
            "fault": {"status": protocol.STATUS_NAMES[status], "message": message,
                      "health": {k: fault_snap[k] for k in ("state", "failures", "transitions")}}}


def verifyd_hot_keys(batch, dev):
    """13d: set-less traffic from phase 3's 256 signers, each seen 3 times,
    under two tenants with 128 pins each: K1 first, then the store (K3)."""
    from tendermint_tpu_torch.ops import introspect, precompute, resident
    from tendermint_tpu_torch.verifyd import protocol
    from tendermint_tpu_torch.verifyd.client import VerifydClient
    from tendermint_tpu_torch.verifyd.server import VerifydServer

    part = "phase 13d"
    pks, msgs, sigs, want = batch
    precompute.reset()
    resident.reset()
    check(precompute.tables.stats()["active_sets"] == 0 and resident.stats()["resident_keys"] == 0,
          f"{part}: caches not empty")
    srv = VerifydServer(device=dev, tenant_pin_quota=VERIFYD_HOT_QUOTA)
    srv.start()
    tenants = ("chain-a", "chain-b")
    clients = [VerifydClient("%s:%d" % srv.address, tenant=t) for t in tenants]
    half = VERIFYD_HOT_SIGNERS // 2
    rounds = []
    try:
        for r in range(VERIFYD_HOT_SIGHTINGS):
            before = launches()
            t = time.perf_counter()
            for h, c in enumerate(clients):
                lo = r * VERIFYD_HOT_SIGNERS + h * half
                got = c.verify(pks[lo:lo + half], msgs[lo:lo + half], sigs[lo:lo + half],
                               klass=protocol.CLASS_CONSENSUS)
                check(got == [bool(x) for x in want[lo:lo + half]], f"{part}: round {r} verdicts")
            d = delta(before)
            rounds.append({"ms": (time.perf_counter() - t) * 1e3, "launches": d,
                           "pinned": len(resident.pinned_keys())})
            if r < 2:
                check(d.get("verify", 0) > 0 and not d.get("verify_resident"),
                      f"{part}: round {r} launches {d}")
            else:
                check(d.get("verify_resident", 0) > 0 and not d.get("verify"),
                      f"{part}: round {r} launches {d}")
        pins = resident.tenant_pins()
        store = resident.stats()
        rows = {k: v for k, v in introspect.accountant.snapshot()["device_bytes"].items()
                if k.startswith("resident_tables/")}
        stats = srv.stats()
        check(pins == {t: half for t in tenants} and all(n <= VERIFYD_HOT_QUOTA for n in pins.values()),
              f"{part}: pins {pins}")
        check(store["hits"] > 0 and store["resident_keys"] == VERIFYD_HOT_SIGNERS,
              f"{part}: store {store}")
        check(set(rows) == {f"resident_tables/{t}" for t in tenants}
              and sum(rows.values()) == resident.store.device_nbytes() > 0,
              f"{part}: ledger rows {rows}, store {resident.store.device_nbytes()} bytes")
        check(stats["pin_errors"] == 0 and stats["host_direct_lanes"] == 0
              and stats["admission_rejections"] == 0, f"{part}: stats {stats}")
    finally:
        for c in clients:
            c.close()
        srv.stop()
        precompute.reset()
    return {"rounds": rounds, "tenant_pins": pins, "store": store, "ledger_rows": rows,
            "store_bytes": sum(rows.values())}


def free_ports(n):
    """``n`` TCP ports of 127.0.0.1 that were free a moment ago."""
    import socket

    socks = [socket.socket() for _ in range(n)]
    try:
        for sk in socks:
            sk.bind(("127.0.0.1", 0))
        return [sk.getsockname()[1] for sk in socks]
    finally:
        for sk in socks:
            sk.close()


class Shards:
    """13e's daemon and 13f's second shard: ``python -m
    tendermint_tpu_torch verifyd --shard-id i --shards A,B`` processes,
    started together so that their CUDA starts overlap; shard 0 also
    serves ``/metrics``."""

    def __init__(self, dev):
        import queue

        root = os.path.dirname(os.path.abspath(__file__))
        os.makedirs(os.path.join(root, "build"), exist_ok=True)
        env = dict(os.environ, PYTHONPATH=root, PYTHONUNBUFFERED="1")
        self.addrs = ["127.0.0.1:%d" % p for p in free_ports(VERIFYD_SHARDS)]
        self.procs, self.lines = [], []
        self.t_start = time.perf_counter()
        for sid in range(VERIFYD_SHARDS):
            # the daemon's default device is CUDA; a CPU rehearsal names its own
            argv = ([sys.executable, "-m", "tendermint_tpu_torch", "verifyd", "--listen", self.addrs[sid],
                     "--shard-id", str(sid), "--shards", ",".join(self.addrs),
                     "--tenant-pin-quota", str(VERIFYD_FLEET_PIN_QUOTA)]
                    + (["--metrics", "127.0.0.1:0"] if sid == 0 else [])
                    + ([] if dev.type == "cuda" else ["--device", dev.type]))
            with open(os.path.join(root, "build", f"verifyd_shard{sid}.stderr"), "w") as err:
                proc = subprocess.Popen(argv, cwd=root, env=env, stdout=subprocess.PIPE, stderr=err, text=True)
            lines = queue.Queue()
            threading.Thread(target=lambda p=proc, q=lines: [q.put(x) for x in p.stdout], daemon=True).start()
            self.procs.append(proc)
            self.lines.append(lines)

    def readline(self, sid):
        return self.lines[sid].get(timeout=VERIFYD_CHILD_WAIT_S).strip()

    def stop(self):
        for proc in self.procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)


def verifyd_daemon(light, dev, shards):
    """13e: ``python -m tendermint_tpu_torch verifyd`` as its own process
    on the card (shard 0 of 13f): phase 8's header commits from this
    process and ``verify_commit`` of 1,000 validators against it, over
    the shm ingress and over TCP in turns, its STATS_PATH snapshot and
    ``/metrics``. Its SIGTERM and flight-recorder dump come after 13f."""
    import urllib.request

    from tendermint_tpu_torch.libs.metrics import Registry, VerifydMetrics
    from tendermint_tpu_torch.ops import precompute
    from tendermint_tpu_torch.types.validation import verify_commit
    from tendermint_tpu_torch.verifyd import client as vclient, protocol, shm
    from tendermint_tpu_torch.verifyd.client import VerifydClient

    part = "phase 13e"
    chain, lvset, _ = light
    n_req = VERIFYD_CHILD_WARMUPS + 2 * VERIFYD_CHILD_HEADERS
    requests = [plant_bad(commit_lanes(lvset, sh.commit), ((h * 131 + 17) % LIGHT_VALIDATORS,))
                for h, sh in enumerate(chain[:n_req])]
    want = in_process(requests, dev)
    check(all(sum(not x for x in w) == 1 for w in want), f"{part}: in-process verdicts")
    commit_heads = chain[n_req:n_req + 2 * VERIFYD_CHILD_COMMITS]
    sh = commit_heads[0]
    verify_commit(CHAIN_ID, lvset, sh.commit.block_id, sh.height, sh.commit, device=dev)
    precompute.results.clear()
    banner = shards.readline(0)
    metrics_line = shards.readline(0)
    start_s = time.perf_counter() - shards.t_start
    check(banner.startswith(f"verifyd serving on {shards.addrs[0]} ") and ".sock, shard=0/2)" in banner
          and f"device={dev.type}" in metrics_line, f"{part}: banner {banner!r} {metrics_line!r}")
    addr = shards.addrs[0]
    murl = "http://" + metrics_line.split()[3] + "/metrics"
    clients = {t: VerifydClient(addr, timeout=60.0, shm="on" if t == "shm" else "off") for t in ("shm", "tcp")}
    header_ms = {"shm": [], "tcp": []}
    commit_ms = {"shm": [], "tcp": []}
    try:
        warmup_ms = []
        for i in range(VERIFYD_CHILD_WARMUPS):
            t = time.perf_counter()
            check(clients["tcp"].verify(*requests[i], klass=protocol.CLASS_CONSENSUS) == want[i],
                  f"{part}: the daemon's verdicts differ from the in-process ones")
            warmup_ms.append((time.perf_counter() - t) * 1e3)
        for i in range(VERIFYD_CHILD_WARMUPS, n_req):
            side = "shm" if (i - VERIFYD_CHILD_WARMUPS) % 2 == 0 else "tcp"
            t = time.perf_counter()
            got = clients[side].verify(*requests[i], klass=protocol.CLASS_CONSENSUS)
            header_ms[side].append((time.perf_counter() - t) * 1e3)
            check(got == want[i], f"{part}: the daemon's verdicts over {side} differ from the in-process ones")
        check(clients["shm"].transport == "shm" and clients["tcp"].transport == "tcp",
              f"{part}: transports {[c.transport for c in clients.values()]}")
        vclient.set_remote_addr(addr)
        try:
            for i, sh in enumerate(commit_heads):
                side = "shm" if i % 2 == 0 else "tcp"
                shm.set_shm_mode("on" if side == "shm" else "off")
                check(vclient.remote_transport() == side, f"{part}: the remote rides {vclient.remote_transport()}")
                t = time.perf_counter()
                verify_commit(CHAIN_ID, lvset, sh.commit.block_id, sh.height, sh.commit, device=dev)
                commit_ms[side].append((time.perf_counter() - t) * 1e3)
            remote_stats = vclient.remote_client().stats()
        finally:
            vclient.reset_remote()
            shm.set_shm_mode("")
        snap = clients["tcp"].server_stats(timeout=30.0)
        stats = snap["stats"]
        cstats = {t: c.stats() for t, c in clients.items()}
        sent_shm = cstats["shm"]["shm_lanes"] + remote_stats["shm_lanes"]
        check(stats["requests_served"] == n_req + len(commit_heads) and stats["host_direct_lanes"] == 0
              and stats["pin_errors"] == 0 and stats["admission_rejections"] == 0 and stats["shard_id"] == 0,
              f"{part}: daemon stats {stats}")
        check(stats["shm_lanes"] == sent_shm == VERIFYD_CHILD_HEADERS * LIGHT_VALIDATORS
              + VERIFYD_CHILD_COMMITS * len(sh.commit.signatures)
              and stats["shm_torn_slabs"] == 0 and stats["shm_fallbacks"] == 0
              and cstats["shm"]["shm_fallbacks"] == 0 and remote_stats["shm_fallbacks"] == 0
              and remote_stats["fallback_calls"] == 0 and cstats["shm"]["fallback_calls"] == 0,
              f"{part}: shm lanes {stats['shm_lanes']} (sent {sent_shm}), torn {stats['shm_torn_slabs']}, "
              f"fallbacks {stats['shm_fallbacks']}, clients {cstats} remote {remote_stats}")
        check(all(s["flush_errors"] == 0 and s["fallback_flushes"] == 0
                  for s in snap["schedulers"].values())
              and snap["health"]["state"] == "healthy" and snap["health"]["fallback_batches"] == 0,
              f"{part}: daemon schedulers {snap['schedulers']}, health {snap['health']}")
        child_launches = {k: v for k, v in snap["launches"].items() if v}
        check(child_launches.get("verify", 0) > 0, f"{part}: daemon launches {child_launches}")
        with urllib.request.urlopen(murl, timeout=30) as resp:
            text = resp.read().decode()
        families = sorted({ln.split()[2] for ln in text.splitlines()
                           if ln.startswith("# TYPE tendermint_verifyd_")})
        ref_reg = Registry()
        VerifydMetrics(ref_reg)
        want_families = sorted({ln.split()[2] for ln in ref_reg.expose().splitlines()
                                if ln.startswith("# TYPE ")})
        check(families == want_families
              and 'tendermint_verifyd_requests_total{kind="commit",status="ok"}' in text
              and f"tendermint_verifyd_shm_lanes_total {sent_shm}" in text,
              f"{part}: /metrics families {families}")
    finally:
        for c in clients.values():
            c.close()
    p50 = lambda xs: statistics.median(xs) if xs else None  # noqa: E731
    return {"start_s": start_s, "banner": banner, "header_lanes": LIGHT_VALIDATORS,
            "warmup_header_ms": warmup_ms, "header_ms": header_ms,
            "header_p50_ms": {t: p50(v) for t, v in header_ms.items()},
            "cross_process_commit_ms": commit_ms,
            "cross_process_commit_p50_ms": {t: p50(v) for t, v in commit_ms.items()},
            "requests_served": stats["requests_served"],
            "shm": {k: stats[k] for k in ("shm_lanes", "shm_torn_slabs", "shm_fallbacks", "shm_sessions")},
            "resident": snap["resident"], "pinned_keys": len(snap["pinned_keys"]),
            "tenant_pins": snap["tenant_pins"], "launches": child_launches,
            "metrics_families": len(families)}


def verifyd_fleet(shards, sync, light, batch, dev):
    """13f: a ``FederationClient`` over the two shard processes routes
    phase 7's 500-validator committee (config 4), phase 8's 1,000 (config
    3) and phase 3's set-less signers; then shard 1 is SIGKILLed and the
    next round fails over; ``verifyd stats --shards`` prints the fleet
    roll-up. One card: placement and failover, not a speed-up."""
    from tendermint_tpu_torch.verifyd import protocol
    from tendermint_tpu_torch.verifyd.federation import FederationClient

    part = "phase 13f"
    banner = shards.readline(1)
    start_s = time.perf_counter() - shards.t_start
    check(banner.startswith(f"verifyd serving on {shards.addrs[1]} ") and "shard=1/2)" in banner,
          f"{part}: banner {banner!r}")
    chain, bvset, _ = sync
    lchain, lvset, _ = light
    pks, msgs, sigs, bwant = batch
    sync_lanes = SYNC_VALIDATORS * 2 // 3 + 1
    light_lanes = LIGHT_VALIDATORS * 2 // 3 + 1
    # the light committee's headers after 13e's; the round after the kill
    # takes 13e's last commit again (a verdict the survivor may have cached)
    light_from = VERIFYD_CHILD_WARMUPS + 2 * VERIFYD_CHILD_HEADERS + 2 * VERIFYD_CHILD_COMMITS
    rounds = VERIFYD_FLEET_ROUNDS + 1
    light_rows = list(range(light_from, light_from + VERIFYD_FLEET_ROUNDS)) + [light_from - 1]
    check(light_rows[-2] < LIGHT_HEADERS and rounds <= SYNC_BLOCKS
          and rounds * VERIFYD_FLEET_SIGNERS <= BATCH_SIGNERS, f"{part}: workload too small")
    requests = []
    for r in range(rounds):
        sync_req = plant_bad(commit_lanes(bvset, chain[r].commit, sync_lanes), ((r * 37) % sync_lanes,))
        light_req = plant_bad(commit_lanes(lvset, lchain[light_rows[r]].commit, light_lanes),
                              ((r * 53 + 1) % light_lanes,))
        signers = range(r * VERIFYD_FLEET_SIGNERS, (r + 1) * VERIFYD_FLEET_SIGNERS)
        idx = [i for i in range(BATCH_LANES) if i % BATCH_SIGNERS in signers]
        setless = ([pks[i] for i in idx], [msgs[i] for i in idx], [sigs[i] for i in idx])
        requests.append(tuple(sync_req[k] + light_req[k] + setless[k] for k in range(3)))
    want = in_process(requests, dev)
    for r, (w, req) in enumerate(zip(want, requests)):
        setless_want = [bool(bwant[i]) for i in range(BATCH_LANES) if i % BATCH_SIGNERS
                        in range(r * VERIFYD_FLEET_SIGNERS, (r + 1) * VERIFYD_FLEET_SIGNERS)]
        check(w[sync_lanes + light_lanes:] == setless_want and w.count(False) >= 2,
              f"{part}: in-process verdicts of round {r}")
    # a tenant of its own: 13e's repeat sightings spent the default
    # tenant's pin quota on shard 0 (a re-pinned key counts again)
    fed = FederationClient(shards.addrs, tenant="chip-smoke-13f", timeout=60.0, shm="off", dead_retry_s=600.0)
    ids = [set() for _ in shards.addrs]
    for sid, c in enumerate(fed._clients):
        def call(req, timeout=None, _orig=c.call, _sid=sid):
            resp = _orig(req, timeout=timeout)
            ids[_sid].add(resp.shard_id)
            return resp
        c.call = call
    try:
        committees = {"config4_500": sorted(v.pub_key.bytes() for v in bvset.validators),
                      "config3_1000": sorted(v.pub_key.bytes() for v in lvset.validators)}
        owners = {name: fed.ring.route(fed.note_validator_set(keys)) for name, keys in committees.items()}
        epoch0 = fed.route_epoch
        snaps0 = fed.refresh()
        check(sorted(snaps0) == [0, 1], f"{part}: shards answering {sorted(snaps0)}")
        pinned0 = [set(snaps0[sid]["pinned_keys"]) for sid in (0, 1)]
        launches0 = [snaps0[sid]["launches"] for sid in (0, 1)]
        lanes0 = [snaps0[sid]["tenants"].get(fed.tenant, {}).get("lanes", 0) for sid in (0, 1)]
        round_ms = []
        for r in range(VERIFYD_FLEET_ROUNDS):
            t = time.perf_counter()
            got = fed.verify(*requests[r], klass=protocol.CLASS_CONSENSUS)
            round_ms.append((time.perf_counter() - t) * 1e3)
            check(got == want[r], f"{part}: round {r} verdicts differ from the in-process ones")
        snaps = fed.refresh()
        slices = [set(snaps[sid]["pinned_keys"]) - pinned0[sid] for sid in (0, 1)]
        shard_launches = [{k: v - launches0[sid].get(k, 0) for k, v in snaps[sid]["launches"].items()
                           if v - launches0[sid].get(k, 0)} for sid in (0, 1)]
        shard_lanes = [snaps[sid]["tenants"].get(fed.tenant, {}).get("lanes", 0) - lanes0[sid] for sid in (0, 1)]
        routed = [set() for _ in (0, 1)]
        for r in range(VERIFYD_FLEET_ROUNDS):
            for pk in requests[r][0]:
                routed[fed.shard_for(pk)].add(pk.hex())
        st = fed.stats()
        check(not (slices[0] & slices[1]) and slices[0] and slices[1]
              and slices[0] <= routed[0] and slices[1] <= routed[1],
              f"{part}: pinned slices {len(slices[0])} and {len(slices[1])} keys, "
              f"{len(slices[0] & slices[1])} shared, outside their routes "
              f"{len(slices[0] - routed[0])}, {len(slices[1] - routed[1])}; routed {[len(r) for r in routed]}, "
              f"tenant pins {[snaps[sid]['tenant_pins'] for sid in (0, 1)]}, "
              f"denials {[snaps[sid]['resident'].get('pin_quota_denials') for sid in (0, 1)]}")
        check(ids == [{0}, {1}] and all(snaps[sid]["stats"]["misroutes"] == 0 for sid in (0, 1)),
              f"{part}: response shard ids {ids}")
        check(all(shard_lanes) and all(d.get("verify", 0) + d.get("verify_resident", 0) > 0
                                       for d in shard_launches)
              and sum(d.get("verify_resident", 0) for d in shard_launches) > 0,
              f"{part}: lanes {shard_lanes}, launches {shard_launches}")
        check(st["failovers"] == 0 and st["host_fallback_lanes"] == 0 and st["unanswered_lanes"] == 0,
              f"{part}: router {st}")
        root = os.path.dirname(os.path.abspath(__file__))
        t = time.perf_counter()
        out = subprocess.run([sys.executable, "-m", "tendermint_tpu_torch", "verifyd", "stats",
                              "--shards", ",".join(shards.addrs)], cwd=root, capture_output=True, text=True,
                             env=dict(os.environ, PYTHONPATH=root), timeout=VERIFYD_CHILD_WAIT_S)
        stats_s = time.perf_counter() - t
        rollup = out.stdout.splitlines()
        check(out.returncode == 0 and any(ln.startswith("shard0 ") for ln in rollup)
              and any(ln.startswith("shard1 ") for ln in rollup)
              and any(ln.startswith("fleet ") for ln in rollup),
              f"{part}: verifyd stats exited {out.returncode}: {out.stdout!r} {out.stderr[-2000:]!r}")
        # the kill: the next round's shard-1 groups fail over to shard 0
        last = requests[VERIFYD_FLEET_ROUNDS]
        check(any(fed.shard_for(pk) == 1 for pk in last[0]), f"{part}: nothing of the last round on shard 1")
        shards.procs[1].kill()
        shards.procs[1].wait(timeout=30)
        epoch1 = fed.route_epoch
        t = time.perf_counter()
        got = fed.verify(*last, klass=protocol.CLASS_CONSENSUS)
        failover_ms = (time.perf_counter() - t) * 1e3
        st = fed.stats()
        check(got == want[VERIFYD_FLEET_ROUNDS] and st["failovers"] >= 1 and st["rerouted_lanes"] > 0
              and fed.route_epoch > epoch1 and st["host_fallback_lanes"] == 0 and st["unanswered_lanes"] == 0
              and fed.alive_shards() == [0], f"{part}: after the kill {st}, alive {fed.alive_shards()}")
        final0 = fed._clients[0].server_stats(timeout=30.0)
    finally:
        fed.close()
    launches_served = add_launches(final0["launches"], snaps[1]["launches"])
    return {"shards": shards.addrs, "second_start_s": start_s, "banner": banner,
            "note": "one card: two processes share it; this measures placement and failover, not a speed-up",
            "committees": {k: len(v) for k, v in committees.items()}, "committee_shard": owners,
            "setless_signers": VERIFYD_FLEET_ROUNDS * VERIFYD_FLEET_SIGNERS,
            "round_ms": round_ms, "round_lanes": len(requests[0][0]),
            "per_shard": [{"shard_id": sid, "response_shard_ids": sorted(ids[sid]), "lanes": shard_lanes[sid],
                           "pinned_slice": len(slices[sid]), "pinned_total": len(snaps[sid]["pinned_keys"]),
                           "launches": shard_launches[sid]} for sid in (0, 1)],
            "route_epoch": [epoch0, epoch1, fed.route_epoch], "failover_ms": failover_ms,
            "router": {k: st[k] for k in ("routed_calls", "failovers", "rerouted_lanes", "host_fallback_lanes",
                                          "unanswered_lanes", "route_epoch")},
            "stats_rollup": rollup, "stats_command_s": stats_s, "launches": launches_served}


def stop_shard0(shards):
    """13e's end: SIGTERM to shard 0, which must exit 0 and leave a
    flight-recorder dump (schema, its served ``verifyd_*`` spans)."""
    import glob
    import tempfile

    part = "phase 13e"
    proc = shards.procs[0]
    t = time.perf_counter()
    proc.send_signal(signal.SIGTERM)
    rc = proc.wait(timeout=VERIFYD_CHILD_STOP_S)
    stop_s = time.perf_counter() - t
    check(rc == 0, f"{part}: the daemon exited {rc}")
    dumps = sorted(glob.glob(os.path.join(tempfile.gettempdir(), "tendermint_tpu_flightrec",
                                          f"flightrec-{proc.pid}-sigterm-*.json")))
    check(len(dumps) == 1, f"{part}: flight-recorder dumps {dumps}")
    with open(dumps[0]) as f:
        doc = json.load(f)
    spans = {r["name"] for r in doc["records"] if r["kind"] == "span"}
    check(doc["schema"] == "tendermint-tpu-flightrec/1" and doc["reason"] == "sigterm"
          and {"verifyd_enqueue", "verifyd_wait", "verifyd_respond"} <= spans,
          f"{part}: dump {doc.get('schema')} {doc.get('reason')}, spans {sorted(spans)}")
    return {"stop_s": stop_s, "flightrec": {"path": dumps[0], "records": len(doc["records"]),
                                            "span_names": sorted(spans)[:12],
                                            "memstats_keys": sorted(doc["memstats"])}}


def phase_verifyd(commit_wl, commit_tables, batch, sync, mixed_sync, light, dev):
    """Phase 13: verifyd on the card (see the module note). Returns the
    launches of the requests the servers answered: each sub-phase's
    deltas around its served requests only (13a's and 13b's in-process
    references and 13e's and 13f's are left out), plus the two shard
    daemons' own counts from their snapshots."""
    from tendermint_tpu_torch.ops import precompute
    from tendermint_tpu_torch.verifyd import client as vclient
    from tendermint_tpu_torch.verifyd.server import VerifydServer

    t_phase = time.perf_counter()
    check(len(commit_tables) == COMMIT_VALIDATORS, f"phase 13: {len(commit_tables)} tables of the set")
    srv = VerifydServer(device=dev)  # the reference's defaults
    srv.start()
    try:
        t = time.perf_counter()
        out = verifyd_remote_commit(srv, commit_wl, commit_tables, dev)
        served = {"13a": out["served_launches"]}
        emit({"phase": "verifyd_13a_remote_commit", "seconds": time.perf_counter() - t, **out})
        t = time.perf_counter()
        out = verifyd_mix(commit_wl, sync, mixed_sync, light, dev)
        served["13b"] = out["launches"]  # taken around the clients only
        emit({"phase": "verifyd_13b_mix", "seconds": time.perf_counter() - t, **out})
        health = check_healthy("phase 13a-13b")
        t = time.perf_counter()
        before = launches()  # 13c runs no in-process reference: all of it is served
        out = verifyd_ladder(srv, commit_wl, dev)
        served["13c"] = delta(before)
        emit({"phase": "verifyd_13c_ladder", "seconds": time.perf_counter() - t, **out})
    finally:
        vclient.reset_remote()
        srv.stop()
    shards = Shards(dev)  # 13e's and 13f's daemons start now, beside 13d
    try:
        t = time.perf_counter()
        out = verifyd_hot_keys(batch, dev)
        served["13d"] = add_launches(*(r["launches"] for r in out["rounds"]))
        emit({"phase": "verifyd_13d_hot_keys", "seconds": time.perf_counter() - t, **out})
        t = time.perf_counter()
        daemon = verifyd_daemon(light, dev, shards)
        emit({"phase": "verifyd_13e_daemon", "seconds": time.perf_counter() - t, **daemon})
        seconds_13a_e = time.perf_counter() - t_phase
        t = time.perf_counter()
        fleet = verifyd_fleet(shards, sync, light, batch, dev)
        served["13e_13f"] = fleet["launches"]  # both daemons' own counts
        fleet_s = time.perf_counter() - t
        emit({"phase": "verifyd_13f_federation", "seconds": fleet_s, **fleet})
        stopped = stop_shard0(shards)
        emit({"phase": "verifyd_13e_stop", **stopped})
    finally:
        shards.stop()
    precompute.reset()
    counts = launches()
    summed = add_launches(*served.values())
    total = {k: summed.get(k, 0) for k in counts}
    seconds = time.perf_counter() - t_phase
    emit({"phase": "verifyd", "seconds": seconds, "seconds_13a_13e": seconds_13a_e, "seconds_13f": fleet_s,
          "launches_this_process": counts, "launches_served": served, "launches": total,
          "health_13a_13b": health})
    check(seconds_13a_e <= VERIFYD_PHASE_S, f"phases 13a-13e took {seconds_13a_e:.1f} s")
    check(fleet_s <= VERIFYD_FLEET_S, f"phase 13f took {fleet_s:.1f} s")
    return total


# --- phase 14 ------------------------------------------------------------------


class StageClock:
    """Host seconds by stage, the one stage clock of phases 14 and 15.
    :meth:`wrap` adds a callable's seconds to its stage; in phase 15
    :meth:`step` names the consensus step the node's receive thread is
    in, and the stages are kept under it. :meth:`counted` adds the
    verdict-cache hits and misses during a call to ``cache``."""

    def __init__(self, where=None):
        self.seconds = {}  # stage, or (step, stage) -> seconds
        self.where = where
        self.cache = {"hits": 0, "misses": 0}

    def add(self, key, s):
        k = key if self.where is None else (self.where, key)
        self.seconds[k] = self.seconds.get(k, 0.0) + s

    def wrap(self, key, fn):
        def run(*args, **kwargs):
            t = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.add(key, time.perf_counter() - t)

        return run

    def step(self, where, fn):
        def run(*args, **kwargs):
            outer, self.where = self.where, where
            try:
                return self.wrap("total", fn)(*args, **kwargs)
            finally:
                self.where = outer

        return run

    def counted(self, fn):
        from tendermint_tpu_torch.ops import precompute

        def run(*args, **kwargs):
            before = precompute.results.stats()
            try:
                return fn(*args, **kwargs)
            finally:
                after = precompute.results.stats()
                for k in self.cache:
                    self.cache[k] += after[k] - before[k]

        return run

    def ms(self):
        """{step: {stage: ms}} (phase 15) or {stage: ms} (phase 14)."""
        out = {}
        for k, s in sorted(self.seconds.items(), key=lambda kv: str(kv[0])):
            if isinstance(k, tuple):
                out.setdefault(k[0], {})[k[1]] = s * 1e3
            else:
                out[k] = s * 1e3
        return out


def node_follow(source, dev, clock=None, faults=None):
    """One fresh follower (state from genesis, fresh stores, a fresh app)
    syncing NODE_SYNC_TO blocks through ``BlockSyncer`` from the source's
    block store, each block loaded and decoded as a peer's message would
    be. With ``clock`` (a :class:`StageClock`), each stage is timed.
    With ``faults`` ({peer: fn(height, block) -> the block it serves}),
    those peers serve in turn, each joining once the one before it is
    banned, and a good peer joins last. Returns the syncer, its executor,
    the wall seconds and a log: the (peer, height) requests served, the
    (height, error) of each block ``validate_block`` refused, and the
    hashes of the blocks saved (the last two with ``faults`` only)."""
    from tendermint_tpu_torch.blocksync import syncer as syncer_mod
    from tendermint_tpu_torch.blocksync.syncer import BlockSyncer, PeerTransport
    from tendermint_tpu_torch.state import execution
    from tendermint_tpu_torch.types import validation

    genesis_json, src_exec = source[:2]
    executor, state = node_env(genesis_json, dev)
    syncer = BlockSyncer(state, executor, executor.block_store, transport=None, device=dev)
    faults = faults or {}
    log = {"served": [], "rejected": [], "saved": set()}

    class StoreTransport(PeerTransport):
        def request_block(self, peer_id, height):
            block = src_exec.block_store.load_block(height)
            if block is None:
                return
            if peer_id in faults:
                block = faults[peer_id](height, block)
            log["served"].append((peer_id, height))
            syncer.pool.add_block(peer_id, block)

    syncer.transport = StoreTransport()
    peers = [*faults, "good"] if faults else ["p1"]
    syncer.pool.set_peer_range(peers[0], 1, NODE_HEIGHTS)
    joined = {peers[0]}
    if faults:
        real_validate, real_save = executor.validate_block, executor.block_store.save_block

        def validate_logged(state, block):
            try:
                return real_validate(state, block)
            except Exception as e:
                log["rejected"].append((block.header.height, str(e)))
                raise

        def save_logged(block, parts, seen_commit):
            log["saved"].add(block.hash())
            return real_save(block, parts, seen_commit)

        executor.validate_block = validate_logged
        executor.block_store.save_block = save_logged
    patches = []
    if clock is not None:
        for mod, name, key in ((syncer_mod, "verify_commits_pipelined", "pipeline"),
                               (execution, "validate_block", "validate_block"),
                               (validation, "verify_commit", "verify_commit")):
            fn = getattr(mod, name)
            patches.append((mod, name, fn))
            setattr(mod, name, clock.wrap(key, clock.counted(fn) if key == "verify_commit" else fn))
        executor.apply_block = clock.wrap("apply_block", executor.apply_block)
        executor.app.finalize_block = clock.wrap("finalize_block", executor.app.finalize_block)
        executor.block_store.save_block = clock.wrap("save_block", executor.block_store.save_block)
        executor.state_store.save = clock.wrap("save_state", executor.state_store.save)
    try:
        t = time.perf_counter()
        for _ in range(NODE_MAX_STEPS):
            syncer.step()
            if syncer.state.last_block_height >= NODE_SYNC_TO:
                break
            for banned, nxt in zip(peers, peers[1:]):
                if banned in syncer.pool._banned and nxt not in joined:
                    joined.add(nxt)
                    syncer.pool.set_peer_range(nxt, 1, NODE_HEIGHTS)
        wall = time.perf_counter() - t
    finally:
        for mod, name, fn in patches:
            setattr(mod, name, fn)
    check(syncer.state.last_block_height == NODE_SYNC_TO,
          f"the follower stopped at height {syncer.state.last_block_height}")
    return syncer, executor, wall, log


def check_converged(source, executor, state, where, first=1):
    """The follower's block IDs at ``first``..NODE_SYNC_TO, its app hash at
    NODE_SYNC_TO, and its validator sets (hash and proposer) from
    NODE_CHANGE_HEIGHT to NODE_HEIGHTS equal the source's."""
    _, src_exec, src_state = source[:3]
    for h in range(first, NODE_SYNC_TO + 1):
        check(executor.block_store.load_block_meta(h).block_id
              == src_exec.block_store.load_block_meta(h).block_id, f"{where}: block ID at {h} differs")
    check(state.app_hash == src_state.app_hash, f"{where}: app hash at {NODE_SYNC_TO} differs")
    for h in range(NODE_CHANGE_HEIGHT, NODE_HEIGHTS + 1):
        got, want = executor.state_store.load_validators(h), src_exec.state_store.load_validators(h)
        check(got.hash() == want.hash() and got.get_proposer().address == want.get_proposer().address,
              f"{where}: validator set or proposer at {h} differs")


def phase_node_blocksync(source, dev):
    """BASELINE config 4 as a node runs it: fresh followers sync
    NODE_SYNC_TO blocks of NODE_VALIDATORS validators through
    ``BlockSyncer(device=)``: each window's commits verified in one
    pipeline call (K3), each block applied by ``BlockExecutor`` (its
    ``validate_block`` verifies the LastCommit again, the verdict cache
    answering the lanes the window checked), FinalizeBlock on the kvstore
    app, and the block and state saved. One cold run (host table builds,
    the store's upload), NODE_REPS timed runs from fresh followers with
    the verdict cache emptied, and a run with two faulty peers: one that
    corrupts a signature (the window refuses the block) and one that
    serves a signed block with a forged AppHash (the window passes it,
    ``validate_block`` refuses it before it is saved). Returns the
    phase's launch counts (which start at 0)."""
    from tendermint_tpu_torch.ops import precompute, resident
    from tendermint_tpu_torch.types.block import Block

    genesis_json, src_exec, src_state, changed, fork, _ = source
    vals_before = src_exec.state_store.load_validators(NODE_CHANGE_HEIGHT)
    vals_after = src_exec.state_store.load_validators(NODE_CHANGE_HEIGHT + 2)
    check(vals_before.hash() != vals_after.hash() and len(vals_after) == NODE_VALIDATORS,
          "the val: txs did not change the set two heights on")
    precompute.reset()
    builds = precompute.tables.builds
    invalidations = precompute.tables.invalidations
    uploads = resident.stats()["uploads"]
    before = launches()
    syncer, executor, cold_s, _ = node_follow(source, dev)
    cold_launches = delta(before)
    check_converged(source, executor, syncer.state, "cold run")
    cold = {"s": cold_s, "table_builds": precompute.tables.builds - builds,
            "store_uploads": resident.stats()["uploads"] - uploads, "launches": cold_launches}
    before = launches()
    walls, clocks = [], []
    for _ in range(NODE_REPS):
        precompute.results.clear()
        clock = StageClock()
        syncer, executor, wall, _ = node_follow(source, dev, clock)
        check_converged(source, executor, syncer.state, "timed run")
        walls.append(wall)
        clocks.append(clock)
    timed_launches = delta(before)
    check(timed_launches.get("verify_resident", 0) > 0, f"phase 14 launched no K3: {timed_launches}")
    check(precompute.tables.builds - builds == cold["table_builds"], "table builds after the cold run")

    # "bad" corrupts a signature of block NODE_CORRUPT_HEIGHT's LastCommit:
    # the window fails at NODE_CORRUPT_HEIGHT - 1, both heights are asked
    # again, and "bad" is banned. "fork" then serves the forged block
    # NODE_FORK_HEIGHT and its successor: the window passes the pair,
    # validate_block refuses the block before it is saved, both heights
    # are asked again, and "fork" is banned. The good peer serves the rest.
    def corrupt(height, block):
        if height == NODE_CORRUPT_HEIGHT:
            sig = block.last_commit.signatures[0].signature
            block.last_commit.signatures[0].signature = sig[:40] + bytes([sig[40] ^ 1]) + sig[41:]
            block.last_commit._hash = None
        return block

    def forked(height, block):
        return Block.from_proto_bytes(fork[height]) if height in fork else block

    precompute.results.clear()
    syncer, executor, corrupt_s, log = node_follow(source, dev, faults={"bad": corrupt, "fork": forked})
    served, rejected = log["served"], log["rejected"]
    check({"bad", "fork"} <= syncer.pool._banned, f"faulty peers not banned: {syncer.pool._banned}")
    check(("fork", NODE_CORRUPT_HEIGHT - 1) in served and ("fork", NODE_CORRUPT_HEIGHT) in served,
          f"heights {NODE_CORRUPT_HEIGHT - 1} and {NODE_CORRUPT_HEIGHT} not asked again of the next peer")
    check(("good", NODE_FORK_HEIGHT) in served and ("good", NODE_FORK_HEIGHT + 1) in served,
          f"heights {NODE_FORK_HEIGHT} and {NODE_FORK_HEIGHT + 1} not asked again of the good peer")
    check(rejected == [(NODE_FORK_HEIGHT, "wrong Block.Header.AppHash")],
          f"validate_block refused {rejected}, not the forged block alone")
    check(Block.from_proto_bytes(fork[NODE_FORK_HEIGHT]).hash() not in log["saved"],
          "the forged block was saved")
    check_converged(source, executor, syncer.state, "faulty-peers run")

    i = walls.index(statistics.median(walls))
    split = {k: clocks[i].seconds.get(k, 0.0) for k in ("pipeline", "validate_block", "verify_commit",
                                                         "apply_block", "finalize_block", "save_block",
                                                         "save_state")}
    blocks = NODE_SYNC_TO
    n_runs = NODE_REPS * blocks
    blocks_per_s = blocks / statistics.median(walls)
    cache = clocks[i].cache
    stages = {k: v * 1e3 for k, v in split.items()}
    # validate_block runs before apply_block (whose own call finds the
    # block in the executor's cache), so the stages do not nest.
    stages["other_ms"] = (walls[i] - split["pipeline"] - split["validate_block"] - split["apply_block"]) * 1e3
    counts = launches()
    emit({"phase": "node_blocksync", "blocks": blocks, "validators": NODE_VALIDATORS,
          "txs_per_block": NODE_TXS, "changed_validators_at": NODE_CHANGE_HEIGHT,
          "changed": len(changed), "signers_per_commit": int(NODE_VALIDATORS * NODE_SIGN_SHARE),
          "cold": cold, "seconds": walls, "blocks_per_s_median": blocks_per_s,
          "limit_blocks_per_s": NODE_BLOCKS_PER_S_LIMIT,
          "limit": "met" if blocks_per_s >= NODE_BLOCKS_PER_S_LIMIT else "missed",
          "split_ms_of_median_run": stages,
          "verify_commit_share_of_wall": split["verify_commit"] / walls[i],
          "verify_commit_cache_of_median_run": cache,
          "launches_timed_runs": timed_launches,
          "launches_per_block": {k: v / n_runs for k, v in timed_launches.items()},
          "table_invalidations": precompute.tables.invalidations - invalidations,
          "faulty_peers": {"corrupt_height": NODE_CORRUPT_HEIGHT, "fork_height": NODE_FORK_HEIGHT,
                           "s": corrupt_s, "banned": sorted(syncer.pool._banned),
                           "validate_block_refused": rejected},
          "launches": counts, "store": resident.stats()})
    precompute.reset()
    return counts, blocks_per_s


# --- phase 15 ------------------------------------------------------------------


class TxClient:
    """Phase 15's client: a thread that submits a height's seeded txs
    through the node's ``TxMempool.check_tx`` when the height before it
    commits (the block rate), then the height's first tx again and one
    tx the kvstore app refuses (not UTF-8). Every answer is kept."""

    def __init__(self, txs):
        self.txs = txs
        self.queue = queue.Queue()
        self.accepted, self.failed = {}, []  # h -> txs taken; what was not answered as expected
        self.repeats_refused = self.app_refused = 0
        self.latency = []  # seconds a check_tx took
        self.thread = threading.Thread(target=self._run, name="tx-client", daemon=True)
        self.thread.start()

    def submit(self, mempool, height):
        self.queue.put((mempool, height))

    def stop(self):
        self.queue.put(None)
        self.thread.join(timeout=30)

    def _run(self):
        while True:
            item = self.queue.get()
            if item is None:
                return
            mempool, h = item
            try:
                for tx in self.txs[h]:
                    t = time.perf_counter()
                    res = mempool.check_tx(tx)
                    self.latency.append(time.perf_counter() - t)
                    if res.is_ok():
                        self.accepted[h] = self.accepted.get(h, 0) + 1
                    else:
                        self.failed.append((h, "refused", res.code))
                try:
                    mempool.check_tx(self.txs[h][0])
                    self.failed.append((h, "repeat taken"))
                except KeyError:
                    self.repeats_refused += 1
                res = mempool.check_tx(b"\xff\xfe refused at %d" % h)
                if res.is_ok():
                    self.failed.append((h, "bad tx taken"))
                else:
                    self.app_refused += 1
            except Exception as exc:  # failed by the phase
                self.failed.append((h, repr(exc)))


class ConsensusHarness:
    """The other validators of phase 15, as the node's peers: the node's
    ``Broadcaster``. It is honest and reactive. On the node's first
    PROPOSE step of a (height, round) whose proposer is one of its keys,
    it builds the block from the node's committed state (read from the
    node's state store) with ``make_block`` and ``PartSet``, the height's
    seeded txs and the previous height's commit made from the precommits
    it holds plus the node's own, stamped with the wall clock, and
    delivers the signed proposal and its parts. When the node broadcasts
    a prevote or precommit for (h, r, id or nil), the active validators
    answer with a vote of that type for that id (a non-nil precommit with
    the app's ``ExtendVote`` extension and its signature), signed in the
    harness's spawn pool and submitted through the node's
    ``VotePreverifier`` spread over ``spread`` seconds in a seeded order,
    beside a copy of one validator's precommit with a corrupted
    signature. The proposer of (``nil_height``, 0) withholds its
    proposal. Evidence (``heights``: equivocation, unseen, repeat): at
    the equivocation height one validator adds a prevote for another
    block, and the next height's proposal carries that pair's
    ``DuplicateVoteEvidence``, stamped with the node's last block time
    as the node's pool stamps it; the unseen height's proposal carries a
    pair the harness signs at the height before and never sends; the
    repeat height's round-0 proposal carries the first evidence again.
    On each commit it has ``client`` submit the next height's txs to the
    node's mempool. It never calls the node's executor."""

    def __init__(self, genesis, privs, node_addr, silent, nil_height, txs, pool, spread, rng,
                 heights=None, client=None, last=None):
        from tendermint_tpu_torch.abci.kvstore import KVStoreApplication
        from tendermint_tpu_torch.state import state_from_genesis

        self.vset = state_from_genesis(genesis).validators
        self.privs = privs  # address -> 64-byte private key
        self.node_addr = node_addr
        self.active = [i for i, v in enumerate(self.vset.validators)
                       if v.address != node_addr and v.address not in silent]
        self.bad_index = self.active[0]
        self.equivocator, self.unseen_equivocator = self.active[1], self.active[2]
        self.heights = heights or {}
        self.client, self.last = client, last
        self.seen_pair = self.seen_evidence = self.unseen_evidence = None
        self.misbehavior = {}  # h -> the FinalizeBlock request's misbehavior
        self.nil_height = nil_height
        self.txs = txs
        self.pool = pool
        self.spread = spread
        self.rng = rng
        self.app = KVStoreApplication()  # asked for the extensions, as a peer's app would be
        self.events = queue.Queue()
        self.lock = threading.Lock()
        self.stop_flag = threading.Event()
        self.paused = threading.Event()
        self.thread = None
        self.node = self.pv = None
        self.errors = []
        self.proposed, self.answered, self.withheld = set(), set(), []
        self.precommits = {}  # (h, r) -> {index: Vote}, the non-nil precommits sent
        self.bad_sigs = {}  # h -> the corrupted signatures sent at h
        self.node_votes = {}  # (type, h, r) -> the node's vote
        self.node_signed = []  # (kind, h, r) of everything the node signed, in order
        self.submitted = {}  # (h, r, type, index) -> perf_counter at submit  # guarded-by: lock
        self.latency = {1: [], 2: []}  # type -> seconds, submit to the node's vote set
        self.sign_s = {1: [], 2: []}  # type -> seconds the pool took a step
        self.committed = {}  # h -> {"round", "t", "counters", "bad_in_vote_set"}
        self.t_complete = {}  # (h, r) -> perf_counter of the node's complete proposal

    # --- the node's broadcaster (called on the node's receive thread) ---

    def broadcast_proposal(self, proposal):
        self.node_signed.append(("proposal", proposal.height, proposal.round))

    def broadcast_block_part(self, height, round_, part):
        pass

    def broadcast_vote(self, vote):
        self.node_signed.append((vote.type, vote.height, vote.round))
        self.node_votes[(vote.type, vote.height, vote.round)] = vote
        if not self.paused.is_set():
            self.events.put(("vote", vote))

    def broadcast_has_vote(self, height, round_, type_, index):
        t = time.perf_counter()
        with self.lock:
            sent = self.submitted.pop((height, round_, type_, index), None)
        if sent is not None:
            self.latency[type_].append(t - sent)

    def broadcast_new_round_step(self, rs):
        from tendermint_tpu_torch.consensus.cstypes import RoundStep

        if rs.step == RoundStep.PROPOSE and not self.paused.is_set():
            self.events.put(("propose", rs.height, rs.round))

    def on_committed(self, height):
        node = self.node
        if self.client is not None and height + 1 <= self.last and height != CONSENSUS_HEIGHTS:
            self.client.submit(node.block_exec.mempool, height + 1)
        seen = node.block_store.load_seen_commit()
        bad = node.rs.last_commit.get_by_index(self.bad_index)
        self.committed[height] = {"round": seen.round, "t": time.perf_counter(),
                                  "counters": ingest_counters(),
                                  "bad_in_vote_set": bad is not None
                                  and bad.signature in self.bad_sigs.get(height, ())}

    # --- the harness's own thread ---

    def attach(self, node, pv):
        """Serve ``node`` behind its pre-verifier ``pv``, and time its
        complete proposals."""
        self.node, self.pv = node, pv
        real = node._handle_complete_proposal

        def complete():
            self.t_complete.setdefault((node.rs.height, node.rs.round), time.perf_counter())
            return real()

        node._handle_complete_proposal = complete

    def start(self):
        self.thread = threading.Thread(target=self._run, name="consensus-harness", daemon=True)
        self.thread.start()

    def stop(self):
        self.stop_flag.set()
        self.thread.join(timeout=10)

    def _run(self):
        while not self.stop_flag.is_set():
            try:
                event = self.events.get(timeout=0.05)
            except queue.Empty:
                continue
            if self.paused.is_set():
                continue
            try:
                if event[0] == "propose":
                    self._propose(*event[1:])
                else:
                    self._answer(event[1])
            except Exception as exc:  # failed by the phase
                self.errors.append(repr(exc))

    def _propose(self, height, round_):
        from tendermint_tpu_torch.crypto import ed25519_ref
        from tendermint_tpu_torch.encoding.canonical import Timestamp
        from tendermint_tpu_torch.types.block import BLOCK_PART_SIZE_BYTES, BlockID, Commit, Proposal, make_block
        from tendermint_tpu_torch.types.part_set import PartSet

        if (height, round_) in self.proposed:
            return
        state = self.node.block_exec.state_store.load()  # the node's committed state
        if state.last_block_height + 1 != height:
            return
        self.proposed.add((height, round_))
        vals = state.validators.copy()
        if round_:
            vals.increment_proposer_priority(round_)
        proposer = vals.get_proposer().address
        if proposer == self.node_addr:
            return
        if height == self.nil_height and round_ == 0:
            self.withheld.append((height, round_))
            return
        last_commit = self._last_commit(height - 1, state) if height > state.initial_height else Commit()
        block = make_block(height, self.txs[height], last_commit, self._evidence(height, round_, state))
        h = block.header
        h.version, h.chain_id = state.version, state.chain_id
        h.time = Timestamp.from_unix_ns(time.time_ns())
        h.last_block_id = state.last_block_id
        h.validators_hash = state.validators.hash()
        h.next_validators_hash = state.next_validators.hash()
        h.consensus_hash = state.consensus_params.hash()
        h.app_hash, h.last_results_hash = state.app_hash, state.last_results_hash
        h.proposer_address = proposer
        parts = PartSet.from_data(block.to_proto_bytes(), BLOCK_PART_SIZE_BYTES)
        proposal = Proposal(height=height, round=round_, pol_round=-1,
                            block_id=BlockID(block.hash(), parts.header()), timestamp=h.time)
        proposal.signature = ed25519_ref.sign(self.privs[proposer], proposal.sign_bytes(state.chain_id))
        peer = f"peer{self.vset.get_by_address(proposer)[0]}"
        self.node.add_proposal_from_peer(proposal, peer)
        for i in range(parts.total):
            self.node.add_block_part_from_peer(height, round_, parts.get_part(i), peer)

    def _evidence(self, height, round_, state):
        """The evidence of the proposal of (``height``, ``round_``)."""
        from tendermint_tpu_torch.types.evidence import DuplicateVoteEvidence

        hs = self.heights
        if height == hs.get("equivocation", -1) + 1:
            if self.seen_evidence is None:
                vset = self.node.block_exec.state_store.load_validators(height - 1)
                self.seen_evidence = DuplicateVoteEvidence.new(*self.seen_pair, state.last_block_time, vset)
            return [self.seen_evidence]
        if height == hs.get("unseen"):
            if self.unseen_evidence is None:
                self.unseen_evidence = self._unseen(height - 1, state)
            return [self.unseen_evidence]
        if height == hs.get("repeat") and round_ == 0:
            return [self.seen_evidence]
        return []

    def _unseen(self, height, state):
        """A pair of prevotes of the unseen equivocator at ``height``
        (committed): one for the block, one for another; signed here."""
        from tendermint_tpu_torch.crypto import ed25519_ref
        from tendermint_tpu_torch.encoding.canonical import SIGNED_MSG_TYPE_PREVOTE, Timestamp
        from tendermint_tpu_torch.types.block import BlockID, PartSetHeader, Vote
        from tendermint_tpu_torch.types.evidence import DuplicateVoteEvidence

        i = self.unseen_equivocator
        addr = self.vset.validators[i].address
        real = self.node.block_store.load_block_meta(height).block_id
        other = BlockID(hashlib.sha256(b"unseen %d" % height).digest(),
                        PartSetHeader(1, hashlib.sha256(b"unseen parts").digest()))
        ts = Timestamp.from_unix_ns(time.time_ns())
        votes = [Vote(type=SIGNED_MSG_TYPE_PREVOTE, height=height, round=0, block_id=bid, timestamp=ts,
                      validator_address=addr, validator_index=i) for bid in (real, other)]
        for v in votes:
            v.signature = ed25519_ref.sign(self.privs[addr], v.sign_bytes(state.chain_id))
        vset = self.node.block_exec.state_store.load_validators(height)
        return DuplicateVoteEvidence.new(*votes, state.last_block_time, vset)

    def _last_commit(self, height, state):
        """Height ``height``'s commit for the next block: the precommits
        the harness sent in the round the node precommitted a block in,
        and the node's own."""
        from tendermint_tpu_torch.encoding.canonical import SIGNED_MSG_TYPE_PRECOMMIT
        from tendermint_tpu_torch.types.block import ExtendedCommit, ExtendedCommitSig

        rounds = [r for (h, r) in self.precommits if h == height
                  and (SIGNED_MSG_TYPE_PRECOMMIT, h, r) in self.node_votes
                  and not self.node_votes[(SIGNED_MSG_TYPE_PRECOMMIT, h, r)].block_id.is_nil()]
        r = max(rounds)
        own = self.node_votes[(SIGNED_MSG_TYPE_PRECOMMIT, height, r)]
        votes = {**self.precommits[(height, r)], own.validator_index: own}
        sigs = [votes[i].extended_commit_sig() if i in votes else ExtendedCommitSig()
                for i in range(len(state.last_validators))]
        return ExtendedCommit(height=height, round=r, block_id=own.block_id,
                              extended_signatures=sigs).to_commit()

    def _answer(self, vote):
        from tendermint_tpu_torch.abci import types as abci
        from tendermint_tpu_torch.encoding.canonical import (
            SIGNED_MSG_TYPE_PRECOMMIT,
            SIGNED_MSG_TYPE_PREVOTE,
            Timestamp,
        )
        from tendermint_tpu_torch.types.block import Vote

        key = (vote.type, vote.height, vote.round)
        if key in self.answered:
            return
        self.answered.add(key)
        chain_id = self.node.state.chain_id
        extend = vote.type == SIGNED_MSG_TYPE_PRECOMMIT and not vote.block_id.is_nil()
        ext = (self.app.extend_vote(abci.RequestExtendVote(hash=vote.block_id.hash, height=vote.height))
               .vote_extension if extend else b"")
        ts = Timestamp.from_unix_ns(time.time_ns())
        votes = [Vote(type=vote.type, height=vote.height, round=vote.round, block_id=vote.block_id,
                      timestamp=ts, validator_address=self.vset.validators[i].address, validator_index=i,
                      extension=ext)
                 for i in self.active]
        privs = [self.privs[v.validator_address] for v in votes]
        msgs = [v.sign_bytes(chain_id) for v in votes]
        if extend:
            privs, msgs = privs * 2, msgs + [v.extension_sign_bytes(chain_id) for v in votes]
        t = time.perf_counter()
        sigs = self.pool.map(_sign, list(zip(privs, msgs)), chunksize=16)
        self.sign_s[vote.type].append(time.perf_counter() - t)
        n = len(votes)
        for i, v in enumerate(votes):
            v.signature = sigs[i]
            if extend:
                v.extension_signature = sigs[n + i]
        deliveries = list(votes)
        if (vote.type == SIGNED_MSG_TYPE_PREVOTE and vote.height == self.heights.get("equivocation")
                and self.seen_pair is None):
            from tendermint_tpu_torch.crypto import ed25519_ref
            from tendermint_tpu_torch.types.block import BlockID, PartSetHeader

            honest = votes[self.active.index(self.equivocator)]
            other = copy.copy(honest)
            other.block_id = BlockID(hashlib.sha256(b"the other block").digest(),
                                     PartSetHeader(1, hashlib.sha256(b"the other parts").digest()))
            other.signature = ed25519_ref.sign(self.privs[other.validator_address], other.sign_bytes(chain_id))
            self.seen_pair = (honest, other)
            deliveries.append(other)
        if vote.type == SIGNED_MSG_TYPE_PRECOMMIT:
            bad = copy.copy(votes[0])  # the validator of self.bad_index
            bad.signature = bad.signature[:40] + bytes([bad.signature[40] ^ 1]) + bad.signature[41:]
            self.bad_sigs.setdefault(vote.height, set()).add(bad.signature)
            deliveries.append(bad)
            if extend:
                self.precommits[(vote.height, vote.round)] = {v.validator_index: v for v in votes}
        at = np.sort(self.rng.uniform(0.0, self.spread, len(deliveries)))
        order = self.rng.permutation(len(deliveries))
        start = time.perf_counter()
        for when, j in zip(at, order):
            if self.stop_flag.is_set() or self.paused.is_set():
                return
            wait = start + when - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            v = deliveries[int(j)]
            if j < n:
                with self.lock:
                    self.submitted[(v.height, v.round, v.type, v.validator_index)] = time.perf_counter()
            self.pv.submit(copy.copy(v), f"peer{v.validator_index}")


def consensus_node(genesis, home, txs, dev, harness, metrics, clock, stores=None):
    """Phase 15's node, assembled as a node assembles it: the ``FilePV``
    and the ``WAL`` under ``home``, ``MemDB`` stores (block, state and
    evidence), ``LocalClient`` over a fresh ``KVStoreApplication``, a
    ``TxMempool`` over that client with the reference's defaults, an
    ``EvidencePool(device=dev)`` over the stores and
    ``BlockExecutor(device=dev)``, then ``ConsensusState`` with the
    harness as its broadcaster. A fresh node runs InitChain; a restarted
    one (``stores`` given) runs the ``Handshaker``, which replays the
    stored blocks to the fresh app, and starts with an empty mempool.
    ``clock`` times the node's stages, each on the node's own objects;
    the harness keeps each FinalizeBlock's misbehavior. Returns the
    node, its pre-verifier (started and warm), the warm-up's launches
    and the blocks the handshake replayed."""
    from tendermint_tpu_torch.abci import types as abci
    from tendermint_tpu_torch.abci.client import LocalClient
    from tendermint_tpu_torch.abci.kvstore import KVStoreApplication
    from tendermint_tpu_torch.consensus.replay import Handshaker
    from tendermint_tpu_torch.consensus.state import ConsensusState
    from tendermint_tpu_torch.consensus.wal import WAL
    from tendermint_tpu_torch.evidence import EvidencePool
    from tendermint_tpu_torch.libs.metrics import MempoolMetrics, Registry
    from tendermint_tpu_torch.mempool import MempoolConfig, TxMempool
    from tendermint_tpu_torch.privval import FilePV
    from tendermint_tpu_torch.state import StateStore, state_from_genesis
    from tendermint_tpu_torch.state.execution import BlockExecutor
    from tendermint_tpu_torch.storage.blockstore import BlockStore
    from tendermint_tpu_torch.storage.kv import MemDB

    client = LocalClient(KVStoreApplication())
    client.start()
    if stores is None:
        state = state_from_genesis(genesis)
        state.app_hash = client.init_chain(
            abci.RequestInitChain(chain_id=genesis.chain_id, initial_height=genesis.initial_height)).app_hash
        state_store, block_store, evidence_db = StateStore(MemDB()), BlockStore(MemDB()), MemDB()
        state_store.save(state)
        replayed = 0
    else:
        state_store, block_store, evidence_db = stores
        state = state_store.load()
    mempool = TxMempool(MempoolConfig(), client, height=state.last_block_height,
                        metrics=MempoolMetrics(Registry()))
    evidence_pool = EvidencePool(evidence_db, state_store, block_store, device=dev)
    executor = BlockExecutor(state_store, client, block_store, mempool=mempool, evidence_pool=evidence_pool,
                             device=dev)
    if stores is not None:
        handshaker = Handshaker(state_store, block_store, executor, genesis)
        state = handshaker.handshake(client, state)
        replayed = handshaker.n_blocks_replayed
    evidence_pool.set_state(state)
    evidence_pool.verified = []  # (hash, seconds) of each item the pool verified
    real_verify = evidence_pool.verify

    def verify(ev):
        t = time.perf_counter()
        real_verify(ev)
        evidence_pool.verified.append((ev.hash(), time.perf_counter() - t))

    evidence_pool.verify = verify
    real_finalize = client.finalize_block

    def finalize(req):
        harness.misbehavior[req.height] = list(req.misbehavior)
        return real_finalize(req)

    client.finalize_block = finalize
    pv = FilePV.load(os.path.join(home, "priv_validator_key.json"), os.path.join(home, "priv_validator_state.json"))
    node = ConsensusState(state, executor, block_store, priv_validator=pv, wal=WAL(os.path.join(home, "cs.wal")),
                          broadcaster=harness, on_committed=harness.on_committed, metrics=metrics)
    node._finalize_commit = clock.step("finalize", node._finalize_commit)
    node._do_prevote = clock.step("prevote", node._do_prevote)
    executor.validate_block = clock.wrap("validate_block", clock.counted(executor.validate_block))
    executor.apply_block = clock.wrap("apply_block", executor.apply_block)
    client.finalize_block = clock.wrap("finalize_block", client.finalize_block)
    block_store.save_block_with_extended_commit = clock.wrap("save_block", block_store.save_block_with_extended_commit)
    state_store.save = clock.wrap("save_state", state_store.save)
    preverifier, warm_launches = start_preverifier(node)
    harness.attach(node, preverifier)
    return node, preverifier, warm_launches, replayed


def check_consensus_evidence(node, node2, harness, client, block_store, txs, heights, total):
    """Phase 15's mempool and evidence checks (see ``phase_consensus``);
    returns the evidence's numbers."""
    from tendermint_tpu_torch.encoding.canonical import SIGNED_MSG_TYPE_PREVOTE

    check(not client.failed and client.accepted == {h: len(txs[h]) for h in range(1, total + 1)}
          and client.repeats_refused == client.app_refused == total,
          f"phase 15: the mempool's answers: failed {client.failed[:3]}, repeats refused "
          f"{client.repeats_refused}, bad refused {client.app_refused} of {total}")
    check(block_store.load_block(2).data.txs == txs[2], "phase 15: the node's block 2 is not height 2's txs")
    mp1, mp2 = node.block_exec.mempool, node2.block_exec.mempool
    check(mp1.metrics.failed_txs.value() == CONSENSUS_HEIGHTS and mp2.metrics.failed_txs.value() == total
          - CONSENSUS_HEIGHTS and mp2.size() == 0, f"phase 15: mempool failed {mp1.metrics.failed_txs.value()}, "
          f"{mp2.metrics.failed_txs.value()}; left {mp2.size()}")
    seen, unseen = harness.seen_evidence, harness.unseen_evidence
    e, u, r = heights["equivocation"], heights["unseen"], heights["repeat"]
    check(seen is not None and unseen is not None, "phase 15: the harness made no evidence")
    carried = {h: [ev.hash() for ev in block_store.load_block(h).evidence] for h in range(1, total + 1)}
    check(carried == {h: [seen.hash()] if h == e + 1 else [unseen.hash()] if h == u else []
                      for h in range(1, total + 1)}, f"phase 15: the blocks' evidence {carried}")
    verified = node.block_exec.evidence_pool.verified
    check([hv for hv, _ in verified] == [seen.hash(), unseen.hash()],
          f"phase 15: the node's pool verified {len(verified)} items, not the seen pair then the unseen one")
    pool2 = node2.block_exec.evidence_pool
    check(pool2.is_committed(seen) and pool2.is_committed(unseen) and pool2.pending_evidence(-1)[0] == [],
          "phase 15: the evidence is not committed")
    got = {h: [(m.type, m.validator_address, m.height) for m in ms] for h, ms in harness.misbehavior.items() if ms}
    addr = harness.vset.validators
    check(got == {e + 1: [(1, addr[harness.equivocator].address, e)],
                  u: [(1, addr[harness.unseen_equivocator].address, u - 1)]},
          f"phase 15: FinalizeBlock's misbehavior {got}")
    check(harness.node_votes[(SIGNED_MSG_TYPE_PREVOTE, r, 0)].block_id.is_nil(),
          f"phase 15: the node did not prevote nil on the repeated evidence at {r}")
    return {"heights": heights, "seen_hash": seen.hash().hex(), "unseen_hash": unseen.hash().hex(),
            "pool_verify_ms": [t * 1e3 for _, t in verified]}


def run_heights(node, harness, last):
    """Wait until ``node`` has committed ``last``, failing on a node or
    harness error or a height that takes over CONSENSUS_HEIGHT_WAIT_S."""
    height, since = node.block_store.height(), time.perf_counter()
    while node.block_store.height() < last:
        check(node.error is None, f"phase 15: the node stopped: {node.error!r}")
        check(not harness.errors, f"phase 15: harness errors {harness.errors[:3]}")
        if node.block_store.height() != height:
            height, since = node.block_store.height(), time.perf_counter()
        check(time.perf_counter() - since < CONSENSUS_HEIGHT_WAIT_S,
              f"phase 15: stuck at height {height + 1} (step {node.rs.height_round_step()})")
        time.sleep(0.005)


def histogram_by_label(hist, label):
    """{label value: {"count", "sum_s"}} from a histogram's exposition."""
    out = {}
    for line in hist.collect():
        name, _, value = line.rpartition(" ")
        for suffix, key in (("_count{", "count"), ("_sum{", "sum_s")):
            if suffix in name:
                lv = name.split(f'{label}="', 1)[1].split('"', 1)[0]
                out.setdefault(lv, {})[key] = float(value)
    return out


def phase_consensus(keys, dev):
    """BASELINE config 2 as a validator runs it: one node of
    CONSENSUS_VALIDATORS commits CONSENSUS_HEIGHTS heights with the
    harness playing its peers, every peer vote batch-verified on the card
    by the ``VotePreverifier`` in front of its ``ConsensusState`` and each
    block's LastCommit by ``validate_block``; then it stops, restarts from
    its stores, WAL and ``FilePV`` with the caches emptied (the
    ``Handshaker`` replaying its blocks to a fresh app), and commits
    CONSENSUS_RESTART_HEIGHTS more. Checked: every height's round, every
    stored commit on the card, a fresh executor replaying the blocks to
    the same app and validator hashes, no corrupted precommit in a vote
    set or a commit, the WAL's end-height markers, no second signature at
    an (height, round, step), the device tier and K3 or K1 after the
    restart; the mempool's answers to the client (every tx taken, every
    repeat and bad tx refused, the node's block 2 made of height 2's
    txs); the evidence: the node's pool built and verified the seen pair
    (through the shared scheduler) before the proposal carrying it,
    which it did not verify again, verified the unseen one in
    ``check_evidence``, committed both, FinalizeBlock received both
    misbehaviors, and the repeat drew a nil prevote. Returns the node's
    launch counts (from 0, read before the checks launch their own) and
    the node's stores and genesis."""
    import tempfile

    from tendermint_tpu_torch.consensus.wal import WAL, EndHeightMessage
    from tendermint_tpu_torch.crypto.keys import Ed25519PrivKey, Ed25519PubKey
    from tendermint_tpu_torch.encoding.canonical import (
        SIGNED_MSG_TYPE_PRECOMMIT,
        SIGNED_MSG_TYPE_PREVOTE,
        Timestamp,
    )
    from tendermint_tpu_torch.libs import tracing
    from tendermint_tpu_torch.libs.metrics import ConsensusMetrics, Registry
    from tendermint_tpu_torch.ops import precompute
    from tendermint_tpu_torch.privval import FilePV
    from tendermint_tpu_torch.state import state_from_genesis
    from tendermint_tpu_torch.types import validation
    from tendermint_tpu_torch.types.genesis import GenesisDoc, GenesisValidator
    from tendermint_tpu_torch.types.params import ConsensusParams

    rng = np.random.default_rng(SEED + 15)
    params = ConsensusParams()
    if CONSENSUS_TIMEOUTS is not None:
        params.timeout = CONSENSUS_TIMEOUTS
    params.abci.vote_extensions_enable_height = 1
    genesis = GenesisDoc(chain_id=CHAIN_ID, genesis_time=Timestamp.from_unix_ns(time.time_ns()),
                         consensus_params=params,
                         validators=[GenesisValidator(Ed25519PubKey(pub), 10) for _, pub in keys])
    gstate = state_from_genesis(genesis)
    privs = {Ed25519PubKey(pub).address(): priv for priv, pub in keys}
    node_addr = gstate.next_validators.get_proposer().address  # height 2's proposer
    silent = {v.address for v in gstate.validators.validators[-CONSENSUS_SILENT:]}
    total = CONSENSUS_HEIGHTS + CONSENSUS_RESTART_HEIGHTS
    vals, proposers, round1 = gstate.validators.copy(), {}, {}
    for h in range(1, total + 1):
        rv = vals.copy()
        proposers[(h, 0)] = rv.get_proposer().address
        rv.increment_proposer_priority(1)
        round1[h] = rv.get_proposer().address
        vals.increment_proposer_priority(1)
    repeat = next((h for h in range(CONSENSUS_REPEAT_FROM, CONSENSUS_HEIGHTS + 1)
                   if h != CONSENSUS_NIL_HEIGHT and round1[h] not in silent | {node_addr}), CONSENSUS_HEIGHTS + 1)
    for h in (CONSENSUS_NIL_HEIGHT, repeat):
        proposers[(h, 1)] = round1[h]
    heights = {"equivocation": CONSENSUS_EQUIVOCATION_HEIGHT, "unseen": CONSENSUS_UNSEEN_HEIGHT, "repeat": repeat}
    check(2 < CONSENSUS_EQUIVOCATION_HEIGHT < CONSENSUS_UNSEEN_HEIGHT - 1 < repeat - 1 <= CONSENSUS_HEIGHTS - 1,
          f"phase 15: the evidence heights {heights}")
    check(not silent & set(proposers.values()) and node_addr not in silent,
          "phase 15: a silent validator proposes a round of the phase")
    check([k for k, a in proposers.items() if a == node_addr] == [(2, 0)],
          "phase 15: the node proposes other rounds than (2, 0)")
    txs = {h: [b"acct-%05d=%s" % (a, rng.bytes(17).hex().encode())
               for a in rng.integers(0, CONSENSUS_ACCOUNTS, CONSENSUS_TXS)]
           for h in range(1, total + 1)}
    home = tempfile.mkdtemp(prefix="chip_smoke_consensus_")
    FilePV(Ed25519PrivKey(privs[node_addr]), os.path.join(home, "priv_validator_key.json"),
           os.path.join(home, "priv_validator_state.json")).save()

    metrics = ConsensusMetrics(Registry())
    intervals = []
    real_observe = metrics.block_interval_seconds.observe

    def observe(v, exemplar=None):
        intervals.append(v)
        real_observe(v, exemplar)

    metrics.block_interval_seconds.observe = observe
    clock = StageClock(where="other")
    step_observer = tracing.metrics_observer(consensus=metrics)

    def observer(name, args, seconds):
        step_observer(name, args, seconds)
        if name == "verify_commit":  # its span, inside validate_block
            clock.add("verify_commit", seconds)

    saved_observer = tracing.tracer.metrics_observer
    tracing.tracer.set_metrics_observer(observer)
    precompute.reset()
    pool = multiprocessing.get_context("spawn").Pool(CONSENSUS_SIGNERS)
    client = TxClient(txs)
    harness = ConsensusHarness(genesis, privs, node_addr, silent, CONSENSUS_NIL_HEIGHT, txs, pool,
                               CONSENSUS_SPREAD_S, rng, heights=heights, client=client, last=total)
    try:
        pool.map(_keypair, [b"\0" * 32] * CONSENSUS_SIGNERS)  # the workers are up
        harness.start()
        node, pv, warm1, _ = consensus_node(genesis, home, txs, dev, harness, metrics, clock)
        first = ingest_counters()
        t0 = time.perf_counter()
        client.submit(node.block_exec.mempool, 1)
        node.start()
        run_heights(node, harness, CONSENSUS_HEIGHTS)
        harness.paused.set()  # the peers wait for the restart
        node.stop()
        pv.stop()
        first_wall = time.perf_counter() - t0
        before = (pv.batched, pv.passthrough, list(harness.node_signed))
        stores = (node.block_exec.state_store, node.block_store, node.block_exec.evidence_pool._db)
        state_at_stop = stores[0].load()

        # The restart, with the caches of a new process.
        precompute.reset()
        t = time.perf_counter()
        node2, pv2, warm2, replayed = consensus_node(genesis, home, txs, dev, harness, metrics, clock, stores)
        restart_s = time.perf_counter() - t
        check(replayed == CONSENSUS_HEIGHTS, f"phase 15: the handshake replayed {replayed} blocks")
        restart = ingest_counters()
        harness.paused.clear()
        client.submit(node2.block_exec.mempool, CONSENSUS_HEIGHTS + 1)
        node2.start()
        run_heights(node2, harness, total)
        node2.stop()
        pv2.stop()
        wall = time.perf_counter() - t0
        # The node's launches, read before the checks below launch their own.
        counts = launches()
        everything = ingest_delta(first)
        after_restart = ingest_delta(restart)
    finally:
        harness.stop()
        client.stop()
        pool.terminate()
        pool.join()
        tracing.tracer.set_metrics_observer(saved_observer)
    signed_after = harness.node_signed[len(before[2]):]

    # The checks.
    rounds = {h: harness.committed[h]["round"] for h in range(1, total + 1)}
    check(rounds == {h: int(h in (CONSENSUS_NIL_HEIGHT, repeat)) for h in range(1, total + 1)},
          f"phase 15: commit rounds {rounds}")
    check(harness.withheld == [(CONSENSUS_NIL_HEIGHT, 0)], f"phase 15: withheld {harness.withheld}")
    check(not set(before[2]) & set(signed_after) and len(set(harness.node_signed)) == len(harness.node_signed),
          "phase 15: the node signed twice at an (height, round, step)")
    check(("proposal", 2, 0) in harness.node_signed, "phase 15: the node never proposed height 2")
    block_store, state_store = stores[1], stores[0]
    evidence = check_consensus_evidence(node, node2, harness, client, block_store, txs, heights, total)
    precompute.results.clear()  # every stored commit verified anew on the card
    bad = harness.bad_index
    for h in range(1, total + 1):
        meta = block_store.load_block_meta(h)
        vset = state_store.load_validators(h)
        ext = block_store.load_block_extended_commit(h)
        commits = [ext.to_commit()] + ([block_store.load_block_commit(h)] if h < total else [])
        for c in commits:
            validation.verify_commit(CHAIN_ID, vset, meta.block_id, h, c, device=dev)
            check(c.signatures[bad].signature not in harness.bad_sigs[h],
                  f"phase 15: a corrupted precommit is in height {h}'s commit")
        check(not harness.committed[h]["bad_in_vote_set"], f"phase 15: a corrupted precommit in {h}'s vote set")
    executor, st = node_env(genesis.to_json(), dev)
    for h in range(1, total + 1):
        st = executor.apply_block(st, block_store.load_block_meta(h).block_id, block_store.load_block(h))
        want = state_store.load() if h == total else None
        app_hash = want.app_hash if want else block_store.load_block(h + 1).header.app_hash
        check(st.app_hash == app_hash, f"phase 15: the replayed app hash differs at {h}")
        check(st.validators.hash() == state_store.load_validators(h + 1).hash(),
              f"phase 15: the replayed validator set differs at {h + 1}")
        if h == CONSENSUS_HEIGHTS:
            check(st.app_hash == state_at_stop.app_hash, "phase 15: the app hash at the restart differs")
    ends = {m.height for _, m in WAL(os.path.join(home, "cs.wal")).iter_messages()
            if isinstance(m, EndHeightMessage)}
    check(set(range(1, total + 1)) <= ends, f"phase 15: WAL end-height markers {sorted(ends)}")
    restart_launches = after_restart["launches"]
    check(after_restart["tiers"]["device"] > 0
          and restart_launches.get("verify_resident", 0) + restart_launches.get("verify", 0) > 0,
          f"phase 15: after the restart, device tier {after_restart['tiers']}, launches {restart_launches}")

    # The numbers.
    counters = [first] + [harness.committed[h]["counters"] for h in range(1, total + 1)]
    per_height = []
    for h in range(1, total + 1):
        prev = restart if h == CONSENSUS_HEIGHTS + 1 else counters[h - 1]
        cur = counters[h]
        c = harness.committed[h]
        per_height.append({
            "height": h, "round": c["round"],
            "decision_ms": (c["t"] - harness.t_complete[(h, c["round"])]) * 1e3,
            "launches": {k: v - prev["launches"][k] for k, v in cur["launches"].items()
                         if v != prev["launches"][k]},
            "tiers": {k: v - prev["tiers"][k] for k, v in cur["tiers"].items()},
        })
    sched = everything["sched"]
    lat = {name: harness.latency[t] for name, t in (("prevote", SIGNED_MSG_TYPE_PREVOTE),
                                                     ("precommit", SIGNED_MSG_TYPE_PRECOMMIT))}
    decisions = [r["decision_ms"] for r in per_height]
    emit({"phase": "consensus", "rpc_transport": "none: the validator serves no RPC listener",
          "validators": CONSENSUS_VALIDATORS, "silent": CONSENSUS_SILENT,
          "heights": CONSENSUS_HEIGHTS, "restart_heights": CONSENSUS_RESTART_HEIGHTS,
          "nil_height": CONSENSUS_NIL_HEIGHT, "txs_per_block": CONSENSUS_TXS,
          "spread_ms": CONSENSUS_SPREAD_S * 1e3, "timeouts": vars(params.timeout),
          "wall_s": wall, "first_run_s": first_wall, "restart_s": restart_s,
          "per_height": per_height,
          "decision_ms_p50": statistics.median(decisions), "decision_ms_max": max(decisions),
          "block_interval_s_p50": statistics.median(intervals), "block_intervals": len(intervals),
          "finalize_split_ms": clock.ms(), "verify_commit_cache": clock.cache,
          "vote_latency_ms": {k: {"n": len(v), "p50": percentile(v, 0.5) * 1e3, "p99": percentile(v, 0.99) * 1e3}
                              for k, v in lat.items()},
          "preverifier": {"batched": before[0] + pv2.batched, "passthrough": before[1] + pv2.passthrough},
          "scheduler": {"flushes": sched["flushes"], "lanes": sched["entries_verified"],
                        "mean_lanes_per_flush": sched["entries_verified"] / max(1, sched["flushes"]),
                        "flush_errors": sched["flush_errors"], "fallback_flushes": sched["fallback_flushes"]},
          "tiers": everything["tiers"], "tier_s": everything["tier_s"],
          "warmup_launches": [warm1, warm2], "after_restart": {"tiers": after_restart["tiers"],
                                                              "launches": restart_launches},
          "step_duration": histogram_by_label(metrics.step_duration_seconds, "step"),
          "mempool": {"check_tx": len(client.latency), "check_tx_p50_ms": percentile(client.latency, 0.5) * 1e3,
                      "check_tx_p99_ms": percentile(client.latency, 0.99) * 1e3,
                      "repeats_refused": client.repeats_refused, "app_refused": client.app_refused},
          "evidence": evidence,
          "signing_s_per_step": {name: {"mean": statistics.mean(harness.sign_s[t]), "max": max(harness.sign_s[t]),
                                        "steps": len(harness.sign_s[t])}
                                 for name, t in (("prevote", SIGNED_MSG_TYPE_PREVOTE),
                                                 ("precommit", SIGNED_MSG_TYPE_PRECOMMIT))},
          "launches": everything["launches"]})
    precompute.reset()
    shutil.rmtree(home)
    return counts, (genesis, state_store, block_store, harness)


# --- phase 16 ------------------------------------------------------------------


def kernel_lanes():
    """The lanes the verify path has sent to the kernels so far: the
    verdict cache's misses and hits, and the device hash's lanes."""
    from tendermint_tpu_torch.ops import hash512, precompute

    return {**precompute.results.stats(), "device_hash_lanes": hash512.stats().get("device_lanes", 0)}


def lanes_since(before):
    now = kernel_lanes()
    return {k: now[k] - before[k] for k in ("hits", "misses", "device_hash_lanes")}


def light_chain_stores(chain):
    """A ``BlockStore`` and a ``StateStore`` of honest light blocks: each
    height's meta (its block id and header) and commit, and its set."""
    from tendermint_tpu_torch.state import StateStore
    from tendermint_tpu_torch.storage import blockstore
    from tendermint_tpu_torch.storage.kv import MemDB
    from tendermint_tpu_torch.types.block_meta import BlockMeta

    db, state_store = MemDB(), StateStore(MemDB())
    for lb in chain:
        commit = lb.signed_header.commit
        db.set(blockstore._meta_key(lb.height), BlockMeta(block_id=commit.block_id, header=lb.header).to_proto_bytes())
        db.set(blockstore._commit_key(lb.height), commit.to_proto_bytes())
        state_store._save_validators(lb.height, lb.height, lb.validator_set)
    return state_store, blockstore.BlockStore(db)


def phase_evidence_attack(workload, evidence, dev):
    """16a, BASELINE config 3: phase 11d's ``LightClientAttackEvidence``
    (the light client reported it to its primary) given to a fresh
    ``EvidencePool(device=dev)`` through ``add_evidence``, as the RPC's
    ``broadcast_evidence`` gives it, ATTACK_REPS times, each with the
    verdict cache emptied: the lunatic check's trusting pass over height
    10's set and the conflicting commit's +2/3 pass, 1,000-validator
    lanes on K3 or K1 (K4 declines them: their sign-bytes have two
    lengths). Then three tampered copies (a bad signature inside
    the +2/3 pass, a wrong total voting power, a wrong timestamp) are
    refused, and a second node's fresh pool passes a block carrying the
    good one. Returns the launches (from 0)."""
    from tendermint_tpu_torch.encoding.canonical import Timestamp
    from tendermint_tpu_torch.evidence import EvidencePool, InvalidEvidenceError
    from tendermint_tpu_torch.ops import hash512, precompute
    from tendermint_tpu_torch.state.state import State
    from tendermint_tpu_torch.storage.kv import MemDB
    from tendermint_tpu_torch.types.block import Block, make_block
    from tendermint_tpu_torch.types.evidence import evidence_from_proto_bytes

    chain, _, fork_top = workload
    top = chain[-1]
    check(evidence.conflicting_block.hash() == fork_top.hash() and evidence.common_height == LIGHTD_STORE_HEIGHTS[-2],
          "phase 16a: not phase 11d's evidence")
    state = State(chain_id=CHAIN_ID, last_block_height=top.height, last_block_time=top.header.time,
                  validators=top.validator_set, next_validators=top.validator_set,
                  last_validators=chain[-2].validator_set)

    def fresh_pool(stores):
        pool = EvidencePool(MemDB(), *stores, device=dev)
        pool.set_state(state)
        return pool

    stores = light_chain_stores(chain)
    before, lanes0, hash0, runs = launches(), kernel_lanes(), hash512.stats(), []
    for _ in range(ATTACK_REPS):
        precompute.results.clear()
        pool = fresh_pool(stores)
        t = time.perf_counter()
        pool.add_evidence(evidence)
        runs.append(time.perf_counter() - t)
        check([e.hash() for e in pool.pending_evidence(-1)[0]] == [evidence.hash()],
              "phase 16a: the attack is not pending")
    run_launches, run_lanes = delta(before), lanes_since(lanes0)
    # The chain's vote timestamps end in nanos 0-999, whose varint takes
    # one or two bytes, so a commit's sign-bytes have two lengths and K4
    # declines its chunks (hash512's "declined_mixed_lengths"), as the
    # JAX package's device hash does.
    hash_declined = {k: v - hash0.get(k, 0) for k, v in hash512.stats().items() if v != hash0.get(k, 0)}
    check(run_launches.get("verify_resident", 0) + run_launches.get("verify", 0) > 0,
          f"phase 16a: launches {run_launches}")

    def tampered(kind):
        ev = evidence_from_proto_bytes(evidence.to_proto_bytes())
        if kind == "signature":
            cs = ev.conflicting_block.signed_header.commit.signatures[LIGHTD_BAD_INDEX]
            cs.signature = cs.signature[:40] + bytes([cs.signature[40] ^ 1]) + cs.signature[41:]
        elif kind == "total_voting_power":
            ev.total_voting_power += 1
        else:
            ev.timestamp = Timestamp.from_unix_ns(ev.timestamp.to_unix_ns() + 1)
        return ev

    refused = {}
    for kind, want in (("signature", "signature"), ("total_voting_power", "total voting power"),
                       ("timestamp", "different time")):
        precompute.results.clear()
        pool = fresh_pool(stores)
        try:
            pool.add_evidence(tampered(kind))
            check(False, f"phase 16a: the copy with a wrong {kind} was taken")
        except InvalidEvidenceError as exc:
            refused[kind] = str(exc)
        check(want in refused[kind] and pool.pending_evidence(-1)[0] == [],
              f"phase 16a: the wrong {kind} refused as {refused[kind]!r}")

    block = make_block(top.height + 1, [], top.signed_header.commit, evidence=[evidence])
    decoded = Block.from_proto_bytes(block.to_proto_bytes())
    check(decoded.hash() == block.hash() and [e.hash() for e in decoded.evidence] == [evidence.hash()],
          "phase 16a: the block's evidence did not round-trip")
    for ev in decoded.evidence:
        ev.validate_basic()
    precompute.results.clear()
    second = fresh_pool(light_chain_stores(chain))
    t = time.perf_counter()
    second.check_evidence(decoded.evidence)
    second_s = time.perf_counter() - t
    counts = launches()
    emit({"phase": "evidence_attack", "validators": LIGHTD_VALIDATORS, "conflicting_height": top.height,
          "common_height": evidence.common_height, "evidence_bytes": len(evidence.to_proto_bytes()),
          "add_evidence_ms": [r * 1e3 for r in runs], "add_evidence_ms_p50": statistics.median(runs) * 1e3,
          "launches_per_run": {k: v / ATTACK_REPS for k, v in run_launches.items()},
          "lanes_per_run": {k: v / ATTACK_REPS for k, v in run_lanes.items()},
          "device_hash_per_run": {k: v / ATTACK_REPS for k, v in hash_declined.items()},
          "refused": refused, "second_node_check_evidence_ms": second_s * 1e3, "launches": counts})
    precompute.reset()
    return counts


class TimedStateStore:
    """A state store whose ``load_validators`` calls are timed."""

    def __init__(self, inner):
        self.inner = inner
        self.calls, self.seconds = 0, 0.0  # guarded-by: lock
        self.lock = threading.Lock()

    def load_validators(self, height):
        t = time.perf_counter()
        vset = self.inner.load_validators(height)
        with self.lock:
            self.calls += 1
            self.seconds += time.perf_counter() - t
        return vset


def phase_equivocation_burst(source, workload, dev):
    """16b, BASELINE config 4: the ``DuplicateVoteEvidence`` of the
    validators of phase 14's chain that hold just over 1/3 of the power
    and double-signed a precommit at one synced height (the least
    equivocation that can break safety), given to one ``EvidencePool``
    from EQUIVOCATION_THREADS threads, as the RPC and the evidence
    reactor deliver it, beside one with a bad signature (refused). Each
    pair rides the shared scheduler. Then the source's next block with
    all of it, within the evidence max_bytes, through a fresh node's
    ``validate_block``. Returns the launches (from 0)."""
    from tendermint_tpu_torch.abci.client import LocalClient
    from tendermint_tpu_torch.abci.kvstore import KVStoreApplication
    from tendermint_tpu_torch.evidence import EvidencePool, InvalidEvidenceError
    from tendermint_tpu_torch.ops import precompute
    from tendermint_tpu_torch.state.execution import BlockExecutor
    from tendermint_tpu_torch.storage.kv import MemDB
    from tendermint_tpu_torch.types.block import Block
    from tendermint_tpu_torch.types.evidence import DuplicateVoteEvidence

    _, src_exec, src_state, _, _, _ = source
    height, pairs, bad_pair, power = workload
    vset = src_exec.state_store.load_validators(height)
    block_time = src_exec.block_store.load_block_meta(height).header.time
    evidence = [DuplicateVoteEvidence.new(a, b, block_time, vset) for a, b in pairs]
    bad = DuplicateVoteEvidence.new(*bad_pair, block_time, vset)
    items = evidence + [bad]
    order = np.random.default_rng(SEED + 16).permutation(len(items))
    work = queue.Queue()
    for i in order:
        work.put(items[int(i)])
    states = TimedStateStore(src_exec.state_store)
    pool = EvidencePool(MemDB(), states, src_exec.block_store, device=dev)
    pool.set_state(src_state)
    latency, refused, errors = [], [], []

    def deliver():
        while True:
            try:
                ev = work.get_nowait()
            except queue.Empty:
                return
            t = time.perf_counter()
            try:
                pool.add_evidence(ev)
                latency.append(time.perf_counter() - t)
            except InvalidEvidenceError as exc:
                refused.append((ev.hash(), str(exc)))
            except Exception as exc:  # failed by the phase
                errors.append(repr(exc))

    precompute.results.clear()
    before, t0 = ingest_counters(), time.perf_counter()
    threads = [threading.Thread(target=deliver) for _ in range(EQUIVOCATION_THREADS)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(300)
    wall = time.perf_counter() - t0
    burst = ingest_delta(before)
    check(not errors and [h for h, _ in refused] == [bad.hash()] and "signature" in refused[0][1],
          f"phase 16b: errors {errors[:3]}, refused {refused[:3]}")
    check(sorted(e.hash() for e in pool.pending_evidence(-1)[0]) == sorted(e.hash() for e in evidence),
          "phase 16b: the pending evidence is not the equivocators'")
    check(burst["sched"]["flush_errors"] == 0 and burst["sched"]["fallback_flushes"] == 0,
          f"phase 16b: scheduler {burst['sched']}")

    block = src_exec.block_store.load_block(src_state.last_block_height + 1)
    block.evidence = evidence
    block.header.evidence_hash, block._hash = b"", None
    block.fill_header()
    ev_bytes = sum(len(ev.bytes()) for ev in evidence)
    check(ev_bytes <= src_state.consensus_params.evidence.max_bytes, f"phase 16b: {ev_bytes} evidence bytes")
    block = Block.from_proto_bytes(block.to_proto_bytes())  # as a peer delivers it
    client = LocalClient(KVStoreApplication())
    client.start()
    node_states = TimedStateStore(src_exec.state_store)
    node_pool = EvidencePool(MemDB(), node_states, src_exec.block_store, device=dev)
    node_pool.set_state(src_state)
    node = BlockExecutor(src_exec.state_store, client, src_exec.block_store, evidence_pool=node_pool, device=dev)
    precompute.results.clear()
    before2, t = ingest_counters(), time.perf_counter()
    node.validate_block(src_state, block)
    block_s = time.perf_counter() - t
    in_block = ingest_delta(before2)
    counts = launches()
    emit({"phase": "equivocation_burst", "validators": len(vset), "height": height,
          "equivocators": len(evidence), "power_share": power / vset.total_voting_power(),
          "threads": EQUIVOCATION_THREADS, "evidence_per_s": len(items) / wall, "wall_s": wall,
          "add_evidence_ms_p50": percentile(latency, 0.5) * 1e3, "add_evidence_ms_p99": percentile(latency, 0.99) * 1e3,
          "flushes": burst["sched"]["flushes"], "lanes_scheduled": burst["sched"]["entries_verified"],
          "tiers": burst["tiers"], "tier_s": burst["tier_s"],
          "load_validators": {"calls": states.calls, "s": states.seconds, "share_of_wall": states.seconds / wall},
          "refused": refused[0][1],
          "block": {"evidence": len(block.evidence), "evidence_bytes": ev_bytes, "validate_block_ms": block_s * 1e3,
                    "flushes": in_block["sched"]["flushes"], "tiers": in_block["tiers"],
                    "tier_s": in_block["tier_s"], "launches": in_block["launches"],
                    "load_validators": {"calls": node_states.calls, "s": node_states.seconds}},
          "launches": counts})
    precompute.reset()
    return counts


def phase_mempool():
    """16c: the reference's mempool defaults (``MempoolConfig()``) over
    the kvstore app, filled to MEMPOOL_TXS of phase 14's 45-byte txs
    through ``check_tx`` from MEMPOOL_THREADS threads, reaped at the
    default block max_bytes with no gas limit, then ``update`` with
    MEMPOOL_COMMITTED of them, which rechecks the rest. Host only: no
    launch."""
    from tendermint_tpu_torch.abci import types as abci
    from tendermint_tpu_torch.abci.client import LocalClient
    from tendermint_tpu_torch.abci.kvstore import KVStoreApplication
    from tendermint_tpu_torch.libs.metrics import MempoolMetrics, Registry
    from tendermint_tpu_torch.mempool import MempoolConfig, TxMempool
    from tendermint_tpu_torch.types.params import BlockParams

    rng = np.random.default_rng(SEED + 16)
    txs = [b"acct-%05d=%s" % (a, rng.bytes(17).hex().encode()) for a in rng.integers(0, NODE_ACCOUNTS, MEMPOOL_TXS)]
    check({len(tx) for tx in txs} == {45} and len(set(txs)) == MEMPOOL_TXS, "phase 16c: the txs")
    check(MempoolConfig().size == MEMPOOL_TXS and BlockParams().max_bytes == MEMPOOL_REAP_BYTES,
          "phase 16c: the defaults moved")
    app = KVStoreApplication()
    rechecks = []
    real_check = app.check_tx

    def check_tx(req):
        if req.type == abci.CHECK_TX_TYPE_RECHECK:
            rechecks.append(req.tx)
        return real_check(req)

    app.check_tx = check_tx
    client = LocalClient(app)
    client.start()
    mp = TxMempool(MempoolConfig(), client, metrics=MempoolMetrics(Registry()))
    before, refused = launches(), []

    def fill(part):
        for tx in part:
            if not mp.check_tx(tx).is_ok():
                refused.append(tx)

    threads = [threading.Thread(target=fill, args=(txs[i::MEMPOOL_THREADS],)) for i in range(MEMPOOL_THREADS)]
    t = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(300)
    fill_s = time.perf_counter() - t
    check(not refused and len(mp) == MEMPOOL_TXS and mp.size_bytes() == 45 * MEMPOOL_TXS,
          f"phase 16c: {len(refused)} refused, {len(mp)} held")
    t = time.perf_counter()
    reaped = mp.reap_max_bytes_max_gas(MEMPOOL_REAP_BYTES, -1)
    reap_s = time.perf_counter() - t
    check(reaped == mp.tx_list() and sorted(reaped) == sorted(txs), "phase 16c: the reap is not every tx in order")
    committed = reaped[:MEMPOOL_COMMITTED]
    t = time.perf_counter()
    mp.lock()
    try:
        mp.update(1, committed, [abci.ExecTxResult(code=0)] * len(committed))
    finally:
        mp.unlock()
    update_s = time.perf_counter() - t
    check(mp.tx_list() == reaped[MEMPOOL_COMMITTED:] and sorted(rechecks) == sorted(reaped[MEMPOOL_COMMITTED:]),
          f"phase 16c: {len(mp)} left, {len(rechecks)} rechecked")
    counts = delta(before)
    check(not counts, f"phase 16c launched {counts}")
    emit({"phase": "mempool", "txs": MEMPOOL_TXS, "threads": MEMPOOL_THREADS, "check_tx_per_s": MEMPOOL_TXS / fill_s,
          "fill_s": fill_s, "reap_ms": reap_s * 1e3, "reaped": len(reaped), "committed": len(committed),
          "rechecked": len(rechecks), "update_and_recheck_ms": update_s * 1e3,
          "metrics_size": mp.metrics.size.value(), "launches": counts})



# --- phase 17 ------------------------------------------------------------------


def node_sinks():
    """The process-wide sinks a ``Node`` binds (the tracer's metrics
    observer and profile sink, the profiler's switch): saved before phase
    17's nodes, put back after them by :func:`restore_node_sinks`."""
    from tendermint_tpu_torch.libs import tracing
    from tendermint_tpu_torch.ops import introspect

    return tracing.tracer._observer, tracing.tracer._profile, introspect.profiler._enabled


def restore_node_sinks(saved):
    from tendermint_tpu_torch import ops as tops
    from tendermint_tpu_torch.libs import tracing
    from tendermint_tpu_torch.ops import introspect

    observer, profile, enabled = saved
    introspect.profiler._enabled = enabled
    tracing.tracer.set_metrics_observer(observer)
    tracing.tracer.set_profile_sink(profile)
    tops.bind_metrics(None)


def wait_until(fn, timeout, what, interval=0.01):
    """Wait for ``fn()``; fail after ``timeout`` s with ``what`` (a string,
    or a callable that gives one)."""
    deadline = time.perf_counter() + timeout
    while not fn():
        if time.perf_counter() >= deadline:
            check(False, f"timed out after {timeout} s: {what() if callable(what) else what}")
        time.sleep(interval)


CLUSTER_FACTS = {}  # 17a's block interval and 17b's rate, which phase 20 prints beside its own


def phase_cluster(dev):
    """17a, cluster-4: the e2e CI manifest (``ci.toml``) cut to what the
    port has. Four validators of power CLUSTER_POWER with the default
    consensus params and a full node that starts at height
    CLUSTER_START_AT and block-syncs in, all ``Node``s on one
    ``MemoryNetwork``, found through one persistent peer and PEX, each
    with a ``LocalClient`` kvstore and its RPC on 127.0.0.1; kvstore txs
    through ``Node.submit_tx`` at CLUSTER_TX_PER_S, on the nodes in turn,
    until height CLUSTER_HEIGHTS. Then, while the nodes are up, phase 18b
    (:func:`phase_rpc_cluster`). Returns 18b's launch counts."""
    import tempfile

    from tendermint_tpu_torch.abci.client import LocalClient
    from tendermint_tpu_torch.abci.kvstore import KVStoreApplication
    from tendermint_tpu_torch.encoding.canonical import Timestamp
    from tendermint_tpu_torch.node import Node, NodeConfig
    from tendermint_tpu_torch.p2p.transport import MemoryNetwork
    from tendermint_tpu_torch.privval import FilePV
    from tendermint_tpu_torch.types.genesis import GenesisDoc, GenesisValidator

    home = tempfile.mkdtemp(prefix="chip-smoke-cluster-")
    rng = np.random.default_rng(SEED + 17)
    privs = [FilePV.generate(os.path.join(home, f"k{i}.json"), os.path.join(home, f"s{i}.json"))
             for i in range(CLUSTER_VALIDATORS)]
    genesis = GenesisDoc(chain_id=CLUSTER_CHAIN_ID, genesis_time=Timestamp.from_unix_ns(time.time_ns()),
                         validators=[GenesisValidator(pv.get_pub_key(), CLUSTER_POWER) for pv in privs])
    net = MemoryNetwork()
    nodes = []

    def make(name, pv, peers, blocksync=True):
        node = Node(NodeConfig(chain_id=CLUSTER_CHAIN_ID, listen_addr=name, moniker=name, persistent_peers=peers,
                               blocksync=blocksync, rpc_laddr="127.0.0.1:0"),
                    genesis, LocalClient(KVStoreApplication()), priv_validator=pv, memory_network=net, device=dev)
        nodes.append(node)
        return node

    before = ingest_counters()
    t_phase = time.perf_counter()
    v0 = make("v0", privs[0], [])
    seed_peer = [f"{v0.node_key.node_id}@v0"]
    for i in range(1, CLUSTER_VALIDATORS):
        make(f"v{i}", privs[i], seed_peer)
    validators = list(nodes)
    submitted, submitted_to, committed, errors = {}, {}, {}, []
    stop, stop_watching = threading.Event(), threading.Event()

    def load():
        """CLUSTER_TX_PER_S txs a second, on the started nodes with a peer
        in turn (the mempool reactor gossips a tx when it is admitted, not
        to peers that connect later, so a tx given to a full node with no
        peer yet would stay there)."""
        period, i = 1.0 / CLUSTER_TX_PER_S, 0
        next_t = time.perf_counter()
        while not stop.is_set():
            live = [n for n in nodes if n._started and n.router.connected_peers()] or [v0]
            tx = b"cluster-%05d=%s" % (i, rng.bytes(8).hex().encode())
            node = live[i % len(live)]
            submitted[tx] = time.perf_counter()
            submitted_to[tx] = node.config.moniker
            try:
                node.submit_tx(tx)
            except Exception as exc:  # the phase checks what escaped
                errors.append(repr(exc))
            i += 1
            next_t += period
            stop.wait(max(0.0, next_t - time.perf_counter()))

    def watch():
        """Each block as v0 stores it: the host time its txs were committed."""
        seen = 0
        while not stop_watching.is_set() or seen < v0.height:
            while seen < v0.height:
                seen += 1
                now = time.perf_counter()
                for tx in v0.block_store.load_block(seen).data.txs:
                    committed.setdefault(bytes(tx), []).append((seen, now))
            time.sleep(0.005)

    full = None
    loader, watcher = threading.Thread(target=load), threading.Thread(target=watch)
    try:
        for node in validators:
            node.start()
        loader.start()
        watcher.start()
        wait_until(lambda: v0.height >= CLUSTER_START_AT, CLUSTER_WAIT_S, "phase 17a: the start height")
        full = make("full", None, seed_peer)
        full_started_at = v0.height
        full.start()
        wait_until(lambda: v0.height >= CLUSTER_HEIGHTS, CLUSTER_WAIT_S, "phase 17a: the last height")
        stop.set()
        loader.join(10)
        wait_until(lambda: all(tx in committed for tx in submitted), CLUSTER_WAIT_S,
                   lambda: "phase 17a: every tx committed; missing (tx, node, mempools holding it): "
                   + repr([(tx, submitted_to[tx], [n.config.moniker for n in nodes if tx in n.mempool.tx_list()])
                           for tx in submitted if tx not in committed][:5]))
        wait_until(lambda: full.height >= CLUSTER_HEIGHTS, CLUSTER_WAIT_S,
                   lambda: "phase 17a: the full node's height: " + repr(
                       {"height": full.height, "caught_up": full.caught_up, "failed": full.failed,
                        "synced_to": full.syncer.state.last_block_height, "syncer_error": full.syncer.error,
                        "round_state": full.consensus.rs.height_round_step(), "cs_error": full.consensus.error,
                        "peers": len(full.router.connected_peers()), "v0": v0.height}))
        peers = [len(n.router.connected_peers()) for n in nodes]
        lat = [committed[tx][0][1] - t for tx, t in submitted.items()]
        submit_ms = {"p50": percentile(lat, 0.5) * 1e3, "p99": percentile(lat, 0.99) * 1e3, "max": max(lat) * 1e3}
        wall = time.perf_counter() - t_phase
        counts, top = ingest_delta(before), v0.height  # 17a's, before 18b
        rpc_counts = phase_rpc_cluster(validators, full, submit_ms)
    finally:
        stop.set()
        stop_watching.set()
        watcher.join(10)
        stopped = []
        for node in nodes:
            try:
                node.stop()
                stopped.append(None)
            except Exception as exc:  # the phase checks what escaped
                stopped.append(repr(exc))
    check(not errors and stopped == [None] * len(nodes) and all(n.failed is None for n in nodes),
          f"phase 17a: submit errors {errors[:3]}, stop {stopped}, failed {[n.failed for n in nodes]}")
    last = min(n.height for n in nodes)
    for h in range(1, last + 1):
        metas = [n.block_store.load_block_meta(h) for n in nodes]
        app_hashes = {n.block_store.load_block(h).header.app_hash for n in nodes}
        check(len({m.block_id for m in metas}) == 1 and len(app_hashes) == 1,
              f"phase 17a: the nodes disagree at height {h}")
    counted = {}
    for h in range(1, top + 1):
        for tx in v0.block_store.load_block(h).data.txs:
            counted[bytes(tx)] = counted.get(bytes(tx), 0) + 1
    check(all(counted.get(tx) == 1 for tx in submitted) and set(counted) == set(submitted),
          f"phase 17a: {sum(1 for tx in submitted if counted.get(tx) != 1)} of {len(submitted)} txs "
          "not committed exactly once")
    synced_to = full.syncer.state.last_block_height
    check(full.caught_up and synced_to >= CLUSTER_START_AT - 1,
          f"phase 17a: the full node did not block-sync in (synced to {synced_to}, started at {full_started_at})")
    times = [v0.block_store.load_block(h).header.time.to_unix_ns() / 1e9 for h in range(1, CLUSTER_HEIGHTS + 1)]
    intervals = [b - a for a, b in zip(times, times[1:])]
    CLUSTER_FACTS["block_interval_mean_s"] = statistics.mean(intervals)
    out = {
        "phase": "cluster", "rpc_transport": sorted({n.rpc_server.transport for n in nodes}),
        "validators": CLUSTER_VALIDATORS, "full_nodes": 1, "heights": CLUSTER_HEIGHTS,
        "last_common_height": last, "full_node_started_at": full_started_at, "full_node_synced_to": synced_to,
        "block_interval_s": {"mean": statistics.mean(intervals), "stdev": statistics.pstdev(intervals),
                             "min": min(intervals), "max": max(intervals), "n": len(intervals)},
        "txs_submitted": len(submitted), "txs_committed": len(counted), "tx_per_s": CLUSTER_TX_PER_S,
        "submit_to_committed_ms": submit_ms,
        "peers": peers, "wall_s": wall,
        "launches": counts["launches"], "verifier_lanes": counts["cache"]["misses"],
        "verdict_cache_answered": counts["cache"]["hits"], "host_tier_lanes": counts["tiers"]["host"],
        "device_tier_lanes": counts["tiers"]["device"], "host_tier_s": counts["tier_s"]["host"],
        "device_tier_s": counts["tier_s"]["device"],
    }
    emit(out)
    shutil.rmtree(home, ignore_errors=True)
    return rpc_counts


class ServingPeer:
    """A peer that only serves blocks: a ``Router`` over ``TCPTransport``
    (SecretConnection and MConnection at the default rates) with a
    ``BlockSyncReactor(syncer=None)`` over ``store``."""

    def __init__(self, store, name):
        from tendermint_tpu_torch.blocksync.reactor import BlockSyncReactor
        from tendermint_tpu_torch.p2p.key import NodeKey
        from tendermint_tpu_torch.p2p.mconn import MConnConfig
        from tendermint_tpu_torch.p2p.peermanager import PeerManager
        from tendermint_tpu_torch.p2p.router import Router
        from tendermint_tpu_torch.p2p.transport import NodeInfo, TCPTransport

        self.key = NodeKey.generate()
        self.transport = TCPTransport(self.key, mconn_config=MConnConfig())
        self.transport.listen("127.0.0.1:0")
        self.router = Router(NodeInfo(self.key.node_id, CHAIN_ID, moniker=name,
                                      listen_addr=self.transport.listen_addr),
                             PeerManager(self.key.node_id), self.transport)
        self.reactor = BlockSyncReactor(None, store, self.router)
        self.addr = f"{self.key.node_id}@{self.transport.listen_addr}"
        self.router.start()
        self.reactor.start()

    def stop(self):
        self.reactor.stop()
        self.router.stop()


class CorruptingStore:
    """The store of a peer that corrupts signature 0 of the LastCommit of
    the first block it serves above height 1, and serves the rest as it is."""

    def __init__(self, store):
        self.store, self.corrupted = store, None

    def base(self):
        return self.store.base()

    def height(self):
        return self.store.height()

    def load_block(self, height):
        block = self.store.load_block(height)
        if block is not None and self.corrupted is None and height >= 2:
            sig = block.last_commit.signatures[0].signature
            block.last_commit.signatures[0].signature = sig[:40] + bytes([sig[40] ^ 1]) + sig[41:]
            block.last_commit._hash = None
            self.corrupted = height
        return block


AEAD_ZERO = {"seal_s": 0.0, "open_s": 0.0, "sealed_frames": 0, "opened_frames": 0}


def timed_aead(acc, lock):
    """Patch ``ChaCha20Poly1305.seal_many`` and ``open_many`` of this
    process to add their seconds and frames to ``acc`` (keys of
    :data:`AEAD_ZERO`) under ``lock``. Returns a callable that undoes it."""
    from tendermint_tpu_torch.crypto.chacha20poly1305 import ChaCha20Poly1305

    reals = {op: getattr(ChaCha20Poly1305, op + "_many") for op in ("seal", "open")}

    def timed(real, op):
        def run(self, nonces, frames, *args):
            t = time.perf_counter()
            try:
                return real(self, nonces, frames, *args)
            finally:
                with lock:
                    acc[op + "_s"] += time.perf_counter() - t
                    acc[op + "ed_frames"] += len(frames)

        return run

    for op, real in reals.items():
        setattr(ChaCha20Poly1305, op + "_many", timed(real, op))

    def undo():
        for op, real in reals.items():
            setattr(ChaCha20Poly1305, op + "_many", real)

    return undo


def serving_peer_process(conn, items, name, corrupt, top=None):
    """A :class:`ServingPeer` in a process of its own, as a joining node's
    peers are: ``items`` is the ``(data, keys)`` of its store's ``MemDB``,
    ``corrupt`` wraps the store in a :class:`CorruptingStore`, and ``top``
    in a :class:`TruncatedStore` (a peer that holds that many blocks). Sends
    its address and node ID; then answers ``"stats"`` with the seconds and
    frames its AEAD sealed and opened since the last answer, and
    ``"stop"`` with those and the height it corrupted, and stops."""
    from tendermint_tpu_torch.storage.blockstore import BlockStore
    from tendermint_tpu_torch.storage.kv import MemDB

    lock, acc = threading.Lock(), dict(AEAD_ZERO)
    timed_aead(acc, lock)
    db = MemDB()
    db._data, db._keys = items
    store = BlockStore(db)
    if top is not None:
        store = TruncatedStore(store, top)
    if corrupt:
        store = CorruptingStore(store)
    peer = ServingPeer(store, name)
    conn.send((peer.addr, peer.key.node_id))

    def read():
        with lock:
            out = dict(acc)
            acc.update(AEAD_ZERO)
        return out

    try:
        while conn.recv() != "stop":
            conn.send(read())
    finally:
        peer.stop()
    conn.send({**read(), "corrupted": getattr(store, "corrupted", None)})


class PeerProcess:
    """The phase's handle on a :func:`serving_peer_process` over a copy
    of ``store``: started at construction, ``ready()`` waits for its
    address, ``stats()`` asks for its AEAD's seconds and frames, and
    ``stop()`` ends the process (its last answer, or None)."""

    def __init__(self, store, name, corrupt=False, top=None):
        ctx = multiprocessing.get_context("spawn")
        self.name = name
        self.conn, child = ctx.Pipe()
        with store._db._lock:
            items = (dict(store._db._data), list(store._db._keys))
        self.proc = ctx.Process(target=serving_peer_process, args=(child, items, name, corrupt, top), name=name,
                                daemon=True)
        self.proc.start()
        child.close()
        self.addr = self.node_id = None

    def _answer(self, timeout=30):
        check(self.conn.poll(timeout), f"phase 17b: serving peer {self.name} did not answer")
        return self.conn.recv()

    def ready(self, timeout=120):
        self.addr, self.node_id = self._answer(timeout)

    def stats(self):
        self.conn.send("stats")
        return self._answer()

    def stop(self):
        last = None
        try:
            if self.proc.is_alive():
                self.conn.send("stop")
                if self.conn.poll(30):
                    last = self.conn.recv()
        except (OSError, EOFError):
            pass
        self.proc.join(30)
        if self.proc.is_alive():
            self.proc.terminate()
            self.proc.join(5)
        return last


def peers_aead(peers):
    """The serving peers' AEAD since their last answer, summed."""
    out = dict(AEAD_ZERO)
    for p in peers:
        for k, v in p.stats().items():
            out[k] += v
    return out


def p2p_follow(source, peers, dev, clock=None, fault=False, keep=False):
    """A fresh ``Node`` (non-validator, block sync on, memdb, no WAL, a new
    node key, ``persistent_peers`` the serving ``peers``, its RPC on
    127.0.0.1) syncing from them over encrypted TCP until it switches to
    consensus. With ``clock`` (a :class:`StageClock`) its stages are
    timed; with ``fault``, a permanent device fault is installed once its
    first window is applied. Returns the node (stopped; with ``keep``
    still running, unless it failed), the wall seconds from
    ``Node.start()`` to the caught-up event (or to the failure), and a
    log (the handshakes, with ``clock`` the node's AEAD seconds and
    frames, the height the fault came at, what ``stop()`` raised, the
    bytes by channel at the caught-up event)."""
    from tendermint_tpu_torch.abci.client import LocalClient
    from tendermint_tpu_torch.abci.kvstore import KVStoreApplication
    from tendermint_tpu_torch.blocksync import syncer as syncer_mod
    from tendermint_tpu_torch.node import Node, NodeConfig
    from tendermint_tpu_torch.ops import fault_injection
    from tendermint_tpu_torch.p2p import transport as transport_mod
    from tendermint_tpu_torch.state import execution
    from tendermint_tpu_torch.types import validation
    from tendermint_tpu_torch.types.genesis import GenesisDoc

    genesis_json = source[0]
    node = Node(NodeConfig(chain_id=CHAIN_ID, listen_addr="127.0.0.1:0", wal_enabled=False, moniker="follower",
                           persistent_peers=[p.addr for p in peers], rpc_laddr="127.0.0.1:0"),
                GenesisDoc.from_json(genesis_json), LocalClient(KVStoreApplication()), device=dev)
    log = {"handshakes_ms": [], "fault_at": None, "stop_raised": None}
    patches = []
    undo_aead = None

    def patch(obj, name, fn):
        patches.append((obj, name, getattr(obj, name)))
        setattr(obj, name, fn)

    real_handshake = transport_mod._TCPConn.handshake

    def handshake(conn, info):
        t = time.perf_counter()
        try:
            return real_handshake(conn, info)
        finally:
            if conn._node_key.node_id == node.node_key.node_id:
                log["handshakes_ms"].append((time.perf_counter() - t) * 1e3)

    patch(transport_mod._TCPConn, "handshake", handshake)
    if clock is not None:
        for mod, name, key in ((syncer_mod, "verify_commits_pipelined", "pipeline"),
                               (execution, "validate_block", "validate_block"),
                               (validation, "verify_commit", "verify_commit")):
            fn = getattr(mod, name)
            patch(mod, name, clock.wrap(key, clock.counted(fn) if key == "verify_commit" else fn))
        # the serving peers run in processes of their own: this process's
        # AEAD is the node's
        log["aead"] = dict(AEAD_ZERO)
        undo_aead = timed_aead(log["aead"], threading.Lock())
        ex = node.block_exec
        patch(ex, "apply_block", clock.wrap("apply_block", ex.apply_block))
        patch(ex.app, "finalize_block", clock.wrap("finalize_block", ex.app.finalize_block))
        patch(ex.block_store, "save_block", clock.wrap("save_block", ex.block_store.save_block))
        patch(ex.state_store, "save", clock.wrap("save_state", ex.state_store.save))
        # the default tx_index: the kv sink indexes each block in apply_block
        patch(node.event_sink, "index_finalized_block",
              clock.wrap("index", node.event_sink.index_finalized_block))
        patch(node.blocksync_reactor, "_handle", clock.wrap("fetch_decode", node.blocksync_reactor._handle))
    if fault:
        real_apply = node.syncer._apply_ready_blocks

        def apply_then_fault():
            applied = real_apply()
            if applied and log["fault_at"] is None:
                log["fault_at"] = node.block_store.height()
                fault_injection.install(fault_injection.FaultPlan(site="ed25519", fail_from=1, fail_count=1 << 30,
                                                                  permanent=True))
            return applied

        node.syncer._apply_ready_blocks = apply_then_fault
    try:
        t = time.perf_counter()
        node.start()
        wait_until(lambda: node.caught_up or node.failed is not None, P2P_SYNC_WAIT_S,
                   "phase 17b: the follower's catch-up")
        wall = time.perf_counter() - t
        log["bytes"] = p2p_bytes(node)
        if fault:
            # the syncer's thread has ended on the fault: no block after it
            wait_until(lambda: not node.syncer._thread or not node.syncer._thread.is_alive(), 30,
                       "phase 17b: the syncer's thread after the fault")
            time.sleep(0.5)
    except BaseException:
        keep = False
        raise
    finally:
        fault_injection.uninstall()
        if not keep or node.failed is not None:
            try:
                node.stop()
            except Exception as exc:  # the phase checks what escaped
                log["stop_raised"] = exc
        for obj, name, fn in reversed(patches):
            setattr(obj, name, fn)
        if undo_aead is not None:
            undo_aead()
    return node, wall, log


def p2p_bytes(node):
    """Bytes by channel the node received and sent (``P2PMetrics``)."""
    m = node.p2p_metrics
    out = {}
    for cid in (0x00, 0x20, 0x21, 0x22, 0x23, 0x30, 0x38, 0x40):
        rx = m.message_receive_bytes_total.value(chID=str(cid))
        tx = m.message_send_bytes_total.value(chID=str(cid))
        if rx or tx:
            out[f"{cid:#04x}"] = {"received": int(rx), "sent": int(tx)}
    return out


def host_costs_one_thread(store):
    """What p2p adds per block, timed on one thread of the card's host
    with no other thread busy: the serving side's ``load_block`` from its
    store and proto encode, the node's proto decode, and the AEAD sealing
    and opening the frames of one block response (the block of median
    size). Medians over the chain; the AEAD over 5 passes."""
    import struct

    from tendermint_tpu_torch.blocksync.reactor import TAG_BLOCK_RESPONSE
    from tendermint_tpu_torch.crypto.chacha20poly1305 import ChaCha20Poly1305
    from tendermint_tpu_torch.p2p import secret_connection as sc
    from tendermint_tpu_torch.types.block import Block

    load, enc, dec, raws = [], [], [], []
    for h in range(1, NODE_SYNC_TO + 1):
        t0 = time.perf_counter()
        block = store.load_block(h)
        t1 = time.perf_counter()
        raw = block.to_proto_bytes()
        t2 = time.perf_counter()
        Block.from_proto_bytes(raw)
        t3 = time.perf_counter()
        load.append(t1 - t0)
        enc.append(t2 - t1)
        dec.append(t3 - t2)
        raws.append(raw)
    raw = sorted(raws, key=len)[len(raws) // 2]
    msg = bytes([TAG_BLOCK_RESPONSE]) + raw
    frames = sc._frames(struct.pack("<I", len(msg)) + msg)
    nonces = [sc._nonce(i) for i in range(len(frames))]
    aead = ChaCha20Poly1305(bytes(range(32)))
    seal, open_ = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        sealed = aead.seal_many(nonces, frames)
        t1 = time.perf_counter()
        opened = aead.open_many(nonces, sealed)
        t2 = time.perf_counter()
        check(opened == frames, "phase 17b: the AEAD did not open what it sealed")
        seal.append(t1 - t0)
        open_.append(t2 - t1)
    return {"block_bytes_median": len(raw), "load_block_ms_median": statistics.median(load) * 1e3,
            "encode_ms_median": statistics.median(enc) * 1e3, "decode_ms_median": statistics.median(dec) * 1e3,
            "frames_a_block": len(frames), "seal_ms_a_frame": statistics.median(seal) * 1e3 / len(frames),
            "open_ms_a_frame": statistics.median(open_) * 1e3 / len(frames)}


def phase_node_p2p_sync(source, dev, inproc_blocks_per_s, peers, peers_start_s, kept):
    """17b, node-p2p-sync-64x500 (BASELINE config 4 as a node joins): phase
    14's source chain served by the P2P_SYNC_PEERS ``peers``, each in a
    process of its own over its own copy of the source's block store
    (:func:`serving_peers`, which started them in ``peers_start_s``);
    fresh ``Node``s sync NODE_SYNC_TO blocks from them over encrypted TCP and switch to consensus. One cold run (the
    host's table builds and the store's uploads), P2P_SYNC_REPS timed runs
    (the verdict cache emptied before each; no table build), a run with a
    third peer that serves one block with a corrupted signature (banned,
    its block never saved), the health machine checked, and a run with a
    permanent device fault installed after the first window (the
    ``DeviceFault`` ends in ``Node.failed`` and ``Node.stop()`` raises
    it; the health machine shows that one permanent failure and no
    fallback, and is reset after, as phase 6 does). Then the per-block
    host costs on one thread (:func:`host_costs_one_thread`). The last
    timed run's node and the corrupting-peer run's stay up, serving
    their RPC, as phase 18a's primary and witness: they are appended to
    ``kept``, which the caller stops. The tables and the store are left
    to that phase. Returns the phase's launch counts."""
    from tendermint_tpu_torch.ops import device_policy, precompute, resident
    from tendermint_tpu_torch.ops.fault_injection import DeviceFault

    _, src_exec = source[:2]

    def store_delta(before):
        after = resident.stats()
        return {k: after[k] - before[k] for k in ("uploads", "h2d_bytes", "invalidations")}

    phase_store = resident.stats()
    t = time.perf_counter()
    bad = PeerProcess(src_exec.block_store, "corrupting", corrupt=True)
    bad_last = None
    try:
        bad.ready()
        bad_start_s = time.perf_counter() - t
        before, builds, store = launches(), precompute.tables.builds, resident.stats()
        node, cold_s, cold_log = p2p_follow(source, peers, dev)
        check(node.failed is None and cold_log["stop_raised"] is None and node.caught_up
              and node.syncer.state.last_block_height == NODE_SYNC_TO,
              f"phase 17b cold run: failed {node.failed!r}, height {node.height}")
        check_converged(source, node.block_exec, node.syncer.state, "phase 17b cold run")
        cold = {"s": cold_s, "launches": delta(before), "handshakes_ms": cold_log["handshakes_ms"],
                "table_builds": precompute.tables.builds - builds, "store": store_delta(store)}
        peers_aead(peers)  # the cold run's
        before, builds, store = launches(), precompute.tables.builds, resident.stats()
        walls, clocks, logs, served = [], [], [], []
        for rep in range(P2P_SYNC_REPS):
            precompute.results.clear()
            clock = StageClock()
            last = rep == P2P_SYNC_REPS - 1
            node, wall, log = p2p_follow(source, peers, dev, clock, keep=last)
            if last and node.failed is None:
                kept.append(node)
            served.append(peers_aead(peers))
            check(node.failed is None and log["stop_raised"] is None and node.caught_up
                  and node.syncer.state.last_block_height == NODE_SYNC_TO,
                  f"phase 17b timed run: failed {node.failed!r}, stop raised {log['stop_raised']!r}")
            check_converged(source, node.block_exec, node.syncer.state, "phase 17b timed run")
            walls.append(wall)
            clocks.append(clock)
            logs.append(log)
        timed_launches = delta(before)
        timed_store = store_delta(store)
        check(timed_launches.get("verify_resident", 0) > 0, f"phase 17b launched no K3: {timed_launches}")
        check(precompute.tables.builds == builds, "phase 17b: table builds after the cold run")

        # a third peer corrupts a signature of one block's LastCommit
        precompute.results.clear()
        node, corrupt_s, corrupt_log = p2p_follow(source, [*peers, bad], dev, keep=True)
        if node.failed is None:
            kept.append(node)
        banned = sorted(node.syncer.pool._banned)
        bad_last = bad.stop()
        corrupted = bad_last and bad_last["corrupted"]
        check(node.failed is None and node.caught_up and corrupted is not None and bad.node_id in banned,
              f"phase 17b corrupting peer: corrupted {corrupted}, banned {banned}, failed {node.failed!r}")
        saved = node.block_store.load_block(corrupted).last_commit.signatures[0].signature
        check(saved == src_exec.block_store.load_block(corrupted).last_commit.signatures[0].signature,
              f"phase 17b corrupting peer: the corrupted block {corrupted} was saved")
        check_converged(source, node.block_exec, node.syncer.state, "phase 17b corrupting-peer run")
        # every run so far without a fallback or a health transition
        check_healthy("phase 17b before its fault run")

        # a permanent device fault after the first window
        precompute.results.clear()
        node, fault_s, fault_log = p2p_follow(source, peers, dev, fault=True)
        check(isinstance(node.failed, DeviceFault) and node.failed.permanent
              and fault_log["stop_raised"] is node.failed and fault_log["fault_at"] is not None
              and node.height == fault_log["fault_at"] and not node.caught_up,
              f"phase 17b fault: failed {node.failed!r}, stop raised {fault_log['stop_raised']!r}, "
              f"fault at {fault_log['fault_at']}, height {node.height}")
        fault_snapshot = device_policy.shared.snapshot()
        check(fault_snapshot["state"] == "disabled" and fault_snapshot["transitions"] == [("healthy", "disabled")]
              and fault_snapshot["fallback_batches"] == 0 and not any(fault_snapshot["fallback_lanes"].values())
              and fault_snapshot["failures"]["transient"] == 0 and fault_snapshot["failures"]["permanent"] >= 1,
              f"phase 17b fault: the health machine shows more than the permanent failure: {fault_snapshot}")
        device_policy.shared.reset()
    finally:
        if bad_last is None:
            bad.stop()
    host_costs = host_costs_one_thread(src_exec.block_store)
    i = walls.index(statistics.median(walls))
    keys = ("fetch_decode", "pipeline", "validate_block", "verify_commit", "apply_block",
            "finalize_block", "index", "save_block", "save_state")
    split = {k + "_ms": clocks[i].seconds.get(k, 0.0) * 1e3 for k in keys}
    node_aead, peer_aead = logs[i]["aead"], served[i]
    blocks_per_s = NODE_SYNC_TO / statistics.median(walls)
    CLUSTER_FACTS["p2p_blocks_per_s"] = blocks_per_s
    counts = launches()
    emit({"phase": "node_p2p_sync", "rpc_transport": sorted({n.rpc_server.transport for n in kept}),
          "blocks": NODE_SYNC_TO, "validators": NODE_VALIDATORS,
          "serving_peers": P2P_SYNC_PEERS, "peers_in_processes_of_their_own": True,
          "transport": "tcp, SecretConnection + MConnection, 5,120,000 B/s", "peers_start_s": peers_start_s,
          "corrupting_peer_start_s": bad_start_s, "tx_index_sinks": ["kv"],
          "cold": cold, "seconds": walls, "blocks_per_s_median": blocks_per_s,
          "phase14_inprocess_blocks_per_s": inproc_blocks_per_s,
          "inprocess_over_p2p": inproc_blocks_per_s / blocks_per_s,
          "handshakes_ms_of_median_run": logs[i]["handshakes_ms"],
          "split_ms_of_median_run": split,
          "aead_of_median_run": {
              "node": {"seal_ms": node_aead["seal_s"] * 1e3, "open_ms": node_aead["open_s"] * 1e3,
                       "sealed_frames": node_aead["sealed_frames"], "opened_frames": node_aead["opened_frames"]},
              "serving_peers": {"seal_ms": peer_aead["seal_s"] * 1e3, "open_ms": peer_aead["open_s"] * 1e3,
                                "sealed_frames": peer_aead["sealed_frames"],
                                "opened_frames": peer_aead["opened_frames"]}},
          "host_costs_one_thread": host_costs,
          "verify_commit_cache_of_median_run": clocks[i].cache,
          "bytes_by_channel_of_median_run": logs[i]["bytes"],
          "launches_timed_runs": timed_launches, "store_timed_runs": timed_store,
          "corrupting_peer": {"corrupted_height": corrupted, "banned": banned, "s": corrupt_s},
          "device_fault": {"after_height": fault_log["fault_at"], "failed": repr(node.failed), "s": fault_s,
                           "health_before_reset": {k: fault_snapshot[k] for k in ("state", "transitions",
                                                                                  "failures")}},
          "launches": counts, "store_phase": store_delta(phase_store)})
    return counts


class WSClient:
    """A websocket client for phase 18b (RFC 6455: the upgrade at
    ``/websocket``, masked text frames out, the server's frames in)."""

    def __init__(self, host, port, timeout=30.0):
        import base64
        import socket

        self.sock = socket.create_connection((host, port), timeout=timeout)
        key = base64.b64encode(os.urandom(16)).decode()
        self.sock.sendall((f"GET /websocket HTTP/1.1\r\nHost: {host}:{port}\r\nUpgrade: websocket\r\n"
                           f"Connection: Upgrade\r\nSec-WebSocket-Key: {key}\r\n"
                           "Sec-WebSocket-Version: 13\r\n\r\n").encode())
        head = b""
        while b"\r\n\r\n" not in head:
            chunk = self.sock.recv(4096)
            check(bool(chunk), "phase 18b: the websocket handshake")
            head += chunk
        head, self._buf = head.split(b"\r\n\r\n", 1)
        check(head.startswith(b"HTTP/1.1 101"), f"phase 18b: the websocket upgrade was refused: {head[:80]!r}")

    def _read(self, n):
        while len(self._buf) < n:
            chunk = self.sock.recv(65536)
            if not chunk:
                raise ConnectionError("websocket closed")
            self._buf += chunk
        out, self._buf = self._buf[:n], self._buf[n:]
        return out

    def send(self, doc):
        import struct

        payload, mask = json.dumps(doc).encode(), os.urandom(4)
        n = len(payload)
        head = bytes([0x81]) + (bytes([0x80 | n]) if n < 126 else bytes([0x80 | 126]) + struct.pack(">H", n))
        self.sock.sendall(head + mask + bytes(b ^ mask[i % 4] for i, b in enumerate(payload)))

    def recv(self):
        """The next text frame as JSON; None when the server closes."""
        import struct

        while True:
            hdr = self._read(2)
            opcode, n = hdr[0] & 0x0F, hdr[1] & 0x7F
            if n == 126:
                (n,) = struct.unpack(">H", self._read(2))
            elif n == 127:
                (n,) = struct.unpack(">Q", self._read(8))
            payload = self._read(n)
            if opcode == 0x1:
                return json.loads(payload)
            if opcode == 0x8:
                return None

    def close(self):
        try:
            self.sock.close()
        except OSError:
            pass


def phase_rpc_cluster(validators, full, submit_ms):
    """18b, rpc-cluster-4: phase 17a's four validators and full node while
    they are up, each serving its RPC. RPC_CLUSTER_THREADS client threads
    send ``broadcast_tx_commit`` over HTTP, one validator each, at
    CLUSTER_TX_PER_S together, for RPC_CLUSTER_HEIGHTS more heights; every
    answer must carry the height its tx was committed at. A websocket
    client subscribed to NewBlock on the full node must see every height
    from its subscription on once, in order; ``tx_search("tx.height=h")``
    on every node must find each block's txs once, and ``tx?hash=`` with
    ``prove=true`` every tx of this phase, with a proof that checks
    against its block's DataHash. No kernel runs: four-lane commits stay
    on the host tier. ``submit_ms`` is 17a's submit-to-committed figures,
    printed beside this phase's. Returns the phase's launch counts."""
    from tendermint_tpu_torch.crypto.merkle import Proof
    from tendermint_tpu_torch.rpc import encoding as enc
    from tendermint_tpu_torch.rpc.client import HTTPClient
    from tendermint_tpu_torch.types.block import tx_hash

    nodes = [*validators, full]
    v0 = validators[0]
    before = ingest_counters()
    t_phase = time.perf_counter()
    ws = WSClient(*full.rpc_server.address)
    pushed, ws_errors = [], []
    try:
        h_before = full.height
        ws.send({"jsonrpc": "2.0", "id": 1, "method": "subscribe", "params": {"query": "tm.event = 'NewBlock'"}})
        ack = ws.recv()
        h_after = full.height
        check(ack == {"jsonrpc": "2.0", "id": 1, "result": {}}, f"phase 18b: the subscription's answer {ack}")

        def read_pushes():
            try:
                while True:
                    msg = ws.recv()
                    if msg is None:
                        return
                    pushed.append(int(msg["result"]["data"]["height"]))
            except (OSError, ConnectionError, ValueError, KeyError) as exc:
                ws_errors.append(repr(exc))

        reader = threading.Thread(target=read_pushes, daemon=True)
        reader.start()
        last = v0.height + RPC_CLUSTER_HEIGHTS
        stop, answers, errors = threading.Event(), [], []

        def client(i):
            rng = np.random.default_rng(SEED + 18 + i)
            rpc = HTTPClient(validators[i].rpc_server.url, timeout=CLUSTER_WAIT_S)
            period = RPC_CLUSTER_THREADS / CLUSTER_TX_PER_S
            next_t, k = time.perf_counter() + i * period / RPC_CLUSTER_THREADS, 0
            while not stop.wait(max(0.0, next_t - time.perf_counter())):
                tx = b"rpc-%d-%04d=%s" % (i, k, rng.bytes(8).hex().encode())
                t = time.perf_counter()
                try:
                    res = rpc.broadcast_tx_commit(tx, timeout=CLUSTER_WAIT_S)
                    answers.append((tx, res, time.perf_counter() - t, i))
                except Exception as exc:  # the phase checks what escaped
                    errors.append(repr(exc))
                k += 1
                next_t = max(next_t + period, time.perf_counter())

        threads = [threading.Thread(target=client, args=(i,)) for i in range(RPC_CLUSTER_THREADS)]
        for t in threads:
            t.start()
        try:
            wait_until(lambda: v0.height >= last, CLUSTER_WAIT_S, "phase 18b: the last height")
        finally:
            stop.set()
            for t in threads:
                t.join(CLUSTER_WAIT_S)
        end = max(n.height for n in nodes)
        wait_until(lambda: min(n.height for n in nodes) >= end and pushed and pushed[-1] >= end, CLUSTER_WAIT_S,
                   lambda: f"phase 18b: the nodes at {[n.height for n in nodes]}, pushes to {pushed[-1:]}")
    finally:
        ws.close()
    load_s = time.perf_counter() - t_phase
    check(not errors and not ws_errors and answers, f"phase 18b: errors {errors[:3]} {ws_errors[:3]}")
    for tx, res, _, i in answers:
        h = int(res.get("height", 0))
        check(res["check_tx"]["code"] == 0 and res.get("tx_result") is not None and h > 0
              and bytes(tx) in v0.block_store.load_block(h).data.txs,
              f"phase 18b: broadcast_tx_commit of {tx!r} at node {i} answered {res}")
    first = pushed[0]
    check(h_before < first <= h_after + 1 and pushed == list(range(first, first + len(pushed))),
          f"phase 18b: the websocket saw {pushed} (subscribed between heights {h_before} and {h_after})")
    # every node's index: each block's txs once, and this phase's txs with proofs
    t_check = time.perf_counter()
    searches = proofs = 0
    height_of = {bytes(tx): int(res["height"]) for tx, res, _, _ in answers}
    for node in nodes:
        rpc = HTTPClient(node.rpc_server.url)
        for h in range(1, end + 1):
            want = sorted(enc.hex_bytes(tx_hash(tx)) for tx in v0.block_store.load_block(h).data.txs)
            found = rpc.tx_search(f"tx.height={h}", per_page=100)
            got = sorted(t["hash"] for t in found["txs"])
            check(got == want and int(found["total_count"]) == len(want),
                  f"phase 18b: tx_search at height {h} on {node.config.moniker}: {len(got)} of {len(want)}")
            searches += 1
        for tx, h in height_of.items():
            out = rpc.call("tx", {"hash": "0x" + tx_hash(tx).hex(), "prove": True})
            p = out["proof"]["proof"]
            proof = Proof(total=int(p["total"]), index=int(p["index"]), leaf_hash=enc.unb64(p["leaf_hash"]),
                          aunts=[enc.unb64(a) for a in p["aunts"]])
            root = bytes.fromhex(out["proof"]["root_hash"])
            check(int(out["height"]) == h and enc.unb64(out["tx"]) == tx and proof.verify(root, tx_hash(tx))
                  and root == node.block_store.load_block(h).header.data_hash,
                  f"phase 18b: tx {tx!r} on {node.config.moniker}: its proof does not check")
            proofs += 1
    counts = ingest_delta(before)
    lat = [a[2] for a in answers]
    emit({"phase": "rpc_cluster", "rpc_transport": sorted({n.rpc_server.transport for n in nodes}),
          "nodes": len(nodes), "client_threads": RPC_CLUSTER_THREADS,
          "tx_per_s_target": CLUSTER_TX_PER_S, "heights": [end - RPC_CLUSTER_HEIGHTS, end],
          "txs_committed": len(answers), "tx_per_s": len(answers) / load_s,
          "broadcast_tx_commit_ms": {"p50": percentile(lat, 0.5) * 1e3, "p99": percentile(lat, 0.99) * 1e3,
                                     "max": max(lat) * 1e3},
          "phase17a_submit_to_committed_ms": submit_ms,
          "websocket_pushes": len(pushed), "websocket_heights": [pushed[0], pushed[-1]],
          "tx_search_requests": searches, "proofs_checked": proofs, "check_s": time.perf_counter() - t_check,
          "wall_s": time.perf_counter() - t_phase, "launches": counts["launches"],
          "host_tier_lanes": counts["tiers"]["host"], "device_tier_lanes": counts["tiers"]["device"]})
    return counts["launches"]


def serving_peers(store):
    """Phase 14's source chain served by P2P_SYNC_PEERS
    :class:`PeerProcess`es, each over its own copy of ``store``, ready.
    Returns them and the seconds they took to start."""
    t = time.perf_counter()
    peers = [PeerProcess(store, f"peer{i}") for i in range(P2P_SYNC_PEERS)]
    try:
        for p in peers:
            p.ready()
    except BaseException:
        for p in peers:
            p.stop()
        raise
    return peers, time.perf_counter() - t


class ForkingRPC:
    """A wrapper over a witness's RPC that serves the witness's answers,
    except ``/commit`` at NODE_FORK_HEIGHT: phase 14's forged block there
    (another AppHash) with its commit, signed by the height's set."""

    def __init__(self, witness_url, fork):
        from tendermint_tpu_torch.rpc.client import HTTPClient
        from tendermint_tpu_torch.rpc.server import RPCServer
        from tendermint_tpu_torch.types.block import Block

        self.forged = Block.from_proto_bytes(fork[NODE_FORK_HEIGHT])
        self.forged_commit = Block.from_proto_bytes(fork[NODE_FORK_HEIGHT + 1]).last_commit
        self.witness = HTTPClient(witness_url)
        self.server = RPCServer({"commit": self.commit, "validators": self.validators})
        self.server.start()

    def commit(self, height=None):
        from tendermint_tpu_torch.rpc import encoding as enc

        if height is not None and int(height) == NODE_FORK_HEIGHT:
            return {"signed_header": {"header": enc.header_json(self.forged.header),
                                      "commit": enc.commit_json(self.forged_commit)}, "canonical": True}
        return self.witness.call("commit", {} if height is None else {"height": height})

    def validators(self, height=None, page=1, per_page=30):
        return self.witness.call("validators", {"height": height, "page": page, "per_page": per_page})


def stop_nodes(nodes):
    """Stop each of ``nodes``, emptying the list; what each ``stop()``
    raised (None where it raised nothing)."""
    out = []
    while nodes:
        try:
            nodes.pop(0).stop()
            out.append(None)
        except Exception as exc:  # the phase checks what escaped
            out.append(repr(exc))
    return out


def light_proxy(primary_url, witness_urls, anchor, dev, sequential=False):
    """A ``LightProxy`` on 127.0.0.1 over a ``LightClient`` with
    ``HTTPProvider``s, trusting height 1 at ``anchor``, on ``dev``;
    started."""
    from tendermint_tpu_torch.light.client import LightClient, TrustOptions
    from tendermint_tpu_torch.light.provider import HTTPProvider
    from tendermint_tpu_torch.light.proxy import LightProxy

    client = LightClient(CHAIN_ID, TrustOptions(RPC_TRUSTING_PERIOD_S, 1, anchor), HTTPProvider(CHAIN_ID, primary_url),
                         [HTTPProvider(CHAIN_ID, u) for u in witness_urls], sequential=sequential, device=dev)
    proxy = LightProxy(client, primary_url)
    proxy.start()
    return proxy


def proxy_walk(proxy, primary, clock, top, what, tiered=True):
    """Ask ``proxy`` over HTTP for ``/commit?height=h``, h = 2 ... ``top``
    in order, as a light client following the chain does; each answer
    must be the primary's header and commit, and must have been verified
    on the card inside its request: at least one K3 launch, lanes
    verified (verdict-cache misses) and none answered from the cache, no
    host-tier lane and, where the proxy's verification goes through the
    shared scheduler's tiers (``tiered``; the sequential verifier calls
    the engine directly), device-tier lanes. Returns the per-request
    seconds and each request's stage seconds (``clock``'s deltas)."""
    from tendermint_tpu_torch.rpc import encoding as enc
    from tendermint_tpu_torch.rpc.client import HTTPClient

    rpc = HTTPClient(proxy.url, timeout=P2P_SYNC_WAIT_S)
    walls, splits = [], []
    for h in range(2, top + 1):
        before, cache = dict(clock.seconds), ingest_counters()
        t = time.perf_counter()
        out = rpc.commit(h)
        walls.append(time.perf_counter() - t)
        splits.append({k: v - before.get(k, 0.0) for k, v in clock.seconds.items()})
        got = ingest_delta(cache)
        check(got["launches"].get("verify_resident", 0) >= 1 and got["cache"]["misses"] > 0
              and got["cache"]["hits"] == 0 and got["tiers"]["host"] == got["tiers"]["host_cached"] == 0
              and (got["tiers"]["device"] > 0 or not tiered),
              f"{what}: height {h} was not verified on the card in its request: launches {got['launches']}, "
              f"tiers {got['tiers']}, cache {got['cache']}")
        meta = primary.block_store.load_block_meta(h)
        commit = primary.block_store.load_block_commit(h) or primary.block_store.load_seen_commit()
        check(out["signed_header"]["header"] == enc.header_json(meta.header)
              and out["signed_header"]["commit"] == enc.commit_json(commit)
              and out["signed_header"]["commit"]["block_id"]["hash"] == enc.hex_bytes(meta.block_id.hash),
              f"{what}: the proxy's commit at height {h} is not the primary's")
    return walls, splits


def timed_proxy(proxy, clock):
    """Time the proxy client's stages into ``clock``: each provider's
    light block (the HTTP requests of ``commit`` and the ``validators``
    pages with their JSON, and the decode), the verification and the
    witness check."""
    client = proxy.client
    for name, p in [("primary", client.primary)] + [(f"witness", w) for w in client.witnesses]:
        p.client.call = clock.wrap(f"{name}_http", p.client.call)
        p.light_block = clock.wrap(f"{name}_light_block", p.light_block)
    client._verify_skipping_batched = clock.wrap("verify", client._verify_skipping_batched)
    client._verify_sequential = clock.wrap("verify", client._verify_sequential)
    client._detect_divergence = clock.wrap("witness_check", client._detect_divergence)


def split_summary(walls, splits):
    """The stage split of the median request and the sums over the walk
    (ms): the primary's fetch as HTTP and decode, the verification, the
    witness check (the witness's fetch inside it), the rest (the proxy's
    serving, JSON and the client's HTTP)."""

    def shape(s, wall):
        out = {"request": wall * 1e3,
               "primary_http": s.get("primary_http", 0.0) * 1e3,
               "primary_decode": (s.get("primary_light_block", 0.0) - s.get("primary_http", 0.0)) * 1e3,
               "verify": s.get("verify", 0.0) * 1e3,
               "witness_check": s.get("witness_check", 0.0) * 1e3,
               "witness_http": s.get("witness_http", 0.0) * 1e3}
        out["rest"] = out["request"] - out["primary_http"] - out["primary_decode"] - out["verify"] \
            - out["witness_check"]
        return out

    i = walls.index(sorted(walls)[len(walls) // 2])
    total = {}
    for s in splits:
        for k, v in s.items():
            total[k] = total.get(k, 0.0) + v
    return {"median_request_ms": shape(splits[i], walls[i]), "walk_total_ms": shape(total, sum(walls))}


def proxy_cli(command, primary_url, witness_url, anchor, dev):
    """``python -m tendermint_tpu_torch light|lightd`` in a process of its
    own, on ``dev``'s type (the commands' default is the card), over the
    two nodes: the process, a queue of its output lines and its start
    time."""
    flag = "--laddr" if command == "light" else "--listen"
    root = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.Popen(
        [sys.executable, "-m", "tendermint_tpu_torch", command, primary_url, "--chain-id", CHAIN_ID,
         "--trust-height", "1", "--trust-hash", anchor.hex(), "--trust-period", str(RPC_TRUSTING_PERIOD_S),
         "--witness", witness_url, flag, "127.0.0.1:0"] + ([] if dev.type == "cuda" else ["--device", dev.type]),
        cwd=root, env=dict(os.environ, PYTHONPATH=root), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    lines = queue.Queue()
    threading.Thread(target=lambda: [lines.put(ln) for ln in proc.stdout], daemon=True).start()
    return proc, lines, time.perf_counter()


def cli_answer(command, proc, lines, t_start, path):
    """Wait for the command's banner, then GET ``path`` from it; the
    answer and the seconds from the process's start."""
    import urllib.request

    try:
        banner = lines.get(timeout=RPC_CLI_WAIT_S)
    except queue.Empty:
        banner = ""
    check(" on http://" in banner, f"phase 18a: `{command}` printed no banner: {banner!r} "
          f"(exit {proc.poll()}, stderr {proc.stderr.read()[-2000:] if proc.poll() is not None else ''})")
    url = banner.split(" on ", 1)[1].split()[0]
    with urllib.request.urlopen(f"{url}/{path}", timeout=RPC_CLI_WAIT_S) as resp:
        doc = json.load(resp)
    check("result" in doc, f"phase 18a: `{command}` answered {path} with {doc.get('error')}")
    return doc["result"], time.perf_counter() - t_start


def phase_rpc_light(source, nodes, dev):
    """18a, rpc-light-proxy-64x500 (BASELINE config 4 as a light client
    follows a full node): ``nodes``, two fresh ``Node``s that synced phase
    14's chain in phase 17b and stay up with their RPC on, are the
    primary and a witness; this phase stops them and empties the list.
    A ``LightProxy`` in this process over ``HTTPProvider``s, trusting
    height 1 (its hash from the primary's ``/commit``), answers
    ``/commit?height=h`` for h = 2 ... NODE_SYNC_TO in order over HTTP,
    each verified on the card inside its request (:func:`proxy_walk`),
    then ``/validators`` at the top and ``/abci_query`` of a key the top
    block wrote, each checked against the primary's stores; the same walk
    with ``sequential`` up to RPC_SEQUENTIAL_TO. Faults: a wrapper over
    the witness's RPC serves the forged block at NODE_FORK_HEIGHT (the
    height is not answered, the client's evidence reaches the primary's
    pool, which verifies it); with the health machine checked first, a
    device fault reaches the client as an RPC error that names it. The
    ``light`` and ``lightd`` commands run in processes of their own,
    started after the timed walks (their start, about 10 s, overlaps the
    faults) and asked last. Kernel launches are counted from the walk on;
    the children's are their own. Returns them."""
    from tendermint_tpu_torch.abci import types as abci
    from tendermint_tpu_torch.ops import cuda_hash, cuda_verify, device_policy, fault_injection, precompute, resident
    from tendermint_tpu_torch.rpc import encoding as enc
    from tendermint_tpu_torch.rpc.client import HTTPClient, RPCClientError
    from tendermint_tpu_torch.rpc.server import INTERNAL_ERROR, INVALID_PARAMS
    from tendermint_tpu_torch.types.evidence import LightClientAttackEvidence
    from tendermint_tpu_torch.types.genesis import GenesisDoc

    t_phase = time.perf_counter()
    _, src_exec, _, changed, fork, _ = source
    proxies, procs, cli = [], [], {}
    forking = None
    try:
        check(len(nodes) == 2 and all(n.caught_up and n.failed is None and n.height == NODE_SYNC_TO for n in nodes),
              f"phase 18a: the nodes at {[n.height for n in nodes]}, failed {[n.failed for n in nodes]}")
        primary, witness = nodes
        p_url, w_url = primary.rpc_server.url, witness.rpc_server.url
        node_transports = sorted({n.rpc_server.transport for n in nodes})
        anchor = bytes.fromhex(HTTPClient(p_url).commit(1)["signed_header"]["commit"]["block_id"]["hash"])
        check(anchor == src_exec.block_store.load_block_meta(1).block_id.hash, "phase 18a: the anchor")

        # the walk, with the counts and the verdict cache from zero
        precompute.results.clear()
        cuda_verify.reset_launches()
        cuda_hash.reset_launches()
        before, lanes, store, builds = ingest_counters(), kernel_lanes(), resident.stats(), precompute.tables.builds
        clock = StageClock()
        proxy = light_proxy(p_url, [w_url], anchor, dev)
        proxies.append(proxy)
        timed_proxy(proxy, clock)
        t = time.perf_counter()
        walls, splits = proxy_walk(proxy, primary, clock, NODE_SYNC_TO, "phase 18a")
        walk_s = time.perf_counter() - t
        walk = ingest_delta(before)
        walk_lanes, walk_store = lanes_since(lanes), resident.stats()
        walk_store = {k: walk_store[k] - store[k] for k in ("uploads", "h2d_bytes", "invalidations")}
        walk_builds = precompute.tables.builds - builds
        check(walk["tiers"]["host"] == walk["tiers"]["host_cached"] == 0 and walk_lanes["hits"] == 0
              and walk["launches"].get("verify_resident", 0) >= len(walls),
              f"phase 18a: the walk's tiers {walk['tiers']}, lanes {walk_lanes}, launches {walk['launches']}")
        rpc = HTTPClient(proxy.url)
        vals = rpc.call("validators", {"height": NODE_SYNC_TO})
        want = primary.state_store.load_validators(NODE_SYNC_TO)
        check(vals["validators"] == [enc.validator_json(v) for v in want.validators]
              and vals["total"] == str(NODE_VALIDATORS), "phase 18a: the proxy's validators at the top")
        genesis = GenesisDoc.from_json(source[0])
        power = {v.address: v.voting_power for v in want.validators}
        check(all(power[genesis.validators[i].pub_key.address()] == p for i, p in changed.items())
              and want.hash() == primary.block_store.load_block_meta(NODE_SYNC_TO).header.validators_hash,
              "phase 18a: the set at the top does not carry the change at height 33")
        key, value = primary.block_store.load_block(NODE_SYNC_TO).data.txs[-1].split(b"=", 1)
        out = rpc.call("abci_query", {"data": "0x" + key.hex()})["response"]
        check(enc.unb64(out["value"]) == value == primary.app.query(abci.RequestQuery(data=key)).value
              and out["verified_height"] == str(NODE_SYNC_TO), f"phase 18a: abci_query of {key!r}: {out}")

        # the same walk, sequential, over its first heights
        precompute.results.clear()
        before_seq = ingest_counters()
        seq_clock = StageClock()
        seq = light_proxy(p_url, [w_url], anchor, dev, sequential=True)
        proxies.append(seq)
        timed_proxy(seq, seq_clock)
        t = time.perf_counter()
        seq_walls, seq_splits = proxy_walk(seq, primary, seq_clock, RPC_SEQUENTIAL_TO, "phase 18a sequential",
                                          tiered=False)
        seq_s = time.perf_counter() - t
        seq_delta = ingest_delta(before_seq)
        check(seq_delta["launches"].get("verify_resident", 0) >= len(seq_walls),
              f"phase 18a sequential: launches {seq_delta['launches']}")
        # the commands start now, after the timed walks, so their start
        # overlaps the fault checks below and not a walk
        for command in ("light", "lightd"):
            procs.append((command, *proxy_cli(command, p_url, w_url, anchor, dev)))

        # a witness with a conflicting header
        forking = ForkingRPC(w_url, fork)
        attack = light_proxy(p_url, [forking.server.url], anchor, dev)
        proxies.append(attack)
        pending_before = len(primary.evidence_pool.pending_evidence(1 << 30)[0])
        before_attack = launches()
        t = time.perf_counter()
        try:
            HTTPClient(attack.url).commit(NODE_FORK_HEIGHT)
            attack_error = None
        except RPCClientError as exc:
            attack_error = exc
        attack_s = time.perf_counter() - t
        pending = primary.evidence_pool.pending_evidence(1 << 30)[0]
        check(attack_error is not None and attack_error.code == INVALID_PARAMS
              and "conflicting headers detected" in attack_error.message
              and attack.client.trusted_light_block(NODE_FORK_HEIGHT) is None,
              f"phase 18a: the conflicting height was answered or mis-refused: {attack_error!r}")
        evs = [e for e in pending if isinstance(e, LightClientAttackEvidence)]
        check(len(pending) == pending_before + 1 and len(evs) == 1
              and evs[0].conflicting_block.hash() == forking.forged.hash(),
              f"phase 18a: the primary's pool holds {len(pending)} (before {pending_before})")

        # a device fault in the proxy's verification, on a healthy machine
        check_healthy("phase 18a before its fault")
        precompute.results.clear()
        faulted = light_proxy(p_url, [w_url], anchor, dev)
        proxies.append(faulted)
        fault_injection.install(fault_injection.FaultPlan(site="ed25519", fail_from=1, fail_count=1 << 30))
        try:
            HTTPClient(faulted.url).commit(NODE_SYNC_TO)
            fault_error = None
        except RPCClientError as exc:
            fault_error = exc
        finally:
            fault_injection.uninstall()
        fault_health = device_policy.shared.snapshot()
        check(fault_error is not None and fault_error.code == INTERNAL_ERROR and "DeviceFault" in fault_error.data
              and faulted.client.trusted_light_block(NODE_SYNC_TO) is None
              and fault_health["fallback_batches"] == 0 and fault_health["failures"]["transient"] >= 1,
              f"phase 18a: the device fault reached the client as {fault_error!r}, health {fault_health}")
        device_policy.shared.reset()
        recovered = HTTPClient(faulted.url).commit(NODE_SYNC_TO)
        check(recovered["signed_header"]["header"]["height"] == str(NODE_SYNC_TO),
              "phase 18a: the proxy after the fault")
        counts = launches()

        # the light and lightd commands, each in a process of its own
        header = enc.header_json(primary.block_store.load_block_meta(NODE_SYNC_TO).header)
        for command, proc, lines, t_start in procs:
            path = f"commit?height={NODE_SYNC_TO}" if command == "light" else f"light_header?height={NODE_SYNC_TO}"
            result, s = cli_answer(command, proc, lines, t_start, path)
            got = result["signed_header"]["header"] if command == "light" else result["header"]
            check(got == header, f"phase 18a: `{command}` answered another header at {NODE_SYNC_TO}")
            cli[command] = {"start_to_answer_s": s}
    finally:
        for command, proc, _, _ in procs:
            proc.send_signal(signal.SIGTERM)
        for command, proc, _, _ in procs:
            try:
                rc = proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                rc = proc.wait()
            cli.setdefault(command, {})["exit"] = rc
        for p in proxies:
            p.stop()
        if forking is not None:
            forking.server.stop()
        stopped = stop_nodes(nodes)
        precompute.reset()
    check(stopped == [None, None] and all(cli[c]["exit"] == 0 for c in ("light", "lightd")),
          f"phase 18a: the nodes' stop {stopped}, the commands' exits {cli}")
    k3 = walk["launches"].get("verify_resident", 0)
    emit({"phase": "rpc_light_proxy", "rpc_transport": {"nodes": node_transports,
                                                        "proxy": proxies[0].server.transport},
          "heights": [2, NODE_SYNC_TO], "validators": NODE_VALIDATORS,
          "nodes": "phase 17b's last timed run (primary) and corrupting-peer run (witness)",
          "answers": len(walls), "answers_per_s": len(walls) / walk_s,
          "request_ms": {"p50": percentile(walls, 0.5) * 1e3, "p99": percentile(walls, 0.99) * 1e3,
                         "max": max(walls) * 1e3, "first": walls[0] * 1e3},
          "split": split_summary(walls, splits),
          "verification": {"launches": walk["launches"], "k3_share_of_launches": k3 / max(1, sum(
              walk["launches"].values())), "lanes": walk_lanes, "tiers": walk["tiers"], "tier_s": walk["tier_s"],
              "flushes": walk["sched"].get("flushes"), "table_builds": walk_builds},
          "store": walk_store,
          "sequential": {"heights": [2, RPC_SEQUENTIAL_TO], "answers_per_s": len(seq_walls) / seq_s,
                         "request_ms": {"p50": percentile(seq_walls, 0.5) * 1e3,
                                        "p99": percentile(seq_walls, 0.99) * 1e3},
                         "split": split_summary(seq_walls, seq_splits), "launches": seq_delta["launches"]},
          "attack": {"height": NODE_FORK_HEIGHT, "error": attack_error.message, "s": attack_s,
                     "evidence_at_primary": len(evs), "launches": delta(before_attack)},
          "device_fault": {"error": fault_error.message, "code": fault_error.code,
                           "failures": fault_health["failures"]},
          "cli": cli, "wall_s": time.perf_counter() - t_phase, "launches": counts})
    return counts


# --- phase 19 ------------------------------------------------------------------


def write_home(src_exec, home, backend="filedb-c"):
    """Phase 14's source stores (blocks 1-65, the state after 65) written
    into file stores under ``home/data``, as a node that holds the chain
    keeps them. Returns the seconds it took."""
    from tendermint_tpu_torch.storage import open_db

    t = time.perf_counter()
    for name, store in (("state", src_exec.state_store), ("blockstore", src_exec.block_store)):
        with store._db._lock:
            items = list(store._db._data.items())
        db = open_db(backend, os.path.join(home, "data"), name)
        db.apply_batch([("set", k, v) for k, v in items])
        db.close()
    return time.perf_counter() - t


def store_sizes(home):
    data = os.path.join(home, "data")
    return {f: os.path.getsize(os.path.join(data, f)) for f in sorted(os.listdir(data)) if f.endswith(".fdb")}


class TruncatedStore:
    """A block store seen up to ``top``: a peer that holds that much."""

    def __init__(self, store, top):
        self.store, self.top = store, top

    def base(self):
        return self.store.base()

    def height(self):
        return min(self.top, self.store.height())

    def load_block(self, height):
        return self.store.load_block(height) if height <= self.top else None


def statesync_server_process(conn, home, genesis_json, name, interval):
    """A port node serving phase 14's chain in a process of its own, as a
    joining node's peers are: it reopens ``home`` (``filedb-c`` stores),
    its handshake replaying the blocks into a kvstore app that snapshots
    every ``interval`` heights, and serves over TCP on the CPU (serving
    verifies nothing). Sends its address and what it holds; on
    ``"stop"`` stops and sends what ``Node.stop()`` raised (or None)."""
    from tendermint_tpu_torch.abci.client import LocalClient
    from tendermint_tpu_torch.abci.kvstore import KVStoreApplication
    from tendermint_tpu_torch.node import Node, NodeConfig
    from tendermint_tpu_torch.types.genesis import GenesisDoc

    app = KVStoreApplication(snapshot_interval=interval)
    t = time.perf_counter()
    node = Node(NodeConfig(chain_id=CHAIN_ID, home=home, db_backend="filedb-c", wal_enabled=False, blocksync=False,
                           listen_addr="127.0.0.1:0", moniker=name),
                GenesisDoc.from_json(genesis_json), LocalClient(app), device="cpu")
    open_s = time.perf_counter() - t
    node.start()
    conn.send({"addr": f"{node.node_key.node_id}@{node.transport.listen_addr}", "open_s": open_s,
               "replayed": node.handshaker.n_blocks_replayed, "app_height": app._height,
               "engine": node._dbs[0].engine,
               "snapshots": {h: (len(c), sum(len(x) for x in c)) for h, (_, c) in app._snapshots.items()}})
    err = None
    try:
        conn.recv()
    finally:
        try:
            node.stop()
        except Exception as exc:  # sent to the phase, which checks it
            err = repr(exc)
    conn.send(err)


class ServerProcess:
    """The phase's handle on a :func:`statesync_server_process`: started
    at construction, ``ready()`` waits for its facts, ``stop()`` ends it
    (what its node's ``stop()`` raised, or None)."""

    def __init__(self, home, genesis_json, name, interval):
        ctx = multiprocessing.get_context("spawn")
        self.name = name
        self.conn, child = ctx.Pipe()
        self.proc = ctx.Process(target=statesync_server_process, args=(child, home, genesis_json, name, interval),
                                name=name, daemon=True)
        self.proc.start()
        child.close()
        self.facts = None

    def ready(self, timeout=PHASE19_WAIT_S):
        check(self.conn.poll(timeout), f"phase 19: server {self.name} did not answer")
        self.facts = self.conn.recv()
        self.addr = self.facts["addr"]

    def stop(self):
        err = "no answer"
        try:
            if self.proc.is_alive():
                self.conn.send("stop")
                if self.conn.poll(30):
                    err = self.conn.recv()
        except (OSError, EOFError):
            pass
        self.proc.join(30)
        if self.proc.is_alive():
            self.proc.terminate()
            self.proc.join(5)
        return err


def statesync_servers(source, home):
    """STATESYNC_SERVERS :class:`ServerProcess`es, each on a copy of one
    ``filedb-c`` home written from phase 14's source chain, started
    together. Returns them and the seconds it took to write the home."""
    template = os.path.join(home, "template")
    write_s = write_home(source[1], template)
    servers = []
    for i in range(STATESYNC_SERVERS):
        node_home = os.path.join(home, f"server{i}")
        shutil.copytree(template, node_home)
        servers.append(ServerProcess(node_home, source[0], f"server{i}", STATESYNC_SNAPSHOT_INTERVAL))
    return servers, write_s


def phase_statesync_join(source, servers, home, dev, blocksync_s):
    """19a: a fresh node joins phase 14's chain from a snapshot (module
    note). ``blocksync_s`` is phase 14's median time for the same 64
    heights. Returns the launch counts of the run."""
    from tendermint_tpu_torch import ops as tops
    from tendermint_tpu_torch.abci.client import LocalClient
    from tendermint_tpu_torch.abci.kvstore import KVStoreApplication
    from tendermint_tpu_torch.crypto import batch as crypto_batch
    from tendermint_tpu_torch.node import Node, NodeConfig
    from tendermint_tpu_torch.ops import cuda_hash, cuda_verify, precompute
    from tendermint_tpu_torch.statesync import StateSyncConfig
    from tendermint_tpu_torch.types.genesis import GenesisDoc

    _, src_exec, src_state = source[:3]
    snap_h = STATESYNC_SNAPSHOT_INTERVAL
    snaps = servers[0].facts["snapshots"]
    check(list(snaps) == [snap_h], f"phase 19a: the servers' snapshots {list(snaps)}")
    n_chunks, snap_bytes = snaps[snap_h]
    anchor = src_exec.block_store.load_block_meta(1).header.hash()
    cfg = StateSyncConfig(enabled=True, trust_height=1, trust_hash=anchor, trust_period=RPC_TRUSTING_PERIOD_S,
                          discovery_time=0.5, backfill_blocks=STATESYNC_BACKFILL, light_block_timeout=30.0,
                          chunk_timeout=30.0)
    app = KVStoreApplication()
    precompute.results.clear()  # a fresh node's process starts with no verdicts
    before = ingest_counters()
    t0 = time.perf_counter()
    node = Node(NodeConfig(chain_id=CHAIN_ID, home=os.path.join(home, "joiner"), db_backend="filedb-c",
                           wal_enabled=False, listen_addr="127.0.0.1:0", moniker="joiner", statesync=cfg,
                           persistent_peers=[srv.addr for srv in servers]),
                GenesisDoc.from_json(source[0]), LocalClient(app), device=dev)
    syncer = node.statesyncer
    walk, marks = {}, {}
    real_build, real_sync = syncer._build_state, syncer.sync
    # The walk's own verifications and launches, by the thread that runs
    # it: a batch of 16 lanes or more goes to verify_batch (the card), a
    # smaller one to the host, and verify_batch launches on its caller's
    # thread. The process-wide counts also hold what other threads do
    # meanwhile (the consensus reactor ingesting the servers' gossip).
    walk_lanes = {"device": 0, "host": 0}
    walk_launches = {}
    real_vb, real_host = tops.verify_batch, crypto_batch.host_verify_ed25519
    real_launch, real_run = cuda_verify._launch, cuda_hash._run

    def on_walk():
        return threading.get_ident() == walk.get("thread")

    def counted(kind, fn):
        def run(pks, *args, **kwargs):
            if on_walk():
                walk_lanes[kind] += len(pks)
            return fn(pks, *args, **kwargs)

        return run

    def launch(name, key, args, n, *rest):
        out = real_launch(name, key, args, n, *rest)
        if n and on_walk():  # where the wrapper counted a launch
            walk_launches[key] = walk_launches.get(key, 0) + 1
        return out

    def run_hash(name, key, args, device):
        real_run(name, key, args, device)
        if on_walk():
            walk_launches[key] = walk_launches.get(key, 0) + 1

    def build_state(snapshot):
        walk["thread"] = threading.get_ident()
        t = time.perf_counter()
        try:
            out = real_build(snapshot)
        finally:
            walk["s"] = time.perf_counter() - t
            walk["thread"] = None
        walk["state"] = out[0]
        return out

    def sync(*args, **kwargs):
        out = real_sync(*args, **kwargs)
        marks["restored"] = time.perf_counter()
        marks["app_height"], marks["app_hash"] = app._height, app._app_hash
        return out

    syncer._build_state, syncer.sync = build_state, sync
    tops.verify_batch, crypto_batch.host_verify_ed25519 = counted("device", real_vb), counted("host", real_host)
    cuda_verify._launch, cuda_hash._run = launch, run_hash
    try:
        node.start()
        wait_until(lambda: node.failed is not None or node.statesync_error is not None
                   or (node.caught_up and node.syncer.state.last_block_height >= NODE_SYNC_TO), PHASE19_WAIT_S,
                   lambda: f"phase 19a: the joiner at {node.height} (caught up {node.caught_up})")
        caught_up = time.perf_counter()
        check(node.failed is None and node.statesync_error is None,
              f"phase 19a: failed {node.failed!r}, state sync {node.statesync_error!r}")
        state = node.syncer.state
        check(node.block_store.load_block(1) is None and node.block_store.load_block(snap_h) is None
              and node.block_store.base() == snap_h + 1, "phase 19a: the joiner fetched blocks below the snapshot")
        check_converged(source, node, state, "phase 19a", first=snap_h + 1)
        src_hash_at = src_exec.block_store.load_block_meta(snap_h + 1).header.app_hash  # the app after snap_h
        check(marks["app_height"] == snap_h and marks["app_hash"] == src_hash_at == walk["state"].app_hash,
              "phase 19a: the restored app hash is not the source's at the snapshot height")
        check(sorted(syncer.backfilled) == list(range(snap_h - STATESYNC_BACKFILL, snap_h)),
              f"phase 19a: backfilled {sorted(syncer.backfilled)}")
        total = ingest_delta(before)
        check(walk_launches.get("challenge", 0) > 0
              and walk_launches.get("verify_resident", 0) + walk_launches.get("verify", 0) > 0,
              f"phase 19a: the light walk's launches {walk_launches}")
        check(walk_lanes["host"] == 0 and walk_lanes["device"] > 0, f"phase 19a: the light walk's lanes {walk_lanes}")
    finally:
        try:
            node.stop()
        finally:
            syncer._build_state, syncer.sync = real_build, real_sync
            tops.verify_batch, crypto_batch.host_verify_ed25519 = real_vb, real_host
            cuda_verify._launch, cuda_hash._run = real_launch, real_run
    join_s = caught_up - t0
    after_s = caught_up - marks["restored"]
    emit({"phase": "statesync_join", "validators": NODE_VALIDATORS, "heights": NODE_SYNC_TO,
          "servers": len(servers), "transport": "tcp", "db_backend": "filedb-c", "engine": "c",
          "snapshot": {"height": snap_h, "chunks": n_chunks, "bytes": snap_bytes},
          "start_to_caught_up_s": join_s, "phase_14_blocksync_64_s": blocksync_s,
          "start_to_restored_s": marks["restored"] - t0, "light_walk_s": walk["s"],
          "light_walk": {"device_lanes": walk_lanes["device"], "host_lanes": walk_lanes["host"],
                         "launches": walk_launches},
          "blocks_after_join": NODE_SYNC_TO - snap_h, "blocks_per_s_after_join": (NODE_SYNC_TO - snap_h) / after_s,
          "backfilled": len(syncer.backfilled), "launches": total["launches"],
          "scheduler_tiers_of_the_join": total["tiers"]})
    return launches()


def phase_restart_rollback(source, servers, peer, home, dev):
    """19b: sync to ROLLBACK_SYNC_TO from ``peer`` (a :class:`PeerProcess`
    holding one block more), stop, roll back one height, restart from the
    files and sync on from ``servers`` (module note). Returns the launch
    counts of the run, those of the restart's construction among them."""
    from tendermint_tpu_torch.abci.client import LocalClient
    from tendermint_tpu_torch.abci.kvstore import KVStoreApplication
    from tendermint_tpu_torch.node import Node, NodeConfig
    from tendermint_tpu_torch.ops import precompute
    from tendermint_tpu_torch.state.rollback import rollback_state
    from tendermint_tpu_torch.state.store import StateStore
    from tendermint_tpu_torch.storage import open_db
    from tendermint_tpu_torch.storage.blockstore import BlockStore
    from tendermint_tpu_torch.types.genesis import GenesisDoc

    _, src_exec, _ = source[:3]
    genesis = GenesisDoc.from_json(source[0])
    node_home = os.path.join(home, "restart")

    def make(peers):
        return Node(NodeConfig(chain_id=CHAIN_ID, home=node_home, db_backend="filedb-c", wal_enabled=False,
                               listen_addr="127.0.0.1:0", moniker="restart", persistent_peers=peers),
                    genesis, LocalClient(KVStoreApplication()), device=dev)

    t0 = time.perf_counter()
    node = make([peer.addr])
    try:
        node.start()
        wait_until(lambda: node.failed is not None or node.syncer.state.last_block_height >= ROLLBACK_SYNC_TO,
                   PHASE19_WAIT_S, lambda: f"phase 19b: the first run at {node.height}")
    finally:
        node.stop()
    first_s = time.perf_counter() - t0
    check(node.height == ROLLBACK_SYNC_TO and node.syncer.state.last_block_height == ROLLBACK_SYNC_TO,
          f"phase 19b: the first run stopped at {node.height}")
    data = os.path.join(node_home, "data")
    state_store, block_store = StateStore(open_db("filedb-c", data, "state")), \
        BlockStore(open_db("filedb-c", data, "blockstore"))
    engine = state_store._db.engine
    rolled = rollback_state(state_store, block_store)
    state_store._db.close()
    block_store._db.close()
    check(rolled == (ROLLBACK_SYNC_TO - 1, src_exec.block_store.load_block_meta(ROLLBACK_SYNC_TO).header.app_hash)
          and engine == "c", f"phase 19b: rollback to {rolled}, engine {engine}")
    sizes = store_sizes(node_home)
    precompute.results.clear()  # a restarted process starts with no verdicts
    before = launches()
    t1 = time.perf_counter()
    node = make([srv.addr for srv in servers])
    replay_s = time.perf_counter() - t1
    restart_launches = delta(before)
    try:
        replayed = node.handshaker.n_blocks_replayed
        check(replayed == ROLLBACK_SYNC_TO and node.sm_state.last_block_height == ROLLBACK_SYNC_TO,
              f"phase 19b: replayed {replayed} blocks to {node.sm_state.last_block_height}")
        check(restart_launches.get("verify_resident", 0) + restart_launches.get("verify", 0) > 0,
              f"phase 19b: the re-applied tip launched {restart_launches}")
        node.start()
        wait_until(lambda: node.failed is not None or (node.caught_up and
                                                       node.syncer.state.last_block_height >= NODE_SYNC_TO),
                   PHASE19_WAIT_S, lambda: f"phase 19b: the restarted node at {node.height}")
        caught_up_s = time.perf_counter() - t1
        check(node.failed is None, f"phase 19b: failed {node.failed!r}")
        check_converged(source, node, node.syncer.state, "phase 19b")
    finally:
        node.stop()
    emit({"phase": "restart_rollback", "validators": NODE_VALIDATORS, "db_backend": "filedb-c", "engine": engine,
          "first_run_to": ROLLBACK_SYNC_TO, "first_run_s": first_s, "rolled_back_to": rolled[0],
          "store_bytes": sizes, "replayed_blocks": replayed, "replay_s": replay_s,
          "replay_blocks_per_s": replayed / replay_s, "restart_launches": restart_launches,
          "restart_to_caught_up_s": caught_up_s, "synced_to": NODE_SYNC_TO, "final_store_bytes": store_sizes(node_home)})
    return launches()


# --- phase 20 ------------------------------------------------------------------


def prom_samples(text):
    """A Prometheus text exposition as {(name, ((label, value), ...)): value}."""
    import re

    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = re.match(r"^([A-Za-z_:][A-Za-z0-9_:]*)(?:\{(.*)\})?\s+(\S+)$", line)
        if m:
            labels = tuple(sorted(re.findall(r'(\w+)="((?:[^"\\]|\\.)*)"', m.group(2) or "")))
            out[(m.group(1), labels)] = float(m.group(3))
    return out


def prom_total(samples, name, **labels):
    """The sum of ``name``'s samples whose labels include ``labels``."""
    want = set(labels.items())
    return sum(v for (n, ls), v in samples.items() if n == name and want <= set(ls))


def http_get(url, timeout=5.0):
    import urllib.request

    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.read().decode()


def rpc_call(url, method, timeout=5.0, **params):
    import urllib.request

    body = json.dumps({"jsonrpc": "2.0", "id": 1, "method": method, "params": params}).encode()
    req = urllib.request.Request(url, body, {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        doc = json.load(resp)
    check("error" not in doc, f"{method}: {doc.get('error')}")
    return doc["result"]


def rpc_ready(url, method, **params):
    """The route's answer, or None while the listener is not up."""
    try:
        return rpc_call(url, method, timeout=2.0, **params)
    except OSError:
        return None


def cli_env():
    return dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))


def spawn_cli(home, log_path, *args):
    """``python -m tendermint_tpu_torch --home home *args`` from this
    checkout, its output into ``log_path`` (appended)."""
    with open(log_path, "ab") as log:
        proc = subprocess.Popen([sys.executable, "-m", "tendermint_tpu_torch", "--home", home, *args],
                                cwd=os.path.dirname(os.path.abspath(__file__)), env=cli_env(),
                                stdout=log, stderr=subprocess.STDOUT)
    proc.log_path = log_path
    return proc


def log_tail(path, n=3000):
    with open(path, errors="replace") as fh:
        return fh.read()[-n:]


def cli_main(*args):
    """``tendermint_tpu_torch.cli.main(args)`` in this process (a stopped
    home's tool pays no interpreter and torch start): its exit code and
    standard output."""
    import contextlib
    import io

    from tendermint_tpu_torch import cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(list(args))
    return rc, out.getvalue()


def printed_launches(log_path):
    """The sum of the ``kernel launches {...}`` lines a log holds (a
    ``start`` prints one when it stops; a killed one prints none)."""
    total = {}
    with open(log_path, errors="replace") as fh:
        for line in fh:
            if line.startswith("kernel launches "):
                for k, v in json.loads(line[len("kernel launches "):]).items():
                    total[k] = total.get(k, 0) + v
    return total


def stop_cli(proc, what):
    """SIGTERM, and the exit code, which must be 0."""
    proc.send_signal(signal.SIGTERM)
    try:
        rc = proc.wait(CLI_STOP_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(10)
        rc = "hung"
    check(rc == 0, f"{what}: exited {rc} on SIGTERM:\n{log_tail(proc.log_path)}")


def wait_rpc(proc, fn, what, timeout=CLI_WAIT_S):
    """Wait for ``fn()`` (an RPC read), failing early if ``proc`` exited."""
    def ready():
        check(proc.poll() is None, f"{what}: the process exited {proc.returncode}:\n{log_tail(proc.log_path)}")
        try:
            return fn()
        except OSError:
            return False

    wait_until(ready, timeout, what, interval=0.05)


def node_metrics(url, where):
    """The node's /metrics: no fallback lane and a healthy card."""
    m = prom_samples(http_get(url + "/metrics"))
    facts = {
        "fallback_lanes": prom_total(m, "tendermint_ops_device_fallback_lanes_total"),
        "health_state": prom_total(m, "tendermint_ops_device_health_state"),
        "compile_events": {eng: prom_total(m, "tendermint_ops_compile_events_total", engine=eng)
                           for eng in ("ed25519", "pallas", "sr25519")},
        "dispatches": prom_total(m, "tendermint_ops_kernel_bucket_seconds_count", engine="ed25519"),
    }
    check(facts["fallback_lanes"] == 0 and facts["health_state"] == 0, f"{where}: /metrics {facts}")
    return facts


def tx_page(url, height):
    doc = rpc_call(url, "tx_search", query=f"tx.height = {height}", per_page=100)
    return {"total_count": doc["total_count"], "txs": doc["txs"]}


def spawn_init(work):
    """20a's first step, started: ``python -m tendermint_tpu_torch --home
    <work>/node init`` (the script starts it before 19b, so that its
    interpreter's start overlaps 19b)."""
    home = os.path.join(work, "node")
    proc = spawn_cli(home, os.path.join(work, "init.log"), "init", "--chain-id", CHAIN_ID)
    proc.t0 = time.perf_counter()
    return proc


def phase_cli_start(source, servers, dev, work, init):
    """20a (module note): the node ``init`` (:func:`spawn_init`) made in
    ``work``, run by ``start`` from the shell, block-syncing from 19a's
    servers. Returns what 20b takes: the home, its RPC's URL, the
    ``start`` arguments and the running node's answer to ``tx_search``;
    and its launches."""
    from tendermint_tpu_torch.config import Config

    _, src_exec, src_state = source[:3]
    start = ("start",) if dev.type == "cuda" else ("start", "--device", "cpu")  # a rehearsal on the CPU
    home = os.path.join(work, "node")
    log = os.path.join(work, "start1.log")
    meta = src_exec.block_store.load_block_meta
    t_wait = time.perf_counter()
    try:
        rc = init.wait(CLI_WAIT_S)
    except subprocess.TimeoutExpired:
        init.kill()
        rc = "hung"
    check(rc == 0, f"phase 20a: init exited {rc}:\n{log_tail(init.log_path)}")
    init_s, init_waited_s = time.perf_counter() - init.t0, time.perf_counter() - t_wait
    cfg = Config.load(home)
    check(cfg.base.db_backend == "filedb" and not cfg.statesync.enabled and cfg.indexer.sinks == ["kv"],
          "phase 20a: init's defaults")
    with open(cfg.genesis_file(), "w") as fh:  # config 4's chain in place of init's one-validator genesis
        fh.write(source[0])
    p2p_port, rpc_port = free_ports(2)
    cfg.p2p.laddr, cfg.rpc.laddr = f"127.0.0.1:{p2p_port}", f"127.0.0.1:{rpc_port}"
    cfg.p2p.persistent_peers = [srv.addr for srv in servers]
    cfg.save()
    url = f"http://127.0.0.1:{rpc_port}"
    t0 = time.perf_counter()
    proc = spawn_cli(home, log, *start)
    marks = {}

    def at(h):
        st = rpc_ready(url, "status")
        if st is None:
            return False
        height = int(st["sync_info"]["latest_block_height"])
        if height >= 1 and "first" not in marks:
            marks["first"] = time.perf_counter()
        return height >= h

    try:
        wait_rpc(proc, lambda: at(NODE_SYNC_TO), f"phase 20a: the started node at {NODE_SYNC_TO}")
        t64 = time.perf_counter()
        blk = rpc_call(url, "block", height=NODE_SYNC_TO)
        check(blk["block_id"]["hash"].lower() == meta(NODE_SYNC_TO).block_id.hash.hex()
              and blk["block"]["header"]["app_hash"].lower() == meta(NODE_SYNC_TO).header.app_hash.hex(),
              "phase 20a: block or app hash at 64 is not the source's")
        wait_rpc(proc, lambda: rpc_call(url, "status")["sync_info"]["latest_app_hash"].lower()
                 == src_state.app_hash.hex(), "phase 20a: the started node's app hash after 64")
        metrics = node_metrics(url, "phase 20a")
        txs = tx_page(url, NODE_CHANGE_HEIGHT)
    finally:
        stop_cli(proc, "phase 20a: start")
    launches = printed_launches(log)
    check(launches.get("verify_resident", 0) > 0 and launches.get("challenge", 0) > 0
          and metrics["compile_events"]["ed25519"] > 0 and metrics["dispatches"] > 0,
          f"phase 20a: launches {launches}, /metrics {metrics}")
    spawn_to_64 = t64 - t0
    emit({"phase": "cli_start", "validators": NODE_VALIDATORS, "heights": NODE_SYNC_TO,
          "command": "python -m tendermint_tpu_torch --home H start", "db_backend": "filedb",
          "peers": len(servers), "transport": "tcp", "init_s": init_s, "init_waited_s": init_waited_s,
          "spawn_to_64_s": spawn_to_64,
          "blocks_per_s_from_spawn": NODE_SYNC_TO / spawn_to_64, "spawn_to_first_block_s": marks["first"] - t0,
          "blocks_per_s_after_first_block": (NODE_SYNC_TO - 1) / (t64 - marks["first"]),
          "phase_17b_p2p_blocks_per_s": CLUSTER_FACTS.get("p2p_blocks_per_s"),
          "metrics": metrics, "launches": launches})
    return {"home": home, "url": url, "start": start, "txs": txs}, launches


def phase_stopped_home(source, ctx, work):
    """20b (module note), on 20a's stopped home ``ctx``: rollback,
    inspect, a second ``start`` (the tip re-applied on the card), debug
    dump, then the stopped home's tools. Returns its launches."""
    import tarfile

    from tendermint_tpu_torch.config import Config

    _, src_exec, src_state = source[:3]
    home, url, before_txs = ctx["home"], ctx["url"], ctx["txs"]
    meta = src_exec.block_store.load_block_meta
    log = os.path.join(work, "start2.log")
    t_phase = time.perf_counter()
    rc, out = cli_main("--home", home, "rollback")
    want = f"rolled back state to height {NODE_SYNC_TO - 1}, app hash {meta(NODE_SYNC_TO).header.app_hash.hex()}"
    check(rc == 0 and out.strip() == want, f"phase 20b: rollback {rc} {out!r}")
    rc, out = cli_main("--home", home, "inspect")
    inspected = json.loads(out)
    check(rc == 0 and inspected["state_height"] == NODE_SYNC_TO - 1
          and inspected["latest_block_height"] == NODE_SYNC_TO, f"phase 20b: inspect {inspected}")
    tools = {"rollback_and_inspect_s": time.perf_counter() - t_phase}
    t2 = time.perf_counter()
    proc = spawn_cli(home, log, *ctx["start"])
    try:
        wait_rpc(proc, lambda: (rpc_ready(url, "status") or {"sync_info": {"latest_app_hash": ""}})
                 ["sync_info"]["latest_app_hash"].lower() == src_state.app_hash.hex(),
                 "phase 20b: the restarted node's state at 64")
        restart_s = time.perf_counter() - t2
        metrics = node_metrics(url, "phase 20b")
        after_restart_txs = tx_page(url, NODE_CHANGE_HEIGHT)
        t3 = time.perf_counter()
        dump = os.path.join(work, "dump.tgz")
        rc, out = cli_main("--home", home, "debug", "dump", "--rpc", url, "-o", dump)
        with tarfile.open(dump) as tar:
            names = set(tar.getnames())
            status = json.load(tar.extractfile("dump/status.json"))
        check(rc == 0 and {"dump/metrics.prom", "dump/net_info.json", "dump/home/config.toml"} <= names
              and int(status["sync_info"]["latest_block_height"]) == NODE_SYNC_TO,
              f"phase 20b: debug dump {rc} {sorted(names)}")
        tools["debug_dump_s"] = time.perf_counter() - t3
    finally:
        stop_cli(proc, "phase 20b: the restarted start")
    launches = printed_launches(log)
    check(launches.get("verify_resident", 0) + launches.get("verify", 0) > 0
          and launches.get("challenge", 0) > 0, f"phase 20b: the re-applied tip launched {launches}")
    check(after_restart_txs == before_txs and before_txs["txs"], "phase 20b: tx_search after the restart")

    # the stopped home's tools
    t4 = time.perf_counter()
    rc, out = cli_main("--home", home, "compact-db")
    check(rc == 0 and cli_main("--home", home, "inspect")[1] == json.dumps(
        dict(inspected, state_height=NODE_SYNC_TO, app_hash=src_state.app_hash.hex()), indent=2) + "\n",
        f"phase 20b: compact-db {rc} {out!r}")
    tools["compact_db"] = out.strip().splitlines()
    tools["compact_db_s"] = time.perf_counter() - t4
    t4 = time.perf_counter()
    copy = os.path.join(work, "migrated")
    rc, _ = cli_main("--home", home, "key-migrate", "--to-backend", "filedb-py", "--out", os.path.join(copy, "data"))
    mcfg = Config.load(home)
    mcfg.home = copy
    mcfg.base.db_backend = "filedb-py"
    mcfg.save()
    check(rc == 0 and cli_main("--home", copy, "inspect")[1] == cli_main("--home", home, "inspect")[1],
          "phase 20b: inspect of the filedb-py copy differs")
    tools["key_migrate_s"] = time.perf_counter() - t4
    t4 = time.perf_counter()
    data = Config(home=home).data_dir()
    for f in os.listdir(data):
        if f.startswith("tx_index"):
            os.unlink(os.path.join(data, f))
    rc, out = cli_main("--home", home, "reindex-event")
    check(rc == 0 and out.startswith(f"reindexed {NODE_SYNC_TO} blocks"), f"phase 20b: reindex-event {out!r}")
    tools["reindex_event_s"] = time.perf_counter() - t4
    t4 = time.perf_counter()
    iport = free_ports(1)[0]
    iurl = f"http://127.0.0.1:{iport}"
    srv = spawn_cli(home, os.path.join(work, "inspect.log"), "inspect", "--serve", f"127.0.0.1:{iport}")
    try:
        wait_rpc(srv, lambda: rpc_ready(iurl, "health") is not None, "phase 20b: inspect --serve")
        served_txs = tx_page(iurl, NODE_CHANGE_HEIGHT)
    finally:
        stop_cli(srv, "phase 20b: inspect --serve")
    check(served_txs == before_txs, "phase 20b: tx_search over inspect --serve after reindex-event differs")
    tools["inspect_serve_s"] = time.perf_counter() - t4
    t4 = time.perf_counter()
    rc, out = cli_main("wal2json", os.path.join(home, "cs.wal"))
    records = [json.loads(line) for line in out.splitlines()]
    check(rc == 0 and records, f"phase 20b: wal2json {rc}, {len(records)} records")
    tools["wal2json_records"] = len(records)
    tools["wal2json_s"] = time.perf_counter() - t4
    emit({"phase": "stopped_home_tools", "rolled_back_to": NODE_SYNC_TO - 1, "restart_to_64_s": restart_s,
          "metrics": metrics, "launches": launches, "tx_search_txs": len(before_txs["txs"]), **tools,
          "wall_s": time.perf_counter() - t_phase})
    return launches


def phase_e2e_ci(dev):
    """20c (module note): the port's e2e runner on ``networks/ci.toml``,
    every node on the card. Returns its nodes' launches."""
    import tempfile

    from tendermint_tpu_torch.e2e import Manifest, Runner

    here = os.path.dirname(os.path.abspath(__file__))
    manifest = Manifest.load(os.path.join(here, "tendermint_tpu_torch", "e2e", "networks", "ci.toml"))
    manifest.wait_heights = E2E_WAIT_HEIGHTS
    work = tempfile.mkdtemp(prefix="chip-smoke-e2e-")
    t0 = time.perf_counter()
    stages = {}
    events = []

    def log(line):
        events.append((time.perf_counter() - t0, line))

    runner = Runner(manifest, work, log=log, device="cuda" if dev.type == "cuda" else "cpu")
    try:
        for name, stage in (("setup", runner.setup), ("start", runner.start),
                            ("load", lambda: runner.load(E2E_LOAD_S[0])), ("perturb", runner.perturb),
                            ("load_after", lambda: runner.load(E2E_LOAD_S[1])),
                            ("wait", runner.wait), ("test", runner.test)):
            t = time.perf_counter()
            try:
                stage()
            except Exception as exc:  # the runner's E2EError, with its stage
                check(False, f"phase 20c: {name}: {exc!r}; events {events[-8:]}")
            stages[name] = time.perf_counter() - t
        # 19c's checks, on the four validators over their RPC, over the
        # heights every store still holds near the tip (the kvstore app
        # lets a node prune all but its last 100 blocks)
        vals = [n for n in runner.nodes.values() if n.manifest.mode == "validator"]
        sync = [n.rpc("status")["sync_info"] for n in vals]
        latest = min(int(x["latest_block_height"]) for x in sync)
        first = max([int(x["earliest_block_height"]) for x in sync] + [latest - E2E_WINDOW + 1, 1])
        check(latest - first + 1 >= E2E_CHECK_HEIGHTS, f"phase 20c: the validators hold {first}..{latest}")
        for h in range(latest - E2E_CHECK_HEIGHTS + 1, latest + 1):
            ids = {n.rpc("block", {"height": h})["block_id"]["hash"] for n in vals}
            check(len(ids) == 1, f"phase 20c: the validators disagree at height {h}")
        addrs = {v["address"] for v in vals[0].rpc("validators", {"height": latest})["validators"]}
        blocks = [vals[0].rpc("block", {"height": h})["block"] for h in range(first, latest + 1)]
        signed = {s["validator_address"] for b in blocks[1:] for s in b["last_commit"]["signatures"]
                  if s.get("signature")}
        check(len(addrs) == len(vals) and addrs <= signed, "phase 20c: a validator never signed a commit")
        from tendermint_tpu_torch.rpc.encoding import parse_rfc3339

        times = [parse_rfc3339(b["header"]["time"]).to_unix_ns() / 1e9 for b in blocks]
        intervals = [b - a for a, b in zip(times, times[1:])]
        metrics = {n.manifest.name: node_metrics(n.rpc_url, f"phase 20c: {n.manifest.name}")
                   for n in runner.nodes.values() if n.running()}
    finally:
        runner.stop()
    launches = {}
    for n in runner.nodes.values():
        launches = add_launches(launches, printed_launches(n.log_path))
    emit({"phase": "e2e_ci", "manifest": "tendermint_tpu_torch/e2e/networks/ci.toml", "nodes": len(runner.nodes),
          "device": runner.device, "wait_heights": manifest.wait_heights, "stages_s": stages,
          "recoveries_s": {f"{name}:{p}": s for name, p, s in runner.recoveries},
          "block_interval_s": {"mean": statistics.mean(intervals), "min": min(intervals), "max": max(intervals),
                               "n": len(intervals)},
          "phase_17a_block_interval_mean_s": CLUSTER_FACTS.get("block_interval_mean_s"),
          "heights_agreed": [latest - E2E_CHECK_HEIGHTS + 1, latest], "heights_read": [first, latest],
          "load_txs": len(runner._sent_txs),
          "host_tier_by_policy": "a commit of 4 lanes is under DEVICE_THRESHOLD, so its lanes go to the host tier; "
                                 "each node's vote pre-verifier warm-up probe launches",
          "metrics": metrics, "launches": launches, "wall_s": time.perf_counter() - t0})
    shutil.rmtree(work, ignore_errors=True)
    return launches


def start_phase19_servers(source):
    """Phase 19's server processes (19a's two servers and 19b's first
    peer), started together and early: the script starts them before the
    kernels' build, so that their start (a spawned interpreter each, and
    the servers' handshakes) overlaps the build and no measured phase,
    and waits for them (:func:`wait_phase19_servers`) before phase 2.
    Returns what :func:`phase_files_and_joins` takes."""
    import tempfile

    t = time.perf_counter()
    home = tempfile.mkdtemp(prefix="chip-smoke-files-")
    started = {"home": home, "servers": [], "peer": None, "t": t}
    try:
        started["servers"], started["write_home_s"] = statesync_servers(source, home)
        started["peer"] = PeerProcess(source[1].block_store, "rollback-peer", top=ROLLBACK_SYNC_TO + 1)
    except BaseException:
        stop_phase19_servers(started)
        raise
    started["spawn_s"] = time.perf_counter() - t
    return started


def wait_phase19_servers(started):
    """Wait until what :func:`start_phase19_servers` started is ready;
    the seconds waited here."""
    t = time.perf_counter()
    for srv in started["servers"]:
        srv.ready()
    started["peer"].ready()
    started["ready_s"] = time.perf_counter() - started["t"]
    started["waited_s"] = time.perf_counter() - t
    return started["waited_s"]


def stop_phase19_servers(started):
    """Stop what :func:`start_phase19_servers` started (a second call
    stops nothing); what each server's ``Node.stop()`` raised (None where
    nothing)."""
    from concurrent.futures import ThreadPoolExecutor

    procs = started["servers"] + ([started["peer"]] if started["peer"] is not None else [])
    with ThreadPoolExecutor(max(1, len(procs))) as pool:  # each waits for its child's node to stop
        answers = list(pool.map(lambda proc: proc.stop(), procs))
    stopped = answers[:len(started["servers"])]
    started["servers"], started["peer"] = [], None
    shutil.rmtree(started["home"], ignore_errors=True)
    return stopped


def phase_files_and_joins(source, dev, blocksync_s, started=None):
    """Phases 19 and 20 (module note): 19a, 19b and 20a on the servers
    :func:`start_phase19_servers` started and :func:`wait_phase19_servers`
    waited for (both here, unless given), which stop after 20a (19b's
    peer after 19b); then 20b, with 20c beside it in a thread of this
    process. The nodes' process-wide sinks are restored after. Returns
    19a's and 19b's launch counts, phase 20's child processes' and the
    phases' seconds."""
    import resource
    import tempfile

    from tendermint_tpu_torch.ops import cuda_hash, cuda_verify

    t0 = time.perf_counter()
    sinks = node_sinks()
    stopped = None
    e2e, e2e_thread, init = {}, None, None
    work = tempfile.mkdtemp(prefix="chip-smoke-cli-")

    def run_e2e():
        t = time.perf_counter()
        try:
            e2e["launches"] = phase_e2e_ci(dev)
        except BaseException as exc:  # raised by the phase's thread after the join
            e2e["error"] = exc
        e2e["seconds"] = time.perf_counter() - t

    try:
        if started is None:
            started = start_phase19_servers(source)
            wait_phase19_servers(started)
        servers, peer, home = started["servers"], started["peer"], started["home"]
        facts = [srv.facts for srv in servers]
        check(all(f["replayed"] == NODE_HEIGHTS == f["app_height"] and f["engine"] == "c" for f in facts),
              f"phase 19a: the servers {facts}")
        emit({"phase": "statesync_servers", "write_home_s": started["write_home_s"], "servers": len(servers),
              "spawn_s": started["spawn_s"], "ready_s_after_start": started["ready_s"],
              "waited_s_after_the_build": started["waited_s"], "open_s": [f["open_s"] for f in facts],
              "replayed_blocks": NODE_HEIGHTS, "engine": "c",
              "store_bytes": store_sizes(os.path.join(home, "template"))})
        parts = {"servers_s": time.perf_counter() - t0}
        cuda_verify.reset_launches()  # the state-sync join starts here
        cuda_hash.reset_launches()
        statesync_counts = phase_statesync_join(source, servers, home, dev, blocksync_s)
        check_healthy("phase 19a")
        parts["19a_s"] = time.perf_counter() - t0 - sum(parts.values())
        init = spawn_init(work)  # 20a's init, beside 19b
        cuda_verify.reset_launches()  # the restart from files starts here
        cuda_hash.reset_launches()
        restart_counts = phase_restart_rollback(source, servers, peer, home, dev)
        check_healthy("phase 19b")
        parts["19b_s"] = time.perf_counter() - t0 - sum(parts.values())
        started["peer"] = None
        peer.stop()  # 19b's; its memory back before phase 20's processes start
        t20 = time.perf_counter()
        ctx, cli_counts = phase_cli_start(source, servers, dev, work, init)  # a process of its own
        parts["20a_s"] = time.perf_counter() - t20
        stopped = stop_phase19_servers(started)  # 20b and 20c need no server
        # 20c runs beside 20b (module note): its processes are its own
        e2e_thread = threading.Thread(target=run_e2e, name="phase-20c")
        e2e_thread.start()
        cli_counts = add_launches(cli_counts, phase_stopped_home(source, ctx, work))
        parts["20b_s"] = time.perf_counter() - t20 - parts["20a_s"]
    finally:
        if stopped is None and started is not None:
            stopped = stop_phase19_servers(started)
        restore_node_sinks(sinks)
        if e2e_thread is not None:
            e2e_thread.join()
        if init is not None and init.poll() is None:  # where 20a was not reached
            init.kill()
            init.wait(10)
        shutil.rmtree(work, ignore_errors=True)
    parts["20_s"] = time.perf_counter() - t20
    if "error" in e2e:
        raise e2e["error"]
    check(all(x is None for x in stopped), f"phase 19a-b, 20a: the servers' stop {stopped}")
    parts["20c_s"] = e2e["seconds"]
    cli_counts = add_launches(cli_counts, e2e["launches"])
    seconds = time.perf_counter() - t0
    emit({"phase": "files_and_joins", "seconds": seconds, "parts": parts,
          "max_rss_gb_of_this_process": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20,
          "budget_s": {"phase_19": PHASE19_BUDGET_S, "phase_20": PHASE20_BUDGET_S}})
    return statesync_counts, restart_counts, cli_counts, seconds


def main(argv=None) -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description="Drive the port's main path on one GPU and check it.")
    parser.add_argument("--trace-dir", default="build",
                        help="where phase 12 writes its profiler traces (default: build)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing to run", file=sys.stderr)
        return 2
    from tendermint_tpu_torch.crypto import batch as crypto_batch
    from tendermint_tpu_torch.ops import _build, cuda_hash, cuda_verify, device_policy

    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    workers = min(8, os.cpu_count() or 1)
    with multiprocessing.get_context("spawn").Pool(workers) as pool:
        signer = Signer(pool)
        kernel_lanes = fault_lanes(rng, signer)
        batch = batch_lanes(rng, signer)
        commit = commit_workload(rng, signer)
        sr_lanes = sr_fault_lanes(rng, signer)
        mixed = mixed_commit_workload(rng, signer)
        sync = chain_workload(rng, signer, SYNC_BLOCKS, SYNC_VALIDATORS)
        mixed_sync = chain_workload(rng, signer, MIXED_SYNC_BLOCKS, MIXED_SYNC_VALIDATORS, mixed=True)
        light = chain_workload(rng, signer, LIGHT_HEADERS, LIGHT_VALIDATORS)
        round_wl = round_workload(rng, signer)
        lightd_wl = lightd_workload(rng, signer)
        commit_tables = signer.tables(commit[0])  # phase 12 starts from them
        three_type = three_type_workload(rng, signer)
        t_node = time.perf_counter()
        node_source = node_chain_workload(rng, signer)
        node_setup_s = time.perf_counter() - t_node
        equivocation = equivocation_workload(rng, signer, node_source)
        consensus_keys = signer.keys(rng, CONSENSUS_VALIDATORS)
    emit({"phase": "setup", "seconds": time.perf_counter() - t0, "workers": workers,
          "signatures": 2 * KERNEL_LANES + BATCH_LANES + len(COMMIT_HEIGHTS) * COMMIT_VALIDATORS
          + MIXED_VALIDATORS + SYNC_BLOCKS * SYNC_VALIDATORS
          + MIXED_SYNC_BLOCKS * MIXED_SYNC_VALIDATORS + LIGHT_HEADERS * LIGHT_VALIDATORS
          + 3 * ROUND_VALIDATORS + (LIGHTD_HEADERS + 1) * LIGHTD_VALIDATORS
          + THREE_TYPE_VALIDATORS + (NODE_HEIGHTS + 1) * int(NODE_VALIDATORS * NODE_SIGN_SHARE)
          + 2 * (len(equivocation[1]) + 1),
          "node_source_chain_s": node_setup_s})

    phase19 = start_phase19_servers(node_source)  # their start overlaps the build (its note)
    try:
        dev = torch.device("cuda", 0)
        smi = nvidia_smi("name,power.limit")
        t0 = time.perf_counter()
        _build.build_all()
        build_s = time.perf_counter() - t0
        for src, log in _build.build_log.items():
            print(f"--- nvcc {src}\n{log}", file=sys.stderr)
        emit({"phase": "device", "name": torch.cuda.get_device_name(0), "nvidia_smi": smi,
              "torch": torch.__version__, "cuda": torch.version.cuda, "build_s": build_s})
        wait_phase19_servers(phase19)  # before the first measured phase

        rows = phase_kernels(kernel_lanes, dev, sr_lanes=sr_lanes)
        device_policy.shared.reset()
        cuda_verify.reset_launches()  # the main path starts here
        cuda_hash.reset_launches()
        phase_verify_batch(batch, dev)
        phase_commit(commit, dev)
        counts = launches()
        health = {"phases_3_to_4b": check_healthy("phases 3-4b")}
        cuda_verify.reset_launches()  # the mixed commit's path starts here
        cuda_hash.reset_launches()
        mixed_counts = phase_mixed_commit(mixed, dev)
        health["phase_5"] = check_healthy("phase 5")
        cuda_verify.reset_launches()  # the three-type commit's path starts here
        cuda_hash.reset_launches()
        three_type_counts = phase_three_type(three_type, dev)
        health["phase_5c"] = check_healthy("phase 5c")
        cuda_verify.reset_launches()  # the blocksync path starts here
        cuda_hash.reset_launches()
        sync_counts = phase_blocksync(sync, mixed_sync, dev)
        health["phase_7"] = check_healthy("phase 7")
        cuda_verify.reset_launches()  # the light client's path starts here
        cuda_hash.reset_launches()
        light_counts = phase_light(light, dev)
        health["phase_8"] = check_healthy("phase 8")
        vote_counts = phase_votes(commit, round_wl, dev)  # resets the counts after its set-up
        health["phase_9"] = check_healthy("phase 9")
        cuda_verify.reset_launches()  # the light client's bisection round starts here
        cuda_hash.reset_launches()
        light_round_counts = phase_light_round(light, dev)
        health["phase_10"] = check_healthy("phase 10")
        cuda_verify.reset_launches()  # the light client and lightd start here
        cuda_hash.reset_launches()
        lightd_counts, attack = phase_lightd(lightd_wl, dev)
        health["phase_11"] = check_healthy("phase 11")
        cuda_verify.reset_launches()  # the observed path starts here
        cuda_hash.reset_launches()
        observed_counts = phase_observed(commit, commit_tables, mixed, kernel_lanes, batch, lightd_wl, dev,
                                         args.trace_dir)
        health["phase_12"] = check_healthy("phase 12")
        cuda_verify.reset_launches()  # verifyd starts here
        cuda_hash.reset_launches()
        verifyd_counts = phase_verifyd(commit, commit_tables, batch, sync, mixed_sync, light, dev)
        for name in ("verify", "verify_resident", "verify_sr"):
            check(verifyd_counts[name] > 0, f"kernel {name} never launched through verifyd")
        health["phase_13"] = check_healthy("phase 13")
        cuda_verify.reset_launches()  # the node's block sync starts here
        cuda_hash.reset_launches()
        node_counts, node_blocks_per_s = phase_node_blocksync(node_source, dev)
        health["phase_14"] = check_healthy("phase 14")
        cuda_verify.reset_launches()  # the consensus node starts here
        cuda_hash.reset_launches()
        consensus_counts, _ = phase_consensus(consensus_keys, dev)
        health["phase_15"] = check_healthy("phase 15")
        cuda_verify.reset_launches()  # the evidence pools and the mempool start here
        cuda_hash.reset_launches()
        phase_evidence_attack(lightd_wl, attack, dev)
        health["phase_16a"] = check_healthy("phase 16a")
        phase_equivocation_burst(node_source, equivocation, dev)
        health["phase_16b"] = check_healthy("phase 16b")
        phase_mempool()
        evidence_counts = launches()
        health["phase_16c"] = check_healthy("phase 16c")
        check(evidence_counts["verify_resident"] + evidence_counts["verify"] > 0,
              f"phases 16a-c: launches {evidence_counts}")
        cuda_verify.reset_launches()  # the nodes over p2p start here
        cuda_hash.reset_launches()
        sinks = node_sinks()
        peers, peers_start_s = serving_peers(node_source[1].block_store)
        kept = []  # two of 17b's nodes, up until 18a stops them
        try:
            rpc_cluster_counts = phase_cluster(dev)  # and 18b, while its nodes are up
            health["phase_17a_18b"] = check_healthy("phases 17a and 18b")
            phase_node_p2p_sync(node_source, dev, node_blocks_per_s, peers, peers_start_s, kept)
            p2p_counts = {k: v - rpc_cluster_counts.get(k, 0) for k, v in launches().items()}
            health["phase_17b"] = check_healthy("phase 17b")
            check(p2p_counts["verify_resident"] > 0, f"phase 17: launches {p2p_counts}")
            rpc_light_counts = phase_rpc_light(node_source, kept, dev)  # resets the counts at its walk
        finally:
            stop_nodes(kept)  # where 18a was not reached
            for p in peers:
                p.stop()
            restore_node_sinks(sinks)
        rpc_counts = add_launches(rpc_light_counts, rpc_cluster_counts)
        health["phase_18a"] = check_healthy("phase 18a")
        check(rpc_counts["verify_resident"] > 0, f"phase 18: launches {rpc_counts}")
        statesync_counts, restart_counts, cli_counts, _ = phase_files_and_joins(
            node_source, dev, NODE_SYNC_TO / node_blocks_per_s, phase19)
        health["phase_19_20"] = check_healthy("phases 19 and 20")
    finally:
        stop_phase19_servers(phase19)  # where phase 19 was not reached
    crypto_batch.shutdown_shared_scheduler()
    emit({"phase": "health", **health})
    phase_faults(kernel_lanes, sr_lanes, dev)
    for name, row in rows.items():
        n = mixed_counts[name] if name == "verify_sr" else counts[name]
        check(n > 0, f"kernel {name} never launched on the main path")
        row["launches"] = n
        row["launches_mixed_commit"] = mixed_counts[name]
        row["launches_blocksync"] = sync_counts[name]
        row["launches_light_client"] = light_counts[name]
        row["launches_votes"] = vote_counts[name]
        row["launches_light_batch"] = light_round_counts[name]
        row["launches_lightd"] = lightd_counts[name]
        row["launches_observed"] = observed_counts[name]
        row["launches_verifyd"] = verifyd_counts[name]
        row["launches_three_type"] = three_type_counts[name]
        row["launches_node_blocksync"] = node_counts[name]
        row["launches_consensus"] = consensus_counts[name]
        row["launches_evidence"] = evidence_counts[name]
        row["launches_p2p"] = p2p_counts[name]
        row["launches_rpc"] = rpc_counts.get(name, 0)
        row["launches_statesync"] = statesync_counts[name]
        row["launches_restart"] = restart_counts[name]
        row["launches_cli"] = cli_counts.get(name, 0)
    emit({"kernels": list(rows.values())})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
