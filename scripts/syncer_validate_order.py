#!/usr/bin/env python3
"""Whether validating a block before saving it changes a syncing node's rate.

    python3 scripts/syncer_validate_order.py [--turns 2]

``BlockSyncer`` validates each block (``BlockExecutor.validate_block``)
before it saves and applies it, as reactor.go does; the JAX package's
syncer saves first and validates inside ``apply_block``. The work a
block is the same either way (``apply_block``'s own call finds the block
in the executor's validation cache), so the rate should not move. This
script builds ``chip_smoke.py``'s phase-14 source chain (500 validators,
64 blocks, 200 kvstore txs a block, 10 powers changed at height 33),
builds the kernels, runs one cold follower, then times fresh followers
on the card in turns, validate-first (the port) and save-first (a copy
of the reference's loop below), in the order new, old, old, new for
each turn, the verdict cache emptied before each. Every follower is
checked against the source (block IDs, app hash, validator sets).

Prints one JSON line per follower (order, wall seconds, blocks/s), one
summary line with the median of each order, then the card's
``nvidia-smi`` name and power limit. Without CUDA it exits with code 2.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import statistics
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def _apply_save_first(self) -> int:
    """``BlockSyncer._apply_ready_blocks`` in the reference's order: the
    window's verdicts, then save and ``apply_block`` (which validates)."""
    from tendermint_tpu_torch.blocksync import syncer as syncer_mod
    from tendermint_tpu_torch.types.block import BLOCK_PART_SIZE_BYTES, BlockID
    from tendermint_tpu_torch.types.part_set import PartSet

    window = self.pool.peek_blocks(self.verify_window + 1)
    if len(window) < 2:
        return 0
    stable_hash = window[0].header.validators_hash
    tasks, part_sets = [], []
    for first, second in zip(window, window[1:]):
        if first.header.validators_hash != stable_hash:
            break
        parts = PartSet.from_data(first.to_proto_bytes(), BLOCK_PART_SIZE_BYTES)
        part_sets.append(parts)
        tasks.append(syncer_mod.CommitTask(
            chain_id=self.state.chain_id, vals=self.state.validators,
            block_id=BlockID(first.hash(), parts.header()), height=first.header.height,
            commit=second.last_commit))
        if len(tasks) >= self.verify_window:
            break
    if not tasks:
        return 0
    verdicts = syncer_mod.verify_commits_pipelined(tasks, device=self.device)
    applied = 0
    for (first, second), task, parts, verdict in zip(zip(window, window[1:]), tasks, part_sets, verdicts):
        if not verdict.ok:
            self.pool.redo_request(first.header.height)
            self.pool.redo_request(second.header.height)
            break
        self.block_store.save_block(first, parts, second.last_commit)
        self.state = self.block_exec.apply_block(self.state, task.block_id, first)
        self.pool.pop_request()
        applied += 1
    return applied


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--turns", type=int, default=2, help="turns of new, old, old, new (default 2)")
    args = parser.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("syncer_validate_order: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from tendermint_tpu_torch.blocksync.syncer import BlockSyncer
    from tendermint_tpu_torch.ops import _build, precompute

    with multiprocessing.get_context("spawn").Pool(min(8, os.cpu_count() or 1)) as pool:
        source = cs.node_chain_workload(np.random.default_rng(cs.SEED), cs.Signer(pool))
    _build.build_all()
    dev = torch.device("cuda", 0)
    validate_first = BlockSyncer._apply_ready_blocks
    orders = {"validate_first": validate_first, "save_first": _apply_save_first}

    def follow(order):
        BlockSyncer._apply_ready_blocks = orders[order]
        try:
            precompute.results.clear()
            syncer, executor, wall, _ = cs.node_follow(source, dev)
        finally:
            BlockSyncer._apply_ready_blocks = validate_first
        cs.check_converged(source, executor, syncer.state, order)
        return wall

    follow("validate_first")  # cold: host table builds, the store's upload
    walls = {order: [] for order in orders}
    for _ in range(args.turns):
        for order in ("validate_first", "save_first", "save_first", "validate_first"):
            wall = follow(order)
            walls[order].append(wall)
            print(json.dumps({"order": order, "wall_s": wall, "blocks_per_s": cs.NODE_SYNC_TO / wall}),
                  flush=True)
    precompute.reset()
    print(json.dumps({order: {"median_wall_s": statistics.median(w),
                              "blocks_per_s": cs.NODE_SYNC_TO / statistics.median(w)}
                      for order, w in walls.items()}))
    print(cs.nvidia_smi("name,power.limit"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
