"""Block sync: catch up by fetching verified blocks from peers
(reference: internal/blocksync/), with ranges of commits verified in one
batch on the card (parallel/pipeline.py); counterpart of
:mod:`tendermint_tpu.blocksync` without the p2p reactor (ROADMAP §A
item 8d)."""
