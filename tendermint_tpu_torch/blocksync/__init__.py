"""Block sync: catch up by fetching verified blocks from peers
(reference: internal/blocksync/), with ranges of commits verified in one
batch on the card (parallel/pipeline.py); counterpart of
:mod:`tendermint_tpu.blocksync`, with its p2p reactor."""
