"""lightd: the light-client serving tier.

Counterpart of ``tendermint_tpu/light/lightd.py``. One lightd fronts a
LightClient with a verified-header cache (``light/cache.py``) and serves
JSON-RPC over ``rpc/server.py``, on its event loop unless
``evloop=False`` (``workers`` sizes the loop's handler pool). The hot
path is:

  light_header(height) -> cache hit  -> memoized result dict (no store,
                                        no encoding, no device work)
                       -> cache miss -> skipping verification (one
                          scheduler super-batch a bisection round,
                          ``light/batch.py``), then the result and its
                          trust path are memoized.

Single-flight: a thundering herd on one cold height does ONE
verification; followers wait on the leader's event and re-read the
cache. On fork evidence (``DivergedHeaderError``) every cached entry for
the chain is invalidated before the error surfaces: a proven attack
poisons all memoized trust paths.

Three divergences from the reference:

- Verifications run one at a time. The reference allows one leader per
  height, so leaders of two cold heights run the client at once; the
  client holds no lock, and the lower height's leader then finds the
  higher one trusted and fails a valid header ("height A is not above
  trusted B"), and the trust-path delta takes in the other leader's
  pivots. Here a lock is held across the verification and the delta;
  cache hits never take it.
- Only verification failures (an invalid header or commit, too little
  trusted power, a client or provider error) answer
  ``INVALID_PARAMS "light verification failed"``. Any other error, such
  as a device error or a round whose flush failed closed, propagates,
  and the RPC server answers it ``INTERNAL_ERROR``; the reference turns
  every error into ``INVALID_PARAMS``.
- A new leader reads the cache once more after its claim. In the
  reference a request whose miss comes just before the height's leader
  fills the cache and leaves claims the height after it and verifies
  it a second time.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Optional

from tendermint_tpu_torch.libs.metrics import LightMetrics
from tendermint_tpu_torch.light.cache import HeaderCache
from tendermint_tpu_torch.light.client import DivergedHeaderError, LightClient, LightClientError
from tendermint_tpu_torch.light.provider import ProviderError
from tendermint_tpu_torch.rpc import encoding as enc
from tendermint_tpu_torch.rpc.server import INTERNAL_ERROR, INVALID_PARAMS, RPCError, RPCServer
from tendermint_tpu_torch.types.validation import NotEnoughVotingPowerError

# How long a follower waits for the in-flight leader before taking over
# (covers a leader that died without filling the cache).
FOLLOWER_WAIT = 60.0

# What a verification raises when the header, not the server, is at
# fault; the ValueError family takes in the verifier's errors.
_VERIFICATION_FAILURES = (ValueError, LightClientError, NotEnoughVotingPowerError, ProviderError)


class LightServer:
    """Route table + lifecycle for one lightd instance."""

    def __init__(
        self,
        client: LightClient,
        host: str = "127.0.0.1",
        port: int = 0,
        cache: Optional[HeaderCache] = None,
        cache_capacity: int = 10_000,
        metrics: Optional[LightMetrics] = None,
        registry=None,
        evloop: bool = True,
        evloop_metrics=None,
        workers: Optional[int] = None,
    ):
        self.client = client
        self.metrics = metrics or LightMetrics.nop()
        self.cache = cache or HeaderCache(capacity=cache_capacity, metrics=self.metrics)
        self._sf_mtx = threading.Lock()
        # height -> Event set by the verification leader when done
        self._inflight: Dict[int, threading.Event] = {}  # guarded-by: _sf_mtx
        # one verification at a time: the client and its store's
        # before/after delta
        self._verify_mtx = threading.Lock()
        self.server = RPCServer(
            self.routes(),
            host=host,
            port=port,
            metrics_registry=registry,
            evloop=evloop,
            evloop_metrics=evloop_metrics,
            workers=workers,
        )

    # --- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        self.server.start()

    def stop(self) -> None:
        self.server.stop()

    @property
    def url(self) -> str:
        return self.server.url

    @property
    def address(self):
        return self.server.address

    # --- routes --------------------------------------------------------------

    def routes(self) -> Dict[str, Callable]:
        return {
            "health": self.health,
            "light_header": self.light_header,
            "light_status": self.light_status,
        }

    def health(self) -> Dict[str, Any]:
        return {}

    def light_header(self, height=None) -> Dict[str, Any]:
        t0 = time.monotonic()
        outcome = "error"
        try:
            result, outcome = self._serve(height)
            return result
        finally:
            self.metrics.serve_latency_seconds.labels(outcome=outcome).observe(
                time.monotonic() - t0
            )

    def light_status(self) -> Dict[str, Any]:
        trusted = self.client.latest_trusted()
        return {
            "chain_id": self.client.chain_id,
            "trusted_height": str(trusted.height) if trusted else "0",
            "num_witnesses": len(self.client.witnesses),
            "cache": self.cache.stats(),
        }

    # --- serving core --------------------------------------------------------

    def _serve(self, height):
        try:
            h = int(height)
        except (TypeError, ValueError):
            raise RPCError(INVALID_PARAMS, "height required")
        if h <= 0:
            raise RPCError(INVALID_PARAMS, "height must be positive")
        chain = self.client.chain_id
        entry = self.cache.get(chain, h)
        if entry is not None:
            return entry.payload, "hit"
        while True:
            with self._sf_mtx:
                evt = self._inflight.get(h)
                leader = evt is None
                if leader:
                    evt = threading.Event()
                    self._inflight[h] = evt
            if leader:
                break
            # Follower: wait out the leader, then re-read the cache. If
            # the leader failed (nothing cached), loop and become the
            # next leader: the error should reproduce for us too.
            evt.wait(FOLLOWER_WAIT)
            entry = self.cache.get(chain, h)
            if entry is not None:
                return entry.payload, "hit"
        try:
            # A leader that filled the cache between our miss and our
            # claim has left already: serve its entry, uncounted.
            entry = self.cache.peek(chain, h)
            if entry is not None:
                return entry.payload, "hit"
            entry = self._verify_and_fill(chain, h)
            return entry.payload, "miss"
        finally:
            with self._sf_mtx:
                self._inflight.pop(h, None)
            evt.set()

    def _verify_and_fill(self, chain: str, h: int):
        store = self.client.store
        try:
            with self._verify_mtx:
                before = set(store.heights())
                lb = self.client.verify_light_block_at_height(h)
                # Memoized trust path: the pivots this verification
                # persisted, plus the target itself (already-trusted
                # anchors stay implicit).
                path = sorted((set(store.heights()) - before) | {h})
        except DivergedHeaderError as e:
            dropped = self.cache.invalidate_chain(chain)
            raise RPCError(
                INTERNAL_ERROR,
                f"light client attack detected: {e}",
                data=f"invalidated {dropped} cached headers",
            )
        except _VERIFICATION_FAILURES as e:
            raise RPCError(INVALID_PARAMS, f"light verification failed: {e}")
        payload = {
            "header": enc.header_json(lb.header),
            "commit": enc.commit_json(lb.signed_header.commit),
            "hash": enc.hex_bytes(lb.hash()),
            "height": str(lb.height),
            "trust_path": [str(p) for p in path],
        }
        return self.cache.put(chain, lb, trust_path=tuple(path), payload=payload)
