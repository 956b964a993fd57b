"""Light-block providers (light/provider/provider.go).

Counterpart of ``tendermint_tpu/light/provider.py``: a provider serves
LightBlocks by height and accepts evidence of misbehaviour.
``MemoryProvider`` is the in-process provider, ``RetryingProvider``
wraps any provider with retries and a failure budget, and
``HTTPProvider`` builds light blocks from a full node's ``/commit`` and
``/validators`` routes (``rpc/core.py``), paging the set 100 at a time.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional

from tendermint_tpu_torch.rpc import encoding as enc
from tendermint_tpu_torch.rpc.client import HTTPClient, RPCClientError
from tendermint_tpu_torch.types.evidence import Evidence
from tendermint_tpu_torch.types.light import LightBlock, SignedHeader
from tendermint_tpu_torch.types.validator_set import ValidatorSet


class ProviderError(Exception):
    pass


class LightBlockNotFoundError(ProviderError):
    """provider.ErrLightBlockNotFound."""


class HeightTooHighError(ProviderError):
    """provider.ErrHeightTooHigh: the provider chain is shorter."""


class Provider:
    def chain_id(self) -> str:
        raise NotImplementedError

    def light_block(self, height: int) -> LightBlock:
        """Returns the LightBlock at height (0 = latest); raises
        LightBlockNotFoundError / HeightTooHighError."""
        raise NotImplementedError

    def report_evidence(self, evidence: Evidence) -> None:
        raise NotImplementedError


class MemoryProvider(Provider):
    def __init__(self, chain_id: str, blocks: Optional[List[LightBlock]] = None):
        self._chain_id = chain_id
        self._blocks: Dict[int, LightBlock] = {}  # guarded-by: _lock
        self.evidence: List[Evidence] = []  # guarded-by: _lock
        self._lock = threading.Lock()
        for lb in blocks or []:
            self._blocks[lb.height] = lb

    def chain_id(self) -> str:
        return self._chain_id

    def add(self, lb: LightBlock) -> None:
        with self._lock:
            self._blocks[lb.height] = lb

    def latest_height(self) -> int:
        with self._lock:
            return max(self._blocks) if self._blocks else 0

    def light_block(self, height: int) -> LightBlock:
        with self._lock:
            if not self._blocks:
                raise LightBlockNotFoundError(f"no blocks (chain {self._chain_id})")
            latest = max(self._blocks)
            if height == 0:
                return self._blocks[latest]
            if height > latest:
                raise HeightTooHighError(f"height {height} > latest {latest}")
            if height not in self._blocks:
                raise LightBlockNotFoundError(f"no light block at height {height}")
            return self._blocks[height]

    def report_evidence(self, evidence: Evidence) -> None:
        with self._lock:
            self.evidence.append(evidence)


class ProviderBudgetExhaustedError(ProviderError):
    """The wrapped provider burned its failure budget; fail fast until
    the rolling window slides past the old failures."""


class RetryingProvider(Provider):
    """Transient-failure armour for any Provider (lightd serving tier).

    Retries ONLY transient ``ProviderError``s (network flaps, bad
    responses) with exponential backoff. Definitive answers,
    ``LightBlockNotFoundError`` and ``HeightTooHighError``, are part of
    the protocol and propagate at once; retrying them would only stall
    bisection.

    A rolling failure budget turns a persistently sick provider into an
    immediate ``ProviderBudgetExhaustedError`` instead of a retry storm:
    once `failure_budget` transient failures land within `budget_window`
    seconds, calls fail fast until the window slides. `sleep` and
    `clock` are injectable so tests run in zero wall-clock time.
    """

    def __init__(self, inner: Provider, retries: int = 3,
                 base_delay: float = 0.05, max_delay: float = 2.0,
                 failure_budget: int = 8, budget_window: float = 60.0,
                 sleep=time.sleep, clock=time.monotonic):
        if retries < 0:
            raise ValueError("retries must be >= 0")
        self.inner = inner
        self.retries = retries
        self.base_delay = base_delay
        self.max_delay = max_delay
        self.failure_budget = failure_budget
        self.budget_window = budget_window
        self._sleep = sleep
        self._clock = clock
        self._mtx = threading.Lock()
        # Times (clock()) of recent transient failures.
        self._failures: deque = deque()  # guarded-by: _mtx
        self.retries_total = 0  # guarded-by: _mtx
        self.fast_fails_total = 0  # guarded-by: _mtx

    def chain_id(self) -> str:
        return self.inner.chain_id()

    def _budget_left_locked(self) -> int:
        horizon = self._clock() - self.budget_window
        while self._failures and self._failures[0] < horizon:
            self._failures.popleft()
        return self.failure_budget - len(self._failures)

    def _check_budget(self) -> None:
        with self._mtx:
            if self._budget_left_locked() <= 0:
                self.fast_fails_total += 1
                raise ProviderBudgetExhaustedError(
                    f"provider failure budget exhausted "
                    f"({self.failure_budget} transient failures in "
                    f"{self.budget_window:g}s)"
                )

    def light_block(self, height: int) -> LightBlock:
        self._check_budget()
        delay = self.base_delay
        last: Optional[ProviderError] = None
        for attempt in range(self.retries + 1):
            try:
                return self.inner.light_block(height)
            except (LightBlockNotFoundError, HeightTooHighError):
                raise  # definitive protocol answers, never transient
            except ProviderError as e:
                last = e
                with self._mtx:
                    self._failures.append(self._clock())
                    out_of_budget = self._budget_left_locked() <= 0
                    if not out_of_budget and attempt < self.retries:
                        self.retries_total += 1
                if out_of_budget or attempt == self.retries:
                    break
                self._sleep(delay)
                delay = min(delay * 2.0, self.max_delay)
        raise last

    def report_evidence(self, evidence: Evidence) -> None:
        # Evidence broadcast is best-effort upstream: no retry loop.
        self.inner.report_evidence(evidence)


class HTTPProvider(Provider):
    """RPC-backed provider (light/provider/http/http.go): builds
    LightBlocks from /commit + /validators against a full node."""

    def __init__(self, chain_id: str, url: str, timeout: float = 10.0):
        self._chain_id = chain_id
        self.client = HTTPClient(url, timeout=timeout)

    def chain_id(self) -> str:
        return self._chain_id

    def light_block(self, height: int) -> LightBlock:
        try:
            c = self.client.commit(height if height > 0 else None)
            h = int(c["signed_header"]["header"]["height"])
            v = self.client.validators(h, per_page=100)
            vals = [enc.validator_from_json(d) for d in v["validators"]]
            total = int(v["total"])
            page = 2
            while len(vals) < total:
                more = self.client.validators(h, page=page, per_page=100)
                got = [enc.validator_from_json(d) for d in more["validators"]]
                if not got:
                    break
                vals.extend(got)
                page += 1
        except RPCClientError as e:
            msg = e.message + " " + e.data
            if "no block" in msg or "no commit" in msg:
                raise HeightTooHighError(msg)
            raise LightBlockNotFoundError(msg)
        except OSError as e:
            raise ProviderError(str(e))
        # The priorities the full node reported, kept: the set is restored
        # as it came, not rebuilt by the change-set algorithm. A defective
        # node (an empty set) is a ProviderError, so the caller drops the
        # witness, not the whole verification.
        try:
            vset = ValidatorSet.restore(vals)
            vset.get_proposer()
        except ValueError as e:
            raise ProviderError(f"bad validator set from node: {e}")
        return LightBlock(
            signed_header=SignedHeader(
                header=enc.header_from_json(c["signed_header"]["header"]),
                commit=enc.commit_from_json(c["signed_header"]["commit"]),
            ),
            validator_set=vset,
        )

    def report_evidence(self, evidence: Evidence) -> None:
        try:
            self.client.call("broadcast_evidence", {"evidence": "0x" + evidence.to_proto_bytes().hex()})
        except Exception:
            pass  # best effort, as in the reference
