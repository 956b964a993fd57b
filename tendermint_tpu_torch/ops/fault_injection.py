"""Fault-injection hooks at the device dispatch sites of both engines.

Counterpart of ``tendermint_tpu/ops/fault_injection.py``: injected
faults prove that the device health machine (``ops/device_policy.py``)
degrades and recovers. The engines call :func:`fire` at each site, and
an installed :class:`FaultPlan` decides, call by call, whether to
raise a transient fault or a permanent one.

Sites:

- ``ed25519.chunk``: one chunk's launch in the runners of
  ``ops/ed25519_batch.py`` (K1, K2 or K3);
- ``ed25519.collect``: reading a launched chunk's verdicts back;
- ``sr25519.chunk``: one chunk's launch in ``ops/sr25519_batch.py`` (K5).

Without a plan the hook is one global read. Plans are process-wide and
thread-safe. The reference's environment plan (installed at import) is
left out: the port's tests and ``chip_smoke.py`` install plans
explicitly.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Callable, Iterable, Optional, Set


class DeviceFault(RuntimeError):
    """An injected device error. The health machine classifies it by its
    ``permanent`` attribute, never by its text. ``device`` names the
    card a fault is attributed to, where a caller knows it."""

    def __init__(
        self,
        message: str = "injected device fault",
        permanent: bool = False,
        device: Optional[int] = None,
    ):
        super().__init__(message)
        self.permanent = permanent
        self.device = device


class FaultPlan:
    """One installed fault schedule.

    ``site`` is a prefix filter (``"ed25519"`` matches the chunk and the
    collect sites; None matches every site). Matching calls are counted;
    a call fails when its 1-based index is in ``fail_calls`` or lies in
    [``fail_from``, ``fail_from + fail_count``).
    """

    def __init__(
        self,
        site: Optional[str] = None,
        fail_calls: Iterable[int] = (),
        fail_from: Optional[int] = None,
        fail_count: int = 0,
        permanent: bool = False,
        error_factory: Optional[Callable[[], BaseException]] = None,
    ):
        self.site = site
        self.fail_calls: Set[int] = set(fail_calls)
        self.fail_from = fail_from
        self.fail_count = fail_count
        self.permanent = permanent
        self.error_factory = error_factory
        self._mtx = threading.Lock()
        self.calls = 0  # guarded-by: _mtx
        self.faults_raised = 0  # guarded-by: _mtx

    def _matches(self, site: str) -> bool:
        return self.site is None or site.startswith(self.site)

    def on_call(self, site: str) -> None:
        if not self._matches(site):
            return
        with self._mtx:
            self.calls += 1
            idx = self.calls
            fail = idx in self.fail_calls or (
                self.fail_from is not None
                and self.fail_from <= idx < self.fail_from + self.fail_count
            )
            if fail:
                self.faults_raised += 1
        if fail:
            if self.error_factory is not None:
                raise self.error_factory()
            raise DeviceFault(
                f"injected {'permanent' if self.permanent else 'transient'} "
                f"fault at {site} call #{idx}",
                permanent=self.permanent,
            )


_PLAN: Optional[FaultPlan] = None
_PLAN_MTX = threading.Lock()


def install(plan: FaultPlan) -> FaultPlan:
    global _PLAN
    with _PLAN_MTX:
        _PLAN = plan
    return plan


def uninstall() -> None:
    global _PLAN
    with _PLAN_MTX:
        _PLAN = None


def active() -> Optional[FaultPlan]:
    return _PLAN


def fire(site: str) -> None:
    """The per-dispatch hook the engines call. No-op without a plan."""
    plan = _PLAN
    if plan is not None:
        plan.on_call(site)


@contextmanager
def inject(**plan_kwargs):
    """Scoped installation::

        with fault_injection.inject(site="ed25519", fail_from=1, fail_count=2) as plan:
            ...
    """
    plan = install(FaultPlan(**plan_kwargs))
    try:
        yield plan
    finally:
        uninstall()
