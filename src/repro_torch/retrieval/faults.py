"""Deterministic fault injection for the serving/persistence stack.

Production retrieval dies in boring ways: a host<->device transfer hits a
transient link error, the background tiering worker thread takes an
unhandled exception and silently stops, a promotion trips device OOM, a
snapshot process is killed mid-write, a disk flips a bit under a stored
array. None of those paths can be hardened honestly without a way to
MAKE them happen on demand — so this module provides the one fault
source the rest of the stack (``retrieval.tiering``,
``training.checkpoint``, ``launch.serve --fault-plan``) arms.

Design rules:

- **Deterministic, seeded, counter-keyed.** Whether operation ``n`` at a
  site ("h2d", "d2h", "worker", snapshot leaf ``i``) faults is a pure
  function of ``(FaultPlan.seed, site, n)`` — per-site counters index
  per-site PRNG streams, and explicit schedules (``kill_worker_at``,
  ``oom_at``) are op indices, never wall-clock times. Re-running the
  same operation sequence replays the same faults; there is no
  ``time.time()``/global-``random`` anywhere in a fault decision.
- **Faults are typed.** Injected errors are ``FaultError`` subclasses so
  the hardened code retries exactly what is declared transient and
  surfaces the rest; ``WorkerKilled`` derives from ``BaseException`` so
  it sails through ``except Exception`` handlers and genuinely kills the
  worker thread it targets (the supervisor, not a catch-all, must
  recover).
- **Arming is explicit.** Nothing in this module patches or wraps; the
  tiering engine and checkpoint writer accept an injector and call its
  hooks at their transfer/write sites. ``disarm()`` turns a live
  injector into a no-op (counters keep advancing, so a later re-arm
  stays aligned with the op sequence).

Host-synchronous on purpose (``time.sleep`` emulates slow transfers).
Pure numpy: a fault decision never touches the device. This is the
port's own copy of ``repro.retrieval.faults``, decision for decision
(``tests/test_torch_fault_injection.py`` holds the two together).
"""
from __future__ import annotations

import dataclasses
import threading
import time
import zlib
from dataclasses import dataclass

import numpy as np


class FaultError(RuntimeError):
    """Base class of every injected fault."""


class TransientTransferError(FaultError):
    """A retryable host<->device transfer failure (the emulated link
    dropped this copy; an immediate retry may succeed)."""


class DeviceOOM(FaultError):
    """Device allocator failure on promotion (injected) — remedied by
    evicting, not by waiting."""


class SnapshotKilled(FaultError):
    """The snapshot writer 'process' died mid-write: the ``.tmp``
    directory is left behind exactly as a real crash would leave it."""


class WorkerKilled(BaseException):
    """Injected death of a background worker thread. BaseException on
    purpose: per-item ``except Exception`` recovery must NOT swallow it —
    the thread exits and only the supervisor can bring service back."""


@dataclass(frozen=True)
class FaultPlan:
    """A seeded, declarative fault schedule (see module docstring).

    transfer_fail_rate / transfer_fail_burst
        Each transfer op ("h2d"/"d2h" sites) draws from its site's seeded
        stream; a draw under ``rate`` starts a burst of ``burst``
        consecutive ``TransientTransferError`` ops at that site (burst >
        the engine's retry budget = a permanent failure).
    transfer_fail_ops
        Explicit site-local op indices that fail regardless of rate —
        precise placement for tests.
    slow_transfer_rate / slow_transfer_s
        A draw under ``rate`` pads the transfer with ``slow_transfer_s``
        seconds of injected latency (deadline-pressure fuel).
    kill_worker_at
        Worker-loop op indices at which the worker thread dies
        (``WorkerKilled``).
    oom_at
        "h2d" op indices raising ``DeviceOOM`` on promotion.
    snapshot_kill_after_leaf
        Die (``SnapshotKilled``) after this many snapshot leaves are
        written — leaves the checkpoint ``.tmp`` debris in place. -1
        disables.
    snapshot_bitflip_leaf
        Flip one bit in this leaf's bytes as they hit disk (the recorded
        checksum stays honest, so restore must detect it). -1 disables.
    """
    seed: int = 0
    transfer_fail_rate: float = 0.0
    transfer_fail_burst: int = 1
    transfer_fail_ops: tuple = ()
    slow_transfer_rate: float = 0.0
    slow_transfer_s: float = 0.0
    kill_worker_at: tuple = ()
    oom_at: tuple = ()
    snapshot_kill_after_leaf: int = -1
    snapshot_bitflip_leaf: int = -1

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        """Build a plan from a ``k=v,k=v`` CLI spec (``--fault-plan``).
        Tuple-valued fields take ``+``-joined ints, e.g.
        ``transfer_fail_rate=0.05,kill_worker_at=3+9,seed=7``."""
        kinds = {f.name: f.type for f in dataclasses.fields(cls)}
        kw: dict = {}
        for part in filter(None, (p.strip() for p in spec.split(","))):
            if "=" not in part:
                raise ValueError(f"fault-plan entry {part!r} is not k=v")
            k, v = part.split("=", 1)
            k = k.strip()
            if k not in kinds:
                raise ValueError(
                    f"unknown fault-plan field {k!r} "
                    f"(known: {', '.join(sorted(kinds))})")
            if kinds[k] == "tuple":
                kw[k] = tuple(int(x) for x in v.split("+") if x)
            elif kinds[k] == "float":
                kw[k] = float(v)
            else:
                kw[k] = int(v)
        return cls(**kw)


class FaultInjector:
    """Live counters + PRNG streams realising a ``FaultPlan``.

    One injector can be shared by every site it arms (the tiering engine
    calls ``fire`` from both the worker thread and the serving thread);
    counter updates are locked, and each site draws from its own
    ``(seed, site)``-keyed stream so the n-th op at a site sees the same
    draw regardless of what other sites did in between.
    """

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self.armed = True
        self.events: list = []            # (site, op_index, kind)
        self._lock = threading.Lock()
        self._n: dict = {}                # site -> next op index
        self._burst: dict = {}            # site -> transient failures left
        self._streams: dict = {}          # (site, channel) -> Generator

    # -- internals -----------------------------------------------------

    def _draw(self, site: str, channel: str) -> float:
        key = (site, channel)
        rng = self._streams.get(key)
        if rng is None:
            rng = np.random.default_rng(
                [self.plan.seed, zlib.crc32(f"{channel}:{site}".encode())])
            self._streams[key] = rng
        return float(rng.random())

    def _record(self, site: str, n: int, kind: str) -> None:
        self.events.append((site, n, kind))

    # -- hooks ---------------------------------------------------------

    def fire(self, site: str) -> None:
        """One operation at ``site``: advance its counter and inject
        whatever the plan schedules for that index. ``site`` is one of
        "h2d" / "d2h" (tier transfers) or "worker" (worker-loop items)."""
        p = self.plan
        with self._lock:
            n = self._n.get(site, 0)
            self._n[site] = n + 1
            if not self.armed:
                return
            if site == "worker":
                if n in p.kill_worker_at:
                    self._record(site, n, "kill")
                    raise WorkerKilled(f"worker op {n}")
                return
            slow = (p.slow_transfer_rate
                    and self._draw(site, "slow") < p.slow_transfer_rate)
            if site == "h2d" and n in p.oom_at:
                self._record(site, n, "oom")
                raise DeviceOOM(f"injected OOM at h2d op {n}")
            fail = n in p.transfer_fail_ops
            burst_left = self._burst.get(site, 0)
            if burst_left > 0:
                self._burst[site] = burst_left - 1
                fail = True
            elif (not fail and p.transfer_fail_rate
                    and self._draw(site, "fail") < p.transfer_fail_rate):
                fail = True
                self._burst[site] = max(0, p.transfer_fail_burst - 1)
        # sleeps happen outside the lock: a slow transfer must not
        # serialise the other thread's fault bookkeeping
        if slow and not fail:
            self._record(site, n, "slow")
            time.sleep(p.slow_transfer_s)
        if fail:
            self._record(site, n, "transfer_fail")
            raise TransientTransferError(f"injected {site} failure, op {n}")

    def corrupt_snapshot_leaf(self, index: int, a: np.ndarray) -> np.ndarray:
        """The bytes leaf ``index`` actually writes to disk: the original
        array, or a one-bit-flipped copy when the plan schedules it
        (checksums are computed on the TRUE bytes before this hook, so
        the flip models silent media corruption)."""
        if (not self.armed or index != self.plan.snapshot_bitflip_leaf
                or a.size == 0):
            return a
        self._record("snapshot", index, "bitflip")
        flipped = np.ascontiguousarray(a).copy()
        flat = flipped.view(np.uint8).reshape(-1)
        flat[0] ^= 1
        return flipped

    def snapshot_leaf_written(self, index: int) -> None:
        """Called after leaf ``index`` lands in the .tmp zip; kills the
        writer there when scheduled (crash emulation — no cleanup)."""
        if self.armed and index == self.plan.snapshot_kill_after_leaf:
            self._record("snapshot", index, "kill")
            raise SnapshotKilled(
                f"snapshot writer killed after leaf {index}")

    # -- control / introspection ----------------------------------------

    def disarm(self) -> None:
        """Stop injecting (counters keep advancing so op indices stay
        aligned with the underlying operation sequence)."""
        self.armed = False

    def counts(self) -> dict:
        """Injected-fault totals by kind (for tests and ledgers)."""
        out: dict = {}
        for _, _, kind in self.events:
            out[kind] = out.get(kind, 0) + 1
        return out


def as_injector(faults) -> FaultInjector | None:
    """Normalise the ``faults=`` argument surfaces accept: None, a
    ``FaultPlan`` (wrapped fresh) or an already-live ``FaultInjector``."""
    if faults is None:
        return None
    if isinstance(faults, FaultInjector):
        return faults
    if isinstance(faults, FaultPlan):
        return FaultInjector(faults)
    raise TypeError(f"faults must be FaultPlan | FaultInjector | None, "
                    f"got {type(faults).__name__}")
