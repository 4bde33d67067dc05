"""Tiered segment storage: corpora bigger than device memory, plus
snapshot/restore.

A ``SegmentedStore`` that must sit wholly in device memory caps the corpus
at the card's memory. This module lifts that cap:

- **residency tiers** — hot segments stay on the device, cold segments
  spill to host memory with the SAME keys, shapes and dtypes
  (``Segment.tier``). On the card the host tier is pinned CPU tensors,
  one set per segment, allocated at the segment's first demotion and
  reused by every later one (pinning ~140 MB costs milliseconds, which
  would dominate a demotion paid each time). Residency is placement,
  never shape: ``SegmentedStore.layout_key()`` ignores the tier and the
  per-segment search functions take the segment's first global slot as a
  plain argument, so tier churn builds nothing.
- **traffic-keyed promotion/demotion** — an LRU over segment touches
  under a byte ``hbm_budget``. A promotion copies the pinned host
  tensors to fresh device tensors with ``copy_(non_blocking=True)`` on
  the engine's own copy stream and records an event there; the thread
  that promotes waits on that event before ``tier_swap``, so a swap
  commits only after the whole copy has landed. A demotion waits for the
  compute stream's pending writes, copies into the segment's pinned
  buffers on the copy stream, waits on its event, and only then lets go
  of the device tensors. Copies are bitwise, so tiered results equal the
  fully resident search. Every swap goes through
  ``SegmentedStore.tier_swap``, which bumps the store generation (the
  frontend's result cache drops its entries).
- **the caching allocator** — ``_release`` follows a kernel's launch,
  not its end, so a segment may be demoted while a scan queued on the
  compute stream still reads it, and torch's allocator (unlike JAX's
  buffers) does not wait for that scan before it reuses freed memory. A
  demotion's copy therefore first waits for the compute stream, and
  every promoted tensor, allocated on the copy stream, is marked with
  ``record_stream`` for the compute stream: no block goes to a later
  promotion before the compute stream's work queued at its free has
  finished, whoever frees it.
- **async prefetch** — a background worker thread promotes the segments
  that ``prefetch(scope)`` (or the search loop, one segment ahead) asks
  for; its copies run on the copy stream under the current segment's
  kernels.
- **snapshot/restore** — ``snapshot``/``restore_store`` persist the whole
  ``SegmentedStore`` (tensors, slot maps, tenant/filter/IVF companions,
  router policy) through ``training.checkpoint``, in ``repro``'s format:
  a snapshot written by either package restores in the other, bit for
  bit.

On a CPU store (the tests) there is no pinning and no stream: the
"device" tier is the store's CPU tensors, a promotion is a ``clone()``
and a demotion hands the tensors to the host tier as they are. Which of
the two an engine does follows from the store's device.

``TieredEngine.search`` runs the SAME per-segment code as the resident
cascade (``engine._segment_stage0``/``_segment_rerank`` through
``engine.make_segment_scan_fn``/``make_segment_rerank_fn``, so the same
kernels) and folds segments with the same stable top-k merge and
elementwise max, so its results are bit for bit
``Retriever.search``'s. On a mesh (``Retriever(mesh=...)``) a segment
moves between the tiers slab by slab, each slab to and from its own
mesh device, and ``search`` promotes the whole scope, then runs it as one
joint sharded cascade (``_search_mesh``: the function
``engine.make_segmented_search_fn`` builds for a resident search), so
its results are bit for bit the resident mesh search's; the deadline
path is single-device only (on a mesh the deadline is ignored). A
snapshot holds each segment whole (its slabs gathered) with the store's
``n_shards``; ``restore_store(mesh=...)`` places it on a mesh.
"""
from __future__ import annotations

import queue
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.multistage import top_k
from repro_torch.launch.mesh import home_device
from repro_torch.retrieval import engine
from repro_torch.retrieval import faults as FLT
from repro_torch.retrieval import routing as RT
from repro_torch.retrieval.segments import Segment, SegmentedStore
from repro_torch.retrieval.store import (FILTER_KEY, as_filter_arrays,
                                         filter_words, snapshot_entries)
from repro_torch.retrieval.topk import merge_topk
from repro_torch.training import checkpoint as CKPT

SNAPSHOT_KIND = "segmented_store"


class TierError(RuntimeError):
    """A tier transfer failed PERMANENTLY (bounded retries exhausted, or
    no recovery path). Waiters get this typed error, never a hang and
    never a raw exception from another thread's context."""


@dataclass(frozen=True)
class DegradePolicy:
    """How a deadline-budgeted search degrades instead of missing.

    skip_cold
        Serve from resident segments only once the remaining budget
        cannot cover the next cold segment's promotion: the segment is
        skipped (counted in ``TieredResult.skipped_segments``) and the
        result is flagged ``degraded=True``. With False, the deadline is
        advisory (nothing is skipped; results stay exact).
    min_segments
        Always scan at least this many scope segments — even past the
        deadline a request gets a real (if partial) answer.
    stages_degraded
        Optional cheaper cascade used when the deadline is ALREADY blown
        on arrival; results from it are flagged degraded even when no
        segment is skipped. None keeps the request's own stages.
    """
    skip_cold: bool = True
    min_segments: int = 1
    stages_degraded: tuple | None = None


@dataclass
class TieredResult:
    """A tiered search answer plus its degradation provenance.

    Iterates as the ``(scores, ids)`` pair ``Retriever.search`` returns
    (scores a tensor on the device, ids numpy page ids). The
    exact-or-flagged invariant: ``degraded=False`` means bit-for-bit
    equality with the fully resident search over the same scope;
    ``degraded=True`` means ``skipped_segments`` scope segments (or a
    cheaper cascade) were dropped to meet the deadline — partial, but
    every returned id carries its exact score."""
    scores: torch.Tensor
    ids: np.ndarray
    degraded: bool = False
    skipped_segments: int = 0

    def __iter__(self):
        yield self.scores
        yield self.ids


# ---------------------------------------------------------------------------
# combine steps (the joint cascade's closing ops, one segment at a time)
# ---------------------------------------------------------------------------

def _merge_pair(av, ai, bv, bi, k: int) -> tuple:
    """Fold one segment's (vals, ids) into the running stage-0 top-k — the
    sequential twin of the joint cascade's concat-then-merge: the stable
    select keeps earlier segments first on ties, as ``merge_topk`` over
    the whole concatenation does."""
    return merge_topk(torch.cat([av, bv], dim=1), torch.cat([ai, bi], dim=1),
                      k)


def _max_scores(a, b):
    """Combine per-segment rerank scores: each candidate is real in
    exactly one segment (NEG everywhere else), so elementwise max is the
    owner's score, and max is exact, so the fold is bit for bit the
    joint cascade's."""
    return torch.maximum(a, b)


def _select_stage(s_all, cand, k: int) -> tuple:
    """Finish one rerank stage: top-k over the combined scores, candidates
    gathered along (the joint cascade's closing ops)."""
    v, sel = top_k(s_all, k)
    return v, torch.gather(cand, 1, sel)


# ---------------------------------------------------------------------------
# snapshot / restore
# ---------------------------------------------------------------------------

def snapshot(store: SegmentedStore, directory: str, *,
             step: int | None = None, keep: int = 3,
             faults=None) -> str:
    """Persist a whole ``SegmentedStore`` under ``directory``.

    The tensors flow through ``training.checkpoint.save`` (atomic
    tmp+rename, keep-last-k, one leaf on the host at a time, bfloat16 as
    bit patterns, a CRC32 per leaf named ``seg<i>/<key>``); the tag
    words are written as the uint32 words ``repro`` stores. Everything
    else — per-segment key order (``store.snapshot_entries``),
    capacities, fills, slot maps, tiers, IVF ``RouteState``, the router
    policy, the store's scalars (``n_shards`` among them) — rides the
    checkpoint meta, in ``repro``'s layout. Host-tier segments persist
    from host memory. A segment on a mesh is written whole, each leaf
    gathered from the slabs onto the host when its turn comes.
    ``step`` defaults to the store generation. ``faults`` (a
    ``faults.FaultPlan`` or ``FaultInjector``) arms the writer's crash
    and corruption emulation."""
    def leaf(seg, k):
        v = seg.tensor(k, "cpu")
        return v.numpy().view(np.uint32) if k == FILTER_KEY else v

    seg_meta, leaf_names, order = [], [], []
    for si, seg in enumerate(store.segments):
        keys = [k for k, _ in snapshot_entries(seg.slabs[0])]
        order += [(seg, k) for k in keys]
        leaf_names += [f"seg{si}/{k}" for k in keys]
        seg_meta.append({
            "keys": keys,
            "capacity": seg.capacity,
            "n_docs": seg.n_docs,
            "doc_ids": np.asarray(seg.doc_ids).tolist(),
            "tier": seg.tier,
            "routing": None if seg.routing is None else {
                "fills": np.asarray(seg.routing.fills).tolist(),
                "drift": int(seg.routing.drift)},
        })
    meta = {
        "kind": SNAPSHOT_KIND,
        "store_dtype": store.store_dtype,
        "n_shards": store.n_shards,
        "next_id": store.next_id,
        "filter_words": store.filter_words,
        "generation": store.generation,
        "router": None if store.router is None else {
            "n_clusters": store.router.n_clusters,
            "cluster_capacity": store.router.cluster_capacity,
            "iters": store.router.iters,
            "drift_threshold": store.router.drift_threshold},
        "segments": seg_meta,
    }
    step = store.generation if step is None else step
    # one leaf on the host at a time: the save pulls them one by one
    return CKPT.save(directory, step, (leaf(seg, k) for seg, k in order),
                     meta=meta, keep=keep, leaf_names=leaf_names,
                     faults=FLT.as_injector(faults))


def restore_store(directory: str, *, mesh=None, step: int | None = None,
                  device=None, place: bool = True) -> SegmentedStore:
    """Rebuild a ``SegmentedStore`` from a ``snapshot`` directory (one
    written by this package or by ``repro``), bit for bit: tensors
    through the checkpoint's bit-pattern round trip, slot maps, tenants,
    filters, IVF companions and their ``RouteState``, and ``n_shards``
    from the meta. Every segment comes back resident ("device" tier) on
    ``device`` ("cuda" by default) or, with ``mesh`` (and ``place``),
    placed on the mesh (routing companions on every shard): restore
    doubles as a restart onto another topology, and a store saved from a
    mesh restores onto one device as well. With ``mesh`` and
    ``place=False`` the segments stay whole on the mesh's first device,
    and a mesh search splits them on each call. Wrap the store in a
    ``TieredEngine`` to impose a budget again."""
    dev = home_device(mesh, device)
    if step is None:
        step = CKPT.latest_step(directory)
    ckpt_meta = CKPT.load_meta(directory, step)
    m = ckpt_meta["meta"]
    if m.get("kind") != SNAPSHOT_KIND:
        raise ValueError(
            f"{directory} is not a store snapshot (kind={m.get('kind')!r})")
    leaves, _ = CKPT.restore(directory, step=step, device=dev)
    out = SegmentedStore([], m["store_dtype"], next_id=int(m["next_id"]),
                         filter_words=int(m["filter_words"]),
                         n_shards=int(m.get("n_shards", 1)))
    if m["router"] is not None:
        out.router = RT.RoutingPolicy(**m["router"])
    it = iter(leaves)
    for sm in m["segments"]:
        seg = Segment(({k: next(it) for k in sm["keys"]},),
                      int(sm["capacity"]), int(sm["n_docs"]),
                      np.asarray(sm["doc_ids"], np.int64))
        if sm["routing"] is not None:
            seg.routing = RT.RouteState(
                fills=np.asarray(sm["routing"]["fills"], np.int64),
                drift=int(sm["routing"]["drift"]))
        out.segments.append(seg)
    if mesh is not None and place:
        out.place_on(mesh)
    out.generation = int(m["generation"])
    return out


# ---------------------------------------------------------------------------
# the tiered engine
# ---------------------------------------------------------------------------

class _PendingOp:
    """One in-flight async promotion: completion event + the worker's
    PER-OP error (a shared error slot would let concurrent failures
    overwrite each other and surface on the wrong waiter)."""
    __slots__ = ("event", "error")

    def __init__(self):
        self.event = threading.Event()
        self.error: Exception | None = None


class TieredEngine:
    """Budgeted residency + per-segment pipelined search over a Retriever.

    ``hbm_budget`` caps the BYTES of device-resident segment tensors; the
    rest of the corpus lives in host memory. Searches take an optional
    ``scope`` (segment indices — the unit of traffic locality: a
    collection, a tenant's segments); touched segments promote, LRU
    segments demote. ``prefetch`` is the async half: hand it the scopes a
    scheduler expects next and the worker's copies land under the
    current query's kernels.

    The budget is a soft cap at the margin: a promotion that cannot make
    room (every other resident segment is pinned by an in-flight scan)
    overshoots and counts ``stats["overflow"]`` rather than deadlocking.

    ``link_bw`` (bytes/s) pads every transfer to ``bytes / link_bw`` of
    wall time, an emulated link for the CPU tests (a CPU "transfer" is a
    clone); leave it None on the card, whose times are the real link's.

    Thread model: ONE background worker promotes asynchronously; public
    methods are safe to call from the serving thread, whose current CUDA
    stream at construction is the compute stream the kernels run on.
    ``close()`` (or use as a context manager) stops the worker."""

    def __init__(self, retriever, hbm_budget: int, prefetch: bool = True,
                 link_bw: float | None = None, faults=None,
                 max_retries: int = 3, retry_backoff_s: float = 0.002):
        self.r = retriever
        self.store: SegmentedStore = retriever.store
        self.device = retriever.device
        self.hbm_budget = int(hbm_budget)
        self.prefetch_enabled = bool(prefetch)
        self.link_bw = float(link_bw) if link_bw else None
        self.max_retries = int(max_retries)
        self.retry_backoff_s = float(retry_backoff_s)
        self._faults = FLT.as_injector(faults)
        self._cuda = self.device.type == "cuda"
        # the device of each slab of a segment, in mesh order
        mesh = retriever.mesh
        self._slab_devices = ((self.device,) if mesh is None
                              else tuple(mesh.devices.flat))
        self._copy = self._compute = None
        if self._cuda:                             # a copy stream per card
            self._copy = {d: torch.cuda.Stream(d)
                          for d in set(self._slab_devices)}
            self._compute = {d: torch.cuda.current_stream(d)
                             for d in self._copy}
        self._host: dict = {}          # (seg_i, slab) -> pinned tensors
        self._lock = threading.RLock()
        self._lru: OrderedDict = OrderedDict()     # resident seg_i -> True
        self._resident_bytes = 0
        self._pins: dict = {}                      # seg_i -> pin count
        self._pending: dict = {}                   # seg_i -> _PendingOp
        self._queue: queue.Queue = queue.Queue()
        self._closed = False
        self._promote_ema = 0.0                    # s, recent promote cost
        self._fns: dict = {}
        self.stats = {"promotions": 0, "demotions": 0, "bytes_h2d": 0,
                      "bytes_d2h": 0, "hits": 0, "misses": 0,
                      "overflow": 0, "wait_s": 0.0, "retries": 0,
                      "transfer_errors": 0, "worker_restarts": 0,
                      "oom_evictions": 0, "deadline_skips": 0,
                      "degraded": 0}
        for i, seg in enumerate(self.store.segments):
            if seg.tier == "device":
                self._lru[i] = True
                self._resident_bytes += seg.nbytes
        self._worker = threading.Thread(
            target=self._run, name="tiering-worker", daemon=True)
        self._worker.start()
        self.enforce_budget()

    # -- lifecycle -----------------------------------------------------

    def arm(self, faults) -> FLT.FaultInjector | None:
        """(Re)arm fault injection on this engine's transfer/worker
        sites; ``None`` disarms. Returns the live injector."""
        self._faults = FLT.as_injector(faults)
        return self._faults

    def close(self) -> None:
        with self._lock:
            self._closed = True
        if self._worker.is_alive():
            self._queue.put(None)
            self._worker.join(timeout=30)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- residency bookkeeping ------------------------------------------

    def resident(self) -> tuple:
        """Device-resident segment indices, LRU order (oldest first)."""
        with self._lock:
            return tuple(self._lru)

    @property
    def resident_bytes(self) -> int:
        return self._resident_bytes

    def enforce_budget(self) -> None:
        """Demote LRU segments until the budget holds (used at
        construction and after mutations grow the resident set)."""
        while True:
            with self._lock:
                victim = self._pick_victim()
                if victim is None:
                    return
            self._demote(victim)

    def _pick_victim(self):
        """Under ``self._lock``: the LRU unpinned resident segment, or
        None when the budget already holds (or nothing is evictable)."""
        if self._resident_bytes <= self.hbm_budget:
            return None
        for i in self._lru:
            if not self._pins.get(i):
                return i
        self.stats["overflow"] += 1
        return None

    # -- transfers -------------------------------------------------------

    def _to_host(self, i: int, slabs: tuple) -> tuple:
        """Segment ``i``'s slabs in host memory, bitwise. On the card:
        copied into the segment's pinned buffers (allocated once, reused)
        on the copy stream of each slab's device, after that device's
        compute stream's pending writes, and waited for; the caller may
        drop the device tensors on return. On the CPU the tensors
        themselves are the host tier."""
        if not self._cuda:
            return tuple(dict(slab) for slab in slabs)
        out, events = [], []
        for r, slab in enumerate(slabs):
            bufs = self._host.get((i, r))
            if bufs is None:
                bufs = {k: torch.empty(v.shape, dtype=v.dtype,
                                       pin_memory=True)
                        for k, v in slab.items()}
                self._host[(i, r)] = bufs
            dev = self._slab_devices[r]
            copy = self._copy[dev]
            copy.wait_stream(self._compute[dev])
            with torch.cuda.stream(copy):
                for k, v in slab.items():
                    bufs[k].copy_(v, non_blocking=True)
            events.append(copy.record_event())
            out.append(dict(bufs))
        for e in events:
            e.synchronize()
        return tuple(out)

    def _to_device_tier(self, slabs: tuple) -> tuple:
        """Fresh device tensors holding ``slabs`` (host tier; each slab
        going to its mesh device) bitwise. On the card: allocated and
        filled on the device's copy stream, waited for, and marked in use
        by its compute stream (``record_stream``) so the allocator reuses
        none of them before the compute stream's work queued at their
        free has finished. On the CPU a clone."""
        if not self._cuda:
            return tuple({k: v.clone() for k, v in slab.items()}
                         for slab in slabs)
        out, events = [], []
        for r, slab in enumerate(slabs):
            d = self._slab_devices[r]
            with torch.cuda.stream(self._copy[d]):
                dev = {k: torch.empty(v.shape, dtype=v.dtype, device=d)
                       for k, v in slab.items()}
                for k, v in slab.items():
                    dev[k].copy_(v, non_blocking=True)
            events.append(self._copy[d].record_event())
            out.append(dev)
        for e in events:
            e.synchronize()
        for r, dev in enumerate(out):
            for t in dev.values():
                t.record_stream(self._compute[self._slab_devices[r]])
        return tuple(out)

    def _pace(self, n_bytes: int, t0: float) -> None:
        """Emulated-link pacing: hold this thread until the transfer has
        taken at least ``n_bytes / link_bw`` seconds (no-op without
        ``link_bw``). Sleeps release the GIL, so a paced worker transfer
        still overlaps the serving thread."""
        if self.link_bw:
            time.sleep(max(0.0, n_bytes / self.link_bw
                           - (time.monotonic() - t0)))

    def _demote(self, i: int) -> None:
        """Spill segment ``i`` to host memory. Transient transfer failures
        retry with bounded exponential backoff; exhaustion raises
        ``TierError``. The swap commits via ``tier_swap`` only after the
        copy fully succeeded, so a failed attempt leaves the segment
        resident and consistent."""
        seg = self.store.segments[i]
        last = None
        delay = self.retry_backoff_s
        for attempt in range(self.max_retries + 1):
            try:
                t0 = time.monotonic()
                if self._faults is not None:
                    self._faults.fire("d2h")
                host = self._to_host(i, seg.slabs)
                self._pace(seg.nbytes, t0)
            except FLT.TransientTransferError as e:
                last = e
                if attempt == self.max_retries:
                    break
                self.stats["retries"] += 1
                time.sleep(delay)
                delay = min(delay * 2, 0.1)
                continue
            with self._lock:
                if i not in self._lru:         # raced with another demote
                    return
                n = seg.nbytes
                self.store.tier_swap(i, host, "host")
                del self._lru[i]
                self._resident_bytes -= n
                self.stats["demotions"] += 1
                self.stats["bytes_d2h"] += n
            return
        self.stats["transfer_errors"] += 1
        raise TierError(
            f"demotion of segment {i} failed after "
            f"{self.max_retries + 1} attempts") from last

    def _make_room(self, i: int, need: int) -> None:
        """Demote LRU victims until ``need`` fits (or nothing unpinned is
        left — the budget overshoots rather than deadlocking)."""
        while True:
            with self._lock:
                if self._resident_bytes + need <= self.hbm_budget:
                    return
                victim = None
                for j in self._lru:
                    if not self._pins.get(j) and j != i:
                        victim = j
                        break
                if victim is None:
                    self.stats["overflow"] += 1
                    return
            self._demote(victim)

    def _oom_victim(self, i: int):
        """Under fault pressure: one more unpinned resident segment to
        evict when the allocator (not the budget) says no."""
        with self._lock:
            for j in self._lru:
                if not self._pins.get(j) and j != i:
                    return j
        return None

    def _promote(self, i: int) -> None:
        """Host->device transfer of segment ``i`` plus the room-making
        demotions it needs. Runs on the worker thread (prefetch) or
        inline (synchronous acquire).

        Transient transfer errors retry with bounded exponential backoff;
        an injected device OOM retries after evicting one more unpinned
        victim; exhaustion raises ``TierError``. The swap commits only
        after the copy's event has been waited for, so any failed
        attempt leaves the segment host-tier and every residency
        structure consistent; the promotion's time, taken after that
        wait, feeds ``_promote_estimate``."""
        with self._lock:
            if i in self._lru:
                self._lru.move_to_end(i)
                return
            seg = self.store.segments[i]
            need = seg.nbytes
        # make room first so the device never holds budget + need
        self._make_room(i, need)
        last = None
        delay = self.retry_backoff_s
        for attempt in range(self.max_retries + 1):
            try:
                t0 = time.monotonic()
                if self._faults is not None:
                    self._faults.fire("h2d")
                dev = self._to_device_tier(seg.slabs)
                self._pace(need, t0)
            except (FLT.TransientTransferError, FLT.DeviceOOM) as e:
                last = e
                if isinstance(e, FLT.DeviceOOM):
                    victim = self._oom_victim(i)
                    if victim is not None:
                        self._demote(victim)
                        self.stats["oom_evictions"] += 1
                if attempt == self.max_retries:
                    break
                self.stats["retries"] += 1
                if isinstance(e, FLT.TransientTransferError):
                    time.sleep(delay)
                    delay = min(delay * 2, 0.1)
                continue
            dt = time.monotonic() - t0
            with self._lock:
                self.store.tier_swap(i, dev, "device")
                self._lru[i] = True
                self._lru.move_to_end(i)
                self._resident_bytes += need
                self.stats["promotions"] += 1
                self.stats["bytes_h2d"] += need
                self._promote_ema = dt if not self._promote_ema \
                    else 0.8 * self._promote_ema + 0.2 * dt
            return
        self.stats["transfer_errors"] += 1
        raise TierError(
            f"promotion of segment {i} failed after "
            f"{self.max_retries + 1} attempts") from last

    def _promote_estimate(self, i: int) -> float:
        """Expected seconds to promote segment ``i``: exact under the
        emulated link, else an EMA of recent promotions (0.0 until one
        lands — optimistic, so an unknown-cost transfer is attempted
        rather than skipped)."""
        if self.link_bw:
            return self.store.segments[i].nbytes / self.link_bw
        return self._promote_ema

    # -- async worker ----------------------------------------------------

    def _run(self) -> None:
        while True:
            i = self._queue.get()
            if i is None:
                return
            try:
                if self._faults is not None:
                    self._faults.fire("worker")
            except FLT.WorkerKilled:
                # injected thread death: exit WITHOUT finishing item i —
                # its waiters (and everything queued behind it) are
                # stranded until the supervisor restarts us
                return
            err = None
            try:
                self._promote(i)                # has its own retry budget
            except Exception as e:              # surfaced to THIS waiter
                err = e
            self._finish(i, err)

    def _finish(self, i: int, err: Exception | None) -> None:
        with self._lock:
            op = self._pending.pop(i, None)
        if op is not None:
            op.error = err
            op.event.set()

    def _ensure_worker(self) -> None:
        """Supervisor: if the worker thread died (injected kill, or any
        escape from its loop), restart it and re-enqueue every pending
        promotion so stranded waiters complete. Re-enqueueing an item the
        old worker had already finished is harmless — ``_promote`` is
        idempotent on resident segments and ``_finish`` tolerates an
        already-popped op. Swaps commit atomically under the lock, so a
        mid-transfer death never leaves half a segment resident."""
        with self._lock:
            if self._closed or self._worker.is_alive():
                return
            self.stats["worker_restarts"] += 1
            stranded = list(self._pending)
            self._worker = threading.Thread(
                target=self._run, name="tiering-worker", daemon=True)
            self._worker.start()
            for i in stranded:
                self._queue.put(i)

    def _wait_op(self, op: _PendingOp) -> None:
        """Wait for an async promotion without ever hanging on a dead
        worker: poll with a short timeout and run the supervisor between
        polls — a restart re-enqueues the op, whose event then fires."""
        while not op.event.wait(0.05):
            self._ensure_worker()

    def _request(self, i: int):
        """Enqueue an async promotion of segment ``i`` (idempotent);
        returns the in-flight ``_PendingOp``, or None when already
        resident."""
        self._ensure_worker()
        with self._lock:
            if i in self._lru:
                self._lru.move_to_end(i)
                return None
            op = self._pending.get(i)
            if op is None:
                op = _PendingOp()
                self._pending[i] = op
                self._queue.put(i)
            return op

    def prefetch(self, scope) -> None:
        """Async-promote the segments a scheduler predicts are needed
        next. Never blocks; the worker's copies overlap the caller's
        kernels."""
        if not self.prefetch_enabled:
            return
        for i in scope:
            self._request(int(i))

    def _acquire(self, i: int, overlap: bool) -> None:
        """Make segment ``i`` resident and pin it until ``_release``.
        ``overlap=True`` waits on the worker (the transfer was ideally
        prefetched and already done); ``overlap=False`` is the
        synchronous-fetch baseline — the transfer runs inline, fully
        exposed on the caller's critical path.

        Never hangs and never leaks: waits are supervised, a worker-side
        failure is retried once inline on this thread, and a permanent
        failure raises ``TierError`` with the pin released."""
        t0 = time.perf_counter()
        with self._lock:
            resident = i in self._lru
            if resident:
                self._lru.move_to_end(i)
                self.stats["hits"] += 1
            else:
                self.stats["misses"] += 1
            self._pins[i] = self._pins.get(i, 0) + 1
        if not resident:
            try:
                if overlap:
                    op = self._request(i)
                    if op is not None:
                        self._wait_op(op)
                    if op is not None and op.error is not None:
                        # the worker already spent its retry budget; one
                        # last inline attempt on the waiter's thread
                        self._promote(i)
                    else:
                        with self._lock:
                            still_missing = i not in self._lru
                        if still_missing:        # worker raced/failed
                            self._promote(i)
                else:
                    self._ensure_worker()
                    with self._lock:
                        op = self._pending.get(i)
                    if op is not None:           # a stray prefetch owns it
                        self._wait_op(op)
                    self._promote(i)
            except BaseException:
                self._release(i)                 # failed acquire: no pin
                raise
            self.stats["wait_s"] += time.perf_counter() - t0

    def _release(self, i: int) -> None:
        with self._lock:
            left = self._pins.get(i, 0) - 1
            if left > 0:
                self._pins[i] = left
            else:
                self._pins.pop(i, None)

    def _try_acquire(self, i: int, deadline: float | None) -> bool:
        """Deadline-budgeted acquire: pin and return True when segment
        ``i`` is resident or its promotion fits the remaining budget;
        return False (nothing pinned) when promoting it would blow the
        deadline — the degraded search skips it."""
        with self._lock:
            if i in self._lru:
                self._lru.move_to_end(i)
                self.stats["hits"] += 1
                self._pins[i] = self._pins.get(i, 0) + 1
                return True
        if deadline is not None:
            budget = deadline - time.monotonic()
            if budget <= 0 or self._promote_estimate(i) > budget:
                self.stats["deadline_skips"] += 1
                return False
        self._acquire(i, overlap=False)
        return True

    # -- per-segment function cache ---------------------------------------

    def _seg_fn(self, kind: str, stages: tuple, si_stage: int, seg_i: int,
                layout):
        """The per-segment function for ``(kind, stages, stage, layout of
        the segment)``, built once (``tracing`` counts each build)."""
        key = (kind, stages, si_stage, layout[seg_i])
        fn = self._fns.get(key)
        if fn is None:
            cap = self.store.segments[seg_i].capacity
            if kind == "scan":
                fn = engine.make_segment_scan_fn(stages, cap)
            else:
                fn = engine.make_segment_rerank_fn(stages, si_stage, cap)
            self._fns[key] = fn
        return fn

    # -- search ------------------------------------------------------------

    def search(self, q, q_mask=None, *, stages: tuple, scope=None,
               filter=None, overlap: bool | None = None,
               deadline_ms: float | None = None,
               degrade: DegradePolicy | None = None) -> TieredResult:
        """Tiered cascade -> ``TieredResult`` (iterates as ``(scores
        [B,k], stable page ids [B,k])``, as ``Retriever.search``).

        ``scope`` restricts the search to those segment indices (default:
        the whole corpus) — the unit of traffic locality the LRU keys on.
        ``overlap=None`` follows the engine's prefetch setting; False is
        the synchronous-fetch baseline. Results are bit for bit the fully
        resident search over the same scope (the same per-segment code,
        exact combines, NEG-filler ids masked to -1 as
        ``Retriever.search`` does).

        ``deadline_ms`` gives the request a wall budget: when promoting
        the next cold segment cannot fit the remaining budget, the
        engine degrades per ``degrade`` (default ``DegradePolicy()``)
        instead of blocking — cold segments are skipped and the result
        comes back ``degraded=True`` with the skip count (a non-degraded
        result is ALWAYS the resident search's answer). On a mesh the
        scope runs as one joint sharded cascade (``_search_mesh``) and
        the deadline is ignored."""
        t_entry = time.monotonic()
        store = self.store
        stages = tuple(stages)
        scope = tuple(range(len(store.segments))) if scope is None \
            else tuple(int(s) for s in scope)
        if not scope:
            raise ValueError("empty scope")
        overlap = self.prefetch_enabled if overlap is None else bool(overlap)
        q = torch.as_tensor(q).to(self.device)
        if q_mask is None:
            q_mask = torch.ones(q.shape[:2], dtype=torch.bool,
                                device=self.device)
        else:
            q_mask = torch.as_tensor(q_mask).to(self.device).bool()
        fspec = as_filter_arrays(
            filter, filter_words(store.segments[scope[0]].slabs[0]),
            self.device)
        if self.r.mesh is not None:
            return self._search_mesh(q, q_mask, stages, scope, fspec,
                                     overlap)
        if deadline_ms:
            return self._search_degraded(
                q, q_mask, stages, scope, fspec,
                t_entry + deadline_ms / 1e3, degrade or DegradePolicy())
        offs = engine._offsets(store.capacities)
        caps = store.capacities
        layout = store.layout_key()
        k0 = stages[0].k

        # stage 0: per-segment scans, merged as each lands; the prefetch
        # of segment j+1 is enqueued BEFORE segment j's scan so the
        # worker's copy runs under it
        acc_v = acc_i = None
        width = 0
        self._acquire(scope[0], overlap)
        for j, si in enumerate(scope):
            nxt = scope[j + 1] if j + 1 < len(scope) else None
            if overlap and nxt is not None:
                self._request(nxt)
            fn = self._seg_fn("scan", stages, 0, si, layout)
            v, i = fn(store.segments[si].vectors, q, q_mask, fspec,
                      offs[si])
            self._release(si)
            if acc_v is None:
                acc_v, acc_i = v, i
                width = caps[si]
            else:
                width += caps[si]
                acc_v, acc_i = _merge_pair(acc_v, acc_i, v, i,
                                           min(k0, width))
            if nxt is not None:
                self._acquire(nxt, overlap)
        scores, cand = acc_v, acc_i

        # rerank stages: the same pipeline; each segment scores the
        # global candidate set (NEG for non-owned) and the max-fold
        # recovers the owner's score
        for si_stage, stage in enumerate(stages[1:], start=1):
            s_all = None
            self._acquire(scope[0], overlap)
            for j, si in enumerate(scope):
                nxt = scope[j + 1] if j + 1 < len(scope) else None
                if overlap and nxt is not None:
                    self._request(nxt)
                fn = self._seg_fn("rerank", stages, si_stage, si, layout)
                s = fn(store.segments[si].vectors, q, q_mask, fspec,
                       offs[si], cand)
                self._release(si)
                s_all = s if s_all is None else _max_scores(s_all, s)
                if nxt is not None:
                    self._acquire(nxt, overlap)
            scores, cand = _select_stage(s_all, cand,
                                         min(stage.k, cand.shape[1]))
        return TieredResult(*self._translate(scores, cand))

    def _search_degraded(self, q, q_mask, stages, scope, fspec,
                         deadline: float, policy: DegradePolicy
                         ) -> TieredResult:
        """Deadline-budgeted cascade: scan scope segments in order,
        skipping cold ones whose promotion would blow the remaining
        budget (``_try_acquire``); the scanned set is an order-preserving
        subsequence of ``scope``, so a run that skips nothing folds in
        the resident order and stays bit for bit (degraded=False).

        Acquires are synchronous here — prefetching a segment the
        deadline may force us to skip would waste link time and evict
        hot residents. Rerank stages revisit only the SCANNED segments
        (skipped segments contributed no candidates) and never skip:
        every candidate's owner score stays exact, which is what makes a
        degraded answer partial but never wrong."""
        store = self.store
        offs = engine._offsets(store.capacities)
        caps = store.capacities
        layout = store.layout_key()
        degraded_stages = False
        if policy.stages_degraded is not None \
                and time.monotonic() >= deadline:
            # already blown on arrival: drop to the cheaper cascade
            stages = tuple(policy.stages_degraded)
            degraded_stages = True
        k0 = stages[0].k
        skip = deadline if policy.skip_cold else None
        acc_v = acc_i = None
        width = 0
        scanned, skipped = [], []

        def scan_one(si):
            nonlocal acc_v, acc_i, width
            fn = self._seg_fn("scan", stages, 0, si, layout)
            v, i = fn(store.segments[si].vectors, q, q_mask, fspec,
                      offs[si])
            self._release(si)
            if acc_v is None:
                acc_v, acc_i = v, i
                width = caps[si]
            else:
                width += caps[si]
                acc_v, acc_i = _merge_pair(acc_v, acc_i, v, i,
                                           min(k0, width))
            scanned.append(si)

        for si in scope:
            if not self._try_acquire(si, skip):
                skipped.append(si)
                continue
            scan_one(si)
        if len(scanned) < min(max(1, policy.min_segments), len(scope)):
            # deadline or not, a request gets a real answer: force the
            # first skipped segments in (still in scope order)
            for si in skipped[:max(1, policy.min_segments)
                              - len(scanned)]:
                self._acquire(si, overlap=False)
                scan_one(si)
                skipped.remove(si)
        scores, cand = acc_v, acc_i

        for si_stage, stage in enumerate(stages[1:], start=1):
            s_all = None
            for si in scanned:
                self._acquire(si, overlap=False)
                fn = self._seg_fn("rerank", stages, si_stage, si, layout)
                s = fn(store.segments[si].vectors, q, q_mask, fspec,
                       offs[si], cand)
                self._release(si)
                s_all = s if s_all is None else _max_scores(s_all, s)
            scores, cand = _select_stage(s_all, cand,
                                         min(stage.k, cand.shape[1]))
        degraded = bool(skipped) or degraded_stages
        if degraded:
            self.stats["degraded"] += 1
        return TieredResult(*self._translate(scores, cand),
                            degraded=degraded,
                            skipped_segments=len(skipped))

    def _search_mesh(self, q, q_mask, stages, scope, fspec,
                     overlap: bool) -> TieredResult:
        """Mesh path: promote the scope (with ``overlap`` the worker's
        transfers overlap each other; per-segment pipelining of compute
        is the single-device path's), then run the scope as one joint
        sharded cascade — the function a resident search over those
        segments runs. Slot ids are scope-local (offsets over the scope's
        capacities) and translate through the scope's slot maps."""
        if overlap:
            self.prefetch(scope)
        for si in scope:
            self._acquire(si, overlap)
        try:
            segs = [self.store.segments[si] for si in scope]
            layout = self.store.layout_key()
            key = ("mesh", stages, tuple(layout[si] for si in scope))
            fn = self._fns.get(key)
            if fn is None:
                fn = engine.make_segmented_search_fn(
                    stages, tuple(seg.capacity for seg in segs), self.r.mesh,
                    self.r.rerank_overcommit)
                self._fns[key] = fn
            # an unplaced store's segments are one dict each, which the
            # search splits over the mesh
            scores, slots = fn(tuple(seg.slabs if self.store.mesh is not None
                                     else seg.vectors for seg in segs),
                               q, q_mask, fspec)
        finally:
            for si in scope:
                self._release(si)
        table = np.concatenate([seg.doc_ids for seg in segs])
        slots = slots.cpu().numpy()
        ids = np.where(slots >= 0, table[np.clip(slots, 0, len(table) - 1)],
                       np.int64(-1))
        filler = (scores <= engine.NEG / 2).cpu().numpy()
        return TieredResult(scores, np.where(filler, np.int64(-1), ids))

    def _translate(self, scores, cand) -> tuple:
        """Slot ids -> stable page ids with the retriever's NEG-filler
        masking (dead slots, filter-excluded live slots and dropped-id
        sentinels all come back as -1)."""
        ids = self.store.translate_slots(cand.cpu().numpy())
        filler = (scores <= engine.NEG / 2).cpu().numpy()
        return scores, np.where(filler, np.int64(-1), ids)

    # -- persistence -------------------------------------------------------

    def snapshot(self, directory: str, **kw) -> str:
        """``tiering.snapshot`` under the residency lock (no tier swap
        can interleave with the flatten)."""
        with self._lock:
            return snapshot(self.store, directory, **kw)
