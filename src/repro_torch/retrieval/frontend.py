"""Shape-bucketed streaming frontend: micro-batched query serving.

ColPali late-interaction traffic is ragged: queries have varying token
counts and arrive one at a time, not as fixed ``[B, Q, d]`` blocks.
``ServingFrontend`` turns that stream into a few fixed block shapes and
coalesces requests into one cascade launch each:

- **shape buckets** — requests are zero-padded into a static set of
  power-of-two ``(B_bucket, Q_bucket)`` shapes (symmetric with the
  bucketed segment capacities). Padded tokens are masked via ``q_mask``;
  a masked token adds an exact +0 to every MaxSim sum, and padded batch
  rows (no valid token at all) score 0 for every document and are
  dropped BEFORE id translation. Eager PyTorch compiles nothing per
  shape, so the buckets bound the block shapes the kernels see (and the
  allocator's sizes) rather than compiles; ``warm()`` runs each bucket
  once, off the serving path, and after it in-bounds traffic builds
  nothing (``tracing.no_retrace`` holds).
- **micro-batching** — an admission queue coalesces single or ragged
  requests into one cascade dispatch per micro-batch. ``pump()`` flushes
  FIFO when the queued rows fill ``max_batch`` or the oldest request has
  waited ``flush_ms``. Batch rows are independent through every stage
  (each query is scored, selected and reranked alone), so micro-batched
  results are bit for bit those of per-request calls. Requests carrying
  a ``store.FilterSpec`` queue PER FILTER (one filter per dispatch);
  flushes round-robin across the filter queues so a bursting tenant
  cannot starve a quiet one, and an optional per-tenant admission quota
  (``tenant_quota``) bounds the queued rows one tenant may hold — excess
  submits raise ``AdmissionError``. A request past its deadline
  (``deadline_ms``) is shed instead of queued or dispatched.
- **tiered dispatch** (optional) — with ``engine=`` a
  ``tiering.TieredEngine`` serves the blocks instead of the retriever; a
  micro-batch carries its tightest member's remaining budget into the
  engine, which degrades (resident segments only, per ``degrade=``)
  instead of blocking on cold-segment promotions. A degraded answer is
  flagged (``PendingResult.degraded``), counted in ``stats["degraded"]``
  and never cached.
- **result cache** (optional) — an LRU keyed on (stages, store
  generation, FILTER identity, query bytes, mask bytes) short-circuits
  repeated identical queries without touching the device. The generation
  bumps on every upsert/ingest/delete/compact, so a cached result never
  outlives the corpus it was computed against; the filter identity keeps
  tenants' caches disjoint.

A dispatch brings its scores and slot ids to the host (a synchronising
copy) before it completes its requests, so a request's latency covers
the search, not just its launch.

Single-threaded by design: ``submit``/``pump`` are driven by the serving
loop (see ``replay_open_loop`` and ``repro_torch.launch.serve
--traffic``), which keeps results deterministic and testable.
"""
from __future__ import annotations

import time
from collections import OrderedDict, deque

import numpy as np
import torch

from repro_torch.retrieval.engine import NEG


def bucket_ladder(max_value: int, min_value: int = 1) -> tuple:
    """Power-of-two ladder ``min_value.. >= max_value`` (both rounded up),
    e.g. (1, 2, 4, 8, 16). The static bucket family per axis."""
    if max_value < 1 or min_value < 1:
        raise ValueError(f"ladder bounds must be >= 1, got "
                         f"[{min_value}, {max_value}]")
    hi = 1 << max(0, int(max_value - 1).bit_length())
    lo = min(1 << max(0, int(min_value - 1).bit_length()), hi)
    out, v = [], lo
    while v <= hi:
        out.append(v)
        v <<= 1
    return tuple(out)


class AdmissionError(RuntimeError):
    """A submit was rejected because the request's tenant already holds its
    full admission quota of queued rows (load shedding at the door — the
    caller should retry after draining or surface backpressure)."""


class DeadlineExceeded(RuntimeError):
    """The request's deadline was already blown before it could be
    dispatched, so it was SHED instead of queued or served."""


class PendingResult:
    """Handle for a submitted request; filled in by the flush that serves
    it (or sheds or fails it — a completed handle always resolves: check
    ``error``/``shed``/``degraded``, or call ``result()`` to get
    ``(scores, ids)`` or raise). ``latency`` is seconds from admission to
    completion."""
    __slots__ = ("scores", "ids", "t_submit", "t_done", "cached", "error",
                 "shed", "degraded", "deadline")

    def __init__(self, t_submit: float, deadline: float | None = None):
        self.scores = None
        self.ids = None
        self.t_submit = t_submit
        self.t_done = None
        self.cached = False
        self.error = None
        self.shed = False
        self.degraded = False
        self.deadline = deadline

    def done(self) -> bool:
        return self.t_done is not None

    def result(self) -> tuple:
        """(scores, ids), or raise: the dispatch error for a failed
        cohort, ``DeadlineExceeded`` for a shed request, ``ValueError``
        while still queued."""
        if self.error is not None:
            raise self.error
        if self.t_done is None:
            raise ValueError("request not served yet — pump() the frontend")
        return self.scores, self.ids

    @property
    def latency(self) -> float:
        if self.t_done is None:
            raise ValueError("request not served yet — pump() the frontend")
        return self.t_done - self.t_submit


class ServingFrontend:
    """Shape-bucketed, micro-batching serving frontend over a Retriever.

    ``stages`` is fixed per frontend; run several frontends for several
    cascades — they share the retriever's corpus and search-function
    cache. Queries are normalised to float32 and bool masks.
    """

    def __init__(self, retriever, stages: tuple, *, max_batch: int = 16,
                 max_q: int = 32, min_q: int = 8, flush_ms: float = 2.0,
                 cache_size: int = 0, tenant_quota: int = 0,
                 deadline_ms: float = 0.0, engine=None, degrade=None,
                 clock=time.perf_counter):
        self.retriever = retriever
        # the retriever's scan_chunk default applies, as in its search
        self.stages = retriever._normalize(stages)
        # per-request wall budget (0 = none): a request whose deadline is
        # already blown at admission or flush time is SHED (completed
        # with DeadlineExceeded) instead of queued or dispatched;
        # submit(deadline_ms=...) overrides it per request
        self.deadline_ms = float(deadline_ms)
        # optional tiering.TieredEngine to dispatch through: micro-batches
        # then carry their tightest member's remaining budget into the
        # engine, which degrades instead of blocking on cold-segment
        # promotions; ``degrade`` is the tiering.DegradePolicy (None =
        # the engine's default)
        self._engine = engine
        self._degrade = degrade
        self.b_buckets = bucket_ladder(max_batch)
        self.q_buckets = bucket_ladder(max_q, min_q)
        self.max_batch = self.b_buckets[-1]
        self.max_q = self.q_buckets[-1]
        self.flush_s = flush_ms / 1e3
        self.cache_size = cache_size
        # max queued ROWS one tenant may hold (0 = unlimited)
        self.tenant_quota = tenant_quota
        self.clock = clock
        # one FIFO per filter identity (a micro-batch carries exactly one
        # filter); flushed round-robin so no filter queue can be starved
        self._queues: OrderedDict = OrderedDict()   # fkey -> deque
        self._queued_rows = 0
        self._tenant_rows: dict = {}                # tenant id -> rows
        self._cache: OrderedDict = OrderedDict()
        self.stats = {"requests": 0, "dispatches": 0, "cache_hits": 0,
                      "rows_real": 0, "rows_padded": 0, "rejected": 0,
                      "shed": 0, "degraded": 0, "errors": 0}

    # ------------------------------------------------------------------
    # buckets
    # ------------------------------------------------------------------

    def bucket_for(self, b: int, q_len: int) -> tuple:
        """Smallest ``(B_bucket, Q_bucket)`` covering a ``[b, q_len]``
        request block; raises when the request exceeds the bucket maxima
        (split oversized batches caller-side — the bucket set is static)."""
        if not 1 <= b <= self.max_batch:
            raise ValueError(f"batch rows {b} outside [1, {self.max_batch}]")
        if not 1 <= q_len <= self.max_q:
            raise ValueError(f"query tokens {q_len} outside [1, {self.max_q}]")
        bb = next(x for x in self.b_buckets if x >= b)
        qb = next(x for x in self.q_buckets if x >= q_len)
        return bb, qb

    def warm(self) -> int:
        """Dispatch every ``(B_bucket, Q_bucket)`` block once, off the
        serving path (kernel libraries loaded, the search function built,
        the allocator's block sizes seen). Returns the number of bucket
        shapes warmed; after this, in-bounds traffic builds nothing.
        Warm-up dispatches are excluded from ``stats``."""
        d = self._query_dim()
        snapshot = dict(self.stats)
        n = 0
        for bb in self.b_buckets:
            for qb in self.q_buckets:
                q = np.zeros((bb, qb, d), np.float32)
                qm = np.ones((bb, qb), bool)
                self._dispatch(q, qm, rows=bb)
                n += 1
        self.stats = snapshot
        return n

    def _query_dim(self) -> int:
        """Query embedding dim = widest stored dim among the cascade's
        vectors (Matryoshka stages slice the query DOWN to theirs)."""
        schema = self.retriever.store.schema()
        return max(schema[s.vector].vec_dim for s in self.stages)

    # ------------------------------------------------------------------
    # direct path (one request = one dispatch, still bucketed)
    # ------------------------------------------------------------------

    def search(self, q, q_mask=None, filter=None) -> tuple:
        """Serve one request now: pad to its bucket, dispatch, strip.
        ``q`` is ``[q_len, d]`` (single query) or ``[b, q_len, d]``;
        ``filter`` a ``store.FilterSpec`` scoping the request (or None).
        Returns host ``(scores [b, k], stable page ids [b, k])``."""
        q, qm = self._admit(q, q_mask)
        fkey = self._filter_key(filter)
        self.stats["requests"] += 1
        hit = self._cache_get(q, qm, fkey)
        if hit is not None:
            return hit
        scores, ids, degraded = self._run_block([(q, qm)], fkey)
        if degraded:
            self.stats["degraded"] += 1
        else:
            # a degraded (partial) answer must never be served again
            # from cache as if it were the exact one
            self._cache_put(q, qm, fkey, (scores, ids))
        return scores, ids

    # ------------------------------------------------------------------
    # micro-batching path
    # ------------------------------------------------------------------

    def submit(self, q, q_mask=None, filter=None,
               t_submit: float | None = None,
               deadline_ms: float | None = None) -> PendingResult:
        """Queue one request for the next micro-batch. Returns a
        ``PendingResult`` filled in by a later ``pump``/``flush``
        (immediately, on a result-cache hit). Requests queue per FILTER
        identity, and a tenant over its ``tenant_quota`` of queued rows
        gets ``AdmissionError`` instead of a slot.

        ``deadline_ms`` (default: the frontend's) bounds the request's
        wall budget from ``t_submit``; a request whose deadline is already
        blown — here, or by the time its flush comes — is SHED: completed
        with ``DeadlineExceeded`` (``shed=True``, ``stats["shed"]``).

        ``t_submit`` is the request's TRUE arrival time on this frontend's
        clock (default: now). Replay loops pass the scheduled arrival
        time, so queueing delay accrued while the loop was blocked inside
        a dispatch is billed to the request (no coordinated omission)."""
        q, qm = self._admit(q, q_mask)
        fkey = self._filter_key(filter)
        self.stats["requests"] += 1
        t0 = self.clock() if t_submit is None else t_submit
        eff = self.deadline_ms if deadline_ms is None else deadline_ms
        pr = PendingResult(t0, t0 + eff / 1e3 if eff else None)
        hit = self._cache_get(q, qm, fkey)
        if hit is not None:
            pr.scores, pr.ids = hit
            pr.t_done = self.clock()
            pr.cached = True
            return pr
        if pr.deadline is not None and self.clock() > pr.deadline:
            self._shed(pr, self.clock())     # blown before admission
            return pr
        tenant = self._tenant_of(fkey)
        if self.tenant_quota and self._tenant_rows.get(tenant, 0) \
                + q.shape[0] > self.tenant_quota:
            self.stats["rejected"] += 1
            raise AdmissionError(
                f"tenant {tenant} holds {self._tenant_rows.get(tenant, 0)} "
                f"queued rows (quota {self.tenant_quota})")
        self._queues.setdefault(fkey, deque()).append((pr, q, qm))
        self._queued_rows += q.shape[0]
        self._tenant_rows[tenant] = self._tenant_rows.get(tenant, 0) \
            + q.shape[0]
        return pr

    @property
    def pending(self) -> int:
        """Queued (unserved) requests, across every filter queue."""
        return sum(len(qu) for qu in self._queues.values())

    def next_deadline(self) -> float | None:
        """Absolute clock time the oldest queued request (across all
        filter queues) must flush by."""
        if not self._queues:
            return None
        return min(qu[0][0].t_submit for qu in self._queues.values()) \
            + self.flush_s

    def pump(self, now: float | None = None) -> int:
        """Flush micro-batches whose trigger has fired: queued rows fill
        ``max_batch``, or the oldest request's deadline passed. The serving
        loop calls this between admissions. Returns requests completed."""
        done = 0
        while self._queues:
            now = self.clock() if now is None else now
            full = self._queued_rows >= self.max_batch
            deadline = self.next_deadline()
            due = deadline is not None and now >= deadline
            if not (full or due):
                break
            done += self.flush()
            now = None                       # re-read the clock per batch
        return done

    def flush(self) -> int:
        """Serve ONE micro-batch now: pop FIFO requests up to ``max_batch``
        rows from the next filter queue in ROUND-ROBIN order, dispatch
        once, scatter results. Returns requests completed (served, shed
        or failed)."""
        if not self._queues:
            return 0
        fkey, queue = next(iter(self._queues.items()))
        take = []
        rows = 0
        while queue and rows + queue[0][1].shape[0] <= self.max_batch:
            item = queue.popleft()
            take.append(item)
            rows += item[1].shape[0]
        # rotate: a still-loaded queue goes to the back of the service
        # order, an empty one is dropped
        del self._queues[fkey]
        if queue:
            self._queues[fkey] = queue
        # the popped requests leave the queue NOW, whatever happens next:
        # the row/quota accounting stays in step when the dispatch throws
        tenant = self._tenant_of(fkey)
        self._queued_rows -= rows
        left = self._tenant_rows.get(tenant, 0) - rows
        if left > 0:
            self._tenant_rows[tenant] = left
        else:
            self._tenant_rows.pop(tenant, None)
        # shed the cohort members whose deadline is already blown — a
        # dispatch slot spent on them only delays the live ones
        now = self.clock()
        live = []
        for item in take:
            pr = item[0]
            if pr.deadline is not None and now > pr.deadline:
                self._shed(pr, now)
            else:
                live.append(item)
        if not live:
            return len(take)
        budget = None
        deadlines = [pr.deadline for pr, _, _ in live
                     if pr.deadline is not None]
        if deadlines:
            # the cohort shares one dispatch: its tightest member's
            # remaining budget bounds it
            budget = max((min(deadlines) - now) * 1e3, 0.0)
        try:
            scores, ids, degraded = self._run_block(
                [(q, qm) for _, q, qm in live], fkey, deadline_ms=budget)
        except BaseException as e:
            # complete every popped request with the error — waiters
            # raise (PendingResult.result) instead of hanging on a handle
            # no later flush will ever see again
            t_done = self.clock()
            for pr, _, _ in live:
                pr.error = e
                pr.t_done = t_done
                self.stats["errors"] += 1
            if not isinstance(e, Exception):
                # a kill signal (KeyboardInterrupt, a shutdown sentinel)
                # must still reach the serving loop — complete the
                # cohort, then let it fly
                raise
            return len(take)
        r0 = 0
        t_done = self.clock()
        for pr, q, qm in live:
            b = q.shape[0]
            pr.scores, pr.ids = scores[r0:r0 + b], ids[r0:r0 + b]
            pr.t_done = t_done
            if degraded:
                pr.degraded = True
                self.stats["degraded"] += 1
            else:
                # degraded (partial) answers are flagged, never cached
                self._cache_put(q, qm, fkey, (pr.scores, pr.ids))
            r0 += b
        return len(take)

    def _shed(self, pr: PendingResult, now: float) -> None:
        pr.shed = True
        pr.error = DeadlineExceeded(
            f"deadline blown {1e3 * (now - pr.deadline):.2f}ms before "
            f"dispatch — request shed")
        pr.t_done = now
        self.stats["shed"] += 1

    def drain(self) -> int:
        """Flush until every filter queue is empty. Returns requests
        completed."""
        done = 0
        while self._queues:
            done += self.flush()
        return done

    # ------------------------------------------------------------------
    # internals
    # ------------------------------------------------------------------

    def _admit(self, q, q_mask) -> tuple:
        """Normalise a request to (float32 [b, q_len, d], bool [b, q_len])
        and bounds-check it against the bucket maxima."""
        if isinstance(q, torch.Tensor):
            q = q.cpu().numpy()
        q = np.asarray(q, np.float32)
        if q.ndim == 2:
            q = q[None]
        if q.ndim != 3:
            raise ValueError(f"query must be [q_len, d] or [b, q_len, d], "
                             f"got shape {q.shape}")
        b, q_len, _ = q.shape
        if q_mask is None:
            qm = np.ones((b, q_len), bool)
        else:
            if isinstance(q_mask, torch.Tensor):
                q_mask = q_mask.cpu().numpy()
            qm = np.asarray(q_mask, bool).reshape(b, q_len)
        self.bucket_for(b, q_len)            # bounds check only
        return q, qm

    @staticmethod
    def _filter_key(filter):
        """Canonical queue/cache identity of a request filter. A
        ``FilterSpec`` is frozen, canonicalised and hashable, so it IS the
        key; the null spec collapses to None (the same search, so
        splitting its queue or cache line would only cost batching)."""
        if filter is None or getattr(filter, "is_null", False):
            return None
        return filter

    @staticmethod
    def _tenant_of(fkey) -> int:
        """The tenant a queue entry bills its admission quota to (-1 =
        unscoped requests, which share one bucket)."""
        return getattr(fkey, "tenant", -1) if fkey is not None else -1

    def _run_block(self, reqs: list, fkey=None,
                   deadline_ms: float | None = None) -> tuple:
        """Pad a list of admitted same-filter requests into one bucket
        block and dispatch it. Returns host (scores [rows, k], page ids
        [rows, k], degraded flag)."""
        rows = sum(q.shape[0] for q, _ in reqs)
        q_len = max(q.shape[1] for q, _ in reqs)
        d = reqs[0][0].shape[2]
        bb, qb = self.bucket_for(rows, q_len)
        qp = np.zeros((bb, qb, d), np.float32)
        qmp = np.zeros((bb, qb), bool)
        r0 = 0
        for q, qm in reqs:
            b, ql, _ = q.shape
            qp[r0:r0 + b, :ql] = q
            qmp[r0:r0 + b, :ql] = qm
            r0 += b
        return self._dispatch(qp, qmp, rows=rows, fkey=fkey,
                              deadline_ms=deadline_ms)

    def _dispatch(self, qp: np.ndarray, qmp: np.ndarray, rows: int,
                  fkey=None, deadline_ms: float | None = None) -> tuple:
        """One cascade launch on a padded bucket block. Padded batch rows
        are dropped BEFORE id translation (their scores rank zero
        content). The scores and slots come to the host here, which waits
        for the search. ``fkey`` is the block's filter. Returns (scores,
        ids, degraded); ``degraded`` is only ever True on the tiered
        path under a deadline."""
        self.stats["dispatches"] += 1
        self.stats["rows_real"] += rows
        self.stats["rows_padded"] += qp.shape[0] - rows
        if self._engine is not None:
            # tiered path: the engine translates and masks ids itself and
            # degrades under the cohort's remaining budget
            res = self._engine.search(
                torch.from_numpy(qp), torch.from_numpy(qmp),
                stages=self.stages, filter=fkey, deadline_ms=deadline_ms,
                degrade=self._degrade)
            return (res.scores[:rows].float().cpu().numpy(),
                    res.ids[:rows], bool(res.degraded))
        scores, slots = self.retriever.search(
            torch.from_numpy(qp), torch.from_numpy(qmp), stages=self.stages,
            translate_ids=False, filter=fkey)
        scores = scores[:rows].float().cpu().numpy()
        slots = slots[:rows].cpu().numpy()
        ids = self.retriever.store.translate_slots(slots)
        # filter-excluded live slots score NEG like dead slots; mask their
        # ids so filler can never expose another tenant's page ids (the
        # contract of Retriever.search with translate_ids=True)
        return (scores, np.where(scores <= NEG / 2, np.int64(-1), ids),
                False)

    def _cache_key(self, q: np.ndarray, qm: np.ndarray, fkey):
        # the store generation invalidates every entry on corpus mutation
        # (upsert/ingest/delete/compact) and on every tier swap of a
        # TieredEngine (residency changes no value, so dropping those
        # entries is only conservative); the FILTER identity is part of
        # the key: the same query bytes under different tenants/filters
        # are different requests
        return (self.stages, self.retriever.store.generation, fkey,
                q.shape, q.tobytes(), qm.tobytes())

    def _cache_get(self, q, qm, fkey):
        if not self.cache_size:
            return None
        key = self._cache_key(q, qm, fkey)
        hit = self._cache.get(key)
        if hit is not None:
            self._cache.move_to_end(key)
            self.stats["cache_hits"] += 1
        return hit

    def _cache_put(self, q, qm, fkey, result) -> None:
        if not self.cache_size:
            return
        key = self._cache_key(q, qm, fkey)
        self._cache[key] = result
        self._cache.move_to_end(key)
        while len(self._cache) > self.cache_size:
            self._cache.popitem(last=False)


def replay_open_loop(frontend: ServingFrontend, requests: list,
                     rate: float, seed: int = 0) -> tuple:
    """Drive an open-loop Poisson arrival process through the frontend in
    real time: exponential inter-arrival gaps at ``rate`` req/s, admissions
    via ``submit``, flushes via ``pump`` (deadline- or fill-triggered).

    ``requests`` is a list of ``(q, q_mask)`` pairs or ``(q, q_mask,
    filter)`` triples. Returns ``(pending: list[PendingResult],
    wall_seconds)``: every ADMITTED request served, each with its own
    arrival-to-completion latency; submits rejected by the tenant quota
    are dropped (counted in ``frontend.stats["rejected"]``). Latency is
    measured from the SCHEDULED Poisson arrival time, so a request that
    fell due while the loop was blocked inside a dispatch is billed for
    that wait too (no coordinated omission).
    """
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / rate, size=len(requests)))
    clock = frontend.clock
    out = []
    i, n = 0, len(requests)
    t0 = clock()
    while i < n or frontend.pending:
        now = clock() - t0
        while i < n and arrivals[i] <= now:
            q, qm, *rest = requests[i]
            try:
                out.append(frontend.submit(
                    q, qm, filter=rest[0] if rest else None,
                    t_submit=t0 + arrivals[i]))
            except AdmissionError:
                pass
            i += 1
        if frontend.pump():
            continue
        # idle: sleep to the next event (arrival or oldest flush deadline)
        waits = []
        if i < n:
            waits.append(t0 + arrivals[i] - clock())
        deadline = frontend.next_deadline()
        if deadline is not None:
            waits.append(deadline - clock())
        if waits:
            wait = min(waits)
            if wait > 0:
                time.sleep(min(wait, 0.005))
    return out, clock() - t0
