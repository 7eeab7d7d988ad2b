"""Request batcher: many concurrent HTTP requests -> few large device
batches, with an optional bounded LRU result cache.

The reference calls the detector once per item inside the handler loop
(handlers.go:133-186, one cgo call each); the TPU redesign accumulates
items from all in-flight requests and dispatches them as one batch
(SURVEY.md §3.1), trading a small queueing delay for device efficiency.
A collector thread drains the queue, flushing when `max_batch` items are
pending or `max_delay_ms` has passed since the oldest undispatched item
arrived; flushes run on a small worker pool so batch N+1 accumulates and
dispatches while batch N is still in flight on the device — without
this, every flush pays the backend's full ~95ms dispatch latency
serially and HTTP throughput collapses to flush_size/latency.

The result cache (off by default, `cache_bytes` > 0 enables) keys on
(hints_key, normalized text) — the service normalizes via strip_extras
BEFORE submit, so equal keys imply byte-identical detector input.
Entries from requests with different hint configurations can never
serve each other: the hints_key is part of the key, full stop. At
millions-of-users scale the traffic is dominated by repeated hot
documents (retweets, boilerplate, spam campaigns), so a small cache
absorbs a large fraction of the stream before it ever reaches the
engine; the hit rate exports as a /metrics gauge.
"""
from __future__ import annotations

import inspect
import queue
import threading
from collections import OrderedDict
from concurrent.futures import Future, ThreadPoolExecutor

from .. import faults, knobs, telemetry
from ..locks import make_lock
from . import sharedcache
from .admission import (DeadlineExceeded, FairScheduler,
                        note_deadline_expired)

# concurrent flushes: one packing on the host while others launch or
# finish on the card (the engine hands each job a stream of its own)
_FLUSH_WORKERS = 3


def flush_workers() -> int:
    """Flush-worker count for both batchers: the fixed overlap depth,
    widened when the device pool runs more lanes — N lanes can carry N
    concurrent flushes (plus one accumulating), and a narrower worker
    pool would idle healthy lanes exactly when a sick lane is being
    covered for — and when the dispatch pipeline runs deeper than the
    default (LDT_PIPELINE_DEPTH jobs in flight plus one packing need
    as many flush slots to stay full)."""
    return max(_FLUSH_WORKERS,
               (knobs.get_int("LDT_POOL_LANES") or 0) + 1,
               (knobs.get_int("LDT_PIPELINE_DEPTH") or 0) + 1)

_MISS = object()  # cache sentinel: any real result (even None) differs


def _accepts_trace(fn) -> bool:
    """Does this detect callable take a trace= keyword? (Both batchers
    pass the flush trace through when it does.)"""
    try:
        return "trace" in inspect.signature(fn).parameters
    except (TypeError, ValueError):
        return False


def _value_nbytes(v) -> int:
    """Charged size of a cached result: exact for the code-string
    production path, a flat estimate for result objects."""
    if isinstance(v, (str, bytes)):
        return len(v)
    return 64


class ResultCache:
    """Bounded LRU over detection results, keyed (hints_key, text).

    Byte accounting charges each entry its text bytes + result bytes +
    a fixed per-entry structure overhead, and eviction keeps the total
    at or under max_bytes — the bound is a real memory ceiling, not an
    entry count. Thread-safe: flush workers probe and fill
    concurrently."""

    ENTRY_OVERHEAD = 96  # dict slot + key tuple + bookkeeping, amortized

    def __init__(self, max_bytes: int, shared=None):
        self.max_bytes = max_bytes
        self._d: OrderedDict = OrderedDict()  # key -> (value, nbytes)
        self._lock = make_lock("batcher.result_cache")
        self.bytes = 0
        self.hits = 0
        self.misses = 0
        # single-flight pending map: a key some in-flight flush is
        # already computing. A second flush carrying the same doc waits
        # on the Event instead of dispatching the duplicate (claim /
        # resolve below)
        self._pending: dict = {}
        # fleet-shared L2 (service/sharedcache.py): probed on an L1
        # miss, written through on fill. None unless
        # LDT_RESULT_CACHE_SHM_MB is set; `shared` overrides for tests
        self._shared = shared if shared is not None \
            else sharedcache.shared_tier()
        # artifact epoch: results are only valid against the tables
        # that produced them, so every key is namespaced by the serving
        # artifact's generation and a swap flushes the lot (set_epoch
        # in service/swap.py) — a hit can never be a stale answer from
        # the pre-swap model
        self._epoch = None

    def set_epoch(self, epoch) -> None:
        """Namespace the cache to a new artifact generation, dropping
        every entry produced under the old one. Called by swap_artifact
        after the rebind commits; idempotent for a repeated epoch."""
        with self._lock:
            if epoch == self._epoch:
                return
            self._epoch = epoch
            self._d.clear()
            self.bytes = 0
            # wake every single-flight waiter: the answer its owner is
            # computing belongs to the old artifact — waiters re-probe,
            # miss, and dispatch against the new tables themselves
            pending = list(self._pending.values())
            self._pending.clear()
        for ev in pending:
            ev.set()
        if self._shared is not None:
            self._shared.set_epoch(epoch)

    def get(self, key):
        """Returns the cached value or the module's _MISS sentinel."""
        ekey = (self._epoch,) + key
        with self._lock:
            ent = self._d.get(ekey)
            if ent is not None:
                self._d.move_to_end(ekey)
                self.hits += 1
                return ent[0]
        # L1 miss: probe the fleet-shared tier (outside the L1 lock —
        # the mmap protocol is lock-free) and promote a hit so the hot
        # doc answers from the dict next time
        if self._shared is not None:
            v = self._shared.get(key)
            if v is not None:
                self._put_local(ekey, v, key[-1])
                with self._lock:
                    self.hits += 1
                return v
        with self._lock:
            self.misses += 1
        return _MISS

    def claim(self, key):
        """Single-flight a freshly probed _MISS: returns None when the
        caller becomes the key's owner (it MUST resolve() after its
        dispatch fills — or fails to fill — the cache), else the
        threading.Event the owning flush will set. Waiters re-probe
        get() after the wait and dispatch themselves on a still-miss
        (owner failed, epoch rolled, or the wait timed out)."""
        ekey = (self._epoch,) + key
        with self._lock:
            ev = self._pending.get(ekey)
            if ev is not None:
                return ev
            self._pending[ekey] = threading.Event()
            return None

    def resolve(self, key) -> None:
        """Owner's release of a claimed key, success or failure: wakes
        every flush waiting on it. Idempotent (an epoch roll may have
        already swept the claim)."""
        ekey = (self._epoch,) + key
        with self._lock:
            ev = self._pending.pop(ekey, None)
        if ev is not None:
            ev.set()

    def _put_local(self, ekey, value, text: str):
        nbytes = (len(text.encode("utf-8", "surrogatepass")) +
                  _value_nbytes(value) + self.ENTRY_OVERHEAD)
        if nbytes > self.max_bytes:
            return  # a single oversized doc must not wipe the cache
        with self._lock:
            if ekey in self._d:
                return
            self._d[ekey] = (value, nbytes)
            self.bytes += nbytes
            while self.bytes > self.max_bytes and self._d:
                _, (_, nb) = self._d.popitem(last=False)
                self.bytes -= nb

    def put(self, key, value, text: str):
        self._put_local((self._epoch,) + key, value, text)
        # write-through: only the code-string production values travel
        # to the shared tier (its slots pack utf-8 fragments; richer
        # result objects stay per-worker)
        if self._shared is not None and isinstance(value, str):
            self._shared.put(key, value)

    def stats(self) -> dict:
        with self._lock:
            total = self.hits + self.misses
            out = {"hits": self.hits, "misses": self.misses,
                   "bytes": self.bytes, "entries": len(self._d),
                   "pending": len(self._pending),
                   "hit_rate": self.hits / total if total else 0.0}
        if self._shared is not None:
            out["shared"] = self._shared.stats()
        return out


class Batcher:
    """Deadline/size-batched dispatcher over a detection engine."""

    def __init__(self, detect_fn, max_batch: int = 16384,
                 max_delay_ms: float = 5.0, cache_bytes: int = 0):
        self._detect = detect_fn          # list[str] -> list[results]
        # engine-backed detect fns accept trace= and record their
        # scheduler spans into the flush trace; plain list->list
        # callables (tests, bench harnesses) are served as-is
        self._detect_takes_trace = _accepts_trace(detect_fn)
        self.max_batch = max_batch
        self.max_delay = max_delay_ms / 1e3
        self._cache = ResultCache(cache_bytes) if cache_bytes > 0 \
            else None
        self._q: queue.Queue = queue.Queue()
        # deficit-weighted fair queueing at dequeue (LDT_TENANT_WEIGHTS;
        # None = strict FIFO). Owned by the collector thread alone.
        self._sched = FairScheduler.from_env()
        self._stop = threading.Event()
        nw = flush_workers()
        self._pool = ThreadPoolExecutor(nw,
                                        thread_name_prefix="ldt-flush")
        # bound in-flight flushes so a backed-up device cannot pile
        # unbounded batches in memory
        self._slots = threading.Semaphore(nw + 1)
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="ldt-batcher")
        self._thread.start()

    def submit(self, texts: list, hints_key=None, trace=None) -> Future:
        """Queue one request's texts; resolves to their results (in
        order) once a batch containing them completes. hints_key: any
        hashable token identifying the request's hint configuration —
        cached results are only ever shared within one hints_key.
        trace: optional telemetry.Trace; the flush serving this request
        grafts its stage spans (dedup/pack/dispatch/...) into it before
        resolving the future.

        Callers: the sync front's detect closure and the UDS lane
        (wire.handle_frame) — every ingest path funnels through here,
        so the Future only gets armed once the request is certain to
        enter the queue (a fault-seam raise or post-close fail-fast
        never allocates one just to abandon it)."""
        if self._stop.is_set():
            # post-close submits fail fast instead of sitting in a
            # queue nobody drains until the caller's 60s result timeout
            closed: Future = Future()
            closed.set_exception(RuntimeError("batcher closed"))
            return closed
        if faults.ACTIVE is not None:
            # an injected queue_put error raises out of submit: the
            # handler answers it like any enqueue failure, and no
            # future enters the queue half-armed
            faults.hit("queue_put")
        fut: Future = Future()
        self._q.put((texts, hints_key, trace, fut))
        return fut

    def cache_stats(self) -> dict | None:
        """Live hit/miss/byte counters, or None when the cache is
        disabled (the /metrics exporter reads this)."""
        return self._cache.stats() if self._cache else None

    def close(self):
        """Bounded shutdown: a wedged flush (device hang) must not pin
        close() forever — the collector re-checks _stop while waiting
        for a flush slot, the join is time-limited, and the pool
        shutdown cancels queued (not yet running) flushes rather than
        waiting behind them."""
        self._stop.set()
        self._q.put(None)  # wake the collector
        self._thread.join(timeout=5)
        self._pool.shutdown(wait=False, cancel_futures=True)
        # fail whatever is still sitting in the queue: with the
        # collector gone nothing will ever drain it, and a submit()
        # caller blocked on its future would hang to its full timeout
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is not None:
                self._fail([item], RuntimeError("batcher closed"))
        # the WFQ stash is collector-owned; with the collector joined
        # (or abandoned after its timeout) nothing else drains it
        if self._sched is not None:
            stranded = self._sched.drain_all()
            if stranded:
                self._fail(stranded, RuntimeError("batcher closed"))

    # -- collector -----------------------------------------------------------

    def _run(self):
        while not self._stop.is_set():
            sched = self._sched
            if sched is not None and sched.backlog:
                # stashed backlog exists: don't block on an empty
                # queue, just sweep in whatever already arrived
                try:
                    item = self._q.get(timeout=self.max_delay)
                except queue.Empty:
                    item = None
            else:
                item = self._q.get()
            if item is None and (sched is None or not sched.backlog):
                continue
            pending = [item] if item is not None else []
            n = len(item[0]) if item is not None else 0
            # accumulate until deadline or size cap
            import time
            deadline = time.monotonic() + self.max_delay
            while n < self.max_batch and item is not None:
                timeout = deadline - time.monotonic()
                if timeout <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=timeout)
                except queue.Empty:
                    break
                if nxt is None:
                    break
                pending.append(nxt)
                n += len(nxt[0])
            if sched is not None:
                # fair queueing at dequeue: stash the sweep, pop the
                # next batch in deficit-round-robin order; whatever a
                # saturating tenant over-queued waits in its lane
                for it in pending:
                    sched.push(it)
                pending = sched.pop_batch(self.max_batch)
                if not pending:
                    continue
            if faults.ACTIVE is not None:
                # a dequeue fault fails THIS batch's waiters (typed
                # error, not a hang) and the collector moves on — the
                # collector thread itself must survive any chaos profile
                try:
                    faults.hit("queue_get")
                except faults.FaultInjected as e:
                    self._fail(pending, e)
                    continue
            # wait for a flush slot, re-checking _stop so a wedged
            # device (every slot held by a stuck flush) cannot pin the
            # collector — and with it close()'s join — forever. A
            # HEALTHY close still serves the batch in hand: the grace
            # window comfortably covers normal ~95ms flushes and stays
            # inside close()'s 5s join budget.
            import time as _time
            grace_until = None
            while not self._slots.acquire(timeout=0.5):
                if self._stop.is_set():
                    now = _time.monotonic()
                    if grace_until is None:
                        grace_until = now + 3.0
                    elif now >= grace_until:
                        self._fail(pending,
                                   RuntimeError(
                                       "batcher closed while waiting "
                                       "for a flush slot"))
                        return
            try:
                f = self._pool.submit(self._flush, pending)
                # a close() that cancels queued flushes must fail their
                # waiters, not leave them to their submit timeouts
                f.add_done_callback(
                    lambda ftr, p=pending: self._fail(
                        p, RuntimeError("batcher closed"))
                    if ftr.cancelled() else None)
            except RuntimeError as e:  # pool shut down first
                self._slots.release()
                self._fail(pending, e)
                return

    @staticmethod
    def _fail(pending: list, err: Exception):
        # done() (not just cancelled()) so _fail is idempotent: the
        # flush catch-all and the cancellation done-callback can both
        # sweep a batch whose futures already resolved
        for *_, fut in pending:
            if not fut.done():
                fut.set_exception(err)

    def _run_detect(self, texts: list, ftrace):
        if self._detect_takes_trace:
            return self._detect(texts, trace=ftrace)
        return self._detect(texts)

    @staticmethod
    def _graft(tr, ftrace):
        """Adopt the flush's stage spans as children of the request's
        (still-open) detect span, just before its future resolves."""
        if tr is not None and ftrace is not None:
            tr.graft(ftrace, depth=1)

    @staticmethod
    def _drop_expired(pending: list) -> list:
        """Dequeue-time deadline check: a request whose X-LDT-Deadline
        budget passed while it queued fails with DeadlineExceeded (the
        front answers 504) instead of burning flush capacity on an
        answer nobody is waiting for. Returns the still-live items.
        Items are (..., trace, fut) — shared with AioBatcher, whose
        3-tuples have the same tail."""
        live: list = []
        expired = 0
        for item in pending:
            tr = item[-2]
            dl = getattr(tr, "deadline", None) if tr is not None \
                else None
            if dl is not None and dl.expired():
                expired += 1
                fut = item[-1]
                if not fut.done():
                    fut.set_exception(DeadlineExceeded(
                        "deadline expired before dispatch"))
            else:
                live.append(item)
        if expired:
            note_deadline_expired(expired)
        return live

    def _flush(self, pending: list):
        try:
            pending = self._drop_expired(pending)
            if not pending:
                return
            # one flush-scoped trace shared by every traced request in
            # the batch: the engine records dedup/pack/dispatch spans
            # into it, and each request adopts a copy at resolve time
            ftrace = telemetry.Trace() \
                if any(tr is not None for _, _, tr, _ in pending) \
                else None
            if ftrace is not None:
                ftrace.adopt_constraints(tr for _, _, tr, _ in pending)
            if self._cache is None:
                texts = [t for ts, _, _, _ in pending for t in ts]
                try:
                    results = self._run_detect(texts, ftrace)
                except Exception as e:  # noqa: BLE001 - fail every waiter
                    self._fail(pending, e)
                    return
                i = 0
                for ts, _, tr, fut in pending:
                    if not fut.cancelled():
                        self._graft(tr, ftrace)
                        fut.set_result(results[i:i + len(ts)])
                    i += len(ts)
                return
            # cached flush: probe per item, detect only the misses, fill
            # the cache, then assemble each request's results in order.
            # Misses another in-flight flush already owns (single-flight
            # claim) are not re-dispatched: this flush parks them and
            # adopts the owner's fill after its own detect returns.
            plans: list = []       # one value list per request
            miss_texts: list = []
            miss_refs: list = []   # (plan, slot, key, text) — ours
            waits: list = []       # (plan, slot, key, text, event)
            owned: list = []       # keys we must resolve() no matter what
            for ts, hk, _, _ in pending:
                plan = []
                for t in ts:
                    key = (hk, t)
                    v = self._cache.get(key)
                    plan.append(v)
                    if v is _MISS:
                        ev = self._cache.claim(key)
                        if ev is None:
                            owned.append(key)
                            miss_refs.append(
                                (plan, len(plan) - 1, key, t))
                            miss_texts.append(t)
                        else:
                            waits.append(
                                (plan, len(plan) - 1, key, t, ev))
                plans.append(plan)
            try:
                miss_results = self._run_detect(miss_texts, ftrace) \
                    if miss_texts else []
            except Exception as e:  # noqa: BLE001 - fail every waiter
                for key in owned:
                    self._cache.resolve(key)  # wake waiters to retry
                self._fail(pending, e)
                return
            for (plan, slot, key, t), v in zip(miss_refs, miss_results):
                plan[slot] = v
                self._cache.put(key, v, t)
            for key in owned:
                self._cache.resolve(key)
            if waits:
                # our own claims are resolved above, so a same-flush
                # duplicate's event is already set — only genuinely
                # cross-flush waits block here, for as long as the
                # owning flush's device dispatch can take
                import time as _t
                leftover = []   # (plan, slot, key, text)
                deadline = _t.monotonic() + 30.0
                for plan, slot, key, t, ev in waits:
                    ev.wait(timeout=max(0.0,
                                        deadline - _t.monotonic()))
                    v = self._cache.get(key)
                    if v is _MISS:
                        leftover.append((plan, slot, key, t))
                    else:
                        plan[slot] = v
                if leftover:
                    # the owner failed, timed out, or an epoch roll
                    # swept its claim: score the stragglers ourselves
                    # (no re-claim — a second wait could livelock)
                    try:
                        vals = self._run_detect(
                            [t for _, _, _, t in leftover], ftrace)
                    except Exception as e:  # noqa: BLE001
                        self._fail(pending, e)
                        return
                    for (plan, slot, key, t), v in zip(leftover, vals):
                        plan[slot] = v
                        self._cache.put(key, v, t)
            for (ts, _, tr, fut), plan in zip(pending, plans):
                if not fut.cancelled():
                    self._graft(tr, ftrace)
                    fut.set_result(plan)
        except Exception as e:  # noqa: BLE001 - never orphan a waiter
            # anything unexpected (graft, cache fill, a half-resolved
            # batch) fails the REMAINING futures instead of leaving
            # them to their submit timeouts; _fail skips resolved ones
            self._fail(pending, e)
        finally:
            self._slots.release()
