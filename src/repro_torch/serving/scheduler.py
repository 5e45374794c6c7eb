"""Continuous-batching serving engine and ``Retriever`` over
``anns.api.Database``; the LM side's decode ``Engine`` and the
``rag_answer`` round trip (at the end of the module).

``Database.query`` answers one batch at a time.  A serving front end sees
an open-loop stream of single-query requests with deadlines and tenants,
and would otherwise run the datapath at batch size 1 and let a hot tenant
starve the others of refine budget.  ``ServingEngine`` has four parts:

* **Admission** — requests enter a deadline-ordered (EDF) queue under a
  deterministic virtual clock (microseconds).  The engine is a
  discrete-event simulation over that clock: the same arrival trace gives
  the same batch boundaries.
* **Coalescer** — admitted requests group by service class
  ``(k, degraded)``; a class's batch closes when it holds ``max_batch``
  requests or its oldest one has waited ``max_wait_us``.  Batches pad to
  the power-of-two buckets (``executor.bucket_for`` / ``pad_chunk``), so
  the stages and kernels see a fixed set of batch shapes.
* **Double-buffered dispatch** — where the plan has a front/refine split
  (``CompiledPlan.supports_split``), batch N+1's front (``run_front``) is
  issued before batch N's refine and rerank (``run_finish``) is retired.
  On the GPU the fronts run on a side CUDA stream of the engine's own:
  on one stream batch N's refine would queue behind batch N+1's front.
  Each front records an event; the retire makes the current stream wait
  for it, and every tensor the front made is marked as used by the
  current stream (``record_stream``), so the caching allocator cannot
  hand its memory to a later front while the finish still reads it.
  The finish's fold copies its counters to the host on the current
  stream, which waits for that batch's front only, not for the next one.
  On the CPU the same code runs with no streams.  The virtual-clock model
  mirrors the split: a front unit and a refine unit with their own free
  times, each batch's stage times from its own ledger (front = HBM tier
  seconds, refine = the rest).  The sharded layout has no split point
  and dispatches whole batches on one serial unit, as does
  ``overlap=False``.
* **Per-tenant QoS** — each tenant owns a token bucket
  (``rate_rps``/``burst``).  A request that finds the bucket empty is
  degraded, not rejected: it runs under ``refine_budget`` divided by
  ``degrade_factor`` (floored at k) and its response says
  ``degraded=True``.
* **Result cache** (``serving.cache.ResultCache``) — admission probes the
  cache under the exact class plan the request would run with; hits skip
  the coalescer and are charged a fixed ``hit_latency_us``.

Bit-identity: batches form within one service class, padded rows are
masked out of candidates and counters by ``qvalid``, and the datapath is
per-query deterministic, so every response's ids and distances, and the
summed ledger, are those of sequential ``db.query`` calls with the same
per-request plans.

The virtual-clock latencies are modelled from the tier ledger, not
measured on any device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.anns.api import Database, QueryPlan, SearchResult
from repro_torch.anns.executor import bucket_for, pad_chunk
from repro_torch.memory import QueryCost, Tier
from repro_torch.obs import metrics as obs_metrics, trace
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.serving.cache import ResultCache, query_keys

__all__ = ["Request", "Response", "TenantQoS", "TokenBucket",
           "VirtualClock", "ServingEngine", "ServingStats", "Retriever",
           "Engine", "ServeStats", "RagResult", "rag_answer"]


@dataclass(frozen=True)
class Request:
    """One serving request: a single query vector (best a host copy: the
    cache key is computed from it on the CPU) and its scheduling data.
    ``rid`` is assigned by the engine in arrival order when ``None``."""

    query: object                      # (D,) float vector
    tenant: str = "default"
    k: int | None = None               # None → the plan's k
    arrival_us: float = 0.0
    deadline_us: float = math.inf
    rid: int | None = None


@dataclass
class Response:
    """One completed request.  ``cost`` is the ledger of the batch it rode
    in (shared by its batch mates; None for a cache hit)."""

    rid: int
    tenant: str
    ids: np.ndarray
    distances: np.ndarray
    degraded: bool
    cache_hit: bool
    arrival_us: float
    admit_us: float
    done_us: float
    batch: int | None
    cost: QueryCost | None

    @property
    def latency_us(self) -> float:
        return self.done_us - self.arrival_us


@dataclass
class VirtualClock:
    """Deterministic microsecond clock; only ever advances."""

    now_us: float = 0.0

    def advance_to(self, t_us: float) -> None:
        self.now_us = max(self.now_us, t_us)


@dataclass
class TokenBucket:
    """Token bucket in request units, refilled on observation."""

    rate_per_s: float
    burst: float
    tokens: float = 0.0
    last_us: float = 0.0

    def __post_init__(self):
        self.tokens = self.burst

    def _refill(self, now_us: float) -> None:
        if now_us > self.last_us:
            self.tokens = min(
                self.burst,
                self.tokens + (now_us - self.last_us) * self.rate_per_s / 1e6)
            self.last_us = now_us

    def peek(self, now_us: float) -> bool:
        """True when a full-service token is available (not consumed)."""
        self._refill(now_us)
        return self.tokens >= 1.0

    def take(self, now_us: float) -> None:
        self._refill(now_us)
        self.tokens -= 1.0


@dataclass(frozen=True)
class TenantQoS:
    """A tenant's contract: sustained full-service rate and burst.
    ``rate_rps=None`` means unthrottled (never degraded)."""

    rate_rps: float | None = None
    burst: float = 8.0


@dataclass
class ServingStats:
    requests: int = 0
    batches: int = 0
    cache_hits: int = 0
    degraded: int = 0
    padded_slots: int = 0

    def as_dict(self) -> dict:
        return {"requests": self.requests, "batches": self.batches,
                "cache_hits": self.cache_hits, "degraded": self.degraded,
                "padded_slots": self.padded_slots}


@dataclass
class _Admitted:
    """A request past admission, waiting in its class queue."""

    deadline_us: float
    arrival_us: float
    rid: int
    req: Request
    admit_us: float
    qkey: bytes | None
    degraded: bool


@dataclass
class _Inflight:
    """A batch whose front was issued and whose finish was not retired yet
    (the double buffer holds at most one).  ``done`` is the side stream's
    event after the front (None on the CPU)."""

    bid: int
    batch: list
    cp: object
    qpad: torch.Tensor
    cand: object
    n: int
    dispatch_us: float
    degraded: bool
    done: torch.cuda.Event | None


def _front_tensors(qpad: torch.Tensor, cand) -> list[torch.Tensor]:
    """Every tensor a front made that its finish reads: the padded batch
    and each field and counter of the ``Candidates`` handle."""
    out = [qpad]
    for v in cand:
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif isinstance(v, dict):
            out.extend(t for t in v.values() if isinstance(t, torch.Tensor))
    return out


class ServingEngine:
    """Continuous-batching request scheduler over one ``Database``.

    index : an index of any layout, or a ``Database``; the engine runs on
        its device.
    plan : the base ``QueryPlan``; its ``micro_batch`` is set to
        ``max_batch`` so a coalesced batch is one micro-batch.
    max_batch, max_wait_us : the coalescer's close size and close age.
    qos : ``{tenant: TenantQoS}``; other tenants get ``default_qos``
        (None = unthrottled).
    degrade_factor : refine-budget divisor of throttled requests.
    cache : a ``ResultCache`` to answer repeats at admission.
    batching : False makes every batch one request.
    overlap : False turns the double buffer off (one serial unit).
    dispatch_overhead_us : fixed host cost per dispatched batch in the
        virtual timing model, the submit-and-sync round trip the tier
        ledger cannot see; coalescing amortizes it.
    mesh : a ``launch.mesh.SearchMesh`` for a sharded plan run across
        processes, one shard per rank (every rank serves the same
        requests).
    tracer : an ``obs.trace.Tracer`` active during ``run``, its virtual
        clock wired to the engine's.
    """

    def __init__(self, index, *, plan: QueryPlan | None = None,
                 max_batch: int = 8, max_wait_us: float = 200.0,
                 qos: dict | None = None,
                 default_qos: TenantQoS | None = None,
                 degrade_factor: int = 4,
                 cache: ResultCache | None = None,
                 batching: bool = True, overlap: bool = True,
                 dispatch_overhead_us: float = 50.0, mesh=None,
                 tracer=None):
        self.db = Database.wrap(index)
        self.mesh = mesh
        if not batching:
            max_batch, max_wait_us = 1, 0.0
        self.max_batch = int(max_batch)
        self.max_wait_us = float(max_wait_us)
        base = dataclasses.replace(plan or QueryPlan(),
                                   micro_batch=self.max_batch)
        self.base_plan = self.db.validate(base)
        self.qos = dict(qos or {})
        self.default_qos = default_qos
        self.degrade_factor = int(degrade_factor)
        self.cache = cache
        self.overlap = bool(overlap)
        self.dispatch_overhead_us = float(dispatch_overhead_us)
        if cache is not None:
            cache.attach(self.db.index)
        self.device = self.db.index.device
        # the double buffer's front stream (its fronts; finishes run on
        # the caller's current stream)
        self._side = torch.cuda.Stream(self.device) \
            if self.overlap and self.device.type == "cuda" else None

        self.clock = VirtualClock()
        self.stats = ServingStats()
        self.total_cost = QueryCost()
        self.batch_log: list[tuple] = []   # (bid, dispatch_us, rids)
        self._buckets: dict[str, TokenBucket] = {}
        self._queues: dict[tuple, list] = {}    # (k, degraded) → [_Admitted]
        self._plan_cache: dict[tuple, QueryPlan] = {}
        self._inflight: _Inflight | None = None
        self._next_rid = 0
        # the virtual pipeline units (module docstring)
        self._front_free_us = 0.0
        self._refine_free_us = 0.0
        self._busy_free_us = 0.0

        # a registry of the engine's own, active during ``run`` so the
        # datapath's series (fatrq_model_drift_ratio) land beside the
        # engine's
        self.registry = MetricsRegistry()
        self.tracer = tracer
        if tracer is not None and tracer.virtual_clock is None:
            tracer.virtual_clock = lambda: self.clock.now_us
        self._m_requests = self.registry.counter(
            "serving_requests_total", "requests admitted, by tenant",
            labelnames=("tenant",))
        self._m_throttled = self.registry.counter(
            "serving_throttled_total",
            "requests degraded by QoS throttling, by tenant",
            labelnames=("tenant",))
        self._m_queue_wait = self.registry.histogram(
            "serving_queue_wait_us",
            "virtual µs between admission and batch dispatch")
        self._m_occupancy = self.registry.histogram(
            "serving_batch_occupancy", "requests per dispatched batch",
            buckets=(1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0))
        self.registry.add_collector(self._mirror_stats)
        if cache is not None:
            cache.bind_metrics(self.registry)

    def _mirror_stats(self) -> None:
        """Export-time collector: ``ServingStats`` → the
        ``serving_stats{field=...}`` gauge family."""
        g = self.registry.gauge("serving_stats", "ServingStats snapshot",
                                labelnames=("field",))
        for name, v in self.stats.as_dict().items():
            g.labels(field=name).set(v)

    def metrics(self) -> dict:
        """One flat ``{"name{labels}": value}`` dict: scheduler counters,
        ServingStats, throttling per tenant, cache stats and the datapath
        series recorded during ``run``."""
        return self.registry.flat()

    # -- QoS ---------------------------------------------------------------

    def _bucket(self, tenant: str) -> TokenBucket | None:
        contract = self.qos.get(tenant, self.default_qos)
        if contract is None or contract.rate_rps is None:
            return None
        bucket = self._buckets.get(tenant)
        if bucket is None:
            bucket = self._buckets[tenant] = TokenBucket(
                rate_per_s=contract.rate_rps, burst=contract.burst,
                last_us=self.clock.now_us)
        return bucket

    def _class_plan(self, k: int, degraded: bool) -> QueryPlan:
        """The resolved plan of a (k, degraded) service class: a degraded
        class runs ``refine_budget // degrade_factor``, floored at k so
        the rerank stays well-formed."""
        key = (k, degraded)
        plan = self._plan_cache.get(key)
        if plan is None:
            rb = self.base_plan.refine_budget
            if degraded:
                rb = max(k, rb // self.degrade_factor)
            plan = self._plan_cache[key] = self.db.validate(
                dataclasses.replace(self.base_plan, k=k, refine_budget=rb))
        return plan

    # -- admission ---------------------------------------------------------

    def _admit(self, req: Request, responses: list,
               qkey: bytes | None) -> None:
        now = self.clock.now_us
        self.stats.requests += 1
        self._m_requests.labels(tenant=req.tenant).inc()
        rk = req.k or self.base_plan.k
        bucket = self._bucket(req.tenant)
        degraded = bucket is not None and not bucket.peek(now)
        trace.event("serve.admit", track="sched", rid=req.rid,
                    tenant=req.tenant, k=rk, degraded=degraded)
        if degraded:
            self._m_throttled.labels(tenant=req.tenant).inc()
            trace.event("serve.throttle", track="sched", rid=req.rid,
                        tenant=req.tenant)
        plan = self._class_plan(rk, degraded)
        if self.cache is not None:
            entry = self.cache.lookup(qkey, plan, self.db.generation)
            if entry is not None:
                self.stats.cache_hits += 1
                if degraded:
                    self.stats.degraded += 1
                trace.event("serve.cache_hit", track="sched", rid=req.rid,
                            tenant=req.tenant)
                responses.append(Response(
                    rid=req.rid, tenant=req.tenant,
                    ids=entry.ids.copy(), distances=entry.distances.copy(),
                    degraded=degraded, cache_hit=True,
                    arrival_us=req.arrival_us, admit_us=now,
                    done_us=now + self.cache.hit_latency_us,
                    batch=None, cost=None))
                return
        if degraded:
            self.stats.degraded += 1
        elif bucket is not None:
            bucket.take(now)        # full service consumes; misses only
        self._queues.setdefault((rk, degraded), []).append(_Admitted(
            deadline_us=req.deadline_us, arrival_us=req.arrival_us,
            rid=req.rid, req=req, admit_us=now, qkey=qkey,
            degraded=degraded))

    # -- coalescing + dispatch ---------------------------------------------

    def _dispatch_ready(self, responses: list, *, drain: bool = False) -> None:
        now = self.clock.now_us
        for class_key in list(self._queues):
            queue = self._queues[class_key]
            while queue:
                oldest = min(a.admit_us for a in queue)
                full = len(queue) >= self.max_batch
                aged = now >= oldest + self.max_wait_us
                if not (full or aged or drain):
                    break
                # EDF within the class: deadline, then arrival, then rid
                queue.sort(key=lambda a: (a.deadline_us, a.arrival_us, a.rid))
                batch, self._queues[class_key] = (
                    queue[:self.max_batch], queue[self.max_batch:])
                queue = self._queues[class_key]
                self._dispatch(class_key, batch, responses)
            if not self._queues[class_key]:
                del self._queues[class_key]

    def _stack(self, batch: list) -> torch.Tensor:
        """The batch's queries on the engine's device: stacked where they
        lie, then one copy (from pinned memory, asynchronous on the
        current stream) when they lie on the host and the engine runs on
        the GPU."""
        q = torch.stack([torch.as_tensor(a.req.query, dtype=torch.float32)
                         for a in batch])
        if q.device == self.device:
            return q
        if self.device.type == "cuda" and q.device.type == "cpu":
            return q.pin_memory().to(self.device, non_blocking=True)
        return q.to(self.device)

    def _dispatch(self, class_key: tuple, batch: list,
                  responses: list) -> None:
        rk, degraded = class_key
        bid = len(self.batch_log)
        now = self.clock.now_us
        self.batch_log.append((bid, now, tuple(a.rid for a in batch)))
        self.stats.batches += 1
        self._m_occupancy.observe(len(batch))
        for a in batch:
            self._m_queue_wait.observe(now - a.admit_us)
        trace.event("serve.dispatch", track="sched", bid=bid, k=rk,
                    degraded=degraded, n=len(batch),
                    rids=[a.rid for a in batch])
        cp = self.db.compiled(self._class_plan(rk, degraded), mesh=self.mesh)
        n = len(batch)
        bucket = bucket_for(n, self.max_batch)
        self.stats.padded_slots += bucket - n
        if self.overlap and cp.supports_split:
            done = None
            if self._side is not None:
                # the front reads what the current stream wrote (the
                # index's rows after an insert, a new executor's tensors)
                self._side.wait_stream(torch.cuda.current_stream(self.device))
            with (torch.cuda.stream(self._side) if self._side is not None
                  else contextlib.nullcontext()):
                qpad, qvalid = pad_chunk(self._stack(batch), bucket)
                cand = cp.run_front(qpad, qvalid=qvalid)
                if self._side is not None:
                    done = self._side.record_event()
            # retire the PREVIOUS batch's finish only after this front is
            # issued: the double buffer
            self._retire_inflight(responses)
            self._inflight = _Inflight(bid=bid, batch=batch, cp=cp,
                                       qpad=qpad, cand=cand, n=n,
                                       dispatch_us=now, degraded=degraded,
                                       done=done)
        else:
            self._retire_inflight(responses)
            res = cp.execute(self._stack(batch), pad=True)
            self._complete(bid, batch, cp, res, n, now, degraded, responses,
                           split=False)

    def _retire_inflight(self, responses: list) -> None:
        fl = self._inflight
        if fl is None:
            return
        self._inflight = None
        if fl.done is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(fl.done)
            for t in _front_tensors(fl.qpad, fl.cand):
                t.record_stream(cur)
        res = fl.cp.run_finish(fl.qpad, fl.cand)
        self._complete(fl.bid, fl.batch, fl.cp, res, fl.n, fl.dispatch_us,
                       fl.degraded, responses, split=True)

    # -- completion --------------------------------------------------------

    def _complete(self, bid: int, batch: list, cp, res: SearchResult, n: int,
                  dispatch_us: float, degraded: bool, responses: list,
                  *, split: bool) -> None:
        cost = res.cost
        front_s = cost.tier_seconds(Tier.HBM)
        # the per-batch host round trip rides on the front stage: the
        # fixed cost the coalescer amortizes over the batch
        f_us = front_s * 1e6 + self.dispatch_overhead_us
        r_us = max(cost.total_seconds() - front_s, 0.0) * 1e6
        tr = trace.active()
        if self.overlap and split:
            start_f = max(dispatch_us, self._front_free_us)
            front_done = start_f + f_us
            self._front_free_us = front_done
            start_r = max(front_done, self._refine_free_us)
            done = start_r + r_us
            self._refine_free_us = done
            if tr is not None:
                # the units' occupancy is known only now: the spans carry
                # explicit virtual intervals
                sp = tr.add_span("serve.batch", track="sched",
                                 virtual_start_us=dispatch_us,
                                 virtual_end_us=done, bid=bid, n=n,
                                 degraded=degraded, split=True)
                tr.add_span("serve.front", track="unit:front",
                            virtual_start_us=start_f,
                            virtual_end_us=front_done,
                            parent=sp.sid, bid=bid)
                tr.add_span("serve.refine", track="unit:refine",
                            virtual_start_us=start_r, virtual_end_us=done,
                            parent=sp.sid, bid=bid)
        else:
            start = max(dispatch_us, self._busy_free_us)
            done = start + f_us + r_us
            self._busy_free_us = done
            if tr is not None:
                sp = tr.add_span("serve.batch", track="sched",
                                 virtual_start_us=dispatch_us,
                                 virtual_end_us=done, bid=bid, n=n,
                                 degraded=degraded, split=False)
                tr.add_span("serve.dispatch.serial", track="unit:serial",
                            virtual_start_us=start, virtual_end_us=done,
                            parent=sp.sid, bid=bid)
        self.total_cost.merge(cost)
        ids = res.ids[:n].cpu().numpy()
        dists = res.distances[:n].cpu().numpy()
        for i, adm in enumerate(batch):
            if self.cache is not None and adm.qkey is not None:
                self.cache.insert(adm.qkey, cp.plan, cp.generation,
                                  ids[i], dists[i], degraded=degraded)
            responses.append(Response(
                rid=adm.rid, tenant=adm.req.tenant,
                ids=ids[i], distances=dists[i],
                degraded=degraded, cache_hit=False,
                arrival_us=adm.arrival_us, admit_us=adm.admit_us,
                done_us=done, batch=bid, cost=cost))

    # -- event loop --------------------------------------------------------

    def run(self, requests: list) -> list:
        """Run a request trace to drain; responses in rid order.

        A discrete-event loop: the clock jumps between arrivals and
        coalescer close times, so the simulation is exact and
        deterministic.  The engine's metrics registry (and its tracer,
        if any) is active throughout."""
        with contextlib.ExitStack() as stack:
            stack.enter_context(obs_metrics.use(self.registry))
            if self.tracer is not None:
                stack.enter_context(trace.use(self.tracer))
            return self._run(requests)

    def _run(self, requests: list) -> list:
        pending = sorted(
            requests,
            key=lambda r: (r.arrival_us,
                           r.rid if r.rid is not None else math.inf))
        pending = [r if r.rid is not None
                   else dataclasses.replace(r, rid=self._fresh_rid())
                   for r in pending]
        # every request's cache key from one batched host encode: a key
        # depends on its query alone, so computing it ahead of admission
        # changes nothing
        qkeys = dict(zip((r.rid for r in pending), query_keys(torch.stack([
            torch.as_tensor(r.query, dtype=torch.float32).reshape(-1)
            for r in pending])))) \
            if self.cache is not None and pending else {}
        responses: list[Response] = []
        i = 0
        while i < len(pending) or self._queues:
            times = []
            if i < len(pending):
                times.append(pending[i].arrival_us)
            for queue in self._queues.values():
                times.append(min(a.admit_us for a in queue)
                             + self.max_wait_us)
            self.clock.advance_to(min(times))
            now = self.clock.now_us
            arrivals = []
            while i < len(pending) and pending[i].arrival_us <= now:
                arrivals.append(pending[i])
                i += 1
            # EDF admission order at this instant
            arrivals.sort(key=lambda r: (r.deadline_us, r.arrival_us, r.rid))
            for req in arrivals:
                self._admit(req, responses, qkeys.get(req.rid))
            self._dispatch_ready(responses)
        self._dispatch_ready(responses, drain=True)
        self._retire_inflight(responses)
        responses.sort(key=lambda r: r.rid)
        return responses

    def _fresh_rid(self) -> int:
        rid = self._next_rid
        self._next_rid += 1
        return rid

    def serve(self, queries, *, k: int | None = None,
              tenant: str = "default") -> list:
        """Submit one request per row at the current clock instant and run
        to drain; responses in input order.  The requests hold rows of one
        host copy of ``queries``."""
        queries = torch.as_tensor(queries, dtype=torch.float32).cpu()
        now = self.clock.now_us
        reqs = [Request(query=queries[i], tenant=tenant, k=k,
                        arrival_us=now, rid=self._fresh_rid())
                for i in range(queries.shape[0])]
        return self.run(reqs)


@dataclass
class Retriever:
    """Serving-side wrapper over a ``Database``: one default
    ``QueryPlan`` and a running traffic ledger (``total_cost``).

    ``front`` / ``backend`` / ``micro_batch`` / ``shards`` make the default
    plan (``backend=None``: the index's default, ``cuda`` on the GPU);
    ``plan=`` replaces them.  The plan is validated once against the
    capability registry and compiled once per index generation, so a
    ``StreamingIndex`` mutation or a ``TieredIndex`` migration rebuilds
    it.  ``index`` may be an index of any layout or a ``Database``; it
    runs on the index's device.  With ``bucket=True`` (the default)
    ragged micro-batches pad to their power-of-two bucket under a
    validity mask: the same answers and ledger from a fixed set of batch
    shapes."""

    index: object
    front: str = "ivf"
    backend: str | None = None
    micro_batch: int | None = 8
    shards: int | None = None
    plan: QueryPlan | None = None
    bucket: bool = True
    total_cost: QueryCost = field(default_factory=QueryCost)

    @property
    def db(self) -> Database:
        return Database.wrap(self.index)

    def default_plan(self) -> QueryPlan:
        if self.plan is not None:
            return self.plan
        return QueryPlan(front=self.front, backend=self.backend,
                         shards=self.shards, micro_batch=self.micro_batch)

    def retrieve(self, queries, *, k: int, micro_batch: int | None = None
                 ) -> tuple[torch.Tensor, QueryCost]:
        """The legacy tuple: (Q, k) ids and this call's ledger."""
        res = self.query(queries, k=k, micro_batch=micro_batch)
        return res.ids, res.cost

    def query(self, queries, *, k: int,
              micro_batch: int | None = None) -> SearchResult:
        """Planned retrieval → ``SearchResult``; folds the call's ledger
        into ``total_cost``.  ``micro_batch`` overrides the plan's for
        this call."""
        res = self.db.query(queries, plan=self.default_plan(), k=k,
                            micro_batch=micro_batch, bucket=self.bucket)
        self.total_cost.merge(res.cost)
        return res


# ----------------------------------------------------------- RAG serving
# The LM-facing half of the serving layer: a batched greedy decode engine
# and ``rag_answer``, the round trip that couples it to retrieval (embed
# the prompt, search, feed the retrieved context to the LM).


@dataclass
class ServeStats:
    steps: int = 0
    tokens: int = 0
    retrievals: int = 0


class Engine:
    """Batched greedy decode over a ``models.ModelApi`` model, with its
    family's cache (a KV cache, a recurrent state or both) on the model's
    device."""

    def __init__(self, api, params, *, batch: int, max_len: int,
                 dtype=torch.float32):
        self.api = api
        self.params = params
        self.batch = batch
        self.max_len = max_len
        self.device = next(params.parameters()).device
        self.cache = api.init_cache(params, batch, max_len, dtype)
        self.stats = ServeStats()

    def prefill(self, batch_inputs: dict) -> None:
        if self.api.prefill is not None:
            self.cache = self.api.prefill(self.params, batch_inputs,
                                          self.cache)

    def decode(self, tokens, steps: int) -> torch.Tensor:
        """tokens (B, 1) seed → (B, steps) greedy continuations (int32, on
        the model's device).  Greedy is ``argmax``, the first index on
        ties.  No step reads a device value on the host."""
        cur = torch.as_tensor(tokens).to(self.device)
        out = []
        with torch.inference_mode():
            for _ in range(steps):
                logits, self.cache = self.api.decode_step(self.params, cur,
                                                          self.cache)
                cur = torch.argmax(logits, dim=-1)[:, None].int()
                out.append(cur[:, 0])
                self.stats.steps += 1
                self.stats.tokens += self.batch
            return torch.stack(out, dim=1)


class RagResult(NamedTuple):
    """The RAG round trip's output: generated tokens, retrieved ids, the
    retrieval's ledger, and whether QoS throttling degraded any of the
    batch's retrievals (always False outside a ``ServingEngine``)."""

    tokens: torch.Tensor  # (B, decode_steps) greedy continuations
    ids: torch.Tensor     # (B, k) retrieved context ids
    cost: QueryCost       # retrieval ledger of this call
    degraded: bool        # any retrieval ran under a degraded QoS plan


def rag_answer(engine: Engine, index, embed_fn, prompt_tokens, *,
               k: int = 5, decode_steps: int = 8,
               retriever: Retriever | None = None, micro_batch: int = 8,
               plan: QueryPlan | None = None, serving=None) -> RagResult:
    """One RAG round trip: embed the prompts, retrieve the top-k context
    ids, prepend them (stub tokenization: ids mod vocab) and decode from
    the last token (no prefill).

    Retrieval goes through a default ``Retriever`` over ``index`` (with
    ``plan`` as its plan, its micro-batch ``micro_batch`` unless the plan
    sets one), through the caller's ``retriever``, or through a
    ``ServingEngine`` (``serving``): its ledger then merges once per
    engine batch, and ``degraded`` reports QoS degradation.  ``plan`` and
    ``retriever`` exclude each other; ``serving`` goes alone."""
    prompt_tokens = torch.as_tensor(prompt_tokens)
    q = embed_fn(prompt_tokens)                       # (B, D) embeddings
    if serving is not None:
        if retriever is not None or plan is not None:
            raise ValueError("pass serving= alone: a ServingEngine "
                             "carries its own plan and QoS config")
        resp = serving.serve(q, k=k)
        ids = torch.from_numpy(np.stack([r.ids for r in resp]))
        cost = QueryCost()
        seen_batches = set()
        for r in resp:
            if r.cost is not None and r.batch not in seen_batches:
                seen_batches.add(r.batch)
                cost.merge(r.cost)
        degraded = any(r.degraded for r in resp)
    else:
        if retriever is None:
            if plan is not None and plan.micro_batch is None:
                plan = dataclasses.replace(plan, micro_batch=micro_batch)
            retriever = Retriever(index=index, micro_batch=micro_batch,
                                  plan=plan)
        elif plan is not None:
            raise ValueError("pass plan= or retriever=, not both: a "
                             "Retriever carries its own plan")
        ids, cost = retriever.retrieve(q, k=k)
        degraded = False
    engine.stats.retrievals += q.shape[0]
    # stub contextualization: retrieved ids become context tokens
    ctx = (ids % engine.api.cfg.vocab).to(device=prompt_tokens.device,
                                          dtype=torch.int32)
    seed = torch.cat([ctx, prompt_tokens.int()], dim=1)[:, -1:]
    gen = engine.decode(seed, decode_steps)
    return RagResult(tokens=gen, ids=ids, cost=cost, degraded=degraded)
