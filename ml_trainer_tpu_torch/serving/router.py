"""Disaggregated prefill/decode serving: a router over N engine replicas
(the core of the JAX package's ``serving/router.py``).

Each replica is a ``Server`` (in this process, or a worker process
behind ``fleet.RemoteServer``).  The router places requests, moves their
KV between replicas and keeps every stream alive across replica deaths:

* **Roles.**  A replica advertises ``role`` (``prefill`` / ``decode`` /
  ``both``).  Disaggregated (any replica not ``both``): a request
  prefills on a prefill replica, its slot's KV migrates page by page
  (``transfer.py``) to a decode replica, which carries the stream to its
  end.  Colocated (every replica ``both``): the same router serves the
  same traffic with no migration.
* **Placement.**  Prefill placement hashes ``tenant + adapter + the
  prompt's first KV block`` on a ring of virtual nodes (``_HashRing``),
  so requests sharing a system prompt land on one prefill replica and
  its prefix cache keeps hitting.  Decode placement is least-loaded over
  the replicas' last health payloads, with session stickiness (a
  ``session`` key pins a stream's decode to one replica until it dies).
* **Migration.**  The prefill replica emits the first token, exports the
  slot and releases it (its prompt donated to its prefix cache); the
  router serializes the export once per candidate (the payload the
  metrics count), verifies it (CRC32) and adopts it into the decode
  replica, whose import writes the pages in place.  A refused payload
  (``migration_corrupt``, a flipped byte) goes to the next candidate.
* **Failures.**  A health poller reads every replica's ``/healthz``; a
  replica that dies fails its streams with structured errors, and the
  router resubmits each on a survivor with its committed tokens as a
  resumable prefix (the preempt-resume path, so the tokens stay the
  same), up to ``max_redistributes``.  Circuit breakers, flap damping
  (``unhealthy_after``), hedged prefills for deterministic requests and
  a fleet-wide ``DegradationLadder`` harden the client path.

* **Generations.**  Every replica belongs to a deploy generation (a
  weights wave).  ``deploy`` (``serving/deploy.py``) adds a new
  generation and points the tenant-hash slice ``[0, fraction)``
  (``tenant_slice``, ``set_deploy_split``) at it; ``promote_generation``
  makes it the serving one.  An attempt places, hedges and adopts
  within one generation: KV never crosses weights.
* **Watchtower.**  The health poll samples the process registry into
  ``router.watchtower`` (a ``TimeSeriesStore``) and evaluates
  ``router.alerts`` (an ``AlertEngine``: ``alert_rules``,
  ``add_alert_rule``) on it; the autoscaler's and the deploy canary's
  burn watches are rules on the same engine.

Left out (ROADMAP.md Queue A 7): the rest of the telemetry half (metrics
federation and the scrape of the workers' expositions, fleet traces,
incident bundles, ``/trace`` and ``/dash``); each raises
``NotImplementedError``.

The router's gauges (``publish``): ``router_requests_total{role=,
replica=}``, ``router_kv_migrated_bytes_total``,
``router_migrations_total``, ``router_redistributes_total``, the
hedging, CRC, shed and flap counters, ``router_breaker_state``,
``router_replica_healthy``, each replica's SLO attainment and the
router's own request-level SLO accounting.
"""

from __future__ import annotations

import bisect
import dataclasses
import hashlib
import json
import queue as _queue
import threading
import time
import urllib.error
import urllib.request
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ml_trainer_tpu_torch.resilience.faults import active_plan
from ml_trainer_tpu_torch.serving import transfer
from ml_trainer_tpu_torch.serving.api import (
    _KV_MIGRATE as _MIGRATE,
    Server,
    TokenStream,
)
from ml_trainer_tpu_torch.serving.overload import (
    OPEN,
    CircuitBreaker,
    DegradationConfig,
    DegradationLadder,
    OverloadShed,
    RollingQuantile,
)
from ml_trainer_tpu_torch.serving.scheduler import (
    _DONE,
    AdmissionError,
    EngineUnhealthy,
    Request,
)
from ml_trainer_tpu_torch.serving.slo import SloPolicy, SloTracker
from ml_trainer_tpu_torch.serving.transfer import MigrationCorrupt
from ml_trainer_tpu_torch.telemetry.alerts import AlertEngine, AlertRule
from ml_trainer_tpu_torch.telemetry.flight import get_recorder
from ml_trainer_tpu_torch.telemetry.watchtower import TimeSeriesStore


def _not_ported(what: str, queue: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet; see ROADMAP.md Queue A {queue}")


class Replica:
    """One replica behind the router: its server (a ``Server`` or a
    ``fleet.RemoteServer``) and its routing state (role, deploy
    generation, last health payload, liveness, breaker)."""

    def __init__(self, name: str, server, url: Optional[str] = None,
                 breaker: Optional[CircuitBreaker] = None,
                 generation: int = 0):
        self.name = name
        self.server = server
        self.url = url
        self.role = server.role
        # The weights wave it belongs to: one stream never mixes
        # generations, and the deploy split selects the pool by it.
        self.generation = int(generation)
        self.weights_fp = getattr(getattr(server, "engine", None),
                                  "weights_fp", None)
        self.healthy = True
        self.last_health: dict = {}
        # Placements since the last health refresh: without it every tie
        # lands on one replica until the next poll.
        self.pending = 0
        self.breaker = breaker if breaker is not None else CircuitBreaker()
        self.fail_polls = 0
        self.removing = False

    def fetch_health(self, timeout: float = 2.0) -> dict:
        """The ``/healthz`` payload: over HTTP when the replica has a
        URL (a 503 still carries it), else the in-process snapshot."""
        if not self.url:
            return self.server.health()
        try:
            with urllib.request.urlopen(f"{self.url}/healthz",
                                        timeout=timeout) as resp:
                return json.loads(resp.read())
        except urllib.error.HTTPError as e:
            try:
                return json.loads(e.read())
            except Exception:  # noqa: BLE001 - an unreadable 503 is down
                return {"ok": False, "healthy": False,
                        "reason": f"healthz HTTP {e.code}"}
        except Exception as e:  # noqa: BLE001 - unreachable is down
            return {"ok": False, "healthy": False,
                    "reason": f"healthz unreachable: {e}"}

    def placeable(self) -> bool:
        """Alive, not draining out of the fleet, breaker not open."""
        return (self.healthy and not self.removing
                and self.breaker.state != OPEN)

    def try_place(self) -> bool:
        """Placeable now (a half-open breaker lets one probe through)."""
        return self.placeable() and self.breaker.allow()

    def load_score(self) -> tuple:
        """Least-loaded order: occupied slots + queued + pending
        adoptions + placements since the last poll, then the freest KV
        pool, then the name."""
        h = self.last_health or {}
        depth = (int(h.get("active_slots") or 0)
                 + int(h.get("queue_depth") or 0)
                 + int(h.get("adoptions_pending") or 0) + self.pending)
        return (depth, -(int(h.get("kv_pages_free") or 0)), self.name)


class _HashRing:
    """Consistent hashing with virtual nodes (sha1): a key maps to the
    first clockwise vnode whose replica is alive, so losing a replica
    remaps only its own arcs."""

    def __init__(self, names: Sequence[str], vnodes: int = 64):
        self._points: List[Tuple[int, str]] = sorted(
            (self._hash(f"{name}#{i}".encode()), name)
            for name in names for i in range(vnodes))

    @staticmethod
    def _hash(key: bytes) -> int:
        return int(hashlib.sha1(key).hexdigest()[:16], 16)

    def place(self, key: bytes, alive) -> Optional[str]:
        if not self._points:
            return None
        start = bisect.bisect_right(self._points, (self._hash(key), ""))
        n = len(self._points)
        for i in range(n):
            name = self._points[(start + i) % n][1]
            if name in alive:
                return name
        return None


class RouterMetrics:
    """The router's counters (thread-safe), published as ``router_*``."""

    _COUNTERS = ("migrations_total", "kv_migrated_bytes_total",
                 "redistributes_total", "hedges_total", "hedge_wins_total",
                 "migrations_corrupt_total", "shed_total",
                 "flaps_damped_total", "errors_total")

    def __init__(self):
        self._lock = threading.Lock()
        self.requests_total: Dict[Tuple[str, str], int] = {}
        self.replica_healthy: Dict[str, int] = {}
        for name in self._COUNTERS:
            setattr(self, name, 0)

    def _add(self, name: str, n: int = 1) -> None:
        with self._lock:
            setattr(self, name, getattr(self, name) + int(n))

    def record_request(self, replica: str, role: str) -> None:
        with self._lock:
            key = (role, replica)
            self.requests_total[key] = self.requests_total.get(key, 0) + 1

    def record_migration(self, nbytes: int) -> None:
        with self._lock:
            self.migrations_total += 1
            self.kv_migrated_bytes_total += int(nbytes)

    def record_redistribute(self) -> None:
        self._add("redistributes_total")

    def record_hedge(self) -> None:
        self._add("hedges_total")

    def record_hedge_win(self) -> None:
        self._add("hedge_wins_total")

    def record_corrupt_migration(self) -> None:
        self._add("migrations_corrupt_total")

    def record_shed(self) -> None:
        self._add("shed_total")

    def record_flap_damped(self) -> None:
        self._add("flaps_damped_total")

    def record_error(self) -> None:
        self._add("errors_total")

    def set_replica_health(self, name: str, ok: bool) -> None:
        with self._lock:
            self.replica_healthy[name] = int(ok)

    def snapshot(self) -> dict:
        with self._lock:
            snap = {"requests_total": {
                f"{role}/{rep}": n
                for (role, rep), n in sorted(self.requests_total.items())}}
            snap.update({name: getattr(self, name)
                         for name in self._COUNTERS})
            snap["replica_healthy"] = dict(sorted(
                self.replica_healthy.items()))
            return snap


class Router:
    """The multi-replica front end: role-aware placement, KV migration,
    session stickiness, health polling, drain-and-redistribute.  A
    context manager; ``Router.build`` makes the replicas in-process.

    ``unhealthy_after``: consecutive failed health polls before a replica
    leaves the pool (flap damping).  ``breaker_threshold`` /
    ``breaker_cooldown_s``: per-replica circuit breakers (None: off).
    ``hedging``: a duplicate prefill on another replica once a request
    has waited ``hedge_factor`` x the rolling ``hedge_quantile`` of
    first-result latency (at least ``hedge_min_s``); only deterministic
    requests (greedy, or sampled with a seed) hedge.  ``degradation``
    configures ``router.ladder``, applied to every replica.
    ``alert_rules``: declarative rules for ``router.alerts``, evaluated
    on every health poll over ``router.watchtower``."""

    # How often the health poll samples the process registry into the
    # watchtower (the JAX router's default ``metrics_scrape_interval``).
    WATCHTOWER_INTERVAL_S = 1.0

    def __init__(self, replicas: Dict[str, Server], *,
                 replica_urls: Optional[Dict[str, str]] = None,
                 max_redistributes: int = 8,
                 health_interval: float = 0.25,
                 admission_retry_s: float = 10.0,
                 max_inflight: Optional[int] = None,
                 slo: Optional[SloPolicy] = None,
                 slo_timelines: int = 256,
                 own_servers: bool = False,
                 unhealthy_after: int = 2,
                 breaker_threshold: Optional[int] = 3,
                 breaker_cooldown_s: float = 2.0,
                 hedging: bool = True,
                 hedge_quantile: float = 0.99,
                 hedge_factor: float = 1.5,
                 hedge_min_s: float = 0.05,
                 degradation: Optional[DegradationConfig] = None,
                 metrics_scrape_interval: Optional[float] = None,
                 incident_dir: Optional[str] = None,
                 incident_min_interval_s: Optional[float] = None,
                 alert_rules: Optional[Sequence[AlertRule]] = None):
        for arg, value in (("metrics_scrape_interval",
                            metrics_scrape_interval),
                           ("incident_dir", incident_dir),
                           ("incident_min_interval_s",
                            incident_min_interval_s)):
            if value is not None:
                raise _not_ported(f"Router({arg}=...), the fleet telemetry",
                                  "7")
        if not replicas:
            raise ValueError("router needs at least one replica")
        if unhealthy_after < 1:
            raise ValueError(
                f"unhealthy_after must be >= 1, got {unhealthy_after}")
        urls = replica_urls or {}
        self.breaker_threshold = breaker_threshold
        self.breaker_cooldown_s = float(breaker_cooldown_s)
        self._replicas: Dict[str, Replica] = {
            name: Replica(name, srv, urls.get(name),
                          breaker=self._new_breaker())
            for name, srv in sorted(replicas.items())}
        roles = {r.role for r in self._replicas.values()}
        self.mode = "colocated" if roles == {"both"} else "disagg"
        for name, rep in self._replicas.items():
            self._validate_geometry(name, rep.server)
        engines = [r.server.engine for r in self._replicas.values()]
        e0 = engines[0]
        self.max_len = e0.max_len
        self.vocab_size = e0.vocab_size
        self._spec_slack = max(e.spec_k for e in engines)
        self._affinity_block = max(e0.kv_page_size, 1) if e0.paged else 16
        self.max_redistributes = int(max_redistributes)
        self.admission_retry_s = float(admission_retry_s)
        self.max_inflight = (
            int(max_inflight) if max_inflight is not None
            else sum(r.server.scheduler.max_queue + r.server.engine.max_batch
                     for r in self._replicas.values()))
        self._own_servers = own_servers
        self.metrics = RouterMetrics()
        self.slo = SloTracker(policy=slo, keep_timelines=slo_timelines)
        self._lock = threading.Lock()
        self._sessions: Dict[str, str] = {}
        self._inflight = 0
        # Deploy state (``serving/deploy.py``): the generation serving
        # default traffic, the deployment's target generation and its
        # tenant-hash fraction, the finished-request tap (shadow replay)
        # and the fleet launcher when one built this router.
        self._serving_generation = 0
        self._deploy_generation: Optional[int] = None
        self._deploy_fraction = 0.0
        self._request_tap = None
        self._deployment = None
        self.fleet = None
        self._stopping = False
        self._stop_event = threading.Event()
        self._httpd = None
        self._http_thread = None
        self.unhealthy_after = int(unhealthy_after)
        self.hedging = bool(hedging)
        self.hedge_quantile = float(hedge_quantile)
        self.hedge_factor = float(hedge_factor)
        self.hedge_min_s = float(hedge_min_s)
        # First-result latency (submit -> first token or migration), the
        # hedging clock; it inflates with the queues, so hedges back off
        # under overload.
        self._first_result_lat = RollingQuantile(window=256, min_samples=8,
                                                 default=1.0)
        self.ladder = DegradationLadder(
            lambda: [r.server for r in self._replicas.values()],
            config=degradation, name="router")
        # The fleet's time series and its alert engine.  No incident
        # trigger: a ``page`` rule fires and records (Queue A 7 brings
        # the incident bundles).
        self.watchtower = TimeSeriesStore()
        self.alerts = AlertEngine(alert_rules or (), store=self.watchtower)
        self._wt_sampled_at = -float("inf")
        self._reindex_replicas()
        self._rebuild_ring()
        self._busy_polls = 0
        for rep in self._replicas.values():
            rep.last_health = rep.fetch_health()
            self.metrics.set_replica_health(rep.name, True)
        self._health_interval = float(health_interval)
        self._poller = threading.Thread(target=self._poll_health,
                                        daemon=True, name="router-health")
        self._poller.start()

    def _new_breaker(self) -> CircuitBreaker:
        if self.breaker_threshold is None:
            return CircuitBreaker(threshold=10 ** 9, cooldown_s=1.0)
        return CircuitBreaker(threshold=self.breaker_threshold,
                              cooldown_s=self.breaker_cooldown_s)

    def _validate_geometry(self, name: str, server) -> None:
        """One replica's engine against the fleet's first."""
        e0 = next(iter(self._replicas.values())).server.engine
        e = server.engine
        if e.max_len != e0.max_len or e.vocab_size != e0.vocab_size:
            raise ValueError(
                "replicas must share model geometry: got max_len "
                f"{e.max_len} vs {e0.max_len}, vocab {e.vocab_size} vs "
                f"{e0.vocab_size}")
        if self.mode == "disagg":
            if not e.paged:
                raise ValueError(
                    "disaggregated mode needs paged engines (kv_page_size "
                    f"> 0): replica '{name}' is contiguous; pages are the "
                    "migration unit")
            if e.kv_page_size != e0.kv_page_size:
                raise ValueError(
                    "replicas must share kv_page_size for migration")

    def _reindex_replicas(self) -> None:
        """Fleet indices in name order: what the chaos faults' ``host``
        names."""
        for i, name in enumerate(sorted(self._replicas)):
            self._replicas[name].server.replica_index = i

    def _rebuild_ring(self) -> None:
        names = [n for n, r in self._replicas.items()
                 if r.role in ("prefill", "both")] or list(self._replicas)
        self._ring = _HashRing(names)

    # -- construction -----------------------------------------------------

    @classmethod
    def build(cls, model, roles: Sequence[str], max_batch: int = 4,
              kv_page_size: int = 16, router_kwargs: Optional[dict] = None,
              **server_kwargs) -> "Router":
        """One ``Server`` per entry of ``roles`` (named ``prefill0``,
        ``decode0``, ``rep0``, ...), all over ``model`` (one set of
        weights on the device), and the router in front, which owns and
        closes them.  ``server_kwargs`` go to every ``Server`` (e.g.
        ``paged_kernel``, ``device``)."""
        counts: Dict[str, int] = {}
        replicas: Dict[str, Server] = {}
        try:
            for role in roles:
                stem = {"prefill": "prefill", "decode": "decode"}.get(role,
                                                                      "rep")
                i = counts.get(stem, 0)
                counts[stem] = i + 1
                replicas[f"{stem}{i}"] = Server(
                    model, max_batch=max_batch, kv_page_size=kv_page_size,
                    role=role, **server_kwargs)
            return cls(replicas, own_servers=True, **(router_kwargs or {}))
        except BaseException:
            for srv in replicas.values():
                srv.close()
            raise

    def replica(self, name: str) -> Replica:
        return self._replicas[name]

    @property
    def replicas(self) -> Dict[str, Replica]:
        return dict(self._replicas)

    # -- client surface ---------------------------------------------------

    def submit(self, prompt, max_new_tokens: int, temperature: float = 0.0,
               rng: Optional[int] = None,
               eos_token_id: Optional[int] = None,
               deadline: Optional[float] = None, tenant: str = "default",
               priority: int = 0, session: Optional[str] = None,
               adapter: Optional[str] = None,
               trace: Optional[dict] = None) -> TokenStream:
        """Route one request (thread-safe); the stream is
        ``Server.submit``'s, its tokens flowing across migrations and
        redistributions.  ``session`` pins the decode to a sticky
        replica; ``adapter`` names the LoRA adapter (it is part of the
        affinity key).  ``trace`` (a fleet trace context) is not ported
        (ROADMAP.md Queue A 7)."""
        if trace is not None:
            raise _not_ported("Router.submit(trace=...), the fleet trace "
                              "context", "7")
        if self._stopping:
            raise RuntimeError("router is closed")
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("prompt must be a non-empty 1-D token array")
        if max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}")
        if prompt.size + max_new_tokens + self._spec_slack > self.max_len:
            raise ValueError(
                f"prompt ({prompt.size}) + new tokens ({max_new_tokens}) "
                f"exceeds the fleet's max_len ({self.max_len})")
        if eos_token_id is not None and not (
                0 <= eos_token_id < self.vocab_size):
            raise ValueError(f"eos_token_id must be in [0, "
                             f"{self.vocab_size}), got {eos_token_id}")
        if not isinstance(tenant, str) or not tenant:
            raise ValueError(
                f"tenant must be a non-empty string, got {tenant!r}")
        if adapter is not None and (not isinstance(adapter, str)
                                    or not adapter):
            raise ValueError(f"adapter must be a non-empty string or None, "
                             f"got {adapter!r}")
        with self._lock:
            if self._inflight >= self.max_inflight:
                raise AdmissionError(
                    f"router at its in-flight watermark ({self.max_inflight})"
                    "; request rejected")
            self._inflight += 1
        creq = Request(prompt=prompt, max_new_tokens=int(max_new_tokens),
                       temperature=float(temperature), rng=rng,
                       eos_token_id=eos_token_id, deadline=deadline,
                       tenant=tenant, priority=int(priority),
                       adapter=adapter)
        creq.observer = self.slo.observe
        self.slo.track(creq)
        threading.Thread(target=self._run_request, args=(creq, session),
                         daemon=True, name=f"router-req-{creq.id}").start()
        return TokenStream(creq, prompt)

    def complete(self, prompt, max_new_tokens: int,
                 timeout: Optional[float] = None, **kwargs) -> np.ndarray:
        """Blocking one-shot through the router."""
        return self.submit(prompt, max_new_tokens, **kwargs).result(
            timeout=timeout)

    @staticmethod
    def _serving_replica(creq: Request) -> Optional[str]:
        """The replica carrying the request's decode: the newest
        migration, adoption or placement mark; None before placement."""
        for ev in reversed(creq.events):
            kind = ev.get("event")
            if kind in ("kv_migrated", "evac_adopted"):
                return ev.get("to")
            if kind == "routed":
                return ev.get("decode")
        return None

    def kill_replica(self, name: str) -> None:
        """Kill a replica (chaos, tests): it fails its streams with
        structured errors, which the router redistributes, and leaves
        the pool.  A fleet worker process gets a real ``SIGKILL``
        (``RemoteServer.kill_process``); an in-process replica is marked
        unhealthy."""
        rep = self._replicas[name]
        rep.healthy = False
        self.metrics.set_replica_health(name, False)
        kill = getattr(rep.server, "kill_process", None)
        if kill is not None:
            kill()
        rep.server._mark_unhealthy(f"replica '{name}' killed")

    # -- fleet management -------------------------------------------------

    def add_replica(self, name: str, server, url: Optional[str] = None,
                    generation: Optional[int] = None) -> None:
        """Grow the fleet by one replica (thread-safe).  It takes the
        fleet's degradation rung and joins the ring and the pools; its
        geometry must match.  ``generation`` defaults to the serving
        one, so the autoscaler's additions during a deploy grow the
        stable fleet; the deploy passes its target generation."""
        if name in self._replicas:
            raise ValueError(f"replica '{name}' already exists")
        if server.role not in ("prefill", "decode", "both"):
            raise ValueError(f"bad role {server.role!r}")
        if self.mode == "colocated" and server.role != "both":
            raise ValueError(
                "a colocated fleet only takes role='both' replicas")
        self._validate_geometry(name, server)
        if url is None:
            url = getattr(server, "url", None)  # a RemoteServer's
        if generation is None:
            generation = self._serving_generation
        rep = Replica(name, server, url, breaker=self._new_breaker(),
                      generation=generation)
        server.set_degradation(self.ladder.level, self.ladder.config)
        rep.last_health = rep.fetch_health()
        with self._lock:
            self._replicas = {**self._replicas, name: rep}
        self._reindex_replicas()
        self._rebuild_ring()
        self.metrics.set_replica_health(name, True)
        get_recorder().record(
            "fleet_change", action="add_replica", replica=name,
            role=server.role, fleet=len(self._replicas),
            generation=generation)

    def remove_replica(self, name: str, timeout: float = 30.0,
                       close: Optional[bool] = None) -> bool:
        """Shrink the fleet by one replica: stop placing on it, wait
        (up to ``timeout``) for it to drain, detach it, and close it when
        the router owns the fleet (or ``close=True``).  False when it did
        not drain: its work was failed and is redistributed."""
        rep = self._replicas[name]
        rep.removing = True
        deadline = time.monotonic() + timeout
        drained = False
        while time.monotonic() < deadline and not self._stopping:
            h = rep.fetch_health()
            if (not h.get("active_slots") and not h.get("queue_depth")
                    and not h.get("adoptions_pending")):
                drained = True
                break
            self._stop_event.wait(0.05)
        with self._lock:
            reps = dict(self._replicas)
            reps.pop(name, None)
            self._replicas = reps
            self._sessions = {s: n for s, n in self._sessions.items()
                              if n != name}
        self._reindex_replicas()
        self._rebuild_ring()
        if not drained:
            rep.server._mark_unhealthy(f"replica '{name}' removed")
        if close if close is not None else self._own_servers:
            rep.server.close()
        self.metrics.set_replica_health(name, False)
        get_recorder().record(
            "fleet_change", action="remove_replica", replica=name,
            drained=drained, fleet=len(self._replicas))
        return drained

    def reassign_role(self, name: str, role: str,
                      timeout: float = 30.0) -> bool:
        """Flip a replica prefill <-> decode by evacuating it through
        the migration machinery first: its active slots' KV is adopted
        elsewhere (the streams keep flowing), its queue redistributes,
        then the role flips and the ring is rebuilt.  False (role
        unchanged) when the evacuation timed out."""
        if role not in ("prefill", "decode"):
            raise ValueError(
                f"role must be 'prefill' or 'decode', got {role!r}")
        if self.mode != "disagg":
            raise ValueError("role reassignment needs a disagg fleet")
        rep = self._replicas[name]
        if rep.role == role:
            return True
        rep.removing = True
        evacuated = rep.server.evacuate(
            lambda req, export: self._adopt_evacuated(req, export, rep),
            timeout=timeout)
        if not evacuated:
            rep.removing = False
            return False
        rep.role = role
        rep.server.role = role
        rep.removing = False
        with self._lock:
            self._sessions = {s: n for s, n in self._sessions.items()
                              if n != name}
        self._rebuild_ring()
        get_recorder().record("fleet_change", action="reassign_role",
                              replica=name, role=role)
        return True

    def deploy(self, ckpt: str, canary: Optional[float] = None,
               shadow: bool = False, *, factory=None, config=None):
        """Roll the fleet onto new weights under live traffic
        (``serving/deploy.py``): new-generation replicas from ``ckpt``,
        the tenant-hash slice ``[0, canary)`` pointed at them, the
        slice's SLO burn watched, then a ramp to 100% and the old
        generation retired, or a rollback through the drain path with
        no stream dropped.  ``canary`` replaces ``config``'s when given
        (the JAX router's default of 0.05 replaces it always; the port
        keeps ``config.canary``, whose default is that 0.05).
        ``shadow=True`` first replays sampled live requests on the new
        replicas off the serving path.  ``factory`` (role -> server)
        defaults to the attached fleet's ``deploy_factory(ckpt)``.
        Returns the started ``Deployment``."""
        from ml_trainer_tpu_torch.serving.deploy import (
            DeployConfig,
            Deployment,
        )

        active = self._deployment
        if active is not None and not active.finished():
            raise RuntimeError(
                f"a deployment is already {active.state}; wait for it or "
                "close() it before starting another")
        if factory is None:
            if self.fleet is None:
                raise ValueError(
                    "Router.deploy needs a server factory: attach a Fleet "
                    "(Fleet.make_router) or pass factory=")
            factory = self.fleet.deploy_factory(ckpt)
        cfg = config if config is not None else DeployConfig()
        if canary is not None:
            cfg = dataclasses.replace(cfg, canary=float(canary))
        if shadow:
            cfg = dataclasses.replace(cfg, shadow=True)
        self._deployment = Deployment(self, ckpt, factory, config=cfg)
        return self._deployment.start()

    def _adopt_evacuated(self, req: Request, export, source: Replica
                         ) -> None:
        """The evacuation sink: land the export on another decode
        candidate (a fresh, verified serialization each); when none can
        take it the request fails with a retryable ``draining`` error and
        its pump redistributes it."""
        for rep in self._decode_candidates(generation=source.generation):
            if rep is source or not rep.try_place():
                continue
            payload = transfer.to_bytes(export)
            try:
                self._ship(rep, req, payload)
            except MigrationCorrupt:
                self.metrics.record_corrupt_migration()
                continue
            except (AdmissionError, EngineUnhealthy, RuntimeError):
                continue
            self.metrics.record_migration(len(payload))
            req.mark("evac_adopted", to=rep.name)
            return
        req.finish("error",
                   "replica draining for role reassignment: no candidate "
                   "could adopt the evacuated KV; request redistributed")

    # -- the deploy traffic split (serving/deploy.py) ---------------------

    @staticmethod
    def tenant_slice(tenant: str) -> float:
        """A tenant's fixed coordinate in [0, 1): a deploy at fraction
        ``f`` sends exactly the tenants with ``tenant_slice(t) < f`` to
        the new generation, the same ones on every poll and in every
        process (the JAX router's hash)."""
        h = hashlib.sha1(b"deploy|" + tenant.encode()).hexdigest()[:8]
        return int(h, 16) / float(1 << 32)

    def set_deploy_split(self, generation: Optional[int],
                         fraction: float) -> None:
        """Point the slice ``[0, fraction)`` at ``generation`` (None
        tears the split down: all traffic on the serving generation)."""
        with self._lock:
            self._deploy_generation = generation
            self._deploy_fraction = float(fraction)

    def promote_generation(self, generation: int) -> None:
        """Make ``generation`` the serving one: default traffic and the
        autoscaler's additions land there from now on."""
        with self._lock:
            self._serving_generation = int(generation)
            self._deploy_generation = None
            self._deploy_fraction = 0.0

    def _target_generation(self, tenant: str) -> int:
        """The generation that serves ``tenant`` now."""
        gen, frac = self._deploy_generation, self._deploy_fraction
        if gen is not None and self.tenant_slice(tenant) < frac:
            return gen
        return self._serving_generation

    @staticmethod
    def _gen_pool(pool: Dict[str, Replica], generation: int
                  ) -> Dict[str, Replica]:
        """``pool`` cut to one generation; the whole pool when none of
        it is of that generation (serving somewhere beats refusing: the
        deploy watches the burn, it never relies on placement
        failing)."""
        sub = {n: r for n, r in pool.items() if r.generation == generation}
        return sub or pool

    # -- alerts -----------------------------------------------------------

    def add_alert_rule(self, rule: AlertRule) -> AlertRule:
        """One more rule on the fleet's engine (evaluated from the next
        health poll)."""
        return self.alerts.add_rule(rule)

    @property
    def alert_rules(self) -> List[AlertRule]:
        """The engine's rules, in the order they were added."""
        return list(self.alerts.rules.values())

    # -- not ported -------------------------------------------------------

    def scrape_metrics(self, *args, **kwargs):
        raise _not_ported("Router.scrape_metrics (metrics federation)", "7")

    def federated_metrics_text(self, *args, **kwargs):
        raise _not_ported("Router.federated_metrics_text (metrics "
                          "federation)", "7")

    def fleet_trace(self, *args, **kwargs):
        raise _not_ported("Router.fleet_trace (fleet traces)", "7")

    def save_fleet_trace(self, *args, **kwargs):
        raise _not_ported("Router.save_fleet_trace (fleet traces)", "7")

    def trigger_incident(self, *args, **kwargs):
        raise _not_ported("Router.trigger_incident (incident bundles)", "7")

    def save_incident_bundle(self, *args, **kwargs):
        raise _not_ported("Router.save_incident_bundle (incident bundles)",
                          "7")

    # -- health, snapshot, close ------------------------------------------

    def health(self) -> dict:
        """The router's ``/healthz``: liveness plus every replica's last
        health snapshot."""
        reps = {
            name: {"healthy": rep.healthy, "role": rep.role,
                   "breaker": rep.breaker.state,
                   **{k: rep.last_health.get(k) for k in (
                       "active_slots", "queue_depth", "kv_pages_free",
                       "adoptions_pending", "adapters_resident",
                       "degradation_level")}}
            for name, rep in self._replicas.items()}
        n_alive = sum(1 for r in self._replicas.values() if r.healthy)
        with self._lock:
            inflight, sessions = self._inflight, len(self._sessions)
        return {"ok": n_alive > 0 and not self._stopping, "mode": self.mode,
                "replicas_alive": n_alive,
                "replicas_total": len(self._replicas), "inflight": inflight,
                "sessions": sessions,
                "degradation_level": self.ladder.level, "replicas": reps}

    def snapshot(self) -> dict:
        """The router's counters and state in one JSON-safe dict."""
        snap = self.metrics.snapshot()
        snap["mode"] = self.mode
        snap["degradation"] = self.ladder.snapshot()
        with self._lock:
            snap["inflight"] = self._inflight
            snap["sessions"] = len(self._sessions)
            snap["serving_generation"] = self._serving_generation
            snap["deploy_generation"] = self._deploy_generation
            snap["deploy_fraction"] = self._deploy_fraction
        return snap

    def close(self) -> None:
        self._stopping = True
        self._stop_event.set()
        if self._deployment is not None:
            self._deployment.close()
        if self._own_servers:
            for rep in self._replicas.values():
                rep.server.close()
        self._poller.join(timeout=10.0)
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._http_thread.join(timeout=10.0)
            self._httpd = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- placement --------------------------------------------------------

    def _alive(self) -> Dict[str, Replica]:
        return {n: r for n, r in self._replicas.items() if r.placeable()}

    def _affinity_key(self, tenant: str, prompt: np.ndarray,
                      adapter: Optional[str] = None) -> bytes:
        """The ring's key: tenant, adapter and the prompt's first KV
        block, so a shared system prompt keeps hitting one prefill
        replica's prefix cache and an adapter stays resident where it
        is used."""
        block = np.asarray(prompt[: self._affinity_block],
                           np.int32).tobytes()
        return (tenant.encode() + b"\x1f" + (adapter or "").encode()
                + b"|" + block)

    def _first_allowed(self, pool: Dict[str, Replica], name: str,
                       what: str) -> Replica:
        """``pool[name]`` if its breaker lets a request through, else the
        least-loaded replica of ``pool`` whose breaker does."""
        rep = pool[name]
        if rep.breaker.allow():
            return rep
        others = sorted((r for r in pool.values()
                         if r is not rep and r.breaker.allow()),
                        key=Replica.load_score)
        if not others:
            raise EngineUnhealthy(
                f"no placeable {what}replica: breakers open/probing")
        return others[0]

    def _place(self, creq: Request, session: Optional[str],
               exclude_prefill: Optional[str] = None
               ) -> Tuple[Replica, Replica]:
        """(prefill replica, decode replica) for one attempt, from the
        live health and the breakers; ``exclude_prefill`` skips a replica
        (a hedge never duplicates onto the one it hedges).  Raises
        ``EngineUnhealthy`` when nothing is placeable."""
        alive = self._alive()
        if not alive:
            raise EngineUnhealthy("no healthy replica available")
        # The deploy split first: the whole attempt (prefill, decode,
        # hedges, adoption candidates) stays in one generation.
        alive = self._gen_pool(alive, self._target_generation(creq.tenant))
        key = self._affinity_key(creq.tenant, creq.prompt, creq.adapter)
        if self.mode == "colocated":
            pool = {n: r for n, r in alive.items()
                    if n != exclude_prefill} or alive
            name = self._ring.place(key, pool) or sorted(pool)[0]
            rep = self._first_allowed(pool, name, "")
            return rep, rep
        prefill_pool = {n: r for n, r in alive.items()
                        if r.role in ("prefill", "both")} or alive
        decode_pool = {n: r for n, r in alive.items()
                       if r.role in ("decode", "both")} or alive
        if exclude_prefill and len(prefill_pool) > 1:
            prefill_pool = {n: r for n, r in prefill_pool.items()
                            if n != exclude_prefill}
        name = self._ring.place(key, prefill_pool) or sorted(prefill_pool)[0]
        prefill = self._first_allowed(prefill_pool, name, "prefill ")
        decode = None
        if session:
            with self._lock:
                sticky = self._sessions.get(session)
            if sticky in decode_pool and decode_pool[sticky].placeable():
                decode = decode_pool[sticky]
        if decode is None:
            decode = min(decode_pool.values(), key=Replica.load_score)
            if session:
                with self._lock:
                    self._sessions[session] = decode.name
        decode.pending += 1
        return prefill, decode

    def _decode_candidates(self, generation: Optional[int] = None
                           ) -> List[Replica]:
        alive = self._alive()
        if generation is not None:
            alive = {n: r for n, r in alive.items()
                     if r.generation == generation}
        pool = [r for r in alive.values()
                if r.role in ("decode", "both")] or list(alive.values())
        return sorted(pool, key=Replica.load_score)

    # -- the per-request state machine ------------------------------------

    def _run_request(self, creq: Request, session: Optional[str]) -> None:
        try:
            self._serve(creq, session)
        except Exception as e:  # noqa: BLE001 - never hang a client
            if creq.state in ("queued", "active"):
                self.metrics.record_error()
                creq.finish("error",
                            f"router failure: {type(e).__name__}: {e}")
        finally:
            with self._lock:
                self._inflight -= 1
            tap = self._request_tap
            if tap is not None:
                try:  # the deploy's shadow sampling never fails a stream
                    tap(creq)
                except Exception:  # noqa: BLE001
                    pass

    def _remaining_deadline(self, creq: Request) -> Optional[float]:
        if creq.deadline is None:
            return None
        return creq.deadline - (time.monotonic() - creq.submitted_at)

    def _shadow(self, creq: Request, committed: List[int],
                deadline: Optional[float]) -> Request:
        """One attempt's replica-side request: the same prompt and
        sampling state, the committed tokens as its resume prefix, the
        remaining deadline, and the preemptions so far (so the engine's
        give-up stays structured across replicas)."""
        shadow = Request(prompt=creq.prompt,
                         max_new_tokens=creq.max_new_tokens,
                         temperature=creq.temperature, rng=creq.rng,
                         eos_token_id=creq.eos_token_id, deadline=deadline,
                         tenant=creq.tenant, priority=creq.priority,
                         adapter=creq.adapter)
        shadow.tokens = [int(t) for t in committed]
        shadow.preemptions = creq.preemptions
        return shadow

    def _serve(self, creq: Request, session: Optional[str]) -> None:
        redistributes = 0
        while True:
            if self._stopping:
                creq.finish("error", "router is closed")
                return
            deadline = self._remaining_deadline(creq)
            if deadline is not None and deadline <= 0:
                creq.finish(
                    "expired",
                    f"deadline ({creq.deadline}s) passed while routing "
                    f"({redistributes} redistribution(s) consumed the "
                    "budget)")
                return
            # Resume from what the client received: a token a dying
            # replica recorded but the pump never forwarded is computed
            # again (deterministically), never skipped.
            shadow = self._shadow(creq, list(creq.tokens), deadline)
            placed = self._submit_attempt(creq, shadow, session)
            if placed is None:
                return  # _submit_attempt finished creq with the reason
            prefill_rep, decode_rep = placed
            outcome, shadow, decode_rep = self._pump(
                creq, shadow, decode_rep, prefill_rep, session)
            if outcome == "done":
                creq.preemptions = shadow.preemptions
                decode_rep.breaker.record_success()
                creq.finish("done")
                return
            if outcome == "expired":
                creq.finish("expired", shadow.error)
                return
            if outcome == "shed":
                self.metrics.record_shed()
                creq.retry_after = shadow.retry_after
                creq.finish("shed", shadow.error)
                return
            if outcome == "retry":
                redistributes += 1
                self.metrics.record_redistribute()
                decode_rep.breaker.record_failure(shadow.error
                                                  or "stream failed")
                creq.preemptions = shadow.preemptions + 1
                creq.mark("redistributed", attempt=redistributes,
                          committed_tokens=len(creq.tokens),
                          error=shadow.error)
                if redistributes > self.max_redistributes:
                    self.metrics.record_error()
                    creq.finish(
                        "error",
                        f"request {creq.id} (tenant '{creq.tenant}') "
                        f"redistributed {redistributes}x after replica "
                        "failures; giving up after max_redistributes="
                        f"{self.max_redistributes} (last: {shadow.error})")
                    return
                continue
            self.metrics.record_error()
            creq.finish("error", shadow.error or "replica error")
            return

    def _submit_attempt(self, creq: Request, shadow: Request,
                        session: Optional[str],
                        exclude_prefill: Optional[str] = None,
                        quiet: bool = False
                        ) -> Optional[Tuple[Replica, Replica]]:
        """Place and submit one attempt: ``(prefill, decode)``, or None
        after finishing ``creq`` with a structured error (``quiet``, the
        hedge's path: None only means no duplicate).  The retry window is
        capped by the request's remaining deadline."""
        give_up_at = time.monotonic() + self.admission_retry_s
        deadline_at = (creq.submitted_at + creq.deadline
                       if creq.deadline is not None else None)
        if deadline_at is not None:
            give_up_at = min(give_up_at, deadline_at)
        last_err = "no healthy replica available"
        while not self._stopping:
            try:
                prefill_rep, decode_rep = self._place(
                    creq, session, exclude_prefill=exclude_prefill)
            except EngineUnhealthy as e:
                last_err = str(e)
                if time.monotonic() > give_up_at or quiet:
                    break
                self._stop_event.wait(0.05)
                continue
            disagg = prefill_rep is not decode_rep
            shadow.migration_sink = (
                (lambda r, exp: r._stream.put((_MIGRATE, exp)))
                if disagg else None)
            try:
                prefill_rep.server.submit_request(shadow)
            except OverloadShed as e:
                # The replica's ladder refused it: a structured terminal.
                if quiet:
                    return None
                creq.retry_after = e.retry_after
                self.metrics.record_shed()
                creq.finish("shed", str(e))
                return None
            except AdmissionError as e:
                last_err = str(e)
                prefill_rep.breaker.record_success()  # alive, just full
                if time.monotonic() > give_up_at or quiet:
                    break
                self._stop_event.wait(0.02)
                continue
            except (EngineUnhealthy, RuntimeError) as e:
                # The poller will confirm; do not wait for it.
                last_err = str(e)
                prefill_rep.breaker.record_failure(str(e))
                prefill_rep.healthy = False
                self.metrics.set_replica_health(prefill_rep.name, False)
                if time.monotonic() > give_up_at or quiet:
                    break
                continue
            creq.mark("routed", prefill=prefill_rep.name,
                      decode=decode_rep.name, disagg=disagg,
                      hedge=bool(exclude_prefill))
            self.metrics.record_request(
                prefill_rep.name, "prefill" if disagg else "colocated")
            return prefill_rep, decode_rep
        if quiet:
            return None
        if deadline_at is not None and time.monotonic() >= deadline_at:
            creq.finish("expired",
                        f"deadline ({creq.deadline}s) passed while placing "
                        f"request {creq.id}: {last_err}")
            return None
        self.metrics.record_error()
        creq.finish("error",
                    f"router could not place request {creq.id} (tenant "
                    f"'{creq.tenant}'): {last_err}")
        return None

    def _hedge_after_s(self) -> float:
        return max(self.hedge_min_s, self.hedge_factor
                   * self._first_result_lat.quantile(self.hedge_quantile))

    def _hedge_eligible(self, creq: Request) -> bool:
        """A duplicate must compute the same bytes: greedy, or sampled
        with a pinned seed."""
        return self.hedging and (creq.temperature == 0.0
                                 or creq.rng is not None)

    def _pump(self, creq: Request, shadow: Request, decode_rep: Replica,
              prefill_rep: Replica, session: Optional[str]) -> tuple:
        """Forward the shadow's stream to the client, adopting the KV
        export into the decode replica when it arrives and hedging the
        attempt when the first result is late.  Returns ``(outcome,
        winning shadow, decode replica)``; outcome is ``done``,
        ``expired``, ``shed``, ``retry`` (a replica failed: redistribute)
        or ``error``."""
        t0 = time.monotonic()
        first_seen = False
        hedge_shadow: Optional[Request] = None
        hedge_pair: Optional[Tuple[Replica, Replica]] = None
        hedge_at = (t0 + self._hedge_after_s()
                    if self._hedge_eligible(creq) else None)
        while True:
            wait = 0.5
            if not first_seen and hedge_at is not None:
                wait = min(wait, max(hedge_at - time.monotonic(), 0.01))
            try:
                item = shadow._stream.get(timeout=wait)
            except _queue.Empty:
                if self._stopping:
                    shadow.error = shadow.error or "router is closed"
                    return "error", shadow, decode_rep
                if (not first_seen and hedge_at is not None
                        and hedge_shadow is None
                        and time.monotonic() >= hedge_at):
                    hedge_shadow, hedge_pair = self._fire_hedge(
                        creq, prefill_rep, session)
                    if hedge_shadow is None:
                        # No idle capacity now: look again shortly.
                        hedge_at = time.monotonic() + 0.25
                if hedge_shadow is not None and not first_seen:
                    try:
                        h_item = hedge_shadow._stream.get(timeout=0.02)
                    except _queue.Empty:
                        continue
                    # The hedge won: cancel the primary, swap streams.
                    self.metrics.record_hedge_win()
                    creq.mark("hedge_won", prefill=hedge_pair[0].name,
                              decode=hedge_pair[1].name)
                    self._cancel_attempt(prefill_rep, shadow)
                    shadow, hedge_shadow = hedge_shadow, None
                    prefill_rep, decode_rep = hedge_pair
                    item = h_item
                else:
                    continue
            if not first_seen:
                first_seen = True
                if hedge_at is None or time.monotonic() < hedge_at:
                    # Only unhedged first results feed the clock.
                    self._first_result_lat.observe(time.monotonic() - t0)
                if hedge_shadow is not None:
                    self._cancel_attempt(hedge_pair[0], hedge_shadow)
                    hedge_shadow = None
            if item == _DONE:
                if shadow.state in ("done", "expired", "shed"):
                    return shadow.state, shadow, decode_rep
                if self._stopping or not self._retryable(shadow.error):
                    return "error", shadow, decode_rep
                return "retry", shadow, decode_rep
            if isinstance(item, tuple) and item[0] == _MIGRATE:
                if not self._adopt(creq, shadow, decode_rep, item[1]):
                    return "retry", shadow, decode_rep
                continue
            creq.push_token(int(item))

    def _fire_hedge(self, creq: Request, primary_prefill: Replica,
                    session: Optional[str]):
        """The duplicate prefill on another prefill replica, only onto
        idle capacity (a saturated fleet is the ladder's job).  Returns
        ``(shadow, (prefill, decode))`` or ``(None, None)``."""
        pool = [r for r in self._alive().values()
                if r.role in ("prefill", "both") and r is not primary_prefill
                and r.generation == primary_prefill.generation]
        if not pool:
            return None, None
        best = min(pool, key=Replica.load_score)
        if best.load_score()[0] >= best.server.engine.max_batch:
            return None, None
        hedge_shadow = self._shadow(creq, list(creq.tokens),
                                    self._remaining_deadline(creq))
        placed = self._submit_attempt(creq, hedge_shadow, session,
                                      exclude_prefill=primary_prefill.name,
                                      quiet=True)
        if placed is None:
            return None, None
        if placed[0] is primary_prefill:
            self._cancel_attempt(placed[0], hedge_shadow)
            return None, None
        self.metrics.record_hedge()
        creq.mark("hedged", prefill=placed[0].name, decode=placed[1].name,
                  after_ms=round(self._hedge_after_s() * 1e3, 1))
        return hedge_shadow, placed

    def _cancel_attempt(self, rep: Replica, shadow: Request) -> None:
        """Withdraw a raced attempt's loser (best effort)."""
        try:
            rep.server.cancel(shadow)
        except Exception:  # noqa: BLE001 - the loser is abandoned anyway
            pass

    @staticmethod
    def _ship(rep: Replica, req: Request, payload: bytes) -> None:
        """One adoption: over the fleet's wire (``adopt_payload``: the
        CRC is checked in the receiving process) or in this process
        (verified on deserialization, again at import)."""
        adopt_payload = getattr(rep.server, "adopt_payload", None)
        if adopt_payload is not None:
            adopt_payload(req, payload)
        else:
            rep.server.adopt(req, transfer.from_bytes(payload))

    def _adopt(self, creq: Request, shadow: Request, decode_rep: Replica,
               export) -> bool:
        """Hand the export to a decode replica: the placed one first,
        then any healthy candidate.  Each gets a fresh serialization (the
        bytes the metrics count), verified before a page is written; a
        corrupt payload goes to the next candidate.  The candidates are
        of the exporting attempt's generation: other weights would refuse
        the KV (``WeightsMismatch``)."""
        candidates = [decode_rep] + [
            r for r in self._decode_candidates(
                generation=decode_rep.generation) if r is not decode_rep]
        for rep in candidates:
            if not rep.try_place():
                continue
            payload = transfer.to_bytes(export)
            plan = active_plan()
            if plan is not None and plan.fire("migration_corrupt"):
                # One bit flipped in flight: the CRC check must catch it.
                flipped = bytearray(payload)
                flipped[len(flipped) // 2] ^= 0x40
                payload = bytes(flipped)
            try:
                self._ship(rep, shadow, payload)
            except MigrationCorrupt as e:
                self.metrics.record_corrupt_migration()
                creq.mark("migration_corrupt", to=rep.name, error=str(e))
                continue
            except AdmissionError:
                continue
            except (EngineUnhealthy, RuntimeError) as e:
                rep.breaker.record_failure(str(e))
                rep.healthy = False
                self.metrics.set_replica_health(rep.name, False)
                continue
            self.metrics.record_migration(len(payload))
            self.metrics.record_request(rep.name, "decode")
            creq.mark("kv_migrated", to=rep.name, kv_bytes=len(payload),
                      pages=export.n_pages)
            return True
        shadow.error = ("serving engine unhealthy: no decode replica could "
                        "adopt the migrated KV")
        return False

    @staticmethod
    def _retryable(err: Optional[str]) -> bool:
        """Replica-level failures redistribute; the engine's structured
        give-ups and unknown errors reach the client as they are."""
        if not err or "max_preemptions" in err:
            return False
        return any(needle in err for needle in (
            "unhealthy", "server closed", "wedged", "engine thread died",
            "killed", "draining"))

    # -- health polling ---------------------------------------------------

    def _poll_health(self) -> None:
        while not self._stopping:
            self._fire_chaos_kill()
            for rep in list(self._replicas.values()):
                payload = rep.fetch_health()
                rep.last_health = payload
                rep.pending = 0
                ok = (bool(payload.get("healthy"))
                      and not payload.get("draining")
                      and not payload.get("closed"))
                if ok:
                    rep.fail_polls = 0
                else:
                    rep.fail_polls += 1
                    if rep.fail_polls < self.unhealthy_after and rep.healthy:
                        # One failed poll is a transient until
                        # ``unhealthy_after`` in a row confirm it.
                        self.metrics.record_flap_damped()
                        continue
                rep.healthy = ok
                self.metrics.set_replica_health(rep.name, ok)
            self._watchtower_tick()
            self._stop_event.wait(self._health_interval)

    def _watchtower_tick(self) -> None:
        """One sweep on the health poll: the router's gauges published
        and the process registry sampled into ``self.watchtower`` every
        ``WATCHTOWER_INTERVAL_S``, then the alert rules evaluated.  The
        workers' expositions join the store with ``scrape_metrics``
        (Queue A 7).  Never raises: the poller outlives any sweep."""
        from ml_trainer_tpu_torch.telemetry.registry import default_registry

        try:
            now = time.time()
            mono = time.monotonic()
            if mono - self._wt_sampled_at >= self.WATCHTOWER_INTERVAL_S:
                self._wt_sampled_at = mono
                registry = default_registry()
                self.publish(registry)
                self.watchtower.sample_registry(registry, t=now, force=True)
            self.alerts.evaluate(now=now)
        except Exception:  # noqa: BLE001 - observability never kills it
            pass

    def _fire_chaos_kill(self) -> None:
        """``replica_kill``: at the matching busy poll, kill the replica
        whose fleet index is the fault's ``host``."""
        plan = active_plan()
        if plan is None:
            return
        with self._lock:
            busy = self._inflight > 0
        if not busy:
            return
        self._busy_polls += 1
        fault = plan.fire("replica_kill", step=self._busy_polls)
        if fault is None:
            return
        for name, rep in sorted(self._replicas.items()):
            if rep.server.replica_index == fault.host and rep.healthy:
                self.kill_replica(name)
                return

    def publish(self, registry=None) -> dict:
        """The router's counters as gauges on ``registry`` (default: the
        process registry); returns the snapshot."""
        from ml_trainer_tpu_torch.telemetry.registry import default_registry

        r = registry if registry is not None else default_registry()
        snap = self.metrics.snapshot()
        req = r.gauge("router_requests_total",
                      "requests placed by the router, by role and replica",
                      labelnames=("role", "replica"))
        for key, n in snap["requests_total"].items():
            role, replica = key.split("/", 1)
            req.labels(role=role, replica=replica).set(float(n))
        for name, help_ in (
                ("kv_migrated_bytes_total",
                 "serialized KV payload bytes migrated prefill -> decode"),
                ("migrations_total",
                 "KV migrations adopted by decode replicas"),
                ("redistributes_total",
                 "in-flight requests redistributed off a failed replica"),
                ("hedges_total",
                 "duplicate prefills fired after the rolling-p99 hedge "
                 "clock"),
                ("hedge_wins_total",
                 "hedged duplicates that beat the primary attempt"),
                ("migrations_corrupt_total",
                 "KV migration payloads refused by the CRC32 verify"),
                ("shed_total",
                 "requests shed by the degradation ladder at the router"),
                ("flaps_damped_total",
                 "failed health polls absorbed by flap damping")):
            r.gauge(f"router_{name}", help_).set(float(snap[name]))
        breaker = r.gauge(
            "router_breaker_state",
            "per-replica circuit breaker (0 closed, 1 half-open, 2 open)",
            labelnames=("replica",))
        for name, rep in self._replicas.items():
            breaker.labels(replica=name).set(
                float(rep.breaker.gauge_value()))
        self.ladder.publish(r)
        healthy = r.gauge(
            "router_replica_healthy",
            "1 while the replica is placeable, 0 once it left the pool",
            labelnames=("replica",))
        for name, ok in snap["replica_healthy"].items():
            healthy.labels(replica=name).set(float(ok))
        att = r.gauge(
            "router_replica_slo_attainment",
            "per-replica SLO attainment (each replica's own SloTracker)",
            labelnames=("slo", "replica"))
        for name, rep in self._replicas.items():
            rep_snap = rep.server.slo.snapshot()
            for k in ("ttft", "tpot"):
                att.labels(slo=k, replica=name).set(
                    rep_snap["attainment"][k])
        self.slo.publish(r)
        return snap

    # -- HTTP front end ---------------------------------------------------

    def serve_http(self, host: str = "127.0.0.1", port: int = 0):
        """The router's stdlib HTTP front end (``Server.serve_http``'s
        contract): ``POST /v1/generate`` (with an optional ``"session"``
        for stickiness), ``GET /healthz``, ``/metrics`` (the router's
        gauges on the process registry), ``/metrics.json`` (the
        snapshot) and ``/slo``.  Returns the bound ``(host, port)``."""
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        from ml_trainer_tpu_torch.serving.scheduler import DeadlineExceeded
        from ml_trainer_tpu_torch.telemetry.registry import default_registry

        if self._httpd is not None:
            raise RuntimeError("the HTTP front end is already serving on "
                               f"{self._httpd.server_address}")
        router = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # quiet: the metrics count
                pass

            def _send(self, code: int, payload: dict,
                      retry_after: Optional[float] = None):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                if retry_after is not None:
                    self.send_header("Retry-After",
                                     str(max(1, int(round(retry_after)))))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    payload = router.health()
                    self._send(200 if payload["ok"] else 503, payload)
                elif self.path == "/metrics":
                    registry = default_registry()
                    router.publish(registry)
                    body = registry.prometheus_text().encode()
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        "text/plain; version=0.0.4; charset=utf-8")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif self.path == "/metrics.json":
                    self._send(200, router.snapshot())
                elif self.path == "/slo":
                    self._send(200, router.slo.snapshot())
                else:
                    self._send(404, {"error": "not found"})

            def do_POST(self):
                if self.path != "/v1/generate":
                    self._send(404, {"error": "not found"})
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    body = json.loads(self.rfile.read(n) or b"{}")
                    session = body.get("session")
                    deadline = body.get("deadline")
                    stream = router.submit(
                        np.asarray(body["prompt"], np.int32),
                        int(body.get("max_new_tokens", 16)),
                        temperature=float(body.get("temperature", 0.0)),
                        rng=body.get("seed"),
                        eos_token_id=body.get("eos_token_id"),
                        deadline=deadline,
                        tenant=str(body.get("tenant", "default")),
                        priority=int(body.get("priority", 0)),
                        session=str(session) if session else None,
                        adapter=body.get("adapter"))
                    # Capped by the client's own deadline (plus slack).
                    out = stream.result(timeout=(
                        float(deadline) + 30.0
                        if deadline is not None else None))
                    self._send(200, {
                        "tokens": [int(t) for t in out],
                        "replica": router._serving_replica(stream.request)})
                except OverloadShed as e:
                    payload = {"error": str(e)}
                    if e.retry_after is not None:
                        payload["retry_after"] = e.retry_after
                    self._send(503, payload, retry_after=e.retry_after)
                except AdmissionError as e:
                    self._send(429, {"error": str(e)})
                except EngineUnhealthy as e:
                    self._send(503, {"error": str(e)})
                except (DeadlineExceeded, TimeoutError) as e:
                    self._send(504, {"error": str(e)})
                except (KeyError, TypeError, ValueError) as e:
                    self._send(400, {"error": f"{type(e).__name__}: {e}"})
                except RuntimeError as e:
                    # Structured terminals (the redistribution budget, an
                    # engine give-up) reach the client as JSON.
                    self._send(503, {"error": str(e)})

        class HTTPServer(ThreadingHTTPServer):
            request_queue_size = 128

        self._httpd = HTTPServer((host, port), Handler)
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="router-http")
        self._http_thread.start()
        return self._httpd.server_address
