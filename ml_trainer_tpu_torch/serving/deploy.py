"""Live base-model rollout: canary and shadow deploys with SLO-burn
auto-rollback under traffic (the JAX package's ``serving/deploy.py``).

``Router.deploy(ckpt)`` builds a :class:`Deployment`, a small state
machine over the router's fleet machinery:

    staging -> [shadowing] -> canary -> ramping -> done
                                  \\-> rolling_back -> rolled_back

* **staging** spawns a full new-generation replica set from the
  checkpoint export, mirroring the serving generation's role mix, and
  warms each (on the card its first decoding request captures its
  decode graph).  No traffic moves yet.
* **shadowing** (opt-in) replays a sampled fraction of live finished
  requests against the new replicas OFF the serving path and diffs
  tokens + latency into :meth:`Deployment.shadow_report`.  A greedy
  token mismatch rolls back before any real traffic moves.
* **canary** points the deterministic tenant-hash slice
  ``[0, canary)`` (``Router.tenant_slice``) at the new generation and
  watches that slice's SLO burn through the router's ``SloTracker``.
  The slice is a stable cohort — the same tenants on every poll — so
  the burn signal is attributable to the new weights, not churn.
* **ramping** advances the slice through ``DeployConfig.stages``
  (default 5% -> 50% -> 100%), holding each stage ``hold_s`` of clean
  burn before moving.  After the final stage holds, the new generation
  is promoted (``Router.promote_generation``) and the old replicas are
  retired through the drain path.
* **rolling_back** fires when the canary slice's burn sits at/over
  ``burn_threshold`` for ``high_polls`` consecutive polls (with enough
  window requests to mean anything): the split tears down first (new
  canary traffic lands back on stable instantly), then the new
  replicas drain/evacuate out.  In-flight canary streams either drain
  clean or fail-and-redistribute onto the stable fleet, which
  re-prefills them: KV is never adopted across weights (the
  ``WeightsMismatch`` fingerprint gate in ``serving/transfer.py``), and
  no stream is dropped.  The incident bundle the JAX package assembles
  before the teardown comes with Queue A 7 (ROADMAP.md).

Every transition is a flight-recorder ``deploy`` event and the current
state is exported as ``serving_deploy_*`` gauges.  ``tick()`` runs one
state-machine step synchronously (tests drive it with a fake clock);
``start()`` runs it on a timer thread, autoscaler-style.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, List, Optional

import numpy as np

from ml_trainer_tpu_torch.serving.scheduler import Request
from ml_trainer_tpu_torch.serving.slo import aggregate_timelines
from ml_trainer_tpu_torch.telemetry.alerts import AlertEngine, AlertRule
from ml_trainer_tpu_torch.telemetry.flight import get_recorder
from ml_trainer_tpu_torch.utils.logging import get_logger

# Terminal states: the deployment thread exits, Router.deploy() will
# accept a new deployment.
TERMINAL_STATES = ("done", "rolled_back", "failed")


@dataclasses.dataclass(frozen=True)
class DeployConfig:
    """Knobs for one rollout."""

    # Traffic plan: first stage is the canary fraction; the ramp then
    # visits every stage above it, in order, ending at 1.0.
    canary: float = 0.05
    stages: tuple = (0.5, 1.0)
    # Shadow mode: replay `shadow_fraction` of live finished requests
    # against the new generation off the serving path; require
    # `shadow_min_requests` diffed replays (or give up after
    # `shadow_timeout_s` and proceed — shadowing needs live traffic).
    shadow: bool = False
    shadow_fraction: float = 0.25
    shadow_min_requests: int = 4
    shadow_timeout_s: float = 120.0
    shadow_replay_timeout_s: float = 60.0
    # Burn watch: roll back when the canary slice's windowed burn
    # (max of TTFT/TPOT) sits at/over `burn_threshold` for
    # `high_polls` consecutive polls with at least
    # `min_window_requests` finished requests in the window.
    burn_threshold: float = 2.0
    high_polls: int = 2
    window_s: float = 30.0
    min_window_requests: int = 3
    # Ramp pacing: a stage must hold `hold_s` without a high-burn poll
    # before the fraction advances (and before the final promote).
    # With `stage_min_requests` > 0 a stage additionally may not
    # advance until the canary window has REPORTED that many finished
    # requests — holding on "no data" instead of ramping past a slice
    # whose requests are all still in flight (a slow regression would
    # otherwise outrun the watch).  0 lets traffic-free deploys
    # promote on the hold timer alone.
    hold_s: float = 3.0
    stage_min_requests: int = 0
    poll_interval_s: float = 0.5
    # Staging warmup: run a few off-path greedy requests through every
    # new replica before any traffic moves, so the canary's first
    # clients never pay the cold start (on the card: the kernels'
    # first launches and the decode graph's capture), and the burn
    # watch never mistakes warmup latency for a weights regression.
    warmup: bool = True
    warmup_tokens: int = 4
    warmup_timeout_s: float = 120.0
    # Drain budget per replica when retiring a generation (either
    # direction — rollback or post-promote retirement).
    drain_timeout_s: float = 30.0

    def __post_init__(self):
        if not 0.0 < self.canary <= 1.0:
            raise ValueError(f"canary must be in (0, 1], got {self.canary}")
        if any(not 0.0 < s <= 1.0 for s in self.stages):
            raise ValueError(f"stages must be in (0, 1], got {self.stages}")
        if self.burn_threshold <= 0 or self.high_polls < 1:
            raise ValueError(
                "burn_threshold must be > 0 and high_polls >= 1"
            )

    def fractions(self) -> tuple:
        """The full traffic plan: canary first, then every configured
        stage strictly above it (ascending), always ending at 1.0."""
        ramp = sorted({s for s in self.stages if s > self.canary} | {1.0})
        return (self.canary, *ramp)


class Deployment:
    """One live rollout of new base weights over a Router fleet.

    Built by ``Router.deploy()``; ``factory(role) -> server`` spawns a
    new-generation replica already loaded with the target checkpoint
    (``Fleet.deploy_factory`` for multi-process fleets; in-process
    callers pass their own).  Use ``wait()`` for the verdict, or drive
    ``tick()`` directly in tests."""

    def __init__(self, router, ckpt: str, factory: Callable,
                 config: Optional[DeployConfig] = None,
                 clock=time.monotonic):
        self.router = router
        self.ckpt = ckpt
        self.factory = factory
        self.config = config if config is not None else DeployConfig()
        self._clock = clock
        self._log = get_logger("ml_trainer_tpu_torch.serving.deploy")
        self._lock = threading.Lock()       # state + event list
        self._tick_lock = threading.Lock()  # one tick at a time
        self._stop = threading.Event()
        self._finished = threading.Event()
        self._thread: Optional[threading.Thread] = None

        self.state = "staging"
        self.generation = router._serving_generation + 1
        self.old_generation = router._serving_generation
        self.new_replicas: List[str] = []
        self.events: List[dict] = []
        self.last_burn: Optional[float] = None
        self.rollback_cause: Optional[str] = None
        self.weights_fp: Optional[str] = None
        self.old_weights_fp: Optional[str] = None

        self._stage_idx = -1               # index into config.fractions()
        self._stage_clean_since: Optional[float] = None
        self._split_since: Optional[float] = None  # time.monotonic stamp
        self._started_at = self._clock()

        # Shadow bookkeeping: the router's request tap feeds sampled
        # finished requests here; tick() replays and diffs them.
        self._shadow_pending: List[dict] = []
        self._shadow_rows: List[dict] = []
        self._shadow_since: Optional[float] = None
        self._installed_tap: Optional[Callable] = None

        # The canary burn watch, re-expressed as a for_count alert rule
        # on the fleet's AlertEngine (ONE alerting path): the rule keeps
        # the consecutive-high-poll streak, firing = rollback.  The rule
        # name carries the generation so back-to-back deployments over
        # one router never share state.
        engine = getattr(router, "alerts", None)
        if engine is None:
            engine = AlertEngine(clock=self._clock)
        self.alerts = engine
        self._burn_rule = engine.add_rule(AlertRule(
            f"deploy_canary_burn_gen{self.generation}",
            for_count=self.config.high_polls, severity="warn",
            description=(
                f"canary slice SLO burn >= {self.config.burn_threshold} "
                f"for {self.config.high_polls} consecutive polls"
            ),
        ))

    # -- lifecycle --------------------------------------------------------

    def start(self) -> "Deployment":
        if self._thread is None and not self.finished():
            self._thread = threading.Thread(
                target=self._loop, daemon=True,
                name=f"deploy-gen{self.generation}",
            )
            self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.is_set() and not self.finished():
            try:
                self.tick()
            except Exception as e:  # noqa: BLE001 — the loop must survive
                self._log.error("deploy_error", error=f"{e}")
            self._stop.wait(self.config.poll_interval_s)

    def wait(self, timeout: Optional[float] = None) -> str:
        """Block until the deployment reaches a terminal state (or the
        timeout passes); returns the state either way."""
        self._finished.wait(timeout)
        return self.state

    def finished(self) -> bool:
        return self.state in TERMINAL_STATES

    def close(self) -> None:
        """Stop watching.  An unfinished deployment tears its traffic
        split down first so no tenant is left routed at a generation
        nobody is steering (the replicas stay up; call ``wait()`` for a
        verdict instead when you want the rollout to finish)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        self._uninstall_tap()
        if not self.finished():
            self.router.set_deploy_split(None, 0.0)
            self._transition("failed", cause="closed before terminal")

    # -- event plumbing ---------------------------------------------------

    def _record(self, action: str, **extra) -> None:
        row = {
            "t": round(self._clock(), 3), "action": action,
            "state": self.state, "generation": self.generation, **extra,
        }
        with self._lock:
            self.events.append(row)
        get_recorder().record("deploy", **row)
        self._log.info("deploy_event", **row)

    def _transition(self, state: str, **extra) -> None:
        prev = self.state
        self.state = state
        self._record("transition", frm=prev, to=state, **extra)
        self.publish()
        if state in TERMINAL_STATES:
            self._uninstall_tap()
            self._finished.set()

    def publish(self, registry=None) -> None:
        """``serving_deploy_*`` gauges: one-hot state, generation, the
        live traffic fraction, the last canary burn, shadow volume."""
        from ml_trainer_tpu_torch.telemetry.registry import default_registry

        r = registry if registry is not None else default_registry()
        st = r.gauge(
            "serving_deploy_state",
            "deploy state machine position (one-hot)",
            labelnames=("state",),
        )
        all_states = (
            "staging", "shadowing", "canary", "ramping", "rolling_back",
        ) + TERMINAL_STATES
        for s in all_states:
            st.labels(state=s).set(1.0 if s == self.state else 0.0)
        r.gauge(
            "serving_deploy_generation",
            "target generation of the active/last deployment",
        ).set(float(self.generation))
        r.gauge(
            "serving_deploy_fraction",
            "tenant-hash traffic fraction routed at the new generation",
        ).set(float(self.router._deploy_fraction))
        if self.last_burn is not None:
            r.gauge(
                "serving_deploy_canary_burn",
                "last windowed SLO burn measured on the canary slice",
            ).set(float(self.last_burn))
        r.gauge(
            "serving_deploy_shadow_replays",
            "shadow requests replayed against the new generation",
        ).set(float(len(self._shadow_rows)))

    # -- the state machine ------------------------------------------------

    def tick(self) -> str:
        """Run one state-machine step synchronously and return the
        (possibly new) state.  Thread-safe; the timer thread and tests
        share this entry point."""
        with self._tick_lock:
            if self.finished():
                return self.state
            step = {
                "staging": self._tick_staging,
                "shadowing": self._tick_shadowing,
                "canary": self._tick_watch,
                "ramping": self._tick_watch,
                "rolling_back": self._tick_rollback,
            }.get(self.state)
            if step is not None:
                step()
            self.publish()
            return self.state

    # -- staging ----------------------------------------------------------

    def _role_mix(self) -> List[str]:
        roles = [
            rep.role for rep in self.router.replicas.values()
            if rep.generation == self.old_generation and not rep.removing
        ]
        return roles or ["both"]

    def _tick_staging(self) -> None:
        roles = self._role_mix()
        self.old_weights_fp = next(
            (rep.weights_fp
             for rep in self.router.replicas.values()
             if rep.generation == self.old_generation and rep.weights_fp),
            None,
        )
        try:
            for i, role in enumerate(roles):
                name = f"deploy{self.generation}-{role}{i}"
                server = self.factory(role)
                self.router.add_replica(
                    name, server, generation=self.generation
                )
                self.new_replicas.append(name)
                if self.weights_fp is None:
                    self.weights_fp = getattr(
                        self.router.replicas[name], "weights_fp", None
                    )
            if self.config.warmup:
                self._warm_generation()
        except Exception as e:  # noqa: BLE001 — a failed spawn is a verdict
            self._record("staging_failed", error=f"{e}")
            self._teardown_generation(self.generation)
            self._transition("failed", cause=f"staging: {e}")
            return
        self._record(
            "staged", replicas=list(self.new_replicas), ckpt=self.ckpt,
            weights_fp=self.weights_fp, old_weights_fp=self.old_weights_fp,
        )
        if self.config.shadow:
            self._install_tap()
            self._shadow_since = self._clock()
            self._transition("shadowing")
        else:
            self._begin_stage(0)

    def _warm_generation(self) -> None:
        """Push one off-path greedy request through every new replica
        before any traffic moves.  A replica pays its cold start (the
        first launches, the decode graph's capture) on its first
        request, not at boot; warming here means the canary's first
        clients see steady-state latency and the burn watch never reads
        warmup latency as a weights regression."""
        deadline = self._clock() + self.config.warmup_timeout_s
        for name in self.new_replicas:
            rep = self.router.replicas.get(name)
            if rep is None or not rep.healthy:
                continue
            req = Request(
                prompt=np.zeros(8, dtype=np.int32),
                max_new_tokens=self.config.warmup_tokens,
            )
            t0 = self._clock()
            rep.server.submit_request(req)
            while req.finished_at is None and self._clock() < deadline:
                time.sleep(0.01)
            if req.finished_at is None:
                raise RuntimeError(
                    f"warmup timed out on {name} after "
                    f"{self.config.warmup_timeout_s:.0f}s"
                )
            self._record(
                "warmed", replica=name,
                seconds=round(self._clock() - t0, 3),
            )

    # -- shadowing --------------------------------------------------------

    def _install_tap(self) -> None:
        if self._installed_tap is None:
            self._installed_tap = self._tap
            self.router._request_tap = self._installed_tap

    def _uninstall_tap(self) -> None:
        if self._installed_tap is not None:
            if self.router._request_tap is self._installed_tap:
                self.router._request_tap = None
            self._installed_tap = None

    def _tap(self, creq: Request) -> None:
        """Router request tap: sample finished live requests for shadow
        replay.  Only replayable requests qualify — done, and greedy or
        seed-pinned, so the diff is meaningful (same bytes expected
        from same weights)."""
        if self.state != "shadowing" or creq.state != "done":
            return
        if creq.temperature != 0.0 and creq.rng is None:
            return
        if self.router.tenant_slice(
            f"shadow{creq.id}"
        ) >= self.config.shadow_fraction:
            return
        tl = creq.timeline()
        row = {
            "prompt": np.asarray(creq.prompt).copy(),
            "max_new_tokens": int(creq.max_new_tokens),
            "temperature": float(creq.temperature),
            "rng": creq.rng,
            "tenant": creq.tenant,
            "adapter": creq.adapter,
            "live_tokens": list(creq.tokens),
            "live_e2e_ms": tl.get("e2e_ms"),
        }
        with self._lock:
            if len(self._shadow_pending) < 64:
                self._shadow_pending.append(row)

    def _shadow_target(self):
        """A new-generation replica that can run a request end-to-end
        in place (no migration sink -> it decodes where it prefills)."""
        reps = [
            self.router.replicas[n] for n in self.new_replicas
            if n in self.router.replicas
            and self.router.replicas[n].healthy
        ]
        reps.sort(key=lambda r: (r.role == "decode", r.role != "both"))
        return reps[0] if reps else None

    def _replay(self, sample: dict) -> Optional[dict]:
        rep = self._shadow_target()
        if rep is None:
            return None
        req = Request(
            prompt=sample["prompt"],
            max_new_tokens=sample["max_new_tokens"],
            temperature=sample["temperature"],
            rng=sample["rng"],
            tenant=sample["tenant"],
            adapter=sample["adapter"],
        )
        t0 = time.monotonic()
        try:
            rep.server.submit_request(req)
        except Exception as e:  # noqa: BLE001 — shadow must never hurt live
            return {"state": "error", "error": f"{e}", "match": None}
        deadline = t0 + self.config.shadow_replay_timeout_s
        while req.finished_at is None and time.monotonic() < deadline:
            time.sleep(0.01)
        shadow_tokens = list(req.tokens)
        comparable = req.state == "done" and sample["temperature"] == 0.0
        return {
            "state": req.state,
            "replica": rep.name,
            "match": (
                shadow_tokens == sample["live_tokens"]
                if comparable else None
            ),
            "live_e2e_ms": sample["live_e2e_ms"],
            "shadow_e2e_ms": round((time.monotonic() - t0) * 1e3, 3),
            "n_tokens": len(shadow_tokens),
        }

    def _tick_shadowing(self) -> None:
        with self._lock:
            pending, self._shadow_pending = self._shadow_pending, []
        for sample in pending:
            row = self._replay(sample)
            if row is not None:
                self._shadow_rows.append(row)
        mismatches = [
            r for r in self._shadow_rows if r.get("match") is False
        ]
        if mismatches:
            self._record(
                "shadow_mismatch", n=len(mismatches),
                of=len(self._shadow_rows),
            )
            self._rollback(
                f"shadow diff: {len(mismatches)}/{len(self._shadow_rows)} "
                "replayed requests produced different tokens"
            )
            return
        enough = len(self._shadow_rows) >= self.config.shadow_min_requests
        timed_out = (
            self._clock() - self._shadow_since > self.config.shadow_timeout_s
        )
        if enough or timed_out:
            self._record(
                "shadow_done", n=len(self._shadow_rows),
                timed_out=bool(timed_out and not enough),
                report=self.shadow_report(),
            )
            self._uninstall_tap()
            self._begin_stage(0)

    def shadow_report(self) -> dict:
        """Tokens + latency diff of every shadow replay so far (the
        committed evidence that precedes any real traffic moving)."""
        rows = list(self._shadow_rows)
        compared = [r for r in rows if r.get("match") is not None]

        def _p50(vals):
            vals = sorted(v for v in vals if v is not None)
            return vals[len(vals) // 2] if vals else None

        return {
            "n_replayed": len(rows),
            "n_compared": len(compared),
            "n_token_mismatch": sum(
                1 for r in compared if r["match"] is False
            ),
            "live_e2e_ms_p50": _p50(r.get("live_e2e_ms") for r in rows),
            "shadow_e2e_ms_p50": _p50(
                r.get("shadow_e2e_ms") for r in rows
            ),
            "rows": rows[-32:],
        }

    # -- canary / ramping -------------------------------------------------

    def _begin_stage(self, idx: int) -> None:
        plan = self.config.fractions()
        self._stage_idx = idx
        fraction = plan[idx]
        self.router.set_deploy_split(self.generation, fraction)
        if self._split_since is None:
            self._split_since = time.monotonic()
        self._stage_clean_since = self._clock()
        self._burn_rule.reset()
        self._record("stage", fraction=fraction, stage=idx, plan=plan)
        self._transition("canary" if idx == 0 else "ramping",
                         fraction=fraction)

    def canary_burn(self) -> Optional[dict]:
        """The canary slice's windowed SLO aggregation (None while the
        window holds too few finished canary requests to mean
        anything).  The slice predicate is the same tenant-hash the
        placement path uses, so burn is measured on exactly the
        traffic the new generation served."""
        if self._split_since is None:
            return None
        fraction = self.router._deploy_fraction
        since = max(
            self._split_since, time.monotonic() - self.config.window_s
        )
        tls = self.router.slo.timelines(
            since=since,
            predicate=lambda tl: self.router.tenant_slice(
                tl.get("tenant") or "default"
            ) < fraction,
        )
        if len(tls) < self.config.min_window_requests:
            return None
        return aggregate_timelines(tls, self.router.slo.policy)

    def _tick_watch(self) -> None:
        agg = self.canary_burn()
        now = self._clock()
        if agg is not None:
            burn = max(agg["burn_rate"]["ttft"], agg["burn_rate"]["tpot"])
            self.last_burn = burn
            high = burn >= self.config.burn_threshold
            firing = self.alerts.observe(
                self._burn_rule.name, high, now=now, value=burn,
                extra={"window_requests": agg["n_requests"],
                       "generation": self.generation},
            )
            if high:
                streak = self._burn_rule.count()
                self._stage_clean_since = now
                self._record(
                    "burn_high", burn=burn, streak=streak,
                    window_requests=agg["n_requests"],
                )
                if firing:
                    self._rollback(
                        f"canary burn {burn:.2f} >= "
                        f"{self.config.burn_threshold} for "
                        f"{streak} polls "
                        f"({agg['n_requests']} requests in window)"
                    )
                return
        if now - self._stage_clean_since < self.config.hold_s:
            return
        if self.config.stage_min_requests and (
                agg is None
                or agg["n_requests"] < self.config.stage_min_requests):
            return  # hold: the slice has not reported yet
        plan = self.config.fractions()
        if self._stage_idx + 1 < len(plan):
            self._begin_stage(self._stage_idx + 1)
        else:
            self._promote()

    # -- terminal paths ---------------------------------------------------

    def _teardown_generation(self, generation: int) -> None:
        """Retire every replica of one generation through the drain
        path: each leaves the placement pools immediately, drains
        bounded, and anything still in flight at detach is
        failed-and-redistributed — the pumps re-place those streams on
        the surviving generation (re-prefill; KV never crosses weights)
        so no client stream drops.  Replicas this deployment spawned
        are always closed (it owns them even when the router doesn't
        own its seed fleet)."""
        victims = [
            name for name, rep in self.router.replicas.items()
            if rep.generation == generation
        ]
        for name in victims:
            try:
                drained = self.router.remove_replica(
                    name, timeout=self.config.drain_timeout_s,
                    close=True if name in self.new_replicas else None,
                )
            except KeyError:
                continue
            self._record("retire_replica", replica=name, drained=drained)

    def _rollback(self, cause: str) -> None:
        self.rollback_cause = cause
        self._uninstall_tap()
        self._transition("rolling_back", cause=cause)
        # Split down FIRST: new canary arrivals land on stable before a
        # single replica starts draining.
        self.router.set_deploy_split(None, 0.0)
        self._tick_rollback()

    def _tick_rollback(self) -> None:
        self._teardown_generation(self.generation)
        self._transition("rolled_back", cause=self.rollback_cause)

    def _promote(self) -> None:
        self.router.promote_generation(self.generation)
        self._record("promoted", fraction=1.0)
        self._teardown_generation(self.old_generation)
        self._transition("done")

    # -- reporting --------------------------------------------------------

    def report(self) -> dict:
        """JSON-safe rollout record (the bench artifact's deploy
        section): verdict, traffic plan, fingerprints, burn, events,
        shadow diff."""
        with self._lock:
            events = list(self.events)
        return {
            "state": self.state,
            "ckpt": self.ckpt,
            "generation": self.generation,
            "old_generation": self.old_generation,
            "weights_fp": self.weights_fp,
            "old_weights_fp": self.old_weights_fp,
            "plan": list(self.config.fractions()),
            "last_burn": self.last_burn,
            "rollback_cause": self.rollback_cause,
            "new_replicas": list(self.new_replicas),
            "shadow": self.shadow_report() if self._shadow_rows else None,
            "events": events,
            "elapsed_s": round(self._clock() - self._started_at, 3),
        }

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()
        return False
