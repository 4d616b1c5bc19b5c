"""SLO-burn autoscaler: the control loop that acts on the serving fleet
(the JAX package's ``serving/autoscaler.py``).

``serving/slo.py`` measures attainment and burn rate; this module is
the loop that acts on them:

* **Signals.**  Each poll reads the router's windowed request timelines
  (TTFT burn rate over the last ``window_s`` — lifetime attainment is
  useless for control, old requests dominate it), per-role queue depth
  and free-KV pressure from the replicas' ``/healthz``/registry
  surfaces, and fleet liveness.

* **Actions**, in preference order when burn is high (every action a
  flight event + ``autoscaler_actions_total{action=}``):

  1. **Replace the dead** — a replica death drops the fleet below its
     role floor: add a replacement immediately (short cooldown, no
     hysteresis — this is repair, not scaling).
  2. **Scale up** — add a replica from the factory (the
     ``Router.build`` idiom in process: the same model, so capacity
     arrives with no second copy of the weights; ``Fleet.factory``
     spawns a worker process) on the pressured role, bounded by
     ``max_replicas``.
  3. **Reassign roles** — when one role starves while the other idles
     (queue-pressure imbalance past ``imbalance_ratio``), flip an idle
     replica prefill<->decode by draining it through the migration
     machinery (``Router.reassign_role``: active KV exported page by
     page and adopted elsewhere — streams keep flowing).
  4. **Degrade** — at ``max_replicas`` with burn still high, step the
     graceful-degradation ladder UP (``serving/overload.py``): clamp,
     spec off, hits-only, shed.  Brownout beats blackout.

  When burn stays low the loop walks back down: ladder rungs exit
  first, then surplus replicas drain and leave (never below the
  floors).

* **Hysteresis + cooldown.**  Burn must stay high/low for
  ``high_polls``/``low_polls`` CONSECUTIVE polls before any action, and
  ``cooldown_s`` must elapse between actions, so the loop never flaps —
  an autoscaler that oscillates is worse than none.

Host-only module: the servers own every device interaction.  The
incident bundle the JAX package assembles on a replace-dead repair
comes with Queue A 7 (ROADMAP.md); the repair's flight event carries
the dead workers' log tails (``RemoteServer.stderr_tail``).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, List, Optional

from ml_trainer_tpu_torch.serving.slo import aggregate_timelines
from ml_trainer_tpu_torch.telemetry.alerts import AlertEngine, AlertRule
from ml_trainer_tpu_torch.telemetry.flight import get_recorder
from ml_trainer_tpu_torch.utils.logging import get_logger


@dataclasses.dataclass(frozen=True)
class AutoscalerConfig:
    """Control-loop knobs (hysteresis is the point: every threshold has
    a consecutive-poll requirement and every action a cooldown)."""

    poll_interval_s: float = 0.5
    window_s: float = 8.0            # burn measured over this window
    min_window_requests: int = 6     # below this the burn signal is noise
    burn_high: float = 2.0           # act when TTFT burn >= this...
    high_polls: int = 2              # ...for this many consecutive polls
    burn_low: float = 0.25           # recover when burn <= this...
    low_polls: int = 6               # ...for this many consecutive polls
    cooldown_s: float = 4.0          # between scale/flip/rung actions
    replace_cooldown_s: float = 1.0  # dead-replica repair is urgent
    max_replicas: int = 8
    min_prefill: int = 1             # role floors (disagg fleets)
    min_decode: int = 1
    min_replicas: int = 2            # total floor (colocated fleets)
    imbalance_ratio: float = 3.0     # queue-pressure ratio for a role flip
    role_flip: bool = True
    scale_down: bool = True

    def __post_init__(self):
        if self.poll_interval_s <= 0:
            raise ValueError(
                f"poll_interval_s must be > 0, got {self.poll_interval_s}"
            )
        if self.burn_high <= self.burn_low:
            raise ValueError(
                f"burn_high ({self.burn_high}) must exceed burn_low "
                f"({self.burn_low}) — the hysteresis band"
            )
        if self.high_polls < 1 or self.low_polls < 1:
            raise ValueError("high_polls/low_polls must be >= 1")


class Autoscaler:
    """The fleet control loop over a :class:`~...router.Router`.

    ``server_factory(role) -> Server`` builds a replica with the
    fleet's geometry (share the model, as ``Router.build`` does, or
    ``Fleet.factory``).  Use as a
    context manager, or ``start()``/``close()``.  ``tick()`` runs one
    control decision synchronously (tests drive it with a fake clock;
    the thread just calls it on a timer)."""

    def __init__(self, router, server_factory: Callable,
                 config: Optional[AutoscalerConfig] = None,
                 clock=time.monotonic):
        self.router = router
        self.factory = server_factory
        self.config = config if config is not None else AutoscalerConfig()
        self.ladder = router.ladder
        self._clock = clock
        self._log = get_logger("ml_trainer_tpu_torch.serving.autoscaler")
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._last_action_at = -10.0 ** 9
        self._auto_seq = 0
        self.actions: List[dict] = []
        self.last_burn: Optional[float] = None
        # The hysteresis streaks, re-expressed as for_count alert rules
        # on the fleet's AlertEngine (ONE alerting path): the high/low
        # rules carry the consecutive-poll state the loop used to keep
        # by hand, firing = streak reached, and the post-action streak
        # reset is rule.reset().  Cooldown gating stays OUT here — a
        # rule keeps firing through a cooldown, exactly as the streak
        # kept growing.
        engine = getattr(router, "alerts", None)
        if engine is None:
            engine = AlertEngine(clock=self._clock)
        self.alerts = engine
        cfg = self.config
        self._rule_high = engine.add_rule(AlertRule(
            "autoscaler_burn_high", for_count=cfg.high_polls,
            severity="warn",
            description=(
                f"windowed TTFT burn >= {cfg.burn_high} for "
                f"{cfg.high_polls} consecutive polls"
            ),
        ))
        self._rule_low = engine.add_rule(AlertRule(
            "autoscaler_burn_low", for_count=cfg.low_polls,
            severity="info",
            description=(
                f"windowed TTFT burn <= {cfg.burn_low} for "
                f"{cfg.low_polls} consecutive polls (recovery)"
            ),
        ))

    # -- lifecycle --------------------------------------------------------

    def start(self) -> "Autoscaler":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="autoscaler"
            )
            self._thread.start()
        return self

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()
        return False

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.tick()
            except Exception as e:  # noqa: BLE001 — the loop must survive
                self._log.error("autoscaler_error", error=f"{e}")
            self._stop.wait(self.config.poll_interval_s)

    # -- signals ----------------------------------------------------------

    def _fleet(self) -> dict:
        """One poll's fleet view: alive replicas by capability, queue
        pressure by role, and the windowed TTFT burn (None while the
        window holds too few requests to mean anything)."""
        reps = list(self.router.replicas.values())
        alive = [r for r in reps if r.healthy and not r.removing]
        prefill = [r for r in alive if r.role in ("prefill", "both")]
        decode = [r for r in alive if r.role in ("decode", "both")]

        def _pressure(pool):
            return sum(
                int((r.last_health or {}).get("queue_depth") or 0)
                + int((r.last_health or {}).get("active_slots") or 0)
                for r in pool
            )

        now = self._clock()
        tls = self.router.slo.timelines(
            since=time.monotonic() - self.config.window_s
        )
        burn = None
        if len(tls) >= self.config.min_window_requests:
            agg = aggregate_timelines(tls, self.router.slo.policy)
            burn = agg["burn_rate"]["ttft"]
        self.last_burn = burn
        return {
            "now": now,
            "alive": alive,
            "total": len(alive),
            "prefill": prefill,
            "decode": decode,
            "prefill_pressure": _pressure(prefill),
            "decode_pressure": _pressure(decode),
            "burn": burn,
            "window_requests": len(tls),
        }

    # -- actions ----------------------------------------------------------

    def _record(self, action: str, cause: str, **extra) -> None:
        row = {
            "t": round(self._clock(), 3), "action": action,
            "cause": cause, **extra,
        }
        with self._lock:
            self.actions.append(row)
        get_recorder().record("autoscaler", **row)
        self._log.info("autoscaler_action", **row)

    def _cooldown_ok(self, now: float, repair: bool = False) -> bool:
        gap = (
            self.config.replace_cooldown_s if repair
            else self.config.cooldown_s
        )
        return now - self._last_action_at >= gap

    def _dead_stderr(self) -> dict:
        """Bounded log tails of replicas whose worker PROCESS died after
        the readiness handshake ({name: tail}).  A post-ready crash
        loses its stderr otherwise — the process is gone, the socket
        just sever — so the replace-dead flight event carries the
        post-mortem (RemoteServer.stderr_tail; in-process replicas have
        no process to lose)."""
        tails = {}
        for rep in self.router.replicas.values():
            if rep.healthy:
                continue
            proc = getattr(rep.server, "proc", None)
            tail_fn = getattr(rep.server, "stderr_tail", None)
            if proc is None or tail_fn is None:
                continue
            if proc.poll() is None:  # still running: unhealthy != dead
                continue
            tail = tail_fn()
            if tail:
                tails[rep.name] = tail[-2048:]
        return tails

    def _scale_up(self, role: str, cause: str, now: float,
                  repair: bool = False) -> bool:
        self._auto_seq += 1
        name = f"auto{self._auto_seq}"
        extra = {}
        if repair:
            dead = self._dead_stderr()
            if dead:
                extra["dead_stderr"] = dead
        try:
            server = self.factory(role)
            self.router.add_replica(name, server)
        except Exception as e:  # noqa: BLE001 — a failed add is an event
            self._record("scale_up_failed", f"{cause}: {e}", role=role,
                         **extra)
            return False
        self._last_action_at = now
        self._record("scale_up", cause, role=role, replica=name, **extra)
        return True

    def _scale_down(self, fleet: dict, cause: str, now: float) -> bool:
        cfg = self.config
        # Remove from the LESS pressured role, keeping the floors; the
        # least-loaded removable replica drains and leaves.
        candidates = []
        if self.router.mode == "disagg":
            if len(fleet["prefill"]) > cfg.min_prefill:
                candidates += [
                    r for r in fleet["prefill"] if r.role == "prefill"
                ]
            if len(fleet["decode"]) > cfg.min_decode:
                candidates += [
                    r for r in fleet["decode"] if r.role == "decode"
                ]
        elif fleet["total"] > cfg.min_replicas:
            candidates = list(fleet["alive"])
        if not candidates or fleet["total"] <= 1:
            return False
        victim = sorted(candidates, key=lambda r: r.load_score())[0]
        self._last_action_at = now
        drained = self.router.remove_replica(victim.name, timeout=20.0)
        self._record(
            "scale_down", cause, replica=victim.name, role=victim.role,
            drained=drained,
        )
        return True

    def _maybe_flip_role(self, fleet: dict, cause: str,
                         now: float) -> bool:
        """Queue-pressure imbalance: flip an idle replica onto the
        starving role (drain-through-migration first)."""
        cfg = self.config
        if not cfg.role_flip or self.router.mode != "disagg":
            return False
        pp, dp = fleet["prefill_pressure"], fleet["decode_pressure"]
        pure_prefill = [r for r in fleet["prefill"] if r.role == "prefill"]
        pure_decode = [r for r in fleet["decode"] if r.role == "decode"]
        if (
            pp >= cfg.imbalance_ratio * max(dp, 1)
            and len(pure_decode) > cfg.min_decode
        ):
            victim = sorted(pure_decode, key=lambda r: r.load_score())[0]
            new_role = "prefill"
        elif (
            dp >= cfg.imbalance_ratio * max(pp, 1)
            and len(pure_prefill) > cfg.min_prefill
        ):
            victim = sorted(pure_prefill, key=lambda r: r.load_score())[0]
            new_role = "decode"
        else:
            return False
        self._last_action_at = now
        ok = self.router.reassign_role(victim.name, new_role, timeout=20.0)
        self._record(
            "reassign_role" if ok else "reassign_role_failed", cause,
            replica=victim.name, role=new_role,
            prefill_pressure=pp, decode_pressure=dp,
        )
        return ok

    # -- the control decision ---------------------------------------------

    def tick(self) -> Optional[str]:
        """One control decision; returns the action taken (or None).
        Thread-safe with the router's own machinery; tests call it
        directly."""
        cfg = self.config
        fleet = self._fleet()
        now = fleet["now"]

        # 1. Repair: a death dropped a role below its floor.  No
        # hysteresis — waiting out a burn window while a quarter of the
        # fleet is missing just burns more budget.
        if self._cooldown_ok(now, repair=True):
            if self.router.mode == "disagg":
                if len(fleet["decode"]) < cfg.min_decode:
                    if self._scale_up(
                        "decode", "decode fleet below floor "
                        f"({len(fleet['decode'])} < {cfg.min_decode})",
                        now, repair=True,
                    ):
                        return "scale_up"
                if len(fleet["prefill"]) < cfg.min_prefill:
                    if self._scale_up(
                        "prefill", "prefill fleet below floor "
                        f"({len(fleet['prefill'])} < {cfg.min_prefill})",
                        now, repair=True,
                    ):
                        return "scale_up"
            elif fleet["total"] < cfg.min_replicas:
                if self._scale_up(
                    "both", f"fleet below floor ({fleet['total']} < "
                    f"{cfg.min_replicas})", now, repair=True,
                ):
                    return "scale_up"

        burn = fleet["burn"]
        if burn is None:
            return None  # too few requests: rules hold, nothing observed
        extra = {"window_requests": fleet["window_requests"]}
        high_firing = low_firing = False
        if burn >= cfg.burn_high:
            high_firing = self.alerts.observe(
                "autoscaler_burn_high", True, now=now, value=burn,
                extra=extra,
            )
            self.alerts.observe(
                "autoscaler_burn_low", False, now=now, value=burn,
            )
        elif burn <= cfg.burn_low:
            self.alerts.observe(
                "autoscaler_burn_high", False, now=now, value=burn,
            )
            low_firing = self.alerts.observe(
                "autoscaler_burn_low", True, now=now, value=burn,
                extra=extra,
            )
        else:
            # Inside the hysteresis band: streaks decay, nothing acts.
            self.alerts.observe(
                "autoscaler_burn_high", False, now=now, value=burn,
            )
            self.alerts.observe(
                "autoscaler_burn_low", False, now=now, value=burn,
            )
            return None

        cause = (
            f"ttft burn {burn} over {fleet['window_requests']} request(s)"
        )
        if high_firing and self._cooldown_ok(now):
            if fleet["total"] < cfg.max_replicas:
                role = "both"
                if self.router.mode == "disagg":
                    role = (
                        "prefill"
                        if fleet["prefill_pressure"]
                        >= fleet["decode_pressure"] else "decode"
                    )
                if self._scale_up(role, cause, now):
                    self._rule_high.reset()
                    return "scale_up"
            if self._maybe_flip_role(fleet, cause, now):
                self._rule_high.reset()
                return "reassign_role"
            # No capacity to add: brownout beats blackout.
            if self.ladder.level < 4:
                self._last_action_at = now
                self.ladder.step_up(cause)
                self._record(
                    "degrade", cause, level=self.ladder.level,
                    rung=self.ladder.rung,
                )
                self._rule_high.reset()
                return "degrade"
            return None
        if low_firing and self._cooldown_ok(now):
            recovery = f"ttft burn {burn} (recovered)"
            if self.ladder.level > 0:
                self._last_action_at = now
                self.ladder.step_down(recovery)
                self._record(
                    "undegrade", recovery, level=self.ladder.level,
                    rung=self.ladder.rung,
                )
                self._rule_low.reset()
                return "undegrade"
            if cfg.scale_down and self._scale_down(fleet, recovery, now):
                self._rule_low.reset()
                return "scale_down"
        return None

    # -- reading ----------------------------------------------------------

    def summary(self) -> dict:
        """The ``run_report``-style section the bench artifact embeds:
        every action with its cause, plus per-action counts."""
        with self._lock:
            actions = [dict(a) for a in self.actions]
        counts: dict = {}
        for a in actions:
            counts[a["action"]] = counts.get(a["action"], 0) + 1
        return {
            "actions": actions,
            "counts": counts,
            "last_burn": self.last_burn,
            "ladder": self.ladder.snapshot(),
        }

    def publish(self, registry=None) -> None:
        """``autoscaler_actions_total{action=}`` +
        ``autoscaler_replicas{role=}`` + the burn the loop last saw."""
        from ml_trainer_tpu_torch.telemetry.registry import default_registry

        r = registry if registry is not None else default_registry()
        counts = self.summary()["counts"]
        g = r.gauge(
            "autoscaler_actions_total",
            "autoscaler control actions, by kind",
            labelnames=("action",),
        )
        for action, n in sorted(counts.items()):
            g.labels(action=action).set(float(n))
        reps = r.gauge(
            "autoscaler_replicas",
            "alive replicas by role capability",
            labelnames=("role",),
        )
        alive = [
            rep for rep in self.router.replicas.values()
            if rep.healthy and not rep.removing
        ]
        reps.labels(role="prefill").set(float(sum(
            1 for rep in alive if rep.role in ("prefill", "both")
        )))
        reps.labels(role="decode").set(float(sum(
            1 for rep in alive if rep.role in ("decode", "both")
        )))
        if self.last_burn is not None:
            r.gauge(
                "autoscaler_last_burn",
                "windowed TTFT burn rate the control loop last measured",
            ).set(float(self.last_burn))
