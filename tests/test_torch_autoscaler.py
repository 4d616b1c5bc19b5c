"""The port's SLO-burn autoscaler (``ml_trainer_tpu_torch/serving/
autoscaler.py``) against the JAX package's.

Both packages' ``Autoscaler``, driven over one stand-in fleet, one fake
burn trace and one fake clock, take the same action at every tick and
record the same actions: the hysteresis (``high_polls``/``low_polls``
consecutive polls), the cooldown, scale-up to ``max_replicas``, the role
flip on a queue-pressure imbalance, the ladder up and back down, and
scale-down to the floors.  On a real CPU ``Router``: a killed decode
replica is replaced at the next tick with no hysteresis wait, and the
repaired fleet's greedy tokens equal the JAX ``generate()``.  Actions
and ladder levels are compared exactly.  ``gpt2_tiny`` at max_len 64.
"""

import importlib
import types

import numpy as np
import pytest
import torch

from ml_trainer_tpu_torch import get_model, params_from_jax
from ml_trainer_tpu_torch.serving import (
    Autoscaler,
    AutoscalerConfig,
    Router,
    Server,
)

MAX_LEN = 64
PS = 8


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


class _StandInServer:
    def __init__(self, role):
        self.role = role


class _StandInFleet:
    """The router surface ``Autoscaler`` drives (replicas, the ladder,
    add/remove/reassign), the same for both packages."""

    def __init__(self, pkg, mode, roles, alerts):
        overload = importlib.import_module(f"{pkg}.serving.overload")
        self.mode = mode
        self.alerts = alerts
        self.ladder = overload.DegradationLadder(lambda: [], name="router")
        self._reps = {}
        for i, role in enumerate(roles):
            self.add_replica(f"r{i}", _StandInServer(role))

    @property
    def replicas(self):
        return dict(self._reps)

    def add_replica(self, name, server, url=None, generation=None):
        self._reps[name] = types.SimpleNamespace(
            name=name, server=server, role=server.role, healthy=True,
            removing=False, last_health={"queue_depth": 0,
                                         "active_slots": 0},
            load_score=lambda name=name: (0, 0, name))

    def remove_replica(self, name, timeout=30.0, close=None):
        self._reps.pop(name)
        return True

    def reassign_role(self, name, role, timeout=30.0):
        self._reps[name].role = role
        return True


def _trace(pkg, mode, roles, burns, pressure=(4, 4), **cfg):
    """Tick a ``pkg`` autoscaler once per ``(clock, burn)`` of ``burns``
    over a stand-in fleet; returns (the action of every tick, the
    recorded actions, the ladder's level after every tick, the final
    replicas by role)."""
    alerts = importlib.import_module(f"{pkg}.telemetry.alerts")
    autoscaler = importlib.import_module(f"{pkg}.serving.autoscaler")
    t = [0.0]
    fleet = _StandInFleet(pkg, mode, roles,
                          alerts.AlertEngine(clock=lambda: t[0]))
    asc = autoscaler.Autoscaler(
        fleet, lambda role: _StandInServer(role),
        autoscaler.AutoscalerConfig(**cfg), clock=lambda: t[0])
    burn = [None]

    def fleet_view():
        reps = [r for r in fleet.replicas.values() if r.healthy]
        return {"now": t[0], "alive": reps, "total": len(reps),
                "prefill": [r for r in reps if r.role in ("prefill",
                                                          "both")],
                "decode": [r for r in reps if r.role in ("decode", "both")],
                "prefill_pressure": pressure[0],
                "decode_pressure": pressure[1],
                "burn": burn[0], "window_requests": 20}

    asc._fleet = fleet_view
    ticks, levels = [], []
    for clock, b in burns:
        t[0], burn[0] = clock, b
        ticks.append(asc.tick())
        levels.append(fleet.ladder.level)
    roles_after = sorted(r.role for r in fleet.replicas.values())
    return ticks, asc.summary()["actions"], levels, roles_after


TRACE = [(0.0, 5.0), (0.5, 5.0), (1.0, 5.0), (5.0, 5.0), (5.5, 5.0),
         (10.0, 5.0), (14.5, 5.0), (15.0, 5.0), (20.0, 1.0), (20.5, None),
         (21.0, 0.1), (21.5, 0.1), (22.0, 0.1), (26.0, 0.1), (30.0, 0.1),
         (30.5, 0.1), (35.0, 0.1), (40.0, 0.1), (45.0, 0.1)]


@pytest.mark.parametrize("mode,roles,pressure,cfg", [
    ("colocated", ["both"], (4, 4),
     dict(high_polls=2, low_polls=2, cooldown_s=4.0, max_replicas=3,
          min_replicas=1)),
    ("disagg", ["prefill", "decode", "decode"], (30, 2),
     dict(high_polls=2, low_polls=2, cooldown_s=4.0, max_replicas=3,
          min_prefill=1, min_decode=1)),
    ("colocated", ["both"], (4, 4),
     dict(high_polls=3, low_polls=2, cooldown_s=4.0, max_replicas=1,
          min_replicas=1, scale_down=False)),
])
def test_action_sequence_equals_jax(mode, roles, pressure, cfg):
    got = _trace("ml_trainer_tpu_torch", mode, roles, TRACE, pressure,
                 **cfg)
    want = _trace("ml_trainer_tpu", mode, roles, TRACE, pressure, **cfg)
    assert got == want
    ticks = got[0]
    assert ticks[0] is None  # one high poll: the hysteresis holds
    assert {"scale_up", "degrade"} & set(ticks)
    assert {"scale_down", "undegrade"} & set(ticks)


def test_the_control_law_on_a_fake_clock():
    """The JAX package's pinned sequence at max_replicas 1: two high
    polls degrade, the cooldown holds, in-band burn resets both streaks,
    two low polls walk the ladder back down."""
    burns = [(0.0, 5.0), (0.0, 5.0), (0.0, 5.0), (5.0, 5.0), (10.0, 1.0),
             (10.0, 0.0), (10.0, 0.0), (15.0, 0.0), (15.0, 0.0)]
    ticks, actions, levels, _ = _trace(
        "ml_trainer_tpu_torch", "colocated", ["both"], burns,
        burn_high=2.0, burn_low=0.25, high_polls=2, low_polls=2,
        cooldown_s=4.0, max_replicas=1, min_replicas=1, role_flip=False,
        scale_down=False)
    assert ticks == [None, "degrade", None, "degrade", None, None,
                     "undegrade", None, "undegrade"]
    assert levels == [0, 1, 1, 2, 2, 2, 1, 1, 0]
    assert [a["action"] for a in actions] == ["degrade", "degrade",
                                              "undegrade", "undegrade"]


def test_rules_live_on_the_router_engine():
    with pytest.raises(ValueError, match="hysteresis"):
        AutoscalerConfig(burn_high=0.2, burn_low=0.25)
    router = types.SimpleNamespace(alerts=None, ladder=None)
    from ml_trainer_tpu_torch.telemetry.alerts import AlertEngine

    router.alerts = AlertEngine(clock=lambda: 0.0)
    sc = Autoscaler(router, None,
                    config=AutoscalerConfig(high_polls=3, low_polls=2))
    assert sc.alerts is router.alerts
    assert sc.alerts.rule("autoscaler_burn_high").for_count == 3
    assert sc.alerts.rule("autoscaler_burn_low").for_count == 2


def test_repair_on_a_real_router_keeps_jax_tokens():
    """A decode replica dies; the next tick adds ``auto1`` as a decode
    replica (the repair rule: no hysteresis), the fleet serves again and
    its greedy tokens equal the JAX ``generate()``; the actions publish
    as ``autoscaler_actions_total{action=}``."""
    import jax

    from ml_trainer_tpu.generate import generate as j_generate
    from ml_trainer_tpu.models import get_model as j_get_model
    from ml_trainer_tpu_torch.telemetry.registry import MetricsRegistry

    j_model = j_get_model("gpt2_tiny", max_len=MAX_LEN)
    v = j_model.init({"params": jax.random.PRNGKey(0)},
                     np.zeros((1, 8), np.int32), train=False)
    model = get_model("gpt2_tiny", max_len=MAX_LEN, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray,
                                                       v["params"])))
    model.eval()
    p = np.random.default_rng(18).integers(0, 1024, 8).astype(np.int32)
    with Router.build(model, roles=["prefill", "decode", "decode"],
                      max_batch=2, kv_page_size=PS, device="cpu") as router:
        asc = Autoscaler(
            router, lambda role: Server(model, max_batch=2, kv_page_size=PS,
                                        role=role, device="cpu"),
            AutoscalerConfig(min_decode=2))
        assert asc.tick() is None
        router.kill_replica("decode0")
        assert asc.tick() == "scale_up"
        assert router.replica("auto1").role == "decode"
        assert router.replica("auto1").generation == 0
        out = router.complete(p, 8, timeout=120)
        summary = asc.summary()
        reg = MetricsRegistry()
        asc.publish(reg)
    np.testing.assert_array_equal(
        out, np.asarray(j_generate(j_model, v, p[None], 8))[0])
    assert summary["counts"] == {"scale_up": 1}
    assert summary["actions"][0]["cause"].startswith("decode fleet")
    snap = reg.snapshot()
    assert snap["autoscaler_actions_total{action=scale_up}"] == 1.0
    assert snap["autoscaler_replicas{role=decode}"] == 2.0
