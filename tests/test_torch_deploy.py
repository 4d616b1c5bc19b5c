"""The port's deploy generations (``ml_trainer_tpu_torch/serving/
deploy.py`` and the router's split) and the export manifest against the
JAX package.

A healthy deploy walks canary -> 100%, promotes, and the fleet then
serves the JAX ``generate()`` tokens of the new weights (carried across
by ``params_from_jax``); a wedged canary rolls back within one poll with
no stream dropped and the stable fleet on the old weights' JAX tokens;
shadow mode rolls back on a token diff before the split is raised, or
proceeds when the tokens agree; ``stage_min_requests`` holds a stage
until the slice reports.  ``tenant_slice`` equals the JAX router's on
1,000 names, and the state machine, driven through one stand-in router
in both packages, records the same flight events and the same
``serving_deploy_*`` gauges.  The train-to-serve loop: a port ``fit``
writes ``model_manifest.json`` whose fingerprint equals the JAX
``weights_fingerprint`` of the same weights and the deploy's
``weights_fp``.  ``Fleet.deploy_factory`` spawns a ``--ckpt`` worker,
and ``RemoteServer.stderr_tail`` reads the log of one that refused to
start without a card.  ``gpt2_tiny`` at max_len 64 and page 8; tokens
are compared exactly (greedy), host arithmetic exactly.
"""

import time
import types
import zlib

import numpy as np
import pytest
import torch

from ml_trainer_tpu_torch import get_model, load_model, params_from_jax
from ml_trainer_tpu_torch.checkpoint import (
    load_model_manifest,
    weights_fingerprint,
    weights_structure_digest,
    write_model_manifest,
)
from ml_trainer_tpu_torch.convert import variables_to_jax
from ml_trainer_tpu_torch.serving import (
    DeployConfig,
    Deployment,
    Fleet,
    RemoteServer,
    Router,
    Server,
)
from ml_trainer_tpu_torch.serving.deploy import TERMINAL_STATES
from ml_trainer_tpu_torch.serving.engine import weights_fp
from ml_trainer_tpu_torch.serving.slo import SloPolicy

MAX_LEN = 64
PS = 8


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """One architecture, two weight sets (generations 0 and 1): the JAX
    module and variables, and the port's models over the same weights."""
    import jax

    from ml_trainer_tpu.models import get_model as j_get_model

    j_model = j_get_model("gpt2_tiny", max_len=MAX_LEN)
    x = np.zeros((1, 8), np.int32)
    out = [j_model]
    for seed in (0, 1):
        v = j_model.init({"params": jax.random.PRNGKey(seed)}, x,
                         train=False)
        t = get_model("gpt2_tiny", max_len=MAX_LEN, device="cpu")
        t.load_state_dict(params_from_jax(
            jax.tree.map(np.asarray, v["params"])))
        out += [v, t.eval()]
    return tuple(out)  # j_model, v0, m0, v1, m1


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(0, 1024, n).astype(np.int32)


def _jax_ref(j_model, variables, p, n):
    from ml_trainer_tpu.generate import generate as j_generate

    return np.asarray(j_generate(j_model, variables, p[None], n))[0]


def _tenants(fraction, canary, n):
    """The first ``n`` tenant names inside (``canary``) or outside the
    slice ``[0, fraction)``."""
    out, i = [], 0
    while len(out) < n:
        t = f"tenant{i}"
        if (Router.tenant_slice(t) < fraction) == canary:
            out.append(t)
        i += 1
    return out


def _deploy_router(model, **slo_kw):
    policy = SloPolicy(**{**dict(ttft_ms=60_000.0, tpot_ms=60_000.0,
                                 target=0.9), **slo_kw})
    return Router.build(model, roles=["both", "both"], max_batch=2,
                        kv_page_size=PS, device="cpu",
                        router_kwargs=dict(hedging=False, slo=policy))


def _factory(model, wedge_s=0.0):
    def factory(role):
        server = Server(model, max_batch=2, kv_page_size=PS, role=role,
                        device="cpu")
        if wedge_s:
            inner = server.submit_request

            def wedged(req, _inner=inner):
                time.sleep(wedge_s)
                _inner(req)

            server.submit_request = wedged
        return server

    return factory


# ---------------------------------------------------- the split and slice


def test_tenant_slice_equals_jax_on_1000_names():
    from ml_trainer_tpu.serving.router import Router as JRouter

    names = [f"t{i}" for i in range(500)] + [f"tenant-{i:04d}é"
                                              for i in range(500)]
    got = [Router.tenant_slice(t) for t in names]
    assert got == [JRouter.tenant_slice(t) for t in names]
    assert all(0.0 <= s < 1.0 for s in got)
    assert 0 < sum(s < 0.25 for s in got) < len(got)


def test_generation_split_routes_canary_cohort(models):
    """Split at 0.25: the slice's tenants get the seed-1 weights' JAX
    tokens from the generation-1 replica, the rest seed 0's."""
    j_model, v0, m0, v1, m1 = models
    p = _prompt(2, 8)
    with Router.build(m0, roles=["both"], max_batch=2, kv_page_size=PS,
                      device="cpu",
                      router_kwargs=dict(hedging=False)) as router:
        router.add_replica("deploy1-both0",
                           Server(m1, max_batch=2, kv_page_size=PS,
                                  device="cpu"), generation=1)
        assert router.replica("rep0").generation == 0
        router.set_deploy_split(1, 0.25)
        canary_t = _tenants(0.25, True, 2)
        stable_t = _tenants(0.25, False, 2)
        got1 = [router.complete(p, 6, timeout=120, tenant=t)
                for t in canary_t]
        got0 = [router.complete(p, 6, timeout=120, tenant=t)
                for t in stable_t]
        counts = router.snapshot()["requests_total"]
        snap = router.snapshot()
    for out in got1:
        np.testing.assert_array_equal(out, _jax_ref(j_model, v1, p, 6))
    for out in got0:
        np.testing.assert_array_equal(out, _jax_ref(j_model, v0, p, 6))
    assert counts == {"colocated/deploy1-both0": 2, "colocated/rep0": 2}
    assert (snap["serving_generation"], snap["deploy_generation"],
            snap["deploy_fraction"]) == (0, 1, 0.25)


# ------------------------------------------------------------ deployments


def test_deploy_ramps_and_promotes_to_jax_tokens(models):
    """Staging mirrors the stable role mix, traffic walks 0.25 -> 1.0,
    generation 1 is promoted, the old one retires, and the fleet serves
    the JAX ``generate()`` tokens of the seed-1 weights."""
    j_model, v0, m0, v1, m1 = models
    p = _prompt(3, 8)
    cfg = DeployConfig(canary=0.25, stages=(1.0,), hold_s=0.05,
                       min_window_requests=1, drain_timeout_s=30.0)
    with _deploy_router(m0) as router:
        router.complete(p, 4, timeout=120)
        dep = Deployment(router, "ckpt-v1", _factory(m1), config=cfg)
        assert dep.tick() == "canary"
        assert router._deploy_generation == 1
        assert router._deploy_fraction == pytest.approx(0.25)
        assert len(dep.new_replicas) == 2
        assert dep.weights_fp == weights_fp(m1) != dep.old_weights_fp
        for t in _tenants(0.25, True, 2):
            router.complete(p, 6, timeout=120, tenant=t)
        time.sleep(cfg.hold_s + 0.01)
        assert dep.tick() == "ramping"
        assert router._deploy_fraction == pytest.approx(1.0)
        time.sleep(cfg.hold_s + 0.01)
        assert dep.tick() == "done"
        assert router._serving_generation == 1
        assert router._deploy_generation is None
        out = router.complete(p, 6, timeout=120)
        assert set(router.replicas) == set(dep.new_replicas)
        assert all(r.generation == 1 for r in router.replicas.values())
        actions = [e["action"] for e in dep.events]
    np.testing.assert_array_equal(out, _jax_ref(j_model, v1, p, 6))
    assert "staged" in actions and "promoted" in actions
    assert dep.report()["state"] == "done"


def test_stage_min_requests_holds_until_slice_reports(models):
    _, _, m0, _, m1 = models
    cfg = DeployConfig(canary=0.25, stages=(1.0,), hold_s=0.0,
                       min_window_requests=1, stage_min_requests=1,
                       warmup=False)
    with _deploy_router(m0) as router:
        dep = Deployment(router, "ckpt-v1", _factory(m1), config=cfg)
        assert dep.tick() == "canary"
        assert dep.tick() == "canary"  # the hold is over, no report yet
        assert dep.tick() == "canary"
        router.complete(_prompt(9, 8), 4, timeout=120,
                        tenant=_tenants(0.25, True, 1)[0])
        assert dep.tick() == "ramping"
        assert dep.tick() == "done"
        assert router._serving_generation == 1


def test_forced_regression_rolls_back_with_no_stream_dropped(models):
    """Only the new generation is wedged: the slice's burn crosses the
    threshold and the deploy rolls back at the next poll; the split is
    down, generation 1 gone, every stream finished, and the stable
    fleet's tokens equal the JAX ``generate()`` on seed 0."""
    j_model, v0, m0, _, m1 = models
    p = _prompt(4, 8)
    ref0 = _jax_ref(j_model, v0, p, 6)
    cfg = DeployConfig(canary=0.25, stages=(1.0,), hold_s=60.0,
                       burn_threshold=2.0, high_polls=1,
                       min_window_requests=2, drain_timeout_s=60.0)
    with _deploy_router(m0, ttft_ms=250.0) as router:
        for t in _tenants(0.25, False, 2):
            router.complete(p, 4, timeout=120, tenant=t)
        dep = Deployment(router, "ckpt-wedged", _factory(m1, wedge_s=0.6),
                         config=cfg)
        assert dep.tick() == "canary"
        canary_t = _tenants(0.25, True, 3)
        stable_t = _tenants(0.25, False, 3)
        stable = [router.submit(p, 6, tenant=t) for t in stable_t]
        canary = [router.submit(p, 6, tenant=t) for t in canary_t]
        canary_out = [s.result(timeout=120) for s in canary]
        inflight = router.submit(p, 6, tenant=canary_t[0])
        assert dep.tick() == "rolled_back"
        assert dep.last_burn >= cfg.burn_threshold
        assert "canary burn" in dep.rollback_cause
        assert router._deploy_generation is None
        assert router._deploy_fraction == 0.0
        assert set(router.replicas) == {"rep0", "rep1"}
        late = inflight.result(timeout=120)
        stable_out = [s.result(timeout=120) for s in stable]
        after = router.complete(p, 6, timeout=120, tenant=stable_t[0])
    assert inflight.request.state == "done" and late.size == 14
    assert all(s.request.state == "done" for s in stable + canary)
    assert all(np.asarray(o).size == 14 for o in canary_out)
    for out in stable_out + [after]:
        np.testing.assert_array_equal(out, ref0)
    assert dep.report()["state"] == "rolled_back"


def test_shadow_mismatch_rolls_back_before_traffic_moves(models):
    _, _, m0, _, m1 = models
    cfg = DeployConfig(shadow=True, shadow_fraction=1.0,
                       shadow_min_requests=1)
    with _deploy_router(m0) as router:
        dep = Deployment(router, "ckpt-diff", _factory(m1), config=cfg)
        assert dep.tick() == "shadowing"
        assert router._request_tap is not None
        router.complete(_prompt(5, 8), 6, timeout=120, tenant="live")
        assert dep.tick() == "rolled_back"
        report = dep.shadow_report()
        assert report["n_token_mismatch"] >= 1
        assert "shadow diff" in dep.rollback_cause
        assert all(e["action"] != "stage" for e in dep.events)
        assert router._deploy_fraction == 0.0
        assert router._request_tap is None


def test_shadow_clean_proceeds_to_canary(models):
    _, _, m0, _, _ = models
    cfg = DeployConfig(shadow=True, shadow_fraction=1.0,
                       shadow_min_requests=1, canary=0.25,
                       min_window_requests=10_000)
    with _deploy_router(m0) as router:
        dep = Deployment(router, "ckpt-same", _factory(m0), config=cfg)
        assert dep.tick() == "shadowing"
        router.complete(_prompt(6, 8), 6, timeout=120, tenant="live")
        assert dep.tick() == "canary"
        report = dep.shadow_report()
        assert report["n_compared"] >= 1
        assert report["n_token_mismatch"] == 0
        assert report["shadow_e2e_ms_p50"] is not None
        assert router._deploy_fraction == pytest.approx(0.25)
        dep.close()
        assert dep.state == "failed" and router._deploy_fraction == 0.0


def test_deploy_guards(models):
    _, _, m0, _, _ = models
    with _deploy_router(m0) as router:
        with pytest.raises(ValueError, match="factory"):
            router.deploy("some-ckpt")  # no fleet, no factory
        dep = Deployment(router, "x", _factory(m0))
        router._deployment = dep
        assert not dep.finished() and dep.state not in TERMINAL_STATES
        with pytest.raises(RuntimeError, match="already"):
            router.deploy("y", factory=_factory(m0))
        router._deployment = None
    with pytest.raises(ValueError, match="canary"):
        DeployConfig(canary=0.0)
    with pytest.raises(ValueError, match="stages"):
        DeployConfig(stages=(1.5,))
    with pytest.raises(ValueError, match="burn_threshold"):
        DeployConfig(high_polls=0)
    assert DeployConfig(canary=0.05).fractions() == (0.05, 0.5, 1.0)


def test_router_deploy_runs_to_done_on_its_thread(models):
    """``Router.deploy`` starts the state machine on its timer thread;
    ``wait`` returns the verdict."""
    j_model, _, m0, v1, m1 = models
    p = _prompt(11, 8)
    cfg = DeployConfig(stages=(1.0,), hold_s=0.0, poll_interval_s=0.02,
                       min_window_requests=10_000)
    with _deploy_router(m0) as router:
        dep = router.deploy("ckpt-v1", canary=0.5, factory=_factory(m1),
                            config=cfg)
        assert dep.wait(timeout=120) == "done"
        assert dep.config.canary == 0.5
        out = router.complete(p, 6, timeout=120)
        # Without ``canary=`` the config's stands (the JAX router's
        # default 0.05 would replace it: ROADMAP.md Queue C).
        kept = router.deploy("ckpt-v0", factory=_factory(m0),
                             config=DeployConfig(canary=0.25, stages=(1.0,),
                                                 warmup=False))
        assert kept.config.canary == 0.25
        kept.close()
    np.testing.assert_array_equal(out, _jax_ref(j_model, v1, p, 6))


# ------------------------------------ the state machine in both packages


class _StandInServer:
    """A replica that finishes every request at once (warmup only)."""

    def __init__(self, role, fp):
        self.role = role
        self.engine = types.SimpleNamespace(weights_fp=fp)

    def submit_request(self, req):
        req.tokens = [0] * req.max_new_tokens
        req.finish("done")

    def close(self):
        pass


class _StandInRouter:
    """The surface ``Deployment`` drives, the same for both packages."""

    def __init__(self, slo_tracker, alerts):
        self._serving_generation = 0
        self._deploy_generation = None
        self._deploy_fraction = 0.0
        self._request_tap = None
        self.alerts = alerts
        self.slo = slo_tracker
        self._reps = {}
        for name in ("rep0", "rep1"):
            self.add_replica(name, _StandInServer("both", "w:old"), 0)

    @property
    def replicas(self):
        return dict(self._reps)

    def add_replica(self, name, server, generation=None):
        self._reps[name] = types.SimpleNamespace(
            name=name, server=server, role=server.role, healthy=True,
            removing=False, weights_fp=server.engine.weights_fp,
            generation=(self._serving_generation if generation is None
                        else generation))

    def remove_replica(self, name, timeout=30.0, close=None):
        self._reps.pop(name)
        return True

    tenant_slice = staticmethod(Router.tenant_slice)

    def set_deploy_split(self, generation, fraction):
        self._deploy_generation = generation
        self._deploy_fraction = float(fraction)

    def promote_generation(self, generation):
        self._serving_generation = int(generation)
        self._deploy_generation = None
        self._deploy_fraction = 0.0


def _drive(pkg, rollback: bool):
    """One deployment of package ``pkg`` over the stand-in router, with
    its flight recorder and registry fresh: the event rows (without the
    clock's readings) and the gauges."""
    import importlib

    deploy = importlib.import_module(f"{pkg}.serving.deploy")
    slo = importlib.import_module(f"{pkg}.serving.slo")
    alerts = importlib.import_module(f"{pkg}.telemetry.alerts")
    flight = importlib.import_module(f"{pkg}.telemetry.flight")
    registry = importlib.import_module(f"{pkg}.telemetry.registry")
    flight.reset_recorder()
    t = [0.0]
    router = _StandInRouter(slo.SloTracker(), alerts.AlertEngine(
        clock=lambda: t[0]))
    dep = deploy.Deployment(
        router, "ckpt", lambda role: _StandInServer(role, "w:new"),
        config=deploy.DeployConfig(canary=0.25, stages=(0.5, 1.0),
                                   hold_s=1.0, high_polls=2),
        clock=lambda: t[0])
    states = [dep.tick()]
    if rollback:
        dep.canary_burn = lambda: {"burn_rate": {"ttft": 4.5, "tpot": 0.5},
                                   "n_requests": 3}
    while not dep.finished():
        t[0] += 1.0
        states.append(dep.tick())
    rows = [{k: v for k, v in r.items() if k not in ("seq", "t", "seconds")}
            for r in flight.get_recorder().records()]
    reg = registry.MetricsRegistry()
    dep.publish(reg)
    return states, rows, reg.snapshot(), dep.report()


@pytest.mark.parametrize("rollback", [False, True])
def test_state_machine_events_and_gauges_equal_jax(rollback):
    got = _drive("ml_trainer_tpu_torch", rollback)
    want = _drive("ml_trainer_tpu", rollback)
    assert got[0] == want[0]
    assert got[0][-1] == ("rolled_back" if rollback else "done")
    assert got[1] == want[1]
    kinds = {r["kind"] for r in got[1]}
    assert kinds == ({"deploy", "alert"} if rollback else {"deploy"})
    assert got[2] == want[2]
    assert any(k.startswith("serving_deploy_state") for k in got[2])
    for key in ("state", "plan", "last_burn", "rollback_cause", "events",
                "weights_fp", "old_weights_fp", "new_replicas"):
        assert got[3][key] == want[3][key], key


# --------------------------------------------- train -> export -> deploy


def test_fit_save_model_manifest_deploy(models, tmp_path):
    """A port ``fit`` writes ``model.pth`` with its manifest; the
    manifest's fingerprint is the JAX ``weights_fingerprint`` of the same
    weights in the flax layout and the deploy's ``weights_fp``; the
    promoted fleet serves the JAX ``generate()`` tokens of the trained
    weights."""
    import jax
    import jax.numpy as jnp

    import ml_trainer_tpu_torch as mt
    from ml_trainer_tpu.checkpoint import (
        weights_fingerprint as j_weights_fingerprint,
    )
    from ml_trainer_tpu.checkpoint import (
        weights_structure_digest as j_structure_digest,
    )

    j_model, _, m0, _, _ = models
    model = mt.init_model("gpt2_tiny", seed=3, device="cpu",
                          max_len=MAX_LEN)
    sets = (mt.SyntheticTokens(size=16, seq_len=16, vocab_size=1024),
            mt.SyntheticTokens(size=8, seq_len=16, vocab_size=1024, seed=1))
    mt.Trainer(model, datasets=sets, epochs=1, batch_size=8, metric=None,
               lr=0.01, device="cpu", save_best=True,
               model_dir=str(tmp_path)).fit()
    manifest = load_model_manifest(str(tmp_path))
    data = (tmp_path / "model.pth").read_bytes()
    trained = get_model("gpt2_tiny", max_len=MAX_LEN, device="cpu")
    load_model(trained, str(tmp_path))
    trained.eval()
    flax = {"params": variables_to_jax(trained)["params"]}
    assert manifest["format"] == 1
    assert manifest["weights_fingerprint"] == j_weights_fingerprint(flax)
    assert manifest["weights_fingerprint"] == weights_fp(trained)
    assert manifest["structure_digest"] == j_structure_digest(flax)
    assert manifest["model_bytes"] == len(data)
    assert manifest["model_crc32"] == zlib.crc32(data)
    assert load_model_manifest(str(tmp_path / "best")) == manifest
    assert load_model_manifest(str(tmp_path / "model.pth")) == manifest

    p = _prompt(7, 8)
    variables = {"params": jax.tree.map(jnp.asarray, flax["params"])}
    cfg = DeployConfig(canary=0.25, stages=(1.0,), hold_s=0.0,
                       min_window_requests=10_000)

    def factory(role):
        fresh = get_model("gpt2_tiny", max_len=MAX_LEN, device="cpu")
        load_model(fresh, str(tmp_path))
        return Server(fresh.eval(), max_batch=2, kv_page_size=PS,
                      role=role, device="cpu")

    with _deploy_router(m0) as router:
        dep = Deployment(router, str(tmp_path), factory, config=cfg)
        while not dep.finished():
            dep.tick()
        assert dep.state == "done"
        assert dep.weights_fp == manifest["weights_fingerprint"]
        out = router.complete(p, 6, timeout=120)
    np.testing.assert_array_equal(out, _jax_ref(j_model, variables, p, 6))


def test_manifest_round_trip_and_absence(models, tmp_path):
    _, v0, m0, _, m1 = models
    from ml_trainer_tpu.checkpoint import (
        load_model_manifest as j_load_model_manifest,
    )

    meta = write_model_manifest(str(tmp_path), variables_to_jax(m0))
    assert load_model_manifest(str(tmp_path)) == meta
    assert j_load_model_manifest(str(tmp_path)) == meta
    assert meta["weights_fingerprint"] == weights_fingerprint(
        {"params": variables_to_jax(m0)["params"]})
    assert meta["weights_fingerprint"] != weights_fingerprint(
        variables_to_jax(m1))
    assert meta["structure_digest"] == weights_structure_digest(
        variables_to_jax(m1))
    assert "model_crc32" not in meta
    (tmp_path / "empty").mkdir()
    assert load_model_manifest(str(tmp_path / "empty")) is None


# ------------------------------------------------------------- the fleet


def test_deploy_factory_spawns_a_ckpt_worker_and_stderr_tail(tmp_path,
                                                             monkeypatch,
                                                             models):
    """``deploy_factory(ckpt)`` starts ``--worker ... --ckpt <ckpt>``; the
    worker (no card here, and none visible) refuses to start, and its
    log's tail is what ``stderr_tail`` returns and what the autoscaler's
    replace-dead event attaches."""
    from ml_trainer_tpu_torch.serving import Autoscaler, AutoscalerConfig

    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    fleet = Fleet(["both"], max_len=MAX_LEN, kv_page_size=PS,
                  log_dir=str(tmp_path / "logs"), spawn_timeout=120.0)
    seen = {}
    real_wait = fleet.wait_ready

    def wait_ready(name, proc, url, log_path):
        seen.update(name=name, proc=proc, log_path=log_path)
        return real_wait(name, proc, url, log_path)

    fleet.wait_ready = wait_ready
    ckpt = str(tmp_path / "gen1")
    with pytest.raises(RuntimeError, match="before readiness"):
        fleet.deploy_factory(ckpt)("both")
    proc = seen["proc"]
    argv = list(proc.args)
    assert argv[argv.index("--ckpt") + 1] == ckpt
    assert argv[argv.index("--name") + 1] == seen["name"] == "both0"
    assert proc.wait(timeout=60) != 0
    remote = RemoteServer.__new__(RemoteServer)
    remote.log_path = seen["log_path"]
    tail = remote.stderr_tail()
    assert "no CUDA device is visible" in tail
    assert len(remote.stderr_tail(max_bytes=16).encode()) <= 16
    remote.log_path = None
    assert remote.stderr_tail() is None
    remote.log_path = seen["log_path"]

    _, _, m0, _, _ = models
    with _deploy_router(m0) as router:
        rep = router.replica("rep0")
        rep.healthy = False
        rep.server.proc = proc
        rep.server.stderr_tail = remote.stderr_tail
        auto = Autoscaler(router, _factory(m0),
                          config=AutoscalerConfig(min_replicas=3))
        assert auto._scale_up("both", "replica rep0 found dead",
                              auto._clock(), repair=True)
        action = auto.actions[-1]
    assert action["action"] == "scale_up"
    assert "no CUDA device is visible" in action["dead_stderr"]["rep0"]


def test_make_router_attaches_the_fleet(monkeypatch, tmp_path):
    """``Fleet.make_router`` leaves the fleet on ``router.fleet``, so
    ``Router.deploy(ckpt)`` takes ``deploy_factory(ckpt)``."""
    made = {}

    class _Router:
        def __init__(self, **kw):
            made.update(kw)
            self.fleet = None

    monkeypatch.setattr("ml_trainer_tpu_torch.serving.router.Router",
                        _Router)
    fleet = Fleet(["both"], log_dir=str(tmp_path))
    router = fleet.make_router(hedging=False)
    assert router.fleet is fleet
    assert made == dict(replicas={}, replica_urls={}, hedging=False,
                        own_servers=True)


# ------------------------------------------------ the router's telemetry


def test_router_alert_rules_watchtower_and_fleet_events(models):
    """``Router(alert_rules=)`` and ``add_alert_rule`` put rules on
    ``router.alerts``; the health poll samples the router's gauges into
    ``router.watchtower`` and evaluates them, so a rule over
    ``router_requests_total`` fires (a ``page`` rule records with no
    incident trigger); ``add_replica``/``reassign_role``/
    ``remove_replica`` record the JAX router's ``fleet_change`` events."""
    from ml_trainer_tpu_torch.telemetry import flight
    from ml_trainer_tpu_torch.telemetry.alerts import AlertRule

    _, _, m0, _, _ = models
    flight.reset_recorder()
    first = AlertRule("placed", "router_requests_total{replica=prefill0} "
                      ">= 1", severity="page")
    with Router.build(m0, roles=["prefill", "decode"], max_batch=2,
                      kv_page_size=PS, device="cpu",
                      router_kwargs=dict(hedging=False, alert_rules=[first],
                                         health_interval=0.05)) as router:
        second = router.add_alert_rule(AlertRule(
            "migrated", "router_migrations_total >= 1"))
        assert router.alert_rules == [first, second]
        assert router.alerts.incident_trigger is None
        router.complete(_prompt(12, 8), 4, timeout=120)
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and not (
                first.firing() and second.firing()):
            time.sleep(0.05)
        assert first.firing() and second.firing()
        assert router.watchtower.last_value(
            "router_migrations_total") >= 1.0
        router.add_replica("decode1", Server(m0, max_batch=2,
                                             kv_page_size=PS, role="decode",
                                             device="cpu"))
        assert router.reassign_role("decode1", "prefill", timeout=30)
        assert router.remove_replica("decode1", timeout=30, close=True)
    fired = [e for e in router.alerts.history() if e["state"] == "firing"]
    assert {e["rule"] for e in fired} == {"placed", "migrated"}
    rows = [{k: v for k, v in r.items() if k not in ("seq", "t")}
            for r in flight.get_recorder().records()
            if r["kind"] == "fleet_change"]
    assert rows == [
        dict(kind="fleet_change", action="add_replica", replica="decode1",
             role="decode", fleet=3, generation=0),
        dict(kind="fleet_change", action="reassign_role", replica="decode1",
             role="prefill"),
        dict(kind="fleet_change", action="remove_replica",
             replica="decode1", drained=True, fleet=2)]


# -------------------------------------------------------------- the card


@pytest.mark.cuda
def test_deploy_promotes_on_card():
    """A deploy of seed-1 weights onto a ``cuda:0`` router promotes, and
    the fleet's tokens equal one seed-1 ``Server``'s."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA) and nvcc")
    import ml_trainer_tpu_torch as mt

    m0 = mt.init_model("gpt2_tiny", seed=0, device="cuda", max_len=256)
    m1 = mt.init_model("gpt2_tiny", seed=1, device="cuda", max_len=256)
    prompts = [_prompt(s, n) for s, n in ((1, 20), (2, 140), (3, 37))]
    with Server(m1, max_batch=4, kv_page_size=16, paged_kernel=True,
                device="cuda") as ref:
        want = [ref.complete(p, 12, timeout=300) for p in prompts]

    def factory(role):
        return Server(m1, max_batch=4, kv_page_size=16, paged_kernel=True,
                      role=role, device="cuda")

    cfg = DeployConfig(canary=0.25, stages=(1.0,), hold_s=0.0,
                       min_window_requests=10_000)
    with Router.build(m0, roles=["both", "both"], max_batch=4,
                      kv_page_size=16, paged_kernel=True, device="cuda",
                      router_kwargs=dict(hedging=False)) as router:
        dep = Deployment(router, "seed1", factory, config=cfg)
        while not dep.finished():
            dep.tick()
        assert dep.state == "done" and dep.weights_fp == weights_fp(m1)
        got = [router.complete(p, 12, timeout=300) for p in prompts]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
