"""The port's open-loop load generator (``ml_trainer_tpu_torch/serving/
loadgen.py``) against the JAX package's.

One seed and one tenant mix (shared prefixes, adapters with base-model
entries) give byte-equal ``schedule_to_records`` JSON in both packages;
a trace written by one package replays in the other to the same
records; ``run_open_loop(collect_tokens=True)`` against a CPU ``Server``
(and through a ``Router``) returns the JAX ``generate()`` tokens for
every request, from either package's generator.  The records are
compared as bytes; tokens exactly (greedy).
"""

import json

import numpy as np
import pytest
import torch

from ml_trainer_tpu_torch import get_model, params_from_jax
from ml_trainer_tpu_torch.serving import (
    Router,
    ScheduledRequest,
    Server,
    TenantLoad,
    poisson_schedule,
    run_open_loop,
    schedule_from_trace,
    schedule_to_records,
)

MAX_LEN = 64


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _mix(mod):
    return {
        "pro": mod.TenantLoad(weight=2.0, prompt_len=(130, 300),
                              output_len=(32, 32), shared_prefix_len=16,
                              shared_frac=0.5),
        "lora": mod.TenantLoad(weight=1.0, adapters=(None, "a", "b")),
        "free": mod.TenantLoad(weight=0.5),
    }


@pytest.mark.parametrize("seed,rate,n", [(0, 5.0, 40), (7, 50.0, 24),
                                         (123, 0.5, 9)])
def test_schedule_records_byte_equal_to_jax(seed, rate, n):
    from ml_trainer_tpu.serving import loadgen as j_loadgen

    from ml_trainer_tpu_torch.serving import loadgen

    got = json.dumps(schedule_to_records(poisson_schedule(
        rate, n, 50257, tenants=_mix(loadgen), seed=seed)))
    want = json.dumps(j_loadgen.schedule_to_records(
        j_loadgen.poisson_schedule(rate, n, 50257,
                                   tenants=_mix(j_loadgen), seed=seed)))
    assert got == want
    records = json.loads(got)
    assert {r["tenant"] for r in records} <= {"pro", "lora", "free"}
    assert all("adapter" not in r or r["tenant"] == "lora" for r in records)
    assert json.dumps(schedule_to_records(poisson_schedule(
        5.0, 6, 1024, seed=seed))) == json.dumps(
            j_loadgen.schedule_to_records(j_loadgen.poisson_schedule(
                5.0, 6, 1024, seed=seed)))


def test_traces_round_trip_across_the_packages(tmp_path):
    from ml_trainer_tpu.serving import loadgen as j_loadgen

    from ml_trainer_tpu_torch.serving import loadgen

    sched = poisson_schedule(20.0, 12, 1024, tenants=_mix(loadgen), seed=3)
    sched[2].session = "s1"
    records = schedule_to_records(sched)
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(records))
    back = j_loadgen.schedule_from_trace(str(path))
    assert j_loadgen.schedule_to_records(back) == records
    j_records = j_loadgen.schedule_to_records(j_loadgen.poisson_schedule(
        20.0, 12, 1024, tenants=_mix(j_loadgen), seed=4))
    mine = schedule_from_trace(list(reversed(j_records)))
    assert schedule_to_records(mine) == j_records  # sorted by arrival
    assert isinstance(mine[0], ScheduledRequest)
    assert mine[0].prompt.dtype == np.int32


def test_tenant_load_guards():
    for kw, match in ((dict(weight=0.0), "weight"),
                      (dict(prompt_len=(0, 4)), "prompt_len"),
                      (dict(output_len=(5, 4)), "output_len"),
                      (dict(shared_frac=1.5), "shared_frac"),
                      (dict(adapters=("",)), "adapters")):
        with pytest.raises(ValueError, match=match):
            TenantLoad(**kw)
    with pytest.raises(ValueError, match="rate_rps"):
        poisson_schedule(0.0, 4, 1024)
    with pytest.raises(ValueError, match="n_requests"):
        poisson_schedule(1.0, 0, 1024)
    with pytest.raises(ValueError, match="exactly one"):
        run_open_loop([], url=None, server=None)


@pytest.fixture(scope="module")
def models():
    import jax

    from ml_trainer_tpu.models import get_model as j_get_model

    j_model = j_get_model("gpt2_tiny", max_len=MAX_LEN)
    v = j_model.init({"params": jax.random.PRNGKey(0)},
                     np.zeros((1, 8), np.int32), train=False)
    model = get_model("gpt2_tiny", max_len=MAX_LEN, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray,
                                                       v["params"])))
    return j_model, v, model.eval()


def test_open_loop_tokens_equal_jax_generate(models):
    """Six arrivals, fired open loop at a CPU ``Server`` by the port's
    generator and at a two-replica ``Router`` by the JAX package's: every
    request completes with the JAX ``generate()`` tokens."""
    from ml_trainer_tpu.generate import generate as j_generate
    from ml_trainer_tpu.serving import loadgen as j_loadgen

    j_model, v, model = models
    mix = {"a": TenantLoad(prompt_len=(8, 12), output_len=(4, 6)),
           "b": TenantLoad(prompt_len=(8, 12), output_len=(4, 6))}
    sched = poisson_schedule(40.0, 6, 1024, tenants=mix, seed=5)
    with Server(model, max_batch=4, kv_page_size=8, device="cpu") as s:
        report = run_open_loop(sched, server=s, timeout=120,
                               collect_tokens=True)
    with Router.build(model, roles=["both", "both"], max_batch=2,
                      kv_page_size=8, device="cpu",
                      router_kwargs=dict(hedging=False)) as router:
        j_report = j_loadgen.run_open_loop(
            j_loadgen.schedule_from_trace(schedule_to_records(sched)),
            server=router, timeout=120, time_scale=0.5,
            collect_tokens=True)
    assert sorted(report) == sorted(j_report)
    for rep in (report, j_report):
        assert rep["n_completed"] == 6 and rep["n_errors"] == 0
        for s, row in zip(sched, rep["per_request"]):
            want = np.asarray(j_generate(j_model, v, s.prompt[None],
                                         s.max_new_tokens))[0]
            np.testing.assert_array_equal(row["output"], want)
            assert row["tokens"] == s.max_new_tokens
            assert row["tenant"] == s.tenant
    assert report["useful_tokens"] == sum(s.max_new_tokens for s in sched)
