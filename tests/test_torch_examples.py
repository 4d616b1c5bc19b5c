"""The port's notebook flows (``examples/torch_port/``) on the CPU, and the
``model.pth`` layout they share with the reference and the JAX package.

* 01 then 03 (train -> history -> ``load_model`` -> ``test()``, then
  the inference-only trainer on 01's directory): the history has the
  JAX example's keys; 03 loads 01's weights bitwise and scores them as
  ``trainer.test`` scores 01's model.
* The ``model.pth`` layout, both ways: the port's ``load_model`` of the
  JAX package's ``export_torch`` file gives the JAX ``load_model``'s
  logits, the port's 03 on it the JAX ``examples/03_testing.py``'s
  metrics; the JAX ``load_model`` of the port's ``save_model`` file
  gives the port model's logits; the port's ``export_torch`` file loads
  back bitwise.
* 02 on 2 replicas of the CPU (and its tensor axis refused), 04 (with
  resume and the sampled continuation) and 05 at the JAX example tests'
  sizes: each writes ``history.pkl`` with finite losses.
* ``plot_history``'s two-panel and one-panel figures.
* 08 (every decoding mode) with ``gpt2_tiny`` and ``llama_tiny``: its
  greedy and beam-search lines equal to the JAX example's functions
  (``generate``, ``beam_search``) on the same seeded weights.
"""

import os
import runpy
import sys

import matplotlib

matplotlib.use("Agg")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import ml_trainer_tpu as J  # noqa: E402
import ml_trainer_tpu_torch as mt  # noqa: E402
from ml_trainer_tpu.checkpoint.torch_export import (  # noqa: E402
    save_torch_checkpoint as jax_export_torch,
)

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
PORT_EXAMPLES = os.path.join(ROOT, "examples", "torch_port")
JAX_EXAMPLES = os.path.join(ROOT, "examples")
# The JAX trainer's history keys (``ml_trainer_tpu/trainer.py`` fit()).
HISTORY_KEYS = {"epochs", "train_loss", "val_loss", "train_metric",
                "val_metric", "metric_type", "skipped_steps", "rollbacks",
                "reshapes"}


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads: the flows' small ops otherwise wait on all
    cores' threads, which the suite's other workers hold."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def run_example(name, monkeypatch, tmp_path, env, argv=(),
                where=PORT_EXAMPLES):
    """Run an example's ``main()`` as ``python <name> <argv>`` would, on
    the CPU, and return what it returns."""
    for k, v in dict(env, BACKEND="cpu").items():
        monkeypatch.setenv(k, v)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "argv", [name, *argv])
    # Each examples directory has its own _bootstrap.
    monkeypatch.delitem(sys.modules, "_bootstrap", raising=False)
    monkeypatch.syspath_prepend(where)
    ns = runpy.run_path(os.path.join(where, name), run_name="example")
    return ns["main"]()


def _val_loader():
    val = mt.SyntheticCIFAR10(size=512, seed=1,
                              transform=mt.custom_pre_process_function())
    return mt.Loader(val, batch_size=32, shuffle=True)


def test_01_then_03_on_its_directory(monkeypatch, tmp_path):
    env = {"MODEL_DIR": str(tmp_path / "m"), "EPOCHS": "1",
           "SYNTH_SIZE": "256"}
    trainer, _, loss, acc = run_example("01_local_training.py", monkeypatch,
                                        tmp_path, env)
    history = mt.load_history(str(tmp_path / "m"))
    assert set(history) == HISTORY_KEYS and history["epochs"] == [1]
    assert np.isfinite(history["train_loss"]).all() and np.isfinite(loss)
    model, loss3, acc3 = run_example("03_testing.py", monkeypatch, tmp_path,
                                     {"MODEL_DIR": str(tmp_path / "m")})
    for k, p in trainer.model.state_dict().items():
        assert torch.equal(model.state_dict[k], p), k
    want_loss, want_acc = trainer.test(None, _val_loader())
    assert abs(loss3 - want_loss) <= 1e-6 and abs(acc3 - want_acc) <= 1e-6


@pytest.fixture(scope="module")
def jax_export(tmp_path_factory):
    """A seeded JAX MLModel, its ``export_torch`` file and a batch."""
    d = tmp_path_factory.mktemp("jax_export")
    x = np.random.default_rng(0).normal(size=(8, 32, 32, 3)).astype(
        np.float32)
    variables = J.MLModel().init(jax.random.PRNGKey(7), x)
    path = str(d / "model.pth")
    jax_export_torch(path, jax.tree.map(np.asarray, variables))
    return path, x


def _rel(got, want) -> float:
    return float(np.max(np.abs(np.asarray(got) - np.asarray(want)))
                 / np.max(np.abs(np.asarray(want))))


def test_a_jax_export_loads_as_the_jax_package_loads_it(jax_export):
    path, x = jax_export
    want = np.asarray(J.load_model(J.MLModel(), path)(x))
    got = mt.load_model(mt.MLModel(device="cpu"), path)(torch.tensor(x))
    assert _rel(got.detach().numpy(), want) <= 1e-5


def test_port_03_matches_the_jax_03_on_a_jax_export(jax_export, monkeypatch,
                                                    tmp_path):
    path, _ = jax_export
    _, loss, acc = run_example("03_testing.py", monkeypatch, tmp_path, {},
                               argv=[path])
    seen = []
    real = J.Trainer.test

    def record(self, *a, **k):
        seen.append(real(self, *a, **k))
        return seen[-1]

    monkeypatch.setattr(J.Trainer, "test", record)
    run_example("03_testing.py", monkeypatch, tmp_path, {}, argv=[path],
                where=JAX_EXAMPLES)
    (j_loss, j_acc), = seen
    assert abs(loss - float(j_loss)) <= 1e-5 and acc == float(j_acc)


def test_save_model_and_export_torch_read_across(jax_export, tmp_path):
    path, x = jax_export
    loaded = mt.load_model(mt.MLModel(device="cpu"), path)
    trainer = mt.Trainer(loaded.module, device="cpu")
    want = loaded(torch.tensor(x)).detach().numpy()
    # save_model writes the reference's layout: the JAX load_model
    # reads the port model.
    trainer.save_model(str(tmp_path / "saved"))
    got = J.load_model(J.MLModel(), str(tmp_path / "saved" / "model.pth"))
    assert _rel(np.asarray(got(x)), want) <= 1e-5
    # export_torch -> load_model, and save_model -> load_model: bitwise.
    trainer.export_torch(str(tmp_path / "e.pth"))
    for src in (str(tmp_path / "e.pth"), str(tmp_path / "saved")):
        back = mt.load_model(mt.MLModel(device="cpu"), src)
        out = back(torch.tensor(x)).detach().numpy()
        assert np.array_equal(out, want), src
        for k, p in loaded.module.state_dict().items():
            assert torch.equal(back.state_dict[k], p), (src, k)


def test_load_model_refuses_a_msgpack_directory(tmp_path):
    (tmp_path / "model.msgpack").write_bytes(b"\x80")
    with pytest.raises(ValueError, match="model.msgpack.*export_torch"):
        mt.load_model(mt.MLModel(device="cpu"), str(tmp_path))


def test_02_on_two_replicas(monkeypatch, tmp_path):
    env = {"MODEL_DIR": str(tmp_path / "d"), "SYNTH_SIZE": "64",
           "BATCH_SIZE": "32", "EPOCHS": "1"}
    trainer = run_example("02_distributed_training.py", monkeypatch,
                          tmp_path, env)
    assert trainer.mesh.size == 2
    history = mt.load_history(str(tmp_path / "d"))
    assert np.isfinite(history["train_loss"]).all()
    assert (tmp_path / "d" / "history.pkl").exists()
    with pytest.raises(NotImplementedError, match="tensor"):
        run_example("02_distributed_training.py", monkeypatch, tmp_path,
                    dict(env, TP="2"))


def test_04_trains_resumes_and_samples(monkeypatch, tmp_path):
    env = {"MODEL_DIR": str(tmp_path / "g"), "EPOCHS": "1",
           "SYNTH_SIZE": "64", "BATCH": "8", "SEQ_LEN": "32", "ACCUM": "2",
           "K": "2", "REMAT": "1"}
    run_example("04_gpt2_pretrain.py", monkeypatch, tmp_path, env)
    assert (tmp_path / "g" / "history.pkl").exists()
    trainer, sampled = run_example("04_gpt2_pretrain.py", monkeypatch,
                                   tmp_path, dict(env, EPOCHS="2",
                                                  RESUME="1"))
    history = mt.load_history(str(tmp_path / "g"))
    assert history["epochs"] == [1, 2]
    assert np.isfinite(history["train_loss"]).all()
    assert len(sampled) == 16 and trainer.steps_per_execution == 2


def test_05_fine_tunes_right_padded(monkeypatch, tmp_path):
    env = {"MODEL_DIR": str(tmp_path / "b"), "EPOCHS": "1", "BATCH": "16",
           "MAX_LEN": "32"}
    trainer = run_example("05_bert_finetune.py", monkeypatch, tmp_path, env)
    assert trainer.model.right_padded
    history = mt.load_history(str(tmp_path / "b"))
    assert np.isfinite(history["train_loss"]).all()
    assert (tmp_path / "b" / "history.pkl").exists()


def test_plot_history_two_and_one_panel():
    n = 30  # past the 25-epoch tick thinning
    h2 = {"epochs": list(range(1, n + 1)),
          "train_loss": list(np.linspace(2, 1, n)),
          "val_loss": list(np.linspace(2.1, 1.2, n)),
          "train_metric": list(np.linspace(0.3, 0.8, n)),
          "val_metric": list(np.linspace(0.25, 0.75, n)),
          "metric_type": "accuracy"}
    fig = mt.plot_history(h2, show=False)
    assert len(fig.axes) == 2
    assert list(fig.axes[0].get_xticks()) == list(range(0, n + 1, 5))
    h1 = dict(epochs=list(range(1, 6)), train_loss=h2["train_loss"][:5],
              val_loss=h2["val_loss"][:5], train_metric=[], val_metric=[],
              metric_type=None)
    fig = mt.plot_history(h1, show=False)
    assert len(fig.axes) == 1
    assert list(fig.axes[0].get_xticks()) == list(range(1, 6))
    assert mt.plot_history(h1, show=True) is None


@pytest.mark.parametrize("model", ["gpt2_tiny", "llama_tiny"])
def test_08_generation_matches_the_jax_functions(model, monkeypatch,
                                                 tmp_path, capsys):
    from ml_trainer_tpu.generate import beam_search as jbeam_search
    from ml_trainer_tpu.generate import generate as jgenerate
    from ml_trainer_tpu.models import get_model as jget_model

    out = run_example("08_generation.py", monkeypatch, tmp_path,
                      {"MODEL": model})
    printed = capsys.readouterr().out
    prompt = out["prompt"]
    j_model = jget_model(model)
    variables = {"params": mt.variables_to_jax(out["model"])["params"]}
    greedy = np.asarray(jgenerate(j_model, variables, prompt, 8))
    beams = np.asarray(jbeam_search(j_model, variables, prompt, 6,
                                    num_beams=4))
    np.testing.assert_array_equal(out["greedy"].numpy(), greedy)
    np.testing.assert_array_equal(out["beams"].numpy(), beams)
    assert f"greedy          (2, 14): {greedy[0].tolist()}" in printed
    assert f"beam search     (2, 12): {beams[0].tolist()}" in printed
    assert [len(r) for r in out["ragged"]] == [6, 9]
    stopped = out["stopped"].numpy()
    for row in stopped[:, 6:]:
        hit = np.flatnonzero(row == 3)
        if hit.size:
            assert (row[hit[0] + 1:] == 0).all()
    if "speculative" in out:
        np.testing.assert_array_equal(out["speculative"].numpy(), greedy)
