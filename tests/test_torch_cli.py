"""The port's command line (``ml_trainer_tpu_torch/cli.py``, ``python -m
ml_trainer_tpu_torch``) against the JAX package's ``main.py``, on the
CPU.

* The parsers: the same flags with the same defaults, but for the
  differences listed in ``DIFFERENCES``.
* With each module's ``Trainer`` replaced by a recorder, the same argv
  gives the same Trainer arguments and config and the same model knobs
  (the JAX model's constructor kwargs against the port model's
  ``registry_config``), and the same errors.
* One real run: ``--backend cpu --synthetic`` MLModel for one epoch
  writes ``history.pkl``, ``model.pth`` and ``checkpoints/``; ``--profile``
  writes ``trace.json``.
"""

import json
import os
import pickle
import runpy
import sys

import pytest
import torch

import main as jmain
from ml_trainer_tpu_torch import cli

# flag: (main.py's default, the port's default)
DIFFERENCES = {"backend": ("tpu", "cuda")}


def test_the_parsers_have_the_same_flags_and_defaults():
    want = vars(jmain.parse_args([]))
    got = vars(cli.parse_args([]))
    assert set(got) == set(want)
    for flag, (j, t) in DIFFERENCES.items():
        assert (want[flag], got[flag]) == (j, t)
    same = {k: v for k, v in want.items() if k not in DIFFERENCES}
    assert {k: got[k] for k in same} == same


class _Recorder:
    calls = []

    def __init__(self, model, **kwargs):
        _Recorder.calls.append((model, kwargs))

    def fit(self, resume=False):
        _Recorder.calls[-1][1]["fit_resume"] = resume


def _record(monkeypatch, argv):
    """(model knobs, Trainer kwargs) that main.py and the port's CLI pass
    for ``argv``."""
    knobs = []
    real = jmain.get_model
    monkeypatch.setattr(jmain, "get_model", lambda name, **kw: (
        knobs.append(dict(kw)), real(name, **kw))[1])
    monkeypatch.setattr(jmain, "Trainer", _Recorder)
    monkeypatch.setattr(cli, "Trainer", _Recorder)
    _Recorder.calls = []
    jmain.main(jmain.parse_args(argv))
    cli.main(cli.parse_args(argv))
    (jmodel, jkw), (tmodel, tkw) = _Recorder.calls
    name, tknobs = tmodel.registry_config
    tknobs = {k: v for k, v in tknobs.items() if k != "device"}
    return knobs[0], tknobs, jkw, tkw


ARGVS = [
    ["--backend", "cpu", "--synthetic", "--epochs", "3", "--lr", "0.01",
     "--metric", "accuracy", "--scheduler", "StepLR", "--custom_function",
     "--save_best", "--early_stop_patience", "2"],
    ["--backend", "cpu", "--model", "gpt2_tiny", "--synthetic_tokens",
     "--seq_len", "32", "--vocab_size", "128", "--dtype", "bf16", "--remat",
     "--remat_policy", "dots", "--ema_decay", "0.999",
     "--steps_per_execution", "4", "--optimizer", "adamw",
     "--grad_clip_norm", "1.0", "--batch_size", "8", "--resume",
     "--loss_chunk", "8", "--grad_accum_steps", "2",
     "--decay_exclude_bias_norm", "--label_smoothing", "0.0"],
    ["--backend", "gloo", "--model", "bert_tiny", "--synthetic",
     "--synthetic_train_size", "64", "--remat", "--dtype", "float32"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=["mlmodel", "gpt2", "bert"])
def test_the_same_argv_gives_the_same_trainer_arguments(monkeypatch, argv):
    jknobs, tknobs, jkw, tkw = _record(monkeypatch, argv)
    if "dtype" in jknobs:
        assert str(jknobs.pop("dtype").dtype) == str(
            tknobs.pop("dtype")).replace("torch.", "")
    assert tknobs == jknobs
    jsets, tsets = jkw.pop("datasets"), tkw.pop("datasets")
    assert [len(s) for s in tsets] == [len(s) for s in jsets]
    assert [type(s).__name__ for s in tsets] == [type(s).__name__
                                                 for s in jsets]
    assert tkw == jkw


@pytest.mark.parametrize("argv,error", [
    (["--model", "mlmodel", "--remat"], "does not accept"),
    (["--remat_policy", "dots"], "only applies with --remat"),
    (["--synthetic_tokens", "--model", "bert_tiny"], "sequence classifiers"),
])
def test_the_same_errors(monkeypatch, argv, error):
    monkeypatch.setattr(jmain, "Trainer", _Recorder)
    monkeypatch.setattr(cli, "Trainer", _Recorder)
    argv = ["--backend", "cpu", "--synthetic"] + argv
    with pytest.raises(SystemExit, match=error):
        jmain.main(jmain.parse_args(argv))
    with pytest.raises(SystemExit, match=error):
        cli.main(cli.parse_args(argv))


def test_moe_top_k_is_refused_as_not_ported():
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        cli.main(cli.parse_args(["--backend", "cpu", "--synthetic",
                                 "--moe_top_k", "2"]))


def test_python_dash_m_runs_the_cli(monkeypatch):
    monkeypatch.setattr(cli, "Trainer", _Recorder)
    _Recorder.calls = []
    monkeypatch.setattr(sys, "argv", ["ml_trainer_tpu_torch", "--backend",
                                      "cpu", "--synthetic", "--resume"])
    runpy.run_module("ml_trainer_tpu_torch", run_name="__main__")
    assert _Recorder.calls[-1][1]["fit_resume"] is True


def test_a_cpu_run_writes_its_artifacts(tmp_path, capsys):
    out = tmp_path / "run"
    cli.cli(["--backend", "cpu", "--synthetic", "--epochs", "1",
             "--batch_size", "16", "--synthetic_train_size", "32",
             "--synthetic_val_size", "16", "--metric", "accuracy",
             "--ema_decay", "0.9", "--model_dir", str(out),
             "--profile", str(tmp_path / "prof")])
    with open(out / "history.pkl", "rb") as fp:
        history = pickle.load(fp)
    assert history["epochs"] == [1] and len(history["val_metric"]) == 1
    state = torch.load(out / "model.pth")
    assert "fc1.weight" in state
    assert os.listdir(out / "checkpoints") == ["checkpoint_1"]
    trace = json.load(open(tmp_path / "prof" / "trace.json"))
    assert trace["traceEvents"]
    assert "trace.json" in capsys.readouterr().out
