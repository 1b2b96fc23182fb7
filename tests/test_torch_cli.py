"""``python -m paddle_tpu_torch`` (``cli.py``), ``net_drawer`` and ``plot``
against the JAX package's on the CPU (``--use_tpu=0``), over the small
config of ``tests/test_cli_bench.py:15-37`` written once for each package:

* ``train`` runs a pass and prints ``cost=`` and ``pass 0``; ``--job=time``
  prints a JSON line with the reference's keys; ``--job=checkgrad`` passes
  with the reference's record; ``--job=test`` evaluates a saved model, and
  on a checkpoint the JAX CLI trained it prints the JAX CLI's cost and
  accuracy at rtol 1e-5;
* ``infer`` on a merged artifact of the same weights (the JAX startup's,
  loaded by name) writes the JAX CLI's outputs at rtol 1e-5;
* ``dump_config`` prints the JAX CLI's text (the same op types, variable
  shapes and op schemas);
* ``obs snapshot`` (JSON and Prometheus), ``export-trace``, ``trace
  --fleet`` over it, ``hotspots`` (``--config``, ``--input``, ``--compare``)
  and ``dump`` read what the port wrote, and the JAX CLI reads the port's
  trace and postmortem to the same summaries;
* ``compile``, ``fleet``, ``obs slo`` and ``obs hotspots --port`` raise
  naming ROADMAP A.10, and ``python -m paddle_tpu_torch`` exits nonzero
  on them;
* ``net_drawer.draw`` gives the JAX package's dot text for the same
  program, and ``plot.Ploter``'s CSV the reference's bytes."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import cli as jcli
from paddle_tpu import flags as jflags
from paddle_tpu import obs as jobs
import paddle_tpu_torch as tfluid
from paddle_tpu_torch import cli as tcli
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch import obs

REPO = Path(__file__).resolve().parents[1]
CPU = "--use_tpu=0"


@pytest.fixture(autouse=True)
def fresh(monkeypatch, tmp_path):
    """Each test starts from fresh programs, metrics and flag values, and
    leaves both flag registries as it found them: the CLI defines its own
    flags (``job``, ``config``, ...) in the process-wide registry."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setenv("PADDLE_TPU_POSTMORTEM_DIR", str(tmp_path / "pm"))
    saved = {fg: [(k, f, f.value) for k, f in fg._registry.items()]
             for fg in (jflags, tflags)}
    for fl, fg, o in ((jfluid, jflags, jobs), (tfluid, tflags, obs)):
        fl.reset_default_programs()
        fl.reset_global_scope()
        for f in fg._registry.values():
            f.value = None
        o.metrics.reset()
        o.trace.disable()
        o.trace.clear()
        o.prof.reset()
    yield
    for fg, entries in saved.items():
        fg._registry.clear()
        for k, f, value in entries:
            f.value = value
            fg._registry[k] = f
    for o in (jobs, obs):
        o.trace.disable()
        o.prof.set_sample_every(None)
    torch.set_num_threads(n)


def _conf(tmp_path, pkg):
    conf = tmp_path / f"conf_{pkg}.py"
    conf.write_text(
        "import numpy as np\n"
        f"import {pkg} as fluid\n"
        "def build(batch_size=8, hidden=16):\n"
        "    x = fluid.layers.data('x', [4])\n"
        "    y = fluid.layers.data('y', [1], dtype='int32')\n"
        "    h = fluid.layers.fc(x, hidden, act='relu')\n"
        "    pred = fluid.layers.fc(h, 2, act='softmax')\n"
        "    loss = fluid.layers.mean(fluid.layers.cross_entropy(pred, y))\n"
        "    acc = fluid.layers.accuracy(pred, y)\n"
        "    rng = np.random.RandomState(0)\n"
        "    def synthetic_feed():\n"
        "        return {'x': rng.rand(batch_size, 4).astype('float32'),\n"
        "                'y': rng.randint(0, 2, (batch_size, 1)).astype('int32')}\n"
        "    def reader():\n"
        "        for _ in range(3):\n"
        "            b = synthetic_feed()\n"
        "            yield list(zip(b['x'], b['y']))\n"
        "    return {'loss': loss, 'metrics': {'acc': acc}, 'feeds': [x, y],\n"
        "            'synthetic_feed': synthetic_feed, 'reader': reader,\n"
        "            'optimizer': fluid.optimizer.Adam(1e-2)}\n")
    return conf


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_train_runs_a_pass(tmp_path, capsys):
    rc = tcli.main(["train", f"--config={_conf(tmp_path, 'paddle_tpu_torch')}",
                    CPU, "--num_passes=1", f"--save_dir={tmp_path / 'ckpt'}",
                    "--log_period=1"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "cost=" in out and "pass 0" in out and "=== pass 0 done" in out
    assert tfluid.io.CheckpointManager(str(tmp_path / "ckpt")).latest_step() \
        == 3


def test_cli_job_time_emits_the_reference_keys(tmp_path, capsys):
    args = ["--job=time", "--config_args=batch_size=16,hidden=8",
            "--time_steps=3"]
    assert jcli.main(["train", f"--config={_conf(tmp_path, 'paddle_tpu')}",
                      *args]) == 0
    want = _last_json(capsys)
    assert tcli.main(["train", f"--config={_conf(tmp_path, 'paddle_tpu_torch')}",
                      CPU, *args]) == 0
    got = _last_json(capsys)
    assert set(got) == set(want)
    assert got["config_args"] == want["config_args"] == {"batch_size": 16,
                                                         "hidden": 8}
    assert got["examples_per_sec"] > 0 and got["ms_per_batch"] > 0


def test_cli_job_checkgrad(tmp_path, capsys):
    args = ["--job=checkgrad", "--checkgrad_eps=0.005"]
    assert jcli.main(["train", f"--config={_conf(tmp_path, 'paddle_tpu')}",
                      *args]) == 0
    want = _last_json(capsys)
    rc = tcli.main(["train", f"--config={_conf(tmp_path, 'paddle_tpu_torch')}",
                    CPU, *args])
    rec = _last_json(capsys)
    assert rc == 0, rec
    assert set(rec) == set(want)
    assert rec["job"] == "checkgrad" and rec["failures"] == 0
    assert rec["params_checked"] == want["params_checked"] == 4
    assert rec["max_relative_error"] <= 0.02


def test_cli_job_test_evaluates_saved_model(tmp_path, capsys):
    """The port's ``--job=test`` on its own checkpoint, and on one the JAX
    CLI trained: there it prints the JAX CLI's cost and accuracy."""
    tconf = _conf(tmp_path, "paddle_tpu_torch")
    assert tcli.main(["train", f"--config={tconf}", CPU, "--num_passes=1",
                      f"--save_dir={tmp_path}/tout", "--log_period=100"]) == 0
    capsys.readouterr()
    tfluid.reset_default_programs()
    tfluid.reset_global_scope()
    rc = tcli.main(["train", f"--config={tconf}", CPU, "--job=test",
                    f"--init_model_path={tmp_path}/tout/ckpt-3"])
    rec = _last_json(capsys)
    assert rc == 0 and rec["job"] == "test"
    assert np.isfinite(rec["cost"]) and 0 <= rec["acc"] <= 1

    jconf = _conf(tmp_path, "paddle_tpu")
    assert jcli.main(["train", f"--config={jconf}", "--num_passes=1",
                      f"--save_dir={tmp_path}/jout", "--log_period=100"]) == 0
    capsys.readouterr()
    jfluid.reset_default_programs()
    jfluid.reset_global_scope()
    assert jcli.main(["train", f"--config={jconf}", "--job=test",
                      f"--init_model_path={tmp_path}/jout/ckpt-3"]) == 0
    want = _last_json(capsys)
    tfluid.reset_default_programs()
    tfluid.reset_global_scope()
    assert tcli.main(["train", f"--config={tconf}", CPU, "--job=test",
                      f"--init_model_path={tmp_path}/jout/ckpt-3"]) == 0
    got = _last_json(capsys)
    assert set(got) == set(want) == {"job", "config", "cost", "acc"}
    np.testing.assert_allclose(got["cost"], want["cost"], rtol=1e-5)
    assert got["acc"] == want["acc"]
    # without a model the job refuses, as the reference's
    assert tcli.main(["train", f"--config={tconf}", CPU, "--job=test",
                      "--init_model_path="]) == 2


def test_cli_infer_matches_jax(tmp_path, capsys):
    x = jfluid.layers.data("x", [6])
    pred = jfluid.layers.fc(x, 3, act="softmax")
    exe = jfluid.Executor()
    exe.run(jfluid.default_startup_program())
    xs = np.random.RandomState(3).rand(4, 6).astype("float32")
    ref, = exe.run(feed={"x": xs}, fetch_list=[pred])
    jfluid.io.save_inference_model(str(tmp_path / "jm"), ["x"], [pred], exe,
                                   example_batch=4)
    jfluid.io.merge_model(str(tmp_path / "jm"), str(tmp_path / "jm.tar"))
    arrays = {p.name: np.asarray(jfluid.global_scope().find_var(p.name))
              for p in jfluid.default_main_program().parameters()}

    tx = tfluid.layers.data("x", [6])
    tpred = tfluid.layers.fc(tx, 3, act="softmax")
    texe = tfluid.Executor(tfluid.CPUPlace())
    texe.run(tfluid.default_startup_program())
    tfluid.load_scope(arrays, tfluid.default_main_program(),
                      tfluid.global_scope(), device="cpu")
    tfluid.io.save_inference_model(str(tmp_path / "tm"), ["x"], [tpred], texe,
                                   example_batch=4)
    assert tcli.main(["merge_model", f"--model_dir={tmp_path / 'tm'}",
                      f"--output={tmp_path / 'tm.tar'}"]) == 0

    feed = str(tmp_path / "feed.npz")
    np.savez(feed, x=xs)
    assert jcli.main(["infer", f"--model_dir={tmp_path / 'jm.tar'}",
                      f"--feed={feed}", f"--output={tmp_path / 'j.npz'}"]) == 0
    want = np.load(tmp_path / "j.npz")
    for model in ("tm.tar", "tm"):
        out = tmp_path / f"t-{model}.npz"
        assert tcli.main(["infer", CPU, f"--model_dir={tmp_path / model}",
                          f"--feed={feed}", f"--output={out}"]) == 0
        got = np.load(out)
        assert got.files == want.files
        np.testing.assert_allclose(got[got.files[0]], want[want.files[0]],
                                   rtol=1e-5)
        np.testing.assert_allclose(got[got.files[0]], ref, rtol=1e-5)
    # printed heads without --output; a feed file missing a key refuses
    tflags.set_flag("output", "")
    assert tcli.main(["infer", CPU, f"--model_dir={tmp_path / 'tm'}",
                      f"--feed={feed}"]) == 0
    assert "shape=(4, 3)" in capsys.readouterr().out
    np.savez(str(tmp_path / "bad.npz"), y=xs)
    assert tcli.main(["infer", CPU, f"--model_dir={tmp_path / 'tm'}",
                      f"--feed={tmp_path / 'bad.npz'}"]) == 2


def test_dump_config_matches_jax(tmp_path, capsys, monkeypatch):
    # op protos not registered explicitly are inferred from every op a
    # process has built so far; start both packages from their explicit
    # ones, so that the schemas printed come from this config alone
    from paddle_tpu.core import op_info as jop_info
    from paddle_tpu_torch.core import op_info as top_info

    for m in (jop_info, top_info):
        monkeypatch.setattr(m, "_op_info_map", {
            k: p for k, p in m._op_info_map.items() if not p.inferred})
    assert jcli.main(["dump_config",
                      f"--config={_conf(tmp_path, 'paddle_tpu')}"]) == 0
    want = capsys.readouterr().out.splitlines()
    assert tcli.main(["dump_config",
                      f"--config={_conf(tmp_path, 'paddle_tpu_torch')}"]) == 0
    got = capsys.readouterr().out.splitlines()
    assert got[0].startswith("Program(version=")
    assert got[1:] == want[1:]
    assert "== op schemas ==" in got and any(
        ln.startswith("op_proto cross_entropy") for ln in got)


def test_obs_commands_read_the_port_outputs(tmp_path, capsys):
    conf = _conf(tmp_path, "paddle_tpu_torch")
    assert tcli.main(["obs", "snapshot", f"--config={conf}", CPU,
                      "--obs_steps=2"]) == 0
    snap = json.loads(capsys.readouterr().out)
    assert snap["counters"]["train.steps"] == 2
    assert snap["histograms"]["train.step_ms"]["count"] == 2
    assert tcli.main(["obs", "snapshot", "--format=prom"]) == 0
    assert "train_steps" in capsys.readouterr().out

    traces = tmp_path / "traces"
    traces.mkdir()
    tfluid.reset_default_programs()
    tfluid.reset_global_scope()
    assert tcli.main(["obs", "export-trace", f"--config={conf}", CPU,
                      "--obs_steps=2",
                      f"--output={traces / 'trace-a-1.json'}"]) == 0
    rec = _last_json(capsys)
    assert rec["spans"] > 0 and "train.step" in rec["span_names"]
    merged = {}
    for name, c in (("port", tcli), ("jax", jcli)):
        assert c.main(["obs", "trace", "--fleet", f"--trace_dir={traces}",
                       f"--output={tmp_path / (name + '.json')}"]) == 0
        merged[name] = _last_json(capsys)
    for k in ("files", "processes", "spans", "span_names"):
        assert merged["port"][k] == merged["jax"][k]
    assert merged["port"]["spans"] == rec["spans"]

    tfluid.reset_default_programs()
    tfluid.reset_global_scope()
    assert tcli.main(["obs", "hotspots", f"--config={conf}", CPU,
                      "--obs_steps=6"]) == 0
    h = json.loads(capsys.readouterr().out)
    assert h["rows"]
    hot = tmp_path / "hot.json"
    hot.write_text(json.dumps({"hotspots": h}))
    assert tcli.main(["obs", "hotspots", f"--input={hot}",
                      "--format=table", "--top=1"]) == 0
    assert capsys.readouterr().out.strip()
    assert tcli.main(["obs", "hotspots", "--compare", str(hot),
                      f"{hot}:hotspots", "--format=json"]) == 0
    d = json.loads(capsys.readouterr().out)
    assert d["rows"] and all(r["share_delta"] == 0 for r in d["rows"])

    path = obs.recorder.dump("cli_test", extra={"k": 1})
    for name, c in (("port", tcli), ("jax", jcli)):
        assert c.main(["obs", "dump", f"--input={path}"]) == 0
        merged[name] = json.loads(capsys.readouterr().out)
    assert merged["port"] == merged["jax"]
    assert merged["port"]["reason"] == "cli_test"
    tflags.set_flag("input", "")
    assert tcli.main(["obs", "dump"]) == 0
    listing = json.loads(capsys.readouterr().out)
    assert os.path.basename(path) in listing["files"]
    assert tcli.main(["obs"]) == 2 and tcli.main(["obs", "nope"]) == 2


@pytest.mark.parametrize("argv", [
    ["fleet", "serve"], ["fleet", "status", "--port=1"],
    ["obs", "slo", "--port=1"], ["obs", "hotspots", "--port=1"]])
def test_waiting_commands_name_a10(argv):
    with pytest.raises(NotImplementedError, match="A.10"):
        tcli.main(argv)


def test_module_entry_point_exits_nonzero_on_a_waiting_command(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    p = subprocess.run([sys.executable, "-m", "paddle_tpu_torch", "fleet",
                        "serve"], capture_output=True, text=True,
                       timeout=120, cwd=str(tmp_path), env=env)
    assert p.returncode != 0 and "A.10" in p.stderr
    p = subprocess.run([sys.executable, "-m", "paddle_tpu_torch", "version"],
                       capture_output=True, text=True, timeout=120,
                       cwd=str(tmp_path), env=env)
    assert p.returncode == 0 and p.stdout.strip() == jfluid.__version__


def test_usage_and_unknown_commands(capsys):
    assert tcli.main([]) == 2
    assert tcli.main(["nope"]) == 2
    assert tcli.main(["train"]) == 2
    assert tcli.main(["merge_model"]) == 2
    assert tcli.main(["infer"]) == 2
    assert "usage: python -m paddle_tpu_torch" in capsys.readouterr().out


# ------------------------------------------------- net_drawer and plot


def _small_program(fl):
    x = fl.layers.data("x", [4])
    y = fl.layers.data("y", [1], dtype="int32")
    h = fl.layers.fc(x, 8, act="relu")
    fl.layers.mean(fl.layers.softmax_with_cross_entropy(
        fl.layers.fc(h, 2), y))


def test_net_drawer_emits_the_reference_dot(tmp_path):
    _small_program(jfluid)
    _small_program(tfluid)
    dot = tfluid.net_drawer.draw()
    assert dot == jfluid.net_drawer.draw()
    assert dot.startswith("digraph") and dot.rstrip().endswith("}")
    assert "#ffe9b0" in dot and "#e8e8e8" in dot and dot.count("->") >= 8
    path = tmp_path / "g.dot"
    assert tfluid.net_drawer.draw(path=str(path), graph_name="g") == \
        path.read_text()


def test_ploter_csv_equals_the_reference(tmp_path):
    curves = []
    for mod in (tfluid.plot, jfluid.plot):
        pl = mod.Ploter("train_cost", "test_cost")
        for i in range(5):
            pl.append("train_cost", i, 1.0 / (i + 1))
            pl.append("test_cost", i, 2.0 / (i + 1))
        csv = tmp_path / f"{mod.__name__}.csv"
        pl.save_csv(str(csv))
        curves.append(csv.read_bytes())
        assert pl.plot(None) is False
        pl.plot(str(tmp_path / "curve.png"))  # matplotlib or False
        pl.reset()
        assert pl.data["train_cost"].step == []
    assert curves[0] == curves[1]
    lines = curves[0].decode().strip().splitlines()
    assert lines[0] == "title,step,value" and len(lines) == 11
