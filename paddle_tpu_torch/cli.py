"""CLI (PyTorch port of ``paddle_tpu/cli.py``): ``python -m paddle_tpu_torch
train --config=<conf.py> [--job=train|time|checkgrad|test] ...`` (ref:
paddle/scripts/submit_local.sh.in:150-161 ``paddle train`` dispatching to
the paddle_trainer binary with gflags; benchmark harness run.sh --job=time).

The config file is a Python module defining ``build()`` (constructs the
program, returning a dict with 'loss' and optionally 'metrics': {name: var},
'feeds': [vars], 'optimizer', 'reader', 'test_reader', 'synthetic_feed',
'infer_fetch', 'name') — the config_parser/trainer_config analog, except the
config language is the layer DSL itself; a config imports
``paddle_tpu_torch`` where the JAX package's imports ``paddle_tpu``.

Commands: ``train``, ``merge_model``, ``dump_config``, ``infer``, ``obs``
(``snapshot``, ``export-trace``, ``hotspots``, ``trace``, ``dump``) and
``version``, with the reference's flags, exit codes and JSON lines.  They
run on the CUDA card; ``--use_tpu=0`` (the reference's flag) runs them on
the CPU.  ``compile`` (``stats``, ``ls``, ``warmup``, ``clear``) reads
and fills the AOT store and the manifests of a compile dir.  ``fleet`` and
``obs slo`` (and ``obs hotspots --port``, which asks a fleet endpoint)
raise, naming ROADMAP A.10: ``fleet/`` is not ported yet."""
from __future__ import annotations

import importlib.util
import json
import os
import re
import sys
import time

import numpy as np

from . import flags

_A10 = "ROADMAP A.10"


def _place():
    """The CLI's device: the card, or the CPU under ``--use_tpu=0``."""
    from .core import CPUPlace

    return None if flags.get("use_tpu") else CPUPlace()


def _sync(device) -> None:
    """Wait for the card's queued work before a clock is read."""
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)


def _warm(exe, program, feed, fetch, scope=None) -> bool:
    """Prepare ``program``'s signature for ``feed`` (one CUDA graph on the
    card), as the Trainer warms each new step signature; False when the
    program cannot be captured and runs eagerly."""
    from .core.graphs import WarmError
    from .core.types import dtype_name

    block = program.global_block
    sig = [(n, tuple(np.shape(v)), dtype_name(block.vars[n].dtype)
            if n in block.vars else np.asarray(v).dtype.name)
           for n, v in feed.items()]
    try:
        exe.warm(program, sig, [getattr(f, "name", f) for f in fetch],
                 scope=scope)
        return True
    except WarmError:
        return False


def _load_config(path: str):
    spec = importlib.util.spec_from_file_location("paddle_tpu_torch_user_config",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _parse_config_args(s: str):
    """``k=v,k2=v2`` -> kwargs dict with int/float/bool coercion (the
    reference's --config_args contract, benchmark run.sh:7)."""
    out = {}
    for kv in filter(None, s.split(",")):
        k, _, v = kv.partition("=")
        if v.lower() in ("true", "false"):
            out[k] = v.lower() == "true"
        else:
            try:
                out[k] = int(v)
            except ValueError:
                try:
                    out[k] = float(v)
                except ValueError:
                    out[k] = v
    return out


def cmd_train(argv):
    flags.define("config", "", "model config .py") if "config" not in flags._registry else None
    rest = flags.parse_args(argv)
    cfg_path = flags.get("config") or (rest[0] if rest else None)
    if not cfg_path:
        print("usage: python -m paddle_tpu_torch train --config=<conf.py> "
              "[--job=train|time|checkgrad|test]")
        return 2

    import paddle_tpu_torch as fluid
    from .core.executor import _to_numpy

    cfg = _load_config(cfg_path)
    cfg_kwargs = _parse_config_args(flags.get("config_args"))
    spec = cfg.build(**cfg_kwargs)
    job = flags.get("job") if "job" in flags._registry else "train"

    if job == "time":
        # --job=time: synthetic throughput timing (benchmark run.sh analog).
        # Training configs time the fwd+bwd+update step on 'loss'; a config
        # returning 'infer_fetch' times pure inference/decode instead.  The
        # signature is warmed first, so each timed run is a replay (one CUDA
        # graph on the card); the card is synchronized before every clock
        # read.
        exe = fluid.Executor(_place())
        fetch = spec.get("infer_fetch")
        if fetch is None:
            optimizer = spec.get("optimizer") or fluid.optimizer.Adam(1e-3)
            optimizer.minimize(spec["loss"])
            fetch = [spec["loss"]]
        program = fluid.default_main_program()
        if spec.get("infer_fetch") is not None:
            program = program.prune(fetch)

        feed = {k: np.asarray(v) for k, v in spec["synthetic_feed"]().items()}
        exe.run(fluid.default_startup_program())
        _sync(exe.device)
        t0 = time.perf_counter()
        _warm(exe, program, feed, fetch)
        exe.run(program, feed=feed, fetch_list=fetch)
        _sync(exe.device)
        compile_s = time.perf_counter() - t0
        for _ in range(2):
            exe.run(program, feed=feed, fetch_list=fetch)
        n = int(flags.get("time_steps")) if "time_steps" in flags._registry else 20
        _sync(exe.device)
        t0 = time.perf_counter()
        for _ in range(n):
            exe.run(program, feed=feed, fetch_list=fetch, return_numpy=False)
        _sync(exe.device)
        dt = (time.perf_counter() - t0) / n
        bs = next(iter(feed.values())).shape[0]
        print(json.dumps({"config": spec.get("name", cfg_path),
                          "config_args": cfg_kwargs,
                          "ms_per_batch": round(dt * 1e3, 2),
                          "examples_per_sec": round(bs / dt, 1),
                          "compile_s": round(compile_s, 1)}))
        return 0

    if job == "checkgrad":
        # numeric-vs-analytic gradient check over the config's loss (the
        # reference trainer's --job=checkgrad, Trainer.cpp; same central-
        # difference methodology as its getNumericGradient)
        eps = float(flags.get("checkgrad_eps"))
        loss = spec["loss"]
        # forward-only program for the numeric evaluations (before the
        # backward ops exist) — each central-difference probe must not pay bwd
        fwd_prog = fluid.default_main_program().prune([loss])
        grads = fluid.backward.append_backward(loss)
        exe = fluid.Executor(_place())
        exe.run(fluid.default_startup_program())
        scope = fluid.global_scope()
        feed = spec["synthetic_feed"]()

        def run_loss():
            scope.step_counter = 0
            out, = exe.run(fwd_prog, feed=feed, fetch_list=[loss])
            return float(np.sum(out))

        def put(name, arr, like):
            import torch

            scope.set_var(name, torch.from_numpy(np.ascontiguousarray(arr))
                          .to(device=like.device, dtype=like.dtype))

        snapshot = {n: v.clone() for n, v in scope.items()}
        scope.step_counter = 0
        outs = exe.run(feed=feed, fetch_list=[loss] + [g for _, g in grads])
        analytic = {p.name: g for (p, _), g in zip(grads, outs[1:])}
        for n, v in snapshot.items():
            scope.set_var(n, v.clone())

        rng = np.random.RandomState(int(flags.get("seed")) or 0)
        l0 = run_loss()  # unperturbed loss, shared by every kink probe
        worst = (0.0, None)
        failures = 0
        kinks_skipped = 0
        for (p, _), _g in zip(grads, outs[1:]):
            like = scope.find_var(p.name)
            base = _to_numpy(like).copy()
            for fi in rng.choice(base.size, size=min(4, base.size), replace=False):
                idx = np.unravel_index(fi, base.shape)
                pert = base.copy()
                pert[idx] = base[idx] + eps
                put(p.name, pert, like)
                lp = run_loss()
                pert[idx] = base[idx] - eps
                put(p.name, pert, like)
                lm = run_loss()
                put(p.name, base, like)
                numeric = (lp - lm) / (2 * eps)
                # central difference is only valid where the loss is locally
                # smooth: when the ±eps probes straddle a kink (a relu whose
                # pre-activation sits within eps of 0), the two one-sided
                # differences disagree by O(1) — not evidence about the
                # analytic gradient either way, so skip that index (standard
                # gradcheck practice; smooth-point disagreement stays at the
                # f32 noise floor, far under this threshold)
                dplus = (lp - l0) / eps
                dminus = (l0 - lm) / eps
                if (abs(dplus - dminus)
                        / max(abs(dplus), abs(dminus), 1e-3)) > 0.05:
                    kinks_skipped += 1
                    continue
                a = float(np.asarray(analytic[p.name])[idx])
                rel = abs(numeric - a) / max(abs(numeric), abs(a), 1e-3)
                if rel > worst[0]:
                    worst = (rel, f"{p.name}{list(idx)}")
                if rel > 0.02:  # f32 central-difference noise floor
                    failures += 1
        print(json.dumps({"job": "checkgrad", "config": spec.get("name", cfg_path),
                          "params_checked": len(grads), "eps": eps,
                          "max_relative_error": round(worst[0], 6),
                          "worst_at": worst[1], "failures": failures,
                          "kinks_skipped": kinks_skipped}))
        return 1 if failures else 0

    if job == "test":
        # eval-only pass over the config's test_reader/reader (the reference's
        # Tester job, Tester.cpp): forward-only pruned program, no optimizer
        # graph/state — and a model to load is mandatory (evaluating random
        # init would produce a plausible-looking but meaningless report)
        if not flags.get("init_model_path"):
            print("--job=test requires --init_model_path=<saved persistables dir>")
            return 2
        reader = spec.get("test_reader") or spec.get("reader")
        if reader is None:
            print("--job=test needs a 'test_reader' or 'reader' in the config")
            return 2
        from .data_feeder import DataFeeder

        fetch = {"cost": spec["loss"], **(spec.get("metrics") or {})}
        prog = fluid.default_main_program().prune(list(fetch.values()))
        exe = fluid.Executor(_place())
        exe.run(fluid.default_startup_program())
        fluid.io.load_persistables(exe, flags.get("init_model_path"))
        feeder = DataFeeder(spec.get("feeds", []))
        keys = list(fetch)
        sums = {k: 0.0 for k in keys}
        n = 0
        for batch in reader():
            outs = exe.run(prog, feed=feeder.feed(batch),
                           fetch_list=[fetch[k] for k in keys])
            for k, v in zip(keys, outs):
                sums[k] += float(np.asarray(v).ravel()[0])
            n += 1
        res = {k: sums[k] / max(n, 1) for k in keys}
        print(json.dumps({"job": "test", "config": spec.get("name", cfg_path),
                          **{k: round(v, 6) for k, v in res.items()}}))
        return 0

    loss = spec["loss"]
    optimizer = spec.get("optimizer") or fluid.optimizer.Adam(1e-3)

    from .trainer import Trainer

    if flags.get("comment"):
        print(f"# {flags.get('comment')}")
    trainer = Trainer(
        loss, optimizer, spec.get("feeds", []),
        extra_fetch=spec.get("metrics"),
        checkpoint_dir=flags.get("save_dir"),
        checkpoint_every_n_steps=flags.get("saving_period_by_batches"),
        place=_place(),
    )

    if flags.get("init_model_path"):
        # warm-start from saved persistables (Trainer.cpp init_model_path)
        trainer.exe.run(fluid.default_startup_program())
        fluid.io.load_persistables(trainer.exe, flags.get("init_model_path"))

    log_period = flags.get("log_period")
    dot_period = flags.get("dot_period")
    test_period = flags.get("test_period")
    stats_period = flags.get("show_parameter_stats_period")
    test_reader = spec.get("test_reader")

    def handler(ev):
        from . import events

        if isinstance(ev, events.EndIteration):
            if ev.batch_id % log_period == 0:
                ms = ", ".join(f"{k}={v:.4f}" for k, v in ev.metrics.items())
                print(f"pass {ev.pass_id} batch {ev.batch_id} cost={ev.cost:.5f} {ms}")
            elif dot_period and ev.batch_id % dot_period == 0:
                print(".", end="", flush=True)
            if test_reader and test_period and ev.batch_id and \
                    ev.batch_id % test_period == 0:
                print(f"test @{ev.batch_id}: {trainer.test(test_reader)}")
            if stats_period and ev.batch_id and ev.batch_id % stats_period == 0:
                scope = fluid.global_scope()
                for p in trainer.program.parameters():
                    v = _to_numpy(scope.find_var(p.name))
                    print(f"  param {p.name}: mean={v.mean():.3e} "
                          f"absmax={np.abs(v).max():.3e}")
        elif isinstance(ev, events.EndPass):
            print(f"=== pass {ev.pass_id} done: {ev.metrics}")
            if test_reader and not test_period:
                print(f"test pass {ev.pass_id}: {trainer.test(test_reader)}")

    trainer.train(spec["reader"], num_passes=flags.get("num_passes"),
                  event_handler=handler)
    return 0


def cmd_merge_model(argv):
    """Pack a save_inference_model directory into one deployable file
    (ref: ``paddle merge_model`` — merges config proto + params for serving)."""
    flags.define("model_dir", "", "merge_model --model_dir")
    flags.define("output", "", "merge_model --output")
    rest = flags.parse_args(argv)
    model_dir = flags.get("model_dir") or (rest[0] if rest else None)
    output = flags.get("output") or (rest[1] if len(rest) > 1 else None)
    if not model_dir or not output:
        print("usage: python -m paddle_tpu_torch merge_model --model_dir=<dir> "
              "--output=<file>")
        return 2
    from . import io

    io.merge_model(model_dir, output)
    print(f"merged {model_dir} -> {output}")
    return 0


def cmd_dump_config(argv):
    """Build a config and print the program IR (ref: ``paddle dump_config`` —
    prints the ModelConfig proto the config parser emits)."""
    flags.define("config", "", "model config .py")
    rest = flags.parse_args(argv)
    cfg_path = flags.get("config") or (rest[0] if rest else None)
    if not cfg_path:
        print("usage: python -m paddle_tpu_torch dump_config --config=<conf.py>")
        return 2
    import paddle_tpu_torch as fluid

    cfg = _load_config(cfg_path)
    cfg.build()
    prog = fluid.default_main_program()
    print(prog.to_string())
    # the OpProto schemas of every op type the config used (ref: dump_config
    # prints the full ModelConfig proto; registry.py:82 OpProto introspection)
    from .core import op_info

    used = sorted({op.type for op in prog.global_block.ops})
    print("\n== op schemas ==")
    for t in used:
        p = op_info.get(t)
        if p is not None:
            print(p.to_string())
    return 0


def cmd_infer(argv):
    """Run an exported inference model over a feed file (ref: ``paddle.infer``,
    python/paddle/v2/inference.py:85,111, and the C-API forward examples).

    --model_dir: save_inference_model output (or a merge_model file);
    --feed: .npz whose keys are the model's feed names; --output: .npz to
    write fetches into (default: print shapes/heads to stdout)."""
    flags.define("model_dir", "", "inference model dir or merged .tar file")
    flags.define("feed", "", "input .npz keyed by feed names")
    flags.define("output", "", "output .npz (optional)")
    rest = flags.parse_args(argv)
    model_dir = flags.get("model_dir") or (rest[0] if rest else None)
    feed_path = flags.get("feed") or (rest[1] if len(rest) > 1 else None)
    if not model_dir or not feed_path:
        print("usage: python -m paddle_tpu_torch infer --model_dir=<dir|merged> "
              "--feed=<in.npz> [--output=<out.npz>]")
        return 2
    from . import io
    from .core import Executor

    exe = Executor(_place())
    if os.path.isdir(model_dir):
        infer, feed_names, fetch_names = io.load_inference_model(model_dir, exe)
    else:
        infer, feed_names, fetch_names = io.load_merged_model(model_dir, exe)
    data = dict(np.load(feed_path))
    missing = [n for n in feed_names if n not in data]
    if missing:
        print(f"feed file {feed_path} is missing keys {missing} "
              f"(model feeds: {feed_names})")
        return 2
    outs = infer({n: data[n] for n in feed_names})
    out_path = flags.get("output")
    if out_path:
        np.savez(out_path, **{n: o for n, o in zip(fetch_names, outs)})
        print(f"wrote {out_path}")
    else:
        for n, o in zip(fetch_names, outs):
            flat = np.asarray(o).ravel()
            print(f"{n}: shape={tuple(np.asarray(o).shape)} "
                  f"head={np.array2string(flat[:8], precision=4)}")
    return 0


def _obs_short_run(cfg_path: str, steps: int):
    """Run ``steps`` training batches of a config — the workload behind
    ``obs snapshot --config`` and ``obs export-trace`` (a trace of an empty
    process would be an empty trace)."""
    import paddle_tpu_torch as fluid

    from .trainer import Trainer

    cfg = _load_config(cfg_path)
    spec = cfg.build(**_parse_config_args(flags.get("config_args")))
    optimizer = spec.get("optimizer") or fluid.optimizer.Adam(1e-3)
    trainer = Trainer(spec["loss"], optimizer, spec.get("feeds", []),
                      extra_fetch=spec.get("metrics"), place=_place())
    reader = spec["reader"]

    def capped():
        for i, batch in enumerate(reader()):
            if i >= steps:
                return
            yield batch

    trainer.train(capped, num_passes=1)


def _load_hotspots_file(spec: str):
    """Resolve one ``--compare`` operand to a hotspots object.

    ``spec`` is ``<path>`` or ``<path>:<dotted.key>`` — the dotted selector
    digs into a committed bench log (e.g. ``paged_attention_ab.json:
    arms.composed_fp32.hotspots``).  A literal path wins over the split, so
    exotic filenames containing ':' still load.  After the dig, accepts
    either a bare hotspots object (has "rows") or a dict carrying a
    "hotspots" block.  Returns None when no rows survive."""
    path, key = spec, ""
    if not os.path.exists(path) and ":" in spec:
        path, key = spec.rsplit(":", 1)
    with open(path) as f:
        data = json.load(f)
    for part in [p for p in key.split(".") if p]:
        if not isinstance(data, dict):
            return None
        data = data.get(part)
    if not isinstance(data, dict):
        return None
    if isinstance(data.get("hotspots"), dict):
        data = data["hotspots"]
    return data if isinstance(data.get("rows"), list) else None


def cmd_obs(argv):
    """Observability verb (DESIGN.md §13, §16):

      obs snapshot      [--config=<conf.py> [--obs_steps=N]] [--format=prom]
                        metrics snapshot (JSON, or Prometheus exposition with
                        --format=prom), optionally after a short training run
      obs export-trace  --config=<conf.py> [--obs_steps=N] [--output=trace.json]
                        trace a short training run, write Chrome trace-event
                        JSON (load in Perfetto / chrome://tracing)
      obs hotspots      [--input=<file> | --port=P [--host=H] |
                         --config=<conf.py> [--obs_steps=N] |
                         --compare A B]
                        [--format=json|table] [--top=N]
                        the device-time attribution report (DESIGN.md §23):
                        executables ranked by measured time share, joined
                        with cost-ledger flops/byte intensity and classified
                        memory- vs compute-bound — the measured kernel
                        target list.  --input reads any JSON carrying a
                        "hotspots" block (or a bare hotspots object);
                        --port asks a running fleet worker/front's healthz
                        and raises until fleet/ is ported (ROADMAP A.10);
                        --config samples a short
                        local training run.  --compare takes TWO such files
                        (each optionally <path>:<dotted.key> to dig into a
                        bench log, e.g. paged_attention_ab.json:
                        arms.composed_fp32.hotspots) and prints the
                        per-signature time-share delta B - A — the
                        before/after story of a kernel swap (DESIGN.md §24)
      obs slo           --port=P [--host=H] [--format=json|table]
                        per-priority-class SLO decomposition from a running
                        fleet front (or worker): p50/p99 end-to-end plus the
                        per-hop component table — where the tail went
                        (json is the default, like every obs verb; table is
                        the human rendering) — raises until fleet/ and
                        fleet/slo.py are ported (ROADMAP A.10)
      obs trace         --fleet --trace_dir=<dir> [--output=merged.json]
                        [--trace_id=<hex>]
                        stitch the per-process trace files a traced fleet
                        wrote (PADDLE_TPU_TRACE_DIR) into ONE merged
                        Chrome trace Perfetto shows as a multi-process
                        request timeline; --trace_id keeps one request
      obs dump          [--input=<postmortem.json>]
                        summarize a flight-recorder postmortem, or list the
                        postmortem dir when no --input is given
    """
    from . import obs

    if not argv:
        print(cmd_obs.__doc__)
        return 2
    for name, default, help_ in (("obs_steps", 8, "training batches for obs runs"),
                                 ("format", "json", "snapshot format: json | prom"),
                                 ("output", "", "obs export-trace output path"),
                                 ("input", "", "obs dump postmortem file"),
                                 ("port", 0, "obs slo: fleet front port"),
                                 ("host", "127.0.0.1", "obs slo: front host"),
                                 ("fleet", False, "obs trace: merge a fleet trace dir"),
                                 ("trace_dir", "", "obs trace: per-process trace file dir"),
                                 ("trace_id", "", "obs trace: keep one request only"),
                                 ("top", 0, "obs hotspots: keep the top N rows only")):
        # define unconditionally (the reference's cmd_fleet does the same): another verb's
        # stale default — e.g. the coordinator's port=20134 — must not leak
        flags.define(name, default, help_)
    sub = argv[0]
    rest = list(argv[1:])
    # `obs hotspots --compare A B` takes two BARE operands (paths, not
    # --key=value) — lift them out before the flags parser sees them
    cmp_paths = None
    if "--compare" in rest:
        i = rest.index("--compare")
        cmp_paths = [a for a in rest[i + 1:i + 3] if not a.startswith("--")]
        rest = rest[:i] + rest[i + 1 + len(cmp_paths):]
        if sub != "hotspots" or len(cmp_paths) != 2:
            print("usage: python -m paddle_tpu_torch obs hotspots --compare "
                  "<A.json[:dotted.key]> <B.json[:dotted.key]> "
                  "[--format=json|table] [--top=N]")
            return 2
    # bare boolean switch: `obs trace --fleet` (no =value)
    flags.parse_args(["--fleet=1" if a == "--fleet" else a
                      for a in rest])
    steps = int(flags.get("obs_steps"))

    if sub == "snapshot":
        if flags.get("config"):
            _obs_short_run(flags.get("config"), steps)
        if flags.get("format") == "prom":
            print(obs.metrics.prometheus(), end="")
        else:
            print(json.dumps(obs.metrics.snapshot(), indent=1))
        return 0

    if sub == "export-trace":
        if not flags.get("config"):
            print("usage: python -m paddle_tpu_torch obs export-trace --config=<conf.py> "
                  "[--obs_steps=N] [--output=trace.json]")
            return 2
        out = flags.get("output") or "trace.json"
        obs.trace.enable()
        _obs_short_run(flags.get("config"), steps)
        obs.trace.export(out)
        evs = obs.trace.events()
        names = sorted({e["name"] for e in evs})
        print(json.dumps({"trace": out, "spans": len(evs),
                          "span_names": names,
                          "dropped": obs.trace.dropped()}))
        return 0

    if sub == "hotspots":
        # the report joins SAMPLED dispatch timing with the cost ledger —
        # three sources for the same shape: a committed bench log (the
        # mechanically reproducible ROADMAP target list), a live process's
        # healthz fold, or a short sampled training run in this process
        fmt = flags.get("format")
        if fmt not in ("json", "table"):
            print("usage: python -m paddle_tpu_torch obs hotspots [--input=<file> "
                  "| --port=P [--host=H] | --config=<conf.py> "
                  "| --compare A B] [--format=json|table] [--top=N]")
            return 2
        if cmp_paths:
            from .obs.prof import compare_hotspots, render_hotspots_compare

            pair = []
            for spec in cmp_paths:
                snap = _load_hotspots_file(spec)
                if snap is None:
                    print(json.dumps({"error": "no hotspot rows in "
                                      f"{spec} (want a hotspots object or "
                                      "a JSON with a 'hotspots' block; use "
                                      "path:dotted.key to select inside a "
                                      "bench log)"}))
                    return 1
                pair.append(snap)
            d = compare_hotspots(*pair)
            top = int(flags.get("top") or 0)
            if top:
                d = {**d, "rows": d["rows"][:top]}
            if fmt == "table":
                print(render_hotspots_compare(d))
            else:
                print(json.dumps(d, indent=1))
            return 0
        h = None
        if flags.get("input"):
            with open(flags.get("input")) as f:
                data = json.load(f)
            if not isinstance(data, dict):
                data = {}  # non-object JSON: the clean no-rows error below
            if isinstance(data.get("hotspots"), dict):
                h = data["hotspots"]
            elif isinstance(data.get("rows"), list):
                h = data  # a bare hotspots object
        elif int(flags.get("port")):
            # the reference asks a fleet endpoint's healthz through
            # fleet.FleetClient
            raise NotImplementedError(
                f"obs hotspots --port needs fleet/ (FleetClient), which is "
                f"not ported yet ({_A10})")
        elif flags.get("config"):
            # dense sampling for a short run — but every=2, not 1: at 1 the
            # first call (which carries the live jit COMPILE) is sampled
            # and its seconds-long wall would swamp every real step mean
            obs.prof.set_sample_every(2)
            _obs_short_run(flags.get("config"), steps)
            h = obs.prof.hotspots()
        else:
            print("obs hotspots: need one of --input / --port / --config")
            return 2
        if not isinstance(h, dict) or not h.get("rows"):
            print(json.dumps({"error": "no hotspot rows in this source "
                              "(was sampling on? PADDLE_TPU_PROF_SAMPLE)"}))
            return 1
        top = int(flags.get("top") or 0)
        if top:
            h = {**h, "rows": h["rows"][:top]}
        if fmt == "table":
            print(obs.prof.render_hotspots(h))
        else:
            print(json.dumps(h, indent=1))
        return 0

    if sub == "slo":
        # the reference reads the decomposition from a fleet front's
        # healthz (fleet.FleetClient, fleet/slo.py)
        raise NotImplementedError(
            f"obs slo needs fleet/ and fleet/slo.py, which are not ported "
            f"yet ({_A10})")

    if sub == "trace":
        if not flags.get("fleet") or not flags.get("trace_dir"):
            print("usage: python -m paddle_tpu_torch obs trace --fleet "
                  "--trace_dir=<dir> [--output=merged.json] "
                  "[--trace_id=<hex>]")
            return 2
        import glob as _glob

        d = flags.get("trace_dir")
        paths = sorted(_glob.glob(os.path.join(d, "trace-*.json")))
        if not paths:
            print(json.dumps({"error": f"no trace-*.json files in {d}"}))
            return 1
        merged = obs.trace.merge_chrome_traces(
            paths, trace_id=flags.get("trace_id") or None)
        out = flags.get("output") or os.path.join(d, "merged.json")
        with open(out, "w") as f:
            json.dump(merged, f)
        evs = [e for e in merged["traceEvents"] if e.get("ph") == "X"]
        tids = sorted({(e.get("args") or {}).get("trace_id") for e in evs
                       if (e.get("args") or {}).get("trace_id")})
        print(json.dumps({
            "merged": out, "files": merged["mergedFrom"],
            "processes": len({e.get("pid") for e in evs}),
            "spans": len(evs),
            "span_names": sorted({e["name"] for e in evs}),
            "trace_ids": len(tids),
            "trace_id_head": tids[:4],
        }))
        return 0

    if sub == "dump":
        path = flags.get("input")
        if not path:
            d = obs.recorder.postmortem_dir()
            files = sorted(os.listdir(d)) if os.path.isdir(d) else []
            print(json.dumps({"postmortem_dir": d, "files": files}, indent=1))
            return 0
        with open(path) as f:
            pm = json.load(f)
        steps_rec = [r for r in pm.get("records", []) if r.get("kind") == "step"]
        events = [r for r in pm.get("records", []) if r.get("kind") != "step"]
        print(json.dumps({
            "schema": pm.get("schema"), "reason": pm.get("reason"),
            "time": pm.get("time_iso"), "pid": pm.get("pid"),
            "host": pm.get("host"), "restarts": pm.get("restarts"),
            "step_records": len(steps_rec),
            "last_step": steps_rec[-1] if steps_rec else None,
            "events": events,
            # faulthandler heads the dumping thread "Current thread 0x..."
            # and the rest "Thread 0x..." — count both
            "threads": len(re.findall(r"(?i)\bthread 0x",
                                      pm.get("threads", ""))),
            "counters": pm.get("metrics", {}).get("counters", {}),
        }, indent=1, default=str))
        return 0

    print(f"unknown obs subcommand {sub!r}")
    return 2


def cmd_compile(argv):
    """The compile-subsystem verb (the reference's, ``paddle_tpu/cli.py``):

      compile stats   [--compile_dir=<dir>]
                      the AOT store's totals, the manifests' entry counts
                      and this process's compile health
      compile ls      [--compile_dir=<dir>]
                      one line per store entry: fingerprint, layers, sizes,
                      torch version, label; quarantined entries flagged
      compile warmup  --config=<conf.py> [--compile_dir=<dir>]
                      warm every train-step signature of the manifest for
                      the config through the store (what Trainer.prepare()
                      does at boot), writing it for the next generation
      compile clear   [--compile_dir=<dir>] [--keep_quarantined=true]
                      drop store entries (and the manifests)

    ``--compile_dir`` defaults to $PADDLE_TPU_COMPILE_DIR (the supervisor
    forwarding); stats, ls and clear need one of the two."""
    from . import compile as _compile

    if not argv:
        print(cmd_compile.__doc__)
        return 2
    for name, default, help_ in (
            ("compile_dir", "", "AOT store + manifest dir"),
            ("keep_quarantined", False, "compile clear: keep *.corrupt dirs")):
        if name not in flags._registry:
            flags.define(name, default, help_)
    sub = argv[0]
    flags.parse_args(argv[1:])
    cdir = flags.get("compile_dir") or _compile.default_compile_dir()

    if sub == "warmup":
        if not flags.get("config"):
            print("usage: python -m paddle_tpu_torch compile warmup "
                  "--config=<conf.py> [--compile_dir=<dir>]")
            return 2
        import paddle_tpu_torch as fluid

        from .trainer import Trainer

        cfg = _load_config(flags.get("config"))
        spec = cfg.build(**_parse_config_args(flags.get("config_args")))
        optimizer = spec.get("optimizer") or fluid.optimizer.Adam(1e-3)
        trainer = Trainer(spec["loss"], optimizer, spec.get("feeds", []),
                          extra_fetch=spec.get("metrics"), compile_dir=cdir,
                          place=_place())
        trainer.exe.run(fluid.default_startup_program())
        t0 = time.perf_counter()
        wu = trainer.prepare(wait=True)
        print(json.dumps({
            "compile_dir": trainer.compile_dir,
            "manifest_entries": len(trainer.manifest),
            "warmup_s": round(time.perf_counter() - t0, 3),
            "tasks": wu.status() if wu else {},
            "store": trainer.aot_store.stats() if trainer.aot_store
            else None}, indent=1, default=str))
        return 0

    if not cdir:
        print(f"compile {sub}: no --compile_dir and $PADDLE_TPU_COMPILE_DIR "
              f"is unset")
        return 2
    store = _compile.AOTStore(os.path.join(cdir, "aot"))

    if sub == "stats":
        manifests = {}
        for mname in ("manifest.json", "serving_manifest.json"):
            p = os.path.join(cdir, mname)
            if os.path.exists(p):
                m = _compile.ShapeManifest.load(p)
                manifests[mname] = {"entries": len(m),
                                    "buckets": m.buckets() or None}
        print(json.dumps({"compile_dir": cdir, "store": store.stats(),
                          "manifests": manifests,
                          "health": _compile.health()}, indent=1))
        return 0

    if sub == "ls":
        for e in store.entries():
            layers = ", ".join(
                f"{k}:{v.get('bytes')}B torch={v.get('torch')}"
                + (f" [{v['label']}]" if v.get("label") else "")
                for k, v in e["layers"].items()) or "(no layers)"
            flag = " CORRUPT" if e["corrupt"] else ""
            print(f"{e['fingerprint'][:16]}…{flag}  {layers}")
        print(f"# {len(store.entries())} entr(ies) in {store.dirname}")
        return 0

    if sub == "clear":
        n = store.clear(include_quarantined=not flags.get("keep_quarantined"))
        removed = []
        for mname in ("manifest.json", "serving_manifest.json"):
            p = os.path.join(cdir, mname)
            if os.path.exists(p):
                os.remove(p)
                removed.append(mname)
        print(json.dumps({"cleared_entries": n, "removed_manifests": removed}))
        return 0

    print(f"unknown compile subcommand {sub!r}")
    return 2


def cmd_fleet(argv):
    """The reference's serving-fleet verb (``serve``, ``status``)."""
    raise NotImplementedError(
        f"fleet: fleet/ is not ported yet ({_A10})")


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    flags.define("job", "train", "train | time")
    flags.define("config", "", "model config .py")
    flags.define("config_args", "", "k=v,k2=v2 kwargs forwarded to the config's build()")
    flags.define("time_steps", 20, "timed steps for --job=time")
    if not argv:
        print("usage: python -m paddle_tpu_torch <train|infer|merge_model|"
              "dump_config|obs|compile|fleet|version> [--flags]")
        return 2
    cmd, rest = argv[0], argv[1:]
    if cmd == "compile":
        return cmd_compile(rest)
    if cmd == "fleet":
        return cmd_fleet(rest)
    if cmd == "train":
        return cmd_train(rest)
    if cmd == "merge_model":
        return cmd_merge_model(rest)
    if cmd == "infer":
        return cmd_infer(rest)
    if cmd == "dump_config":
        return cmd_dump_config(rest)
    if cmd == "obs":
        return cmd_obs(rest)
    if cmd == "version":
        import paddle_tpu_torch

        print(paddle_tpu_torch.__version__)
        return 0
    print(f"unknown command {cmd!r}")
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
