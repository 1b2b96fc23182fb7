#!/usr/bin/env python
"""Bounded-restart trainer supervisor as a command (the port's counterpart
of ``scripts/supervise.py``: ``paddle_tpu_torch/supervisor.py`` as a CLI).

    # one child, restart on preemption/hang/crash up to 5 crash restarts:
    python -m paddle_tpu_torch.tools.supervise -- \
        python -m paddle_tpu_torch train --config=conf.py

    # a 2-process local gang, fresh coordinator per generation:
    python paddle_tpu_torch/tools/supervise.py --nproc 2 --log-dir /tmp/sup \
        -- python my_train.py

Exit codes: 0 when the gang finished; the child's crash code when
max_restarts is exhausted; EXIT_PREEMPTED (75) when the supervisor itself
was told to stop (SIGTERM/SIGINT are forwarded to the children first).

The supervisor stays torch-free: ``supervisor.py`` is file-loaded, so the
parent never imports the package (the children own the card: a parent that
initialised CUDA would hold a context on it for every generation).
``python -m paddle_tpu_torch.tools.supervise`` imports the package, and so
torch, before this module runs; that form re-executes this file as a plain
script first, so both forms leave torch out of the supervising process.
"""
from __future__ import annotations

import argparse
import importlib.util
import os
import sys


def _load_supervisor_module():
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "supervisor.py")
    spec = importlib.util.spec_from_file_location("_paddle_tpu_torch_supervisor", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules["_paddle_tpu_torch_supervisor"] = mod
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nproc", type=int, default=1,
                    help="gang size: run N copies with fresh distributed "
                         "identity env each generation (1 = plain child)")
    ap.add_argument("--max-restarts", type=int, default=5,
                    help="budgeted crash/hang restarts before giving up")
    ap.add_argument("--max-preemptions", type=int, default=64,
                    help="preemption restarts are unbudgeted but finite")
    ap.add_argument("--gang-grace-s", type=float, default=15.0,
                    help="SIGTERM→SIGKILL escalation window at gang teardown")
    ap.add_argument("--compile-dir", default="",
                    help="compile dir (AOT store + manifest), forwarded to "
                         "every generation as PADDLE_TPU_COMPILE_DIR, from "
                         "which a port child's Trainer warm-starts")
    ap.add_argument("--log-dir", default="",
                    help="capture per-child stdout to gen<G>-r<I>.log files")
    ap.add_argument("cmd", nargs=argparse.REMAINDER,
                    help="-- command to supervise")
    args = ap.parse_args(argv)
    cmd = [c for c in args.cmd if c != "--"]
    if not cmd:
        ap.error("pass the training command after --")

    sup = _load_supervisor_module()
    # a local gang's members choose their devices themselves (the port's
    # entry points take the card unless told otherwise); each generation
    # gets its identity env from the Supervisor
    return sup.Supervisor([list(cmd)] * max(args.nproc, 1),
                          max_restarts=args.max_restarts,
                          max_preemptions=args.max_preemptions,
                          gang_grace_s=args.gang_grace_s,
                          compile_dir=args.compile_dir or None,
                          log_dir=args.log_dir or None).run()


if __name__ == "__main__":
    if "torch" in sys.modules:  # run by ``python -m``: start over as a script
        os.execv(sys.executable, [sys.executable, os.path.abspath(__file__),
                                  *sys.argv[1:]])
    sys.exit(main())
