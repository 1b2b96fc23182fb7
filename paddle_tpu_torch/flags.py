"""Typed process-level flags (PyTorch port of ``paddle_tpu/flags.py``; ref:
paddle/utils/Flags.cpp:18-81: use_gpu, trainer_count, port, trainer_id,
num_gradient_servers, beam_size, log_period...).

One typed registry, settable from the environment (``PADDLE_TPU_<NAME>``)
or the command line (``--name=value``), in place of gflags: the JAX
package's names, types and defaults.  Two flags have consumers in the
port, as in the reference: ``seed`` (the Executor's step seed of a program
whose ``random_seed`` is 0) and ``log_clipping`` (global-norm clipping
prints when it rescales).  The others are kept for configuration
compatibility."""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Callable, Dict


@dataclass
class _Flag:
    name: str
    default: Any
    help: str
    type: Callable
    value: Any = None


_registry: Dict[str, _Flag] = {}


def define(name: str, default, help: str = ""):
    t = type(default) if default is not None else str
    if t is bool:
        def conv(v):
            return v if isinstance(v, bool) else str(v).lower() in (
                "1", "true", "yes")
    else:
        conv = t
    _registry[name] = _Flag(name, default, help, conv)


def get(name: str):
    f = _registry[name]
    if f.value is not None:
        return f.value
    env = os.environ.get(f"PADDLE_TPU_{name.upper()}")
    if env is not None:
        return f.type(env)
    return f.default


def set_flag(name: str, value):
    f = _registry[name]
    f.value = f.type(value)


def parse_args(argv):
    """Consume ``--name=value`` tokens; returns the rest."""
    rest = []
    for a in argv:
        if a.startswith("--") and "=" in a:
            k, v = a[2:].split("=", 1)
            k = k.replace("-", "_")
            if k in _registry:
                set_flag(k, v)
                continue
        rest.append(a)
    return rest


def all_flags() -> Dict[str, Any]:
    return {k: get(k) for k in _registry}


# ---- the reference's flag set (Flags.cpp:18-81 + Trainer.cpp:40-89).
# Device/backend (use_gpu family):
define("use_tpu", True, "run on the accelerator (use_gpu analog; the port's "
       "entry points take the CUDA card unless given the CPU)")
define("use_mkldnn", False, "accepted for config compat")
define("gpu_id", 0, "device ordinal to bind when several cards are visible")
define("parallel_nn", False,
       "device-annotated model parallelism -> use mesh axes instead")
# Distributed identity (trainer/pserver topology -> torch.distributed):
define("trainer_count", 1, "data-parallel degree (maps to mesh dp axis)")
define("trainer_id", 0, "this host's index in a multi-host job")
define("num_hosts", 1, "total hosts (num_gradient_servers analog)")
define("num_gradient_servers", 1, "alias of num_hosts kept for config compat")
define("coordinator_address", "",
       "process-group rendezvous ip:port (pserver addr analog)")
define("port", 20134, "coordinator port when coordinator_address has no port")
define("nics", "", "network interface hint; accepted for config compat")
define("rdma_tcp", "tcp", "transport hint; accepted for config compat")
define("local", True, "single-host mode (no process group)")
define("start_pserver", False,
       "no PS role; accepted and ignored with a warning")
# Training loop (Trainer.cpp):
define("log_period", 100, "log every N batches")
define("dot_period", 1, "progress dot every N batches between log lines")
define("test_period", 0, "run the test reader every N batches (0 = per pass)")
define("average_test_period", 0,
       "test with ModelAverage params every N batches")
define("num_passes", 1, "training passes")
define("start_pass", 0, "resume training from this pass")
define("saving_period", 1, "checkpoint every N passes")
define("saving_period_by_batches", 1000,
       "checkpoint every N batches within a pass")
define("save_dir", "./output", "checkpoint directory")
define("save_only_one", False, "keep only the newest checkpoint on disk")
define("init_model_path", "",
       "load persistables from this dir before training")
define("load_missing_parameter_strategy", "fail",
       "fail | rand | zero for missing params at load")
define("prev_batch_state", False,
       "carry RNN state across batches (streaming eval)")
define("with_cost", True, "build the cost layer (off for pure-inference "
       "configs)")
define("comment", "", "free-form run annotation echoed into logs")
define("compile_cache_dir", ".cache/xla",
       "the JAX package's persistent XLA compilation cache directory; "
       "registered for config compat, it has no counterpart in the port, "
       "whose compile store is ROADMAP A.10")
# Eval/decode:
define("beam_size", 4,
       "beam search width (RecurrentGradientMachine generation flag)")
define("predict_file", "", "file for saving predict results (infer job)")
define("distribute_test", False, "aggregate test metrics across hosts")
define("test_pass", -1, "load parameters from this pass for --job=test")
# Numerics/debug:
define("batch_size", 64, "global batch size")
define("seed", 0, "global RNG seed (0 = fixed default stream)")
define("checkgrad_eps", 5e-3, "central-difference perturbation for "
       "--job=checkgrad (calibrated with the 2% rel-error threshold for f32 "
       "losses)")
define("log_clipping", False, "log when gradient clipping rescales")
define("log_error_clipping", False, "log activation error-clipping rate")
define("show_parameter_stats_period", 0,
       "print parameter/grad stats every N batches")
define("show_layer_stat", False, "show per-layer output stats each period")
define("enable_grad_share", 0, "kept for config compat")
define("loadsave_parameters_in_pserver", False,
       "no PS; sharded checkpoint instead")
define("allow_only_one_model_on_one_gpu", True, "kept for config compat")
