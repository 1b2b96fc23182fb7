"""paddle_tpu_torch: the PyTorch / CUDA port of paddle_tpu for NVIDIA Hopper.

This slice serves the decoder-only Transformer LM through continuous
batching over a paged KV pool, with a hand-written CUDA paged
decode-attention kernel (``ops/csrc/paged_attention.cu``).  Entry points
run on the CUDA card unless the caller passes ``device="cpu"``; with no
card and no device given they raise.  The package imports torch and numpy,
never jax and nothing of ``paddle_tpu``.
"""
from ._device import card_info, resolve_device
from .models import TransformerLM, from_jax_params, init_lm_params
from .resilience import Deadline, DeadlineExceeded
from .serving import (AdmissionShed, ContinuousDecodeEngine,
                      ContinuousScheduler, DecodeRequest, PagedKVPool,
                      SamplingParams)

__all__ = ["AdmissionShed", "ContinuousDecodeEngine", "ContinuousScheduler",
           "Deadline", "DeadlineExceeded", "DecodeRequest", "PagedKVPool",
           "SamplingParams", "TransformerLM", "card_info", "from_jax_params",
           "init_lm_params", "resolve_device"]
