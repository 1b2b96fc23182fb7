"""The port's models: the decoder-only Transformer LM's training graph and
serving math."""
from . import transformer
from .transformer import (TransformerLM, build_lm, init_lm_params, lm_forward,
                          lm_head_logits, lm_paged_decode_window,
                          lm_param_shapes)
from .weights import from_jax_params, load_scope

__all__ = ["TransformerLM", "build_lm", "from_jax_params", "init_lm_params",
           "lm_forward", "lm_head_logits", "lm_paged_decode_window",
           "lm_param_shapes", "load_scope", "transformer"]
