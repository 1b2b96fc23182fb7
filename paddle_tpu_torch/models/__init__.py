"""The port's models: the decoder-only Transformer LM's serving math."""
from .transformer import (TransformerLM, init_lm_params, lm_forward,
                          lm_head_logits, lm_paged_decode_window,
                          lm_param_shapes)
from .weights import from_jax_params

__all__ = ["TransformerLM", "from_jax_params", "init_lm_params", "lm_forward",
           "lm_head_logits", "lm_paged_decode_window", "lm_param_shapes"]
