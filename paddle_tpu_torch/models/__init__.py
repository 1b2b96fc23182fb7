"""The port's models: the decoder-only Transformer LM's training graph and
serving math, the LSTM text classifier's training graph, and ResNet's."""
from . import resnet, text_lstm, transformer
from .resnet import (init_resnet_params, init_resnet_stats,
                     resnet_param_shapes)
from .text_lstm import init_text_lstm_params, text_lstm_param_shapes
from .transformer import (TransformerLM, build_lm, init_lm_params, lm_forward,
                          lm_head_logits, lm_paged_decode_window,
                          lm_param_shapes)
from .weights import from_jax_params, load_scope

__all__ = ["TransformerLM", "build_lm", "from_jax_params", "init_lm_params",
           "init_resnet_params", "init_resnet_stats", "init_text_lstm_params",
           "lm_forward", "lm_head_logits", "lm_paged_decode_window", "lm_param_shapes",
           "load_scope", "resnet", "resnet_param_shapes", "text_lstm",
           "text_lstm_param_shapes", "transformer"]
