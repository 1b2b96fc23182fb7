"""The port's ops: the paged KV pool and its composed attention forms, the
hand-written paged decode-attention kernel, flash attention with its
hand-written forward and backward kernels, the fused LSTM recurrence with
its hand-written forward and reverse kernels, batch normalisation with its
hand-written backward kernels, the 3x3 implicit-GEMM convolution (plain and
with a folded batch norm and a ReLU) with its hand-written kernels,
dropout with JAX's threefry mask on its hand-written kernel, and per-slot
token selection."""
from .attention import (dequantize_kv, flash_attention, init_kv_pool,
                        init_kv_pool_quant, paged_cache_set,
                        paged_cache_set_window,
                        paged_decode_attention, paged_decode_attention_single,
                        paged_gather_kv, pool_arena, quantize_kv)
from .batch_norm import batch_norm_train
from .conv import igemm_conv, igemm_conv_fused
from .dropout import threefry_dropout
from .lstm import fused_lstm
from .paged_attention import paged_attention, paged_attention_reference
from .sampling import NEG_MASK, masked_select_tokens

__all__ = ["NEG_MASK", "batch_norm_train", "dequantize_kv", "flash_attention", "fused_lstm",
           "igemm_conv", "igemm_conv_fused", "init_kv_pool",
           "init_kv_pool_quant", "masked_select_tokens", "paged_attention",
           "paged_attention_reference", "paged_cache_set",
           "paged_cache_set_window", "paged_decode_attention",
           "paged_decode_attention_single", "paged_gather_kv", "pool_arena",
           "quantize_kv", "threefry_dropout"]
