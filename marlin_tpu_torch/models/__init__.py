"""The port's models: the causal transformer LM (training and inference)
and its int8 decode stack."""

from .convert import params_from_jax
from .quant import dequantize_params, quantize_params_int8
from .transformer import (TransformerConfig, decode_chunk, decode_step,
                          forward, generate, generate_speculative,
                          hidden_states, init_kv_cache, init_params, loss_fn,
                          make_train_step, prefill, train_step)

__all__ = ["TransformerConfig", "decode_chunk", "decode_step",
           "dequantize_params", "forward", "generate",
           "generate_speculative", "hidden_states", "init_kv_cache",
           "init_params", "loss_fn", "make_train_step", "params_from_jax",
           "prefill", "quantize_params_int8", "train_step"]
