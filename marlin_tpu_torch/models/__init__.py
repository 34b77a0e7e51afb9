"""The port's models: the causal transformer LM (training and inference)."""

from .convert import params_from_jax
from .transformer import (TransformerConfig, decode_chunk, decode_step,
                          forward, generate, hidden_states, init_kv_cache,
                          init_params, loss_fn, make_train_step, prefill,
                          train_step)

__all__ = ["TransformerConfig", "decode_chunk", "decode_step", "forward",
           "generate", "hidden_states", "init_kv_cache", "init_params",
           "loss_fn", "make_train_step", "params_from_jax", "prefill",
           "train_step"]
