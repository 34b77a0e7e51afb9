"""The port's models: the causal transformer LM (inference subset)."""

from .convert import params_from_jax
from .transformer import (TransformerConfig, decode_chunk, decode_step,
                          forward, generate, hidden_states, init_kv_cache,
                          init_params, prefill)

__all__ = ["TransformerConfig", "decode_chunk", "decode_step", "forward",
           "generate", "hidden_states", "init_kv_cache", "init_params",
           "params_from_jax", "prefill"]
