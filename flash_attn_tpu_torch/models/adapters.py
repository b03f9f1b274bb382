"""HF config adapters (counterpart of flash_attn_tpu/models/adapters.py).
Only the Llama-family mapping is ported; it covers Mistral through its
sliding window."""

from __future__ import annotations

import torch

from flash_attn_tpu_torch.models.gpt import GPTConfig


def llama_config_to_gpt_config(hf, dtype=torch.bfloat16) -> GPTConfig:
    """Map an HF Llama/Mistral config, given as a plain dict (the parsed
    config.json) or an object with the same attributes."""
    get = hf.get if isinstance(hf, dict) else (
        lambda key, default=None: getattr(hf, key, default))
    window = get("sliding_window")
    bias = get("attention_bias", False)
    mlp_bias = get("mlp_bias", False)
    return GPTConfig(
        vocab_size=get("vocab_size"),
        n_positions=0,
        n_embd=get("hidden_size"),
        n_layer=get("num_hidden_layers"),
        n_head=get("num_attention_heads"),
        n_head_kv=get("num_key_value_heads"),
        head_dim=get("head_dim"),
        n_inner=get("intermediate_size"),
        activation_function="swiglu",
        layer_norm_epsilon=get("rms_norm_eps"),
        rms_norm=True,
        rotary_emb_fraction=1.0,
        rotary_emb_base=get("rope_theta", 10000.0),
        window_size=(window - 1, -1) if window else (-1, -1),
        qkv_proj_bias=bias,
        out_proj_bias=bias,
        mlp_fc1_bias=mlp_bias,
        mlp_fc2_bias=mlp_bias,
        tie_word_embeddings=get("tie_word_embeddings", False),
        dtype=dtype,
    )
