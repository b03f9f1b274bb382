"""Model-size presets and config composition (own copy of
flash_attn_tpu/training/presets.py). A config may say
`model: {preset: gpt2m, ...overrides}`; the preset expands first and
explicit keys win."""

from __future__ import annotations

from typing import Dict

# Field values are GPTConfig kwargs (flash_attn_tpu_torch/models/gpt.py).
MODEL_PRESETS: Dict[str, dict] = {
    # GPT-2 ladder
    "gpt2s": dict(n_embd=768, n_layer=12, n_head=12),            # 124M
    "gpt2m": dict(n_embd=1024, n_layer=24, n_head=16),           # 355M
    "gpt2l": dict(n_embd=1280, n_layer=36, n_head=20),           # 774M
    "gpt2xl": dict(n_embd=1600, n_layer=48, n_head=25),          # 1.6B
    # Llama-style (rotary + swiglu + RMSNorm, untied) small sizes.
    "llama-350m": dict(
        n_embd=1024, n_layer=24, n_head=16, n_positions=0,
        rotary_emb_fraction=1.0, rms_norm=True,
        activation_function="swiglu", n_inner=2816,
        qkv_proj_bias=False, out_proj_bias=False,
        mlp_fc1_bias=False, mlp_fc2_bias=False,
        tie_word_embeddings=False,
    ),
    "llama-1b": dict(
        n_embd=2048, n_layer=16, n_head=32, n_head_kv=8, n_positions=0,
        rotary_emb_fraction=1.0, rms_norm=True,
        activation_function="swiglu", n_inner=8192,
        qkv_proj_bias=False, out_proj_bias=False,
        mlp_fc1_bias=False, mlp_fc2_bias=False,
        tie_word_embeddings=False,
    ),
}


def expand_model_config(mcfg: dict) -> dict:
    """Expand `preset: name` inside a model config dict; explicit keys win."""
    mcfg = dict(mcfg)
    name = mcfg.pop("preset", None)
    if name is None:
        return mcfg
    if name not in MODEL_PRESETS:
        raise KeyError(
            f"unknown model preset {name!r}; have {sorted(MODEL_PRESETS)}"
        )
    out = dict(MODEL_PRESETS[name])
    out.update(mcfg)
    return out
