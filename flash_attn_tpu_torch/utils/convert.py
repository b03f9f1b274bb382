"""Carry the JAX package's GPT parameters over to this port.

`state_dict_from_flax` takes the params of flash_attn_tpu's GPTLMHeadModel
(a nested dict of arrays; numpy or anything `np.asarray` reads), or any
tree shaped like them such as a JAX gradient tree, and returns a
state_dict-shaped dict of fp32 tensors for this package's GPTLMHeadModel.
It imports no JAX."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def state_dict_from_flax(params, config) -> Dict[str, torch.Tensor]:
    """Flax Dense kernels (in, out) become Linear weights (out, in); Embed
    tables, RMSNorm/LayerNorm scales and the untied lm_head map by name;
    a mixer's bare arrays (MLA's W_uk and W_uv) carry over as they are.
    Tensors come back in fp32; `load_state_dict` casts them to the model's
    dtypes."""
    p = params.get("params", params)
    tr = p["transformer"]
    sd = {}

    def dense(prefix, node):
        sd[prefix + ".weight"] = _t(node["kernel"]).T.contiguous()
        if "bias" in node:
            sd[prefix + ".bias"] = _t(node["bias"])

    def norm(prefix, node):
        sd[prefix + ".weight"] = _t(node["scale"])
        if "bias" in node:
            sd[prefix + ".bias"] = _t(node["bias"])

    emb = tr["embeddings"]
    sd["transformer.embeddings.word_embeddings.weight"] = _t(
        emb["word_embeddings"]["embedding"])
    if "position_embeddings" in emb:
        sd["transformer.embeddings.position_embeddings.weight"] = _t(
            emb["position_embeddings"]["embedding"])
    for i in range(config.n_layer):
        layer = tr[f"layers_{i}"]
        prefix = f"transformer.layers.{i}"
        for name, node in layer["mixer"].items():
            if hasattr(node, "keys"):
                dense(f"{prefix}.mixer.{name}", node)
            else:  # MLA's W_uk (h, dn, dc) and W_uv (h, dc, dv), as they are
                sd[f"{prefix}.mixer.{name}"] = _t(node)
        for name, node in layer["mlp"].items():
            dense(f"{prefix}.mlp.{name}", node)
        for name in ("norm1", "norm2"):
            if name in layer:
                norm(f"{prefix}.{name}", layer[name])
    norm("transformer.ln_f", tr["ln_f"])
    if "lm_head" in p:
        sd["lm_head.weight"] = _t(p["lm_head"]["kernel"]).T.contiguous()
    return sd
