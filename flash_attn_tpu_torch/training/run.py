"""Experiment entry point (counterpart of flash_attn_tpu/training/run.py).

    python -m flash_attn_tpu_torch.training.run --config configs/gpt2m-synth.yaml
    python -m flash_attn_tpu_torch.training.run --config ... --set train.lr=1e-4

The YAML maps onto GPTConfig / TrainConfig / the data settings, with dotted
`--set` overrides. The model keeps fp32 parameters and computes in the
config's dtype. It runs on the card unless `--device` names another
device. MFU is against the H100's dense bf16 data-sheet rate."""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from flash_attn_tpu_torch.models.gpt import GPTConfig, GPTLMHeadModel
from flash_attn_tpu_torch.training.data import (
    LMDataModule,
    TokenDataset,
    synthetic_tokens,
)
from flash_attn_tpu_torch.training.presets import expand_model_config
from flash_attn_tpu_torch.training.trainer import (
    SpeedMonitor,
    TrainConfig,
    Trainer,
    gpt_flops_per_token,
)
from flash_attn_tpu_torch.utils.device import resolve_device

# NVIDIA H100 SXM data sheet: dense bf16 tensor-core rate.
H100_BF16_PEAK_FLOPS = 989e12
_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           "float32": torch.float32}


def _apply_overrides(cfg: dict, overrides, yaml):
    for ov in overrides or []:
        path, val = ov.split("=", 1)
        node = cfg
        keys = path.split(".")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = yaml.safe_load(val)
    return cfg


def load_config(path: str, overrides=()):
    """(GPTConfig, TrainConfig, data settings) from a YAML file and dotted
    `key=value` overrides, presets expanded."""
    import yaml  # PyYAML; only the config file needs it

    with open(path) as f:
        cfg = yaml.safe_load(f)
    cfg = _apply_overrides(cfg, overrides, yaml)
    mcfg = expand_model_config(dict(cfg["model"]))
    if "dtype" in mcfg:
        mcfg["dtype"] = _DTYPES[mcfg["dtype"]]
    if "window_size" in mcfg:
        mcfg["window_size"] = tuple(mcfg["window_size"])
    return (GPTConfig(**mcfg), TrainConfig(**cfg.get("train", {})),
            cfg.get("data", {}))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--set", dest="overrides", action="append", default=[])
    ap.add_argument("--device", default=None,
                    help="torch device; the card (cuda) unless named")
    ap.add_argument("--resume", action="store_true",
                    help="auto-resume from the latest checkpoint")
    args = ap.parse_args(argv)
    if args.resume:
        raise NotImplementedError(
            "--resume needs checkpointing, not ported yet: ROADMAP queue 1, "
            "item 13 (checkpointing)")
    device = resolve_device(args.device)
    model_config, train_config, dcfg = load_config(args.config, args.overrides)

    generator = torch.Generator(device=device).manual_seed(train_config.seed)
    model = GPTLMHeadModel(model_config, device=device, generator=generator,
                           param_dtype=torch.float32)

    if dcfg.get("kind", "synthetic") == "synthetic":
        toks = synthetic_tokens(
            model_config.vocab_size, dcfg.get("num_tokens", 1_000_000),
            seed=train_config.seed,
        )
        dataset = TokenDataset(toks, dcfg.get("seqlen", 512))
    else:
        dataset = TokenDataset.from_memmap(
            dcfg["path"], dcfg.get("seqlen", 512),
            dtype=np.dtype(dcfg.get("dtype", "uint16")),
        )
    dm = LMDataModule(dataset, dcfg.get("batch_size", 8),
                      seed=train_config.seed)

    trainer = Trainer(model, train_config, device=device)
    peak = H100_BF16_PEAK_FLOPS if device.type == "cuda" else 1e12
    monitor = SpeedMonitor(gpt_flops_per_token(model_config), peak)
    hist = trainer.fit(dm, speed_monitor=monitor)
    report = {"final": hist[-1] if hist else {}, **monitor.report(),
              "steps": trainer.steps}
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
