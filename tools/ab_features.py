"""Same-call A/B of kernels 1-3's feature instances built from two
checkouts: ptxas registers and spills, and CUDA-event times in turns.

    python3 tools/ab_features.py --base build/other [--cases ...] [--rounds 4]

`--base` is another checkout, or any directory holding
flash_attn_tpu_torch/csrc/ (only its csrc/flash_fwd_features.cu and
csrc/flash_bwd_features.cu, with the headers beside them, are built). Both
checkouts' two sources are compiled with the port's nvcc flags (all nvcc
at once) into build/ab_features/, the registers and spills of kernels 1-3's
instances printed for both, then chip_smoke.py's FEATURE_CASES named by
`--cases` are timed through this checkout's wrappers, the builds in turns
(base, tree, tree, base per round), each time the median of 20 CUDA-event
times of the forward, the dQ and the dK/dV call. The last line gives each
call's median over the rounds for either build. Needs one CUDA card. The
feature-free instances are `tools/ab_kernels.py`'s.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from flash_attn_tpu_torch.kernels import _build, flash_bwd, flash_fwd  # noqa: E402

SOURCES = ("flash_fwd_features", "flash_bwd_features")
OUT_DIR = os.path.join(REPO, "build", "ab_features")
KERNELS = dict(fwd="15fwd_sm90_kernel", dq="bwd_dq_sm90_kernel",
               dkv="bwd_dkv_sm90_kernel")


def build(trees):
    """Compiles SOURCES of every tree, all at once; returns {tag: {source:
    log}}."""
    os.makedirs(OUT_DIR, exist_ok=True)
    jobs = {}
    for tag, root in trees.items():
        for src in SOURCES:
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                   os.path.join(OUT_DIR, f"{tag}-{src}.so"),
                   os.path.join(root, "flash_attn_tpu_torch", "csrc",
                                src + ".cu")]
            jobs[tag, src] = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)
    logs = {tag: {} for tag in trees}
    for (tag, src), proc in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {tag} {src}:\n{log}")
        logs[tag][src] = log
    return logs


_library_path = _build.library_path


def use(tag):
    """Points the feature wrappers at the `tag` build."""
    paths = {src: os.path.join(OUT_DIR, f"{tag}-{src}.so") for src in SOURCES}
    _build.library_path = lambda name: paths.get(name) or _library_path(name)
    _build.load_library.cache_clear()
    flash_fwd._features_kernel.cache_clear()
    flash_bwd._feature_kernels.cache_clear()


def calls(name, seed):
    """The case's three timed calls on seeded inputs, and its features."""
    case = chip_smoke.FEATURE_CASES[name]
    kw, fkw, (q, k, v, do) = chip_smoke.feature_inputs(case, seed)
    kf = chip_smoke.make_features(**fkw)
    lse = flash_fwd.flash_attention_fwd(q, k, v, **kw, **fkw)[1]
    delta = flash_bwd.flash_attention_bwd_dq(q, k, v, do, lse, **kw,
                                             features=kf)[1]
    return dict(
        fwd=lambda: flash_fwd.flash_attention_fwd(q, k, v, **kw, **fkw),
        dq=lambda: flash_bwd.flash_attention_bwd_dq(q, k, v, do, lse, **kw,
                                                    features=kf),
        dkv=lambda: flash_bwd.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                                      **kw, features=kf))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--base", required=True,
                        help="the other checkout (or a directory holding "
                             "flash_attn_tpu_torch/csrc)")
    parser.add_argument("--rounds", type=int, default=4)
    parser.add_argument("--cases", nargs="+",
                        choices=tuple(chip_smoke.FEATURE_CASES),
                        default=["dropout-gpt2m", "all-d64"])
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("ab_features: no CUDA device", file=sys.stderr)
        return 1
    trees = dict(base=os.path.abspath(args.base), tree=REPO)
    logs = build(trees)
    print(json.dumps(dict(
        phase="ptxas", card=chip_smoke.smi(), base=trees["base"],
        registers={tag: {key: chip_smoke.ptxas_of(logs[tag], frag)
                         for key, frag in KERNELS.items()}
                   for tag in trees})), flush=True)
    # The feature-free libraries the wrappers need besides (this tree's).
    _build.build_libraries(["flash_fwd", "flash_bwd"])
    use("tree")
    times = {tag: {} for tag in trees}
    for i, name in enumerate(args.cases):
        fns = calls(name, seed=200 + i)
        for _ in range(args.rounds):
            for tag in ("base", "tree", "tree", "base"):
                use(tag)
                for key, fn in fns.items():
                    times[tag].setdefault(f"{name}/{key}", []).append(
                        chip_smoke.cuda_ms(fn))
        del fns
        torch.cuda.empty_cache()
    medians = {key: dict(base=float(np.median(times["base"][key])),
                         tree=float(np.median(times["tree"][key])))
               for key in times["tree"]}
    for m in medians.values():
        m["tree_over_base"] = m["tree"] / m["base"]
    print(json.dumps(dict(phase="medians", rounds=args.rounds,
                          card=chip_smoke.smi(), ms=medians)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
