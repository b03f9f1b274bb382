"""Same-call A/B of the port's attention kernels that share the tile steps
of csrc/flash_fwd_tile.cuh and csrc/flash_bwd_tile.cuh (dense 1-3, varlen
6-8, vertical-slash sparse 12-15) built from two checkouts: ptxas
registers and spills of every kernel, and CUDA-event times in turns.

    python3 tools/ab_kernels.py --base build/parent [--rounds 6]

`--base` is another checkout of the repository (e.g. the parent commit,
unpacked with `git archive`). Every csrc/*.cu source both checkouts have
is compiled with the port's nvcc flags (all nvcc at once) into build/ab/,
and the ptxas registers and spills of every kernel are compared. The
kernels of csrc/flash_fwd.cu, csrc/flash_bwd.cu, csrc/flash_sparse_fwd.cu
and csrc/flash_sparse_bwd.cu are then timed through this checkout's wrappers
(whose C interface the base must share) on chip_smoke.py's "gpt2m" and
"mistral-window" shapes (1-3), its "gpt2m-packed" documents (6-8) and its
"prefill-8k" sparse case (12-15), the builds in turns (base, tree, tree,
base per round), each time the median of 20 CUDA-event times; the last
line gives each kernel's median over the rounds for either build. The
block-sparse kernels 9-11 (csrc/block_sparse_*.cu) have steps of their
own and are not built here. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from flash_attn_tpu_torch.kernels import (  # noqa: E402
    _build,
    flash_bwd,
    flash_fwd,
    flash_sparse,
    flash_sparse_gather,
    flash_varlen,
)

SOURCES = ("flash_fwd", "flash_bwd", "flash_sparse_fwd", "flash_sparse_bwd")
CASES = ("gpt2m", "mistral-window", "gpt2m-packed", "prefill-8k")
OUT_DIR = os.path.join(REPO, "build", "ab")


def common_sources(trees):
    """The csrc/*.cu sources every tree has: all are built for the register
    comparison, SOURCES are also timed."""
    names = [{f[:-3] for f in os.listdir(os.path.join(root, "flash_attn_tpu_torch",
                                                      "csrc")) if f.endswith(".cu")}
             for root in trees.values()]
    return sorted(set.intersection(*names))


def build(trees):
    """Compiles the sources every tree has, all at once; returns {tag:
    {source: log}}."""
    os.makedirs(OUT_DIR, exist_ok=True)
    jobs = {}
    for tag, root in trees.items():
        for src in common_sources(trees):
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


def registers(log):
    """{kernel: (registers, spill stores, spill loads)} from ptxas -v output,
    keyed by the demangled name with its template arguments."""
    found, name, spills = {}, None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            found[name] = (int(m.group(1)),) + spills
            name = None
    if shutil.which("c++filt"):
        plain = subprocess.run(["c++filt"], input="\n".join(found), text=True,
                               capture_output=True, check=True).stdout.split("\n")
        found = dict(zip(plain, found.values()))
    keyed = {}
    for full, value in found.items():
        m = re.search(r"(\w+)<(.*)>\(", full)
        key = f"{m.group(1)}<{m.group(2)}>" if m else full
        keyed[key] = value
    return keyed


def use(tag):
    """Points the wrappers at the `tag` build."""
    paths = {src: os.path.join(OUT_DIR, f"{tag}-{src}.so") for src in SOURCES}
    _build.library_path = lambda name: paths[name]
    _build.load_library.cache_clear()
    for loader in (flash_fwd._kernel, flash_bwd._kernels,
                   flash_varlen._fwd_kernel, flash_varlen._bwd_kernels,
                   flash_sparse._fwd_kernel, flash_sparse._bwd_kernels):
        loader.cache_clear()


def varlen_inputs(name, seed):
    """chip_smoke.VARLEN_CASES' `name` (thd, no seqused): kernels 6-8."""
    lens, _, _, _, h, hk, d, causal, window, _, _ = chip_smoke.VARLEN_CASES[name]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    tot = sum(lens)
    q, do = (torch.randn(tot, h, d, generator=gen, device=dev,
                         dtype=torch.bfloat16) for _ in range(2))
    k, v = (torch.randn(tot, hk, d, generator=gen, device=dev,
                        dtype=torch.bfloat16) for _ in range(2))
    cu = chip_smoke._dev_int(chip_smoke._cu_of(lens))
    kw = dict(causal=causal, window_size=window)
    mq, mk = dict(max_seqlen_q=max(lens)), dict(max_seqlen_k=max(lens))
    _, lse = flash_varlen.flash_attention_varlen_fwd(q, k, v, cu, cu, **kw, **mq)
    _, delta = flash_varlen.flash_attention_varlen_bwd_dq(q, k, v, do, lse, cu,
                                                          cu, **kw, **mq)
    return dict(
        varlen_fwd=lambda: flash_varlen.flash_attention_varlen_fwd(
            q, k, v, cu, cu, **kw, **mq),
        varlen_dkv=lambda: flash_varlen.flash_attention_varlen_bwd_dkv(
            q, k, v, do, lse, delta, cu, cu, **kw, **mk),
        varlen_dq=lambda: flash_varlen.flash_attention_varlen_bwd_dq(
            q, k, v, do, lse, cu, cu, **kw, **mq))


def sparse_inputs(name, seed):
    """chip_smoke.SPARSE_CASES' `name` on its seeded metadata: kernels 12
    and 15 (each over its planner's lists, planners outside the timing),
    14 and 13."""
    b, h, hk, sq, sk, d, causal, dtype = chip_smoke.SPARSE_CASES[name][:8]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, do = (torch.randn(b, h, sq, d, generator=gen, device=dev, dtype=dtype)
             for _ in range(2))
    k, v = (torch.randn(b, hk, sk, d, generator=gen, device=dev, dtype=dtype)
            for _ in range(2))
    meta = chip_smoke.vs_metadata(b, h, sq, sk, chip_smoke.MINF_HEADS, causal,
                                  seed)
    plans = dict(seqlen_q=sq, seqlen_k=sk, causal=causal)
    plan = flash_sparse.plan_sparse(*meta, keep_table=True, **plans)
    gplan = flash_sparse_gather.plan_gather(*meta, **plans)
    inverse = flash_sparse.plan_inverse(plan.table, hk)
    kw = dict(causal=causal)
    _, lse = flash_sparse.flash_attention_sparse_tiles_fwd(q, k, v, *meta,
                                                           plan=plan, **kw)
    _, delta = flash_sparse.flash_attention_sparse_bwd_dq(
        q, k, v, do, lse, *meta, plan=plan, **kw)
    return dict(
        sparse_tiles_fwd=lambda: flash_sparse.flash_attention_sparse_tiles_fwd(
            q, k, v, *meta, plan=plan, **kw),
        sparse_gather_fwd=lambda: (
            flash_sparse_gather.flash_attention_sparse_gather_fwd(
                q, k, v, *meta, plan=gplan, **kw)),
        sparse_dkv=lambda: flash_sparse.flash_attention_sparse_bwd_dkv(
            q, k, v, do, lse, delta, *meta, inverse=inverse, **kw),
        sparse_dq=lambda: flash_sparse.flash_attention_sparse_bwd_dq(
            q, k, v, do, lse, *meta, plan=plan, **kw))


def inputs(name, seed):
    """The `name` case's timed calls by kernel: chip_smoke.ATTN_CASES'
    shapes for kernels 1-3, else the varlen or sparse case."""
    if name in chip_smoke.VARLEN_CASES:
        return varlen_inputs(name, seed)
    if name in chip_smoke.SPARSE_CASES:
        return sparse_inputs(name, seed)
    (_, b, h, hk, sq, sk, d, causal, window, softcap,
     dtype) = next(c for c in chip_smoke.ATTN_CASES if c[0] == name)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, do = (torch.randn(b, h, sq, d, generator=gen, device=dev, dtype=dtype)
             for _ in range(2))
    k, v = (torch.randn(b, hk, sk, d, generator=gen, device=dev, dtype=dtype)
            for _ in range(2))
    kw = dict(causal=causal, window_size=window, softcap=softcap)
    _, lse = flash_fwd.flash_attention_fwd(q, k, v, **kw)
    _, delta = flash_bwd.flash_attention_bwd_dq(q, k, v, do, lse, **kw)
    return dict(
        fwd=lambda: flash_fwd.flash_attention_fwd(q, k, v, **kw),
        dkv=lambda: flash_bwd.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                                      **kw),
        dq=lambda: flash_bwd.flash_attention_bwd_dq(q, k, v, do, lse, **kw))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--base", required=True,
                        help="the other checkout (e.g. build/parent)")
    parser.add_argument("--rounds", type=int, default=6)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("ab_kernels: no CUDA device", file=sys.stderr)
        return 1
    trees = dict(base=os.path.abspath(args.base), tree=REPO)
    logs = build(trees)
    regs = {tag: {} for tag in trees}
    for tag in trees:
        for src in logs[tag]:
            regs[tag].update({f"{src}: {name}": value for name, value in
                              registers(logs[tag][src]).items()})
    differ = {k: dict(base=regs["base"].get(k), tree=v)
              for k, v in regs["tree"].items() if regs["base"].get(k) != v
              and k in regs["base"]}
    print(json.dumps(dict(phase="ptxas", card=chip_smoke.smi(),
                          base=trees["base"], kernels=len(regs["tree"]),
                          same_in_both=sum(k in regs["base"]
                                           for k in regs["tree"]),
                          differ=differ, registers=regs)), flush=True)
    use("tree")
    calls = {name: inputs(name, seed=20 + i) for i, name in enumerate(CASES)}
    times = {tag: {f"{c}/{k}": [] for c in CASES for k in calls[c]}
             for tag in trees}
    for r in range(args.rounds):
        for tag in ("base", "tree", "tree", "base"):
            use(tag)
            turn = {}
            for case, fns in calls.items():
                for kernel, fn in fns.items():
                    turn[f"{case}/{kernel}"] = chip_smoke.cuda_ms(fn)
                    times[tag][f"{case}/{kernel}"].append(turn[f"{case}/{kernel}"])
            print(json.dumps(dict(phase="turn", round=r, build=tag, ms=turn)),
                  flush=True)
    medians = {key: dict(base=float(np.median(times["base"][key])),
                         tree=float(np.median(times["tree"][key])))
               for key in times["tree"]}
    for m in medians.values():
        m["tree_over_base"] = m["tree"] / m["base"]
    print(json.dumps(dict(phase="medians", rounds=args.rounds,
                          turns_per_build=2 * args.rounds, card=chip_smoke.smi(),
                          ms=medians)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
