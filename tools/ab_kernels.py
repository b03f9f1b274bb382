"""Same-call A/B of the port's attention kernels built from two
checkouts: ptxas registers and spills of every kernel, and CUDA-event times
in turns (dense 1-3, varlen 6-8, block-sparse 9-11, vertical-slash sparse
12-15, and the decode kernels 4 and 5 with a vLLM decode-only step).

    python3 tools/ab_kernels.py --base build/parent [--rounds 6]

`--base` is another checkout of the repository (e.g. the parent commit,
unpacked with `git archive`). Every csrc/*.cu source both checkouts have
is compiled with the port's nvcc flags (all nvcc at once) into build/ab/,
and the ptxas registers and spills of every kernel are compared. The
kernels of csrc/flash_fwd.cu, csrc/flash_bwd.cu, csrc/block_sparse_fwd.cu,
csrc/block_sparse_bwd.cu, csrc/flash_sparse_fwd.cu and
csrc/flash_sparse_bwd.cu are then timed through this checkout's wrappers
(whose C interface the base must share) on chip_smoke.py's "gpt2m" and
"mistral-window" shapes (1-3), its "gpt2m-packed" documents (6-8), its
Mistral paged prefill at page 16 ("mistral-paged-prefill-page16", kernel
6 on vLLM "phd" pools) and vLLM's mixed step ("vllm-mixed-step": a
2041-token chunk and seven decode rows, page 16), its "doc10", "prefix"
and "softcap30-fp16-d64" block-sparse cases (9-11, over this checkout's
execution lists), its "prefill-8k" sparse case (12-15), its
"tinyllama-d64-noncausal" one (12-15 at d 64, non-causal) and the vLLM
prefill at 32768 tokens ("vllm-prefill-32k", kernels 12 and 15), the
builds in turns (base, tree, tree,
base per round), each time the median of 20 CUDA-event times; each case
takes all its rounds before the next one starts. Every turn also runs each
timed call once more and compares its answer with this checkout's first:
the last line counts, per build and call, the turns whose bits differ and
their largest difference. Kernels 4
and 5, whose C interfaces may differ between checkouts, are timed through
each checkout's own wrappers: tools/ab_decode_worker.py runs once per
checkout (its inputs built once), and each turn asks the checkout's worker
for its times, in the same order. The last line gives each kernel's median
over the rounds for either build. `--cases` with no name times kernels 4
and 5 and the vLLM step alone. Needs one CUDA card.
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
    block_sparsity,
    flash_bwd,
    flash_fwd,
    flash_sparse,
    flash_sparse_gather,
    flash_varlen,
)

SOURCES = ("flash_fwd", "flash_bwd", "block_sparse_fwd", "block_sparse_bwd",
           "flash_sparse_fwd", "flash_sparse_bwd")
CASES = ("gpt2m", "mistral-window", "gpt2m-packed",
         "mistral-paged-prefill-page16", "vllm-mixed-step", "doc10", "prefix",
         "softcap30-fp16-d64", "prefill-8k", "tinyllama-d64-noncausal",
         "vllm-prefill-32k")
# Kernel 6 on vLLM pools at Mistral-7B widths, page 16: (query lengths,
# contexts).
PAGED_CASES = {
    "mistral-paged-prefill-page16": (chip_smoke.PAGED_QLENS,
                                     chip_smoke.PAGED_CONTEXTS),
    "vllm-mixed-step": (chip_smoke.MIXED_QLENS, chip_smoke.MIXED_CONTEXTS),
}
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


def base_name(key, base):
    """The base's name of the tree's kernel `key`: the same, or for a
    kernel that gained a trailing template parameter defaulting to 0, its
    name without that argument when the base has it."""
    if key in base:
        return key
    short = re.sub(r", 0>$", ">", key)
    return short if short in base else key


def use(tag):
    """Points the wrappers at the `tag` build."""
    paths = {src: os.path.join(OUT_DIR, f"{tag}-{src}.so") for src in SOURCES}
    _build.library_path = lambda name: paths[name]
    _build.load_library.cache_clear()
    for loader in (flash_fwd._kernel, flash_bwd._kernels,
                   flash_varlen._fwd_kernel, flash_varlen._bwd_kernels,
                   block_sparsity._fwd_kernel, block_sparsity._bwd_kernels,
                   flash_sparse._fwd_kernel, flash_sparse._bwd_kernels):
        loader.cache_clear()


class _VarlenGrid:
    """A kernels library whose flash_varlen_bwd_dq gets `max_len` as its
    max_seqlen_q argument (the 14th) and whose flash_varlen_bwd_dkv gets it
    as its max_seqlen_k (the 15th): the wrappers pass 0, which the flat
    schedules ignore, while a base whose dQ or dK/dV kernel sizes its grid
    by the longest sequence needs it there."""

    def __init__(self, lib, max_len):
        self.lib, self.max_len = lib, max_len

    def __getattr__(self, name):
        return getattr(self.lib, name)

    def flash_varlen_bwd_dq(self, *args):
        return self.lib.flash_varlen_bwd_dq(*args[:13], self.max_len,
                                            *args[14:])

    def flash_varlen_bwd_dkv(self, *args):
        return self.lib.flash_varlen_bwd_dkv(*args[:14], self.max_len,
                                             *args[15:])


def varlen_call(fn, max_len, *args, **kw):
    """The varlen backward wrapper `fn` through _VarlenGrid."""
    loader = flash_varlen._bwd_kernels
    flash_varlen._bwd_kernels = lambda: _VarlenGrid(loader(), max_len)
    try:
        return fn(*args, **kw)
    finally:
        flash_varlen._bwd_kernels = loader


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
    mq, top = dict(max_seqlen_q=max(lens)), max(lens)
    dq_fn = flash_varlen.flash_attention_varlen_bwd_dq
    dkv_fn = flash_varlen.flash_attention_varlen_bwd_dkv
    _, lse = flash_varlen.flash_attention_varlen_fwd(q, k, v, cu, cu, **kw, **mq)
    _, delta = varlen_call(dq_fn, top, q, k, v, do, lse, cu, cu, **kw)
    return dict(
        varlen_fwd=lambda: flash_varlen.flash_attention_varlen_fwd(
            q, k, v, cu, cu, **kw, **mq),
        varlen_dkv=lambda: varlen_call(dkv_fn, top, q, k, v, do, lse, delta,
                                       cu, cu, **kw),
        varlen_dq=lambda: varlen_call(dq_fn, top, q, k, v, do, lse, cu, cu,
                                      **kw))


def paged_inputs(name, seed):
    """PAGED_CASES' `name`: kernel 6 reading "phd" pool views through the
    page table (page 16), as chip_smoke's paged cases call it."""
    qlens, contexts = PAGED_CASES[name]
    st = chip_smoke.paged_step(qlens, contexts, 16, seed)
    return dict(varlen_paged_fwd=lambda: chip_smoke.paged_fwd(st))


def sparse_inputs(name, seed):
    """chip_smoke.SPARSE_CASES' `name` on its seeded metadata: kernels 12
    and 15 (each over its planner's lists, planners outside the timing),
    14 and 13; a forward-only case (the vLLM prefill) times kernels 12 and
    15 alone."""
    b, h, hk, sq, sk, d, causal, dtype = chip_smoke.SPARSE_CASES[name][:8]
    bwd = chip_smoke.SPARSE_CASES[name][-1]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, do = (torch.randn(b, h, sq, d, generator=gen, device=dev, dtype=dtype)
             for _ in range(2))
    k, v = (torch.randn(b, hk, sk, d, generator=gen, device=dev, dtype=dtype)
            for _ in range(2))
    meta = chip_smoke.vs_metadata(b, h, sq, sk, chip_smoke.MINF_HEADS, causal,
                                  seed)
    plans = dict(seqlen_q=sq, seqlen_k=sk, causal=causal)
    if not bwd:
        plan = flash_sparse.plan_sparse(*meta, **plans)
        gplan = flash_sparse_gather.plan_gather(*meta, **plans)
        return dict(
            sparse_tiles_fwd=lambda: (
                flash_sparse.flash_attention_sparse_tiles_fwd(
                    q, k, v, *meta, plan=plan, causal=causal)),
            sparse_gather_fwd=lambda: (
                flash_sparse_gather.flash_attention_sparse_gather_fwd(
                    q, k, v, *meta, plan=gplan, causal=causal)))
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


def blocksparse_inputs(name, seed):
    """chip_smoke.BS_CASES' `name`, its plan and this checkout's execution
    lists built once outside the timing: kernels 9, 11 and 10."""
    b, h, hk, s, d, dtype, softcap = chip_smoke.BS_CASES[name][:7]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, do = (torch.randn(b, h, s, d, generator=gen, device=dev, dtype=dtype)
             for _ in range(2))
    k, v = (torch.randn(b, hk, s, d, generator=gen, device=dev, dtype=dtype)
            for _ in range(2))
    plan, mod, aux = chip_smoke.bs_plan(name)
    lists = block_sparsity.prepare_lists(q, k, v, plan, mask_mod=mod,
                                         aux_tensors=aux)
    kw = dict(mask_mod=mod, aux_tensors=aux, softcap=softcap, lists=lists)
    _, lse = block_sparsity.flash_attention_blocksparse_fwd(q, k, v, plan,
                                                            **kw)
    _, delta = block_sparsity.flash_attention_blocksparse_bwd_dq(
        q, k, v, do, lse, plan, **kw)
    return dict(
        bs_fwd=lambda: block_sparsity.flash_attention_blocksparse_fwd(
            q, k, v, plan, **kw),
        bs_dq=lambda: block_sparsity.flash_attention_blocksparse_bwd_dq(
            q, k, v, do, lse, plan, **kw),
        bs_dkv=lambda: block_sparsity.flash_attention_blocksparse_bwd_dkv(
            q, k, v, do, lse, delta, plan, **kw))


def inputs(name, seed):
    """The `name` case's timed calls by kernel: chip_smoke.ATTN_CASES'
    shapes for kernels 1-3, else the varlen, block-sparse or sparse case."""
    if name in chip_smoke.VARLEN_CASES:
        return varlen_inputs(name, seed)
    if name in PAGED_CASES:
        return paged_inputs(name, seed)
    if name in chip_smoke.BS_CASES:
        return blocksparse_inputs(name, seed)
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


class DecodeWorker:
    """tools/ab_decode_worker.py on one checkout, behind a pipe."""

    def __init__(self, root):
        self.proc = subprocess.Popen(
            [sys.executable, os.path.join(REPO, "tools", "ab_decode_worker.py"),
             "--root", root], stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            text=True)

    def ready(self):
        line = self.proc.stdout.readline()
        if line.strip() != "ready":
            raise RuntimeError(f"decode worker failed to start: {line!r}")

    def times(self):
        self.proc.stdin.write("time\n")
        self.proc.stdin.flush()
        line = self.proc.stdout.readline()
        if not line:
            raise RuntimeError("decode worker ended early")
        return json.loads(line)

    def close(self):
        self.proc.stdin.close()
        self.proc.wait(timeout=120)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--base", required=True,
                        help="the other checkout (e.g. build/parent)")
    parser.add_argument("--rounds", type=int, default=6)
    parser.add_argument("--cases", nargs="*", choices=CASES, default=CASES,
                        help="the kernel 1-3, 6-8, 9-11 and 12-15 cases to "
                             "time (none: kernels 4 and 5 and the vLLM step "
                             "alone)")
    parser.add_argument("--no-decode", action="store_true",
                        help="skip kernels 4 and 5 and the vLLM step")
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
    # A tree kernel that gained a trailing template parameter defaulting to
    # 0 (kernels 1-3's kFeat) is compared with the base's kernel without it.
    named = {base_name(k, regs["base"]): v for k, v in regs["tree"].items()}
    differ = {k: dict(base=regs["base"].get(k), tree=v)
              for k, v in named.items() if regs["base"].get(k) != v
              and k in regs["base"]}
    print(json.dumps(dict(phase="ptxas", card=chip_smoke.smi(),
                          base=trees["base"], kernels=len(regs["tree"]),
                          same_in_both=sum(k in regs["base"] for k in named),
                          differ=differ,
                          only_in_base=sorted(set(regs["base"]) - set(named)),
                          only_in_tree=sorted(set(named) - set(regs["base"])),
                          registers=regs)), flush=True)
    workers = ({} if args.no_decode else
               {tag: DecodeWorker(root) for tag, root in trees.items()})
    for worker in workers.values():
        worker.ready()
    use("tree")
    calls = {name: inputs(name, seed=20 + CASES.index(name))
             for name in args.cases}
    times = {tag: {} for tag in trees}
    # Each case takes all its rounds of turns before the next case starts,
    # so that a kernel's turns follow turns of the same case: a much
    # faster kernel of one build, timed just before an unchanged one, made
    # the unchanged one read 3-8% slower in that build's turns.
    turns = [(case, fns) for case, fns in calls.items()]
    if workers:
        turns.append(("decode", None))
    # Each turn also runs every timed call once more and compares what it
    # returns with this checkout's first answer: bits equal, or the
    # largest difference (a race, or a change of arithmetic, shows here).
    outputs = {tag: {} for tag in trees}
    for case, fns in turns:
        if fns is not None:
            use("tree")
            first = {kernel: [t.clone() for t in fn()]
                     for kernel, fn in fns.items()}
        for r in range(args.rounds):
            for tag in ("base", "tree", "tree", "base"):
                use(tag)
                if fns is None:
                    turn = workers[tag].times()
                else:
                    turn = {f"{case}/{kernel}": chip_smoke.cuda_ms(fn)
                            for kernel, fn in fns.items()}
                    for kernel, fn in fns.items():
                        got = fn()
                        seen = outputs[tag].setdefault(
                            f"{case}/{kernel}",
                            dict(turns=0, differ=0, max_abs_diff=0.0))
                        seen["turns"] += 1
                        same = all(torch.equal(a, b)
                                   for a, b in zip(got, first[kernel]))
                        seen["differ"] += not same
                        if not same:
                            seen["max_abs_diff"] = max(
                                seen["max_abs_diff"],
                                *(float((a.float() - b.float()).nan_to_num()
                                        .abs().max())
                                  for a, b in zip(got, first[kernel])))
                    torch.cuda.synchronize()
                for key, ms in turn.items():
                    times[tag].setdefault(key, []).append(ms)
                print(json.dumps(dict(phase="turn", case=case, round=r,
                                      build=tag, ms=turn)), flush=True)
    for worker in workers.values():
        worker.close()
    medians = {key: dict(base=float(np.median(times["base"][key])),
                         tree=float(np.median(times["tree"][key])))
               for key in times["tree"]}
    for m in medians.values():
        m["tree_over_base"] = m["tree"] / m["base"]
    print(json.dumps(dict(phase="medians", rounds=args.rounds,
                          turns_per_build=2 * args.rounds, card=chip_smoke.smi(),
                          ms=medians, outputs_against_tree_first=outputs)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
