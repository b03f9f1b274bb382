"""Measured sparse-vs-dense crossover (counterpart of
flash_attn_tpu/utils/sparse_crossover.py).

Whether to sparsify at all is the caller's call: sparse attention computes
a different function, and only the caller knows its accuracy budget. What
the port can say is where `sparse_attn_func` was measured faster than exact
dense attention (`flash_attn_func`, causal), so a caller can ask, and a
call outside that range is logged. Nothing here routes a call.

The JAX package's constants were fitted on a TPU v5e and are not kept.
These come from the `sparse_crossover` sweep of chip_smoke.py on an H100
(contexts 2048-32768, densities ~0.02-0.2, slash shares 0.3 and 0.7,
Mistral-7B widths; the table is in PERF.md), through `fit_crossover`. The
sweep's metadata is synthetic (chip_smoke.py `vs_metadata`: MInference's
candidate vertical/slash sizes, and where the slash diagonals lie drawn
at random), so the constants hold for that traffic only.
"""

from __future__ import annotations

import math
from typing import Iterable, Mapping

# Fitted by `fit_crossover` from the H100 sweeps (NVIDIA H100 80GB HBM3,
# 700 W; PERF.md). Sparse lost every cell at 2048 and 4096 keys and won from
# 8192 up to a density of 0.118 at both slash shares in every run; cells
# near 0.12-0.13 won in some runs and lost in others, and every cell from
# 0.24 lost. MAX_DENSITY is the least fit over the runs.
MIN_CONTEXT = 8192
MAX_DENSITY = 0.118
MIN_SLASH_FRAC = 0.3


def should_use_sparse(seqlen_k: int, density: float,
                      slash_frac: float = 1.0) -> bool:
    """True when vertical-slash sparse attention was measured faster than
    dense causal attention at this operating point (same batch and heads):
    a context of at least MIN_CONTEXT keys, a density (attended fraction of
    the sq x sk grid, as `metadata_density` counts it) of at most
    MAX_DENSITY, and a slash share of at least MIN_SLASH_FRAC."""
    return (seqlen_k >= MIN_CONTEXT and density <= MAX_DENSITY
            and slash_frac >= MIN_SLASH_FRAC)


def metadata_density(block_count, column_count, seqlen_q: int,
                     seqlen_k: int) -> float:
    """The fraction of the (b, h, sq, sk) grid the metadata attends, as the
    JAX package counts it: 64 x 64 per slash entry, 64 per vertical column.
    Reads the counts on the host."""
    b, h = block_count.shape[:2]
    attended = (int(block_count.sum()) * 64 * 64
                + int(column_count.sum()) * 64)
    return attended / max(b * h * seqlen_q * seqlen_k, 1)


def warn_if_slow(seqlen_k: int, density_hint) -> None:
    """A dispatch-log advisory (FA_LOG_LEVEL >= 1) when a sparse call lands
    outside the range where it was measured faster than dense attention."""
    if density_hint is None or should_use_sparse(seqlen_k, density_hint):
        return
    from flash_attn_tpu_torch.utils.fa_logging import log_dispatch

    log_dispatch("sparse", route="below-crossover", seqlen_k=seqlen_k,
                 density=round(density_hint, 4),
                 hint=f"sparse was measured faster than dense only at "
                      f"s >= {MIN_CONTEXT} and density <= {MAX_DENSITY} "
                      f"(PERF.md)")


def fit_crossover(cells: Iterable[Mapping]) -> dict:
    """Constants for `should_use_sparse` from sweep cells, each a mapping
    with seqlen_k, density, slash_frac and speedup (dense ms / sparse ms):
    MIN_CONTEXT the least context at which some cell wins (speedup > 1);
    then, over contexts at or above it, MIN_SLASH_FRAC the least slash share
    whose cells win at the lowest density of every context, and MAX_DENSITY
    the largest winning density below every losing one, among those
    contexts and slash shares, floored to 3 decimals. Returns {} when no
    cell wins."""
    cells = list(cells)
    wins = [c for c in cells if c["speedup"] > 1.0]
    if not wins:
        return {}
    min_context = min(c["seqlen_k"] for c in wins)
    above = [c for c in cells if c["seqlen_k"] >= min_context]
    contexts = sorted({c["seqlen_k"] for c in above})
    shares = sorted({c["slash_frac"] for c in above})

    def lowest_wins(share):
        for s in contexts:
            at = [c for c in above if c["seqlen_k"] == s
                  and c["slash_frac"] == share]
            if at and min(at, key=lambda c: c["density"])["speedup"] <= 1.0:
                return False
        return True

    winning = [s for s in shares if lowest_wins(s)]
    if not winning:
        return dict(MIN_CONTEXT=min_context)
    min_share = min(winning)
    kept = [c for c in above if c["slash_frac"] >= min_share]
    losing = [c["density"] for c in kept if c["speedup"] <= 1.0]
    won = [c["density"] for c in kept if c["speedup"] > 1.0
           and all(c["density"] < d for d in losing)]
    return dict(MIN_CONTEXT=min_context, MIN_SLASH_FRAC=min_share,
                MAX_DENSITY=math.floor(1000 * max(won)) / 1000 if won else 0.0)
