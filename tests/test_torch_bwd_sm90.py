"""The dense backward's Hopper kernels (csrc/flash_bwd_sm90.cuh, kernels 2
and 3), on the CPU.

The kernels run only on the card, where chip_smoke.py holds them against
their plain versions. Here: `bwd_walks`, the plain mirror of their tile
walks, visits every visible (query head, row, key) pair exactly once per
kernel (and its tile constants are the kernels'); the backward's TMA copy
rule; and the plain backward, which the kernels are held to, against the
JAX package's backward in interpret mode."""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attn_tpu.kernels.flash_bwd import (
    flash_attention_bwd as jax_flash_attention_bwd,
)
from flash_attn_tpu.kernels.flash_fwd import (
    flash_attention_fwd as jax_flash_attention_fwd,
)
from flash_attn_tpu_torch.kernels import flash_bwd
from flash_attn_tpu_torch.kernels.common import normalize_window, visible_mask
from flash_attn_tpu_torch.kernels.flash_fwd import (
    flash_attention_fwd_ref,
    tma_ready,
)

HEADER = os.path.join(os.path.dirname(flash_bwd.__file__), os.pardir, "csrc",
                      "flash_bwd_sm90.cuh")

# (sq, sk, h, hk, d, causal, window_size, softcap): lengths off the
# 64/128 tiles.
WALK_CASES = {
    "causal-group1": (300, 300, 2, 2, 64, True, (-1, -1), 0.0),
    "window127-group4": (520, 520, 4, 1, 128, True, (127, -1), 0.0),
    "window4095-group8": (700, 700, 8, 1, 64, True, (4095, -1), 0.0),
    "causal-sq-lt-sk": (200, 333, 4, 1, 128, True, (-1, -1), 0.0),
    "causal-sq-gt-sk-softcap": (500, 130, 2, 2, 64, True, (-1, -1), 30.0),
    "noncausal-group8": (90, 200, 8, 1, 128, False, (-1, -1), 0.0),
    "two-sided-window": (400, 400, 4, 2, 64, False, (64, 32), 0.0),
}


@pytest.mark.parametrize("case", list(WALK_CASES))
def test_walks_visit_each_visible_pair_once(case):
    sq, sk, h, hk, d, causal, window, softcap = WALK_CASES[case]
    group = h // hk
    dkv, dq = flash_bwd.bwd_walks(sq, sk, h, hk, d, causal, window, softcap)
    visible = visible_mask(sq, sk, normalize_window(window, causal),
                           torch.device("cpu")).numpy()
    rows, tile = flash_bwd.BLOCK_ROWS, flash_bwd.walk_tile(d, softcap)

    # dK/dV: (key block, kv head, query head, first row); the query head
    # belongs to the block's kv head, blocks in grid order.
    assert all(head // group == g for _, g, head, _ in dkv)
    assert [kb for kb, *_ in dkv] == sorted(kb for kb, *_ in dkv)
    count = np.zeros((h, sq, sk), np.int64)
    for kb, _, head, r0 in dkv:
        count[head, r0:r0 + tile, kb * rows:(kb + 1) * rows] += 1
    assert count.max() <= 1
    assert (count[:, visible] == 1).all()

    # dQ: (query block, query head, first key) of one pass, the last
    # query blocks first.
    blocks = [mb for mb, *_ in dq]
    assert blocks == sorted(blocks, reverse=True)
    count = np.zeros((h, sq, sk), np.int64)
    for mb, head, k0 in dq:
        count[head, mb * rows:(mb + 1) * rows, k0:k0 + tile] += 1
    assert count.max() <= 1
    assert (count[:, visible] == 1).all()


def test_walk_constants_are_the_kernels():
    """BLOCK_ROWS and walk_tile mirror the header's constants."""
    with open(HEADER) as f:
        src = f.read()
    groups = int(re.search(r"constexpr int kWarpgroups = (\d+);", src).group(1))
    rows = re.search(r"constexpr int kBlockRows = (\d+) \* kWarpgroups;", src)
    assert int(rows.group(1)) * groups == flash_bwd.BLOCK_ROWS
    tile = re.search(r"return d == 64 && !softcap \? (\d+) : (\d+);", src)
    wide, narrow = int(tile.group(1)), int(tile.group(2))
    assert flash_bwd.walk_tile(64, False) == wide
    assert {flash_bwd.walk_tile(64, True), flash_bwd.walk_tile(128, False),
            flash_bwd.walk_tile(128, True)} == {narrow}


def _strided(shape, pad, offset):
    """A (b, h, s, d) tensor whose last dim lies `offset` elements into rows
    of d + pad elements."""
    b, h, s, d = shape
    base = torch.zeros(b, h, s, d + pad, dtype=torch.bfloat16)
    return base[..., offset:offset + d]


# (tensor, copied): a (b, s, h, d) view taken as it is; a base 2 bytes off
# 16, copied; a broadcast (stride 0) head dimension, copied.
TMA_CASES = {
    "bshd-view": (lambda: torch.zeros(2, 100, 4, 64,
                                      dtype=torch.bfloat16).transpose(1, 2),
                  False),
    "base-off-16": (lambda: _strided((2, 4, 100, 64), 8, 1), True),
    "broadcast-heads": (lambda: torch.zeros(2, 1, 100, 64, dtype=torch.bfloat16)
                        .expand(2, 4, 100, 64), True),
}


@pytest.mark.parametrize("case", list(TMA_CASES))
def test_backward_tma_rule(case):
    make, copied = TMA_CASES[case]
    t = make()
    flash_bwd.flash_attention_bwd.tma_copies = 0
    got = tma_ready(t, flash_bwd.flash_attention_bwd)
    assert (got is not t) == copied
    assert flash_bwd.flash_attention_bwd.tma_copies == int(copied)
    assert torch.equal(got, t)
    if copied:
        assert got.is_contiguous() and got.data_ptr() % 16 == 0
    flash_bwd.flash_attention_bwd.tma_copies = 0


def test_backward_stats_alignment():
    """An LSE or delta whose base is off 16 bytes is copied for the
    kernels' 1-D tensor maps, and counted; an aligned one is not."""
    flash_bwd.flash_attention_bwd.tma_copies = 0
    buf = torch.arange(2 * 4 * 100 + 1, dtype=torch.float32)
    aligned = buf[:800].view(2, 4, 100)
    assert flash_bwd._stats_ready(aligned) is aligned
    off = buf[1:].view(2, 4, 100)
    got = flash_bwd._stats_ready(off)
    assert got is not off and got.data_ptr() % 16 == 0
    assert torch.equal(got, off)
    assert flash_bwd.flash_attention_bwd.tma_copies == 1
    flash_bwd.flash_attention_bwd.tma_copies = 0


def test_plain_backward_matches_jax():
    """The port's plain backward (what the kernels are held to on the card;
    delta = sum_j P dP) against the JAX package's (Pallas in interpret mode;
    delta = rowsum(dO * O)) on a GQA window case off the tiles, fp32: the
    two differ only in summation order."""
    b, h, hk, sq, sk, d = 1, 4, 1, 200, 260, 64
    kw = dict(causal=True, window_size=(127, -1))
    rng = np.random.default_rng(8)
    q, do = (rng.standard_normal((b, h, sq, d)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((b, hk, sk, d)).astype(np.float32)
            for _ in range(2))

    @jax.jit
    def jax_bwd(q, k, v, do):
        out, lse = jax_flash_attention_fwd(q, k, v, **kw)
        return jax_flash_attention_bwd(q, k, v, out, lse, do, **kw), lse

    want, lse_j = jax_bwd(*map(jnp.asarray, (q, k, v, do)))
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    _, lse = flash_attention_fwd_ref(tq, tk, tv, **kw)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), rtol=1e-5,
                               atol=1e-5)
    got = flash_bwd.flash_attention_bwd(tq, tk, tv, lse, tdo, **kw)
    for g, w in zip(got, want[:3]):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max())
