"""Repository-wide pytest hooks: order the test files for xdist, and give
each xdist worker's torch its share of the cores.

Under `pytest -n N --dist loadfile`, xdist hands out whole files, by
default in descending order of test count. The suite's long files are not
its many-test ones: `tests/test_engine.py` (16 tests) runs about as long
as a whole worker's share of everything else, and many other JAX-only
files each run for several minutes. So xdist keeps the collected order
here, and the collection puts LONG_FILES first, longest first, then every
file not named here in collected order (short ones: they fill the workers
while the longest run), then LATE_FILES, longest first, which even out the
workers' ends. Worker seconds in two timed 6-worker runs on 8 cores (a slow
hour; the whole runs 1925 and 1721 s): LONG_FILES 1629/1530, 726/648,
685/573, 413/513, 450/406, 441/385; LATE_FILES 312-525 down to 105-137.
Replayed over those file times, this order ends the run 5-14% sooner than
the seven-file order it replaces, and a run cut at its time limit loses a
few tests of long files, not many short ones (as when every long file
comes first).
"""

import os

LONG_FILES = (
    "tests/test_engine.py",
    "tests/test_quant.py",
    "tests/test_parallel.py",
    "tests/test_varlen.py",
    "tests/test_engine_tp.py",
    "tests/test_feature_matrix.py",
)
LATE_FILES = (
    "tests/test_zero.py",
    "tests/test_gpt.py",
    "tests/test_kvcache.py",
    "tests/test_headdim_v.py",
    "tests/test_sparse_and_mods.py",
    "tests/test_flash_attn.py",
    "tests/test_flash_attn_bwd.py",
    "tests/test_attention_chunk.py",
    "tests/test_training.py",
    "tests/test_block_sparsity.py",
    "tests/test_speculative.py",
    "tests/test_vllm_compat.py",
    "tests/test_varlen_mods.py",
    "tests/test_bert_vit.py",
    "tests/test_multihost.py",
    "tests/test_mask_mod_library.py",
)


def pytest_configure(config):
    # Set only where xdist registered the option (a run with -p xdist).
    if hasattr(config.option, "loadscopereorder"):
        config.option.loadscopereorder = False
    _share_cores()


def _share_cores():
    """In an xdist worker, give torch its share of the cores: with one
    intra-op thread per core in each of the N workers, the port's tests ran
    3.2x their serial time under `-n 6` on 8 cores (1370 s of worker time
    against 433 s alone) and slowed the JAX files beside them; alone, one
    thread costs them 1.17x (508.6 against 433.0 s)."""
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if workers:
        import torch

        torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(workers)))


def pytest_collection_modifyitems(session, config, items):
    rank = {name: i for i, name in enumerate(LONG_FILES)}
    rank.update({name: len(LONG_FILES) + 1 + i
                 for i, name in enumerate(LATE_FILES)})
    # A stable sort: LONG_FILES in their order, everything else as
    # collected, then LATE_FILES in their order.
    items.sort(key=lambda it: rank.get(it.nodeid.split("::")[0],
                                       len(LONG_FILES)))
