"""Repository-wide pytest hooks: start the longest test files first.

Under `pytest -n N --dist loadfile`, xdist hands out whole files, by
default in descending order of test count. The suite's long files are not
its many-test ones: `tests/test_engine.py` (16 tests) runs about as long
as a whole worker's share of everything else, and a few other JAX-only
files each run for several minutes. Handed out late, they end the run long
after the other workers are idle. So xdist keeps the collected order here,
and the collection puts LONG_FILES first, longest first (their seconds of
worker time in a timed 6-worker run of the suite: 1219, 680, 592, 436,
350, 344, 301); every other file keeps its place.
"""

LONG_FILES = (
    "tests/test_engine.py",
    "tests/test_parallel.py",
    "tests/test_quant.py",
    "tests/test_varlen.py",
    "tests/test_engine_tp.py",
    "tests/test_feature_matrix.py",
    "tests/test_gpt.py",
)


def pytest_configure(config):
    # Set only where xdist registered the option (a run with -p xdist).
    if hasattr(config.option, "loadscopereorder"):
        config.option.loadscopereorder = False


def pytest_collection_modifyitems(session, config, items):
    rank = {name: i for i, name in enumerate(LONG_FILES)}
    # A stable sort: LONG_FILES in their order, then everything else as
    # collected.
    items.sort(key=lambda it: rank.get(it.nodeid.split("::")[0],
                                       len(LONG_FILES)))
