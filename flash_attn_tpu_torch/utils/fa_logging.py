"""Leveled dispatch logging (counterpart of flash_attn_tpu/utils/fa_logging.py;
`FA_LOG_LEVEL`: 0/unset silent, 1 dispatch summaries, 2 verbose).

Besides logging, every `log_dispatch` call counts its (kind, route) in
`dispatch_counts`, so that a test or chip_smoke.py can see which routes a
run took."""

from __future__ import annotations

import collections
import logging
import os
import sys

_LOGGER = None

# (kind, route) -> number of calls
dispatch_counts: collections.Counter = collections.Counter()


def get_logger() -> logging.Logger:
    global _LOGGER
    if _LOGGER is None:
        lg = logging.getLogger("flash_attn_tpu_torch")
        level = int(os.environ.get("FA_LOG_LEVEL", "0") or "0")
        if level <= 0:
            lg.addHandler(logging.NullHandler())
            lg.setLevel(logging.CRITICAL)
        else:
            h = logging.StreamHandler(sys.stderr)
            h.setFormatter(logging.Formatter("[fa_torch] %(message)s"))
            lg.addHandler(h)
            lg.setLevel(logging.INFO if level == 1 else logging.DEBUG)
        _LOGGER = lg
    return _LOGGER


def log_dispatch(kind: str, **kv) -> None:
    dispatch_counts[(kind, kv.get("route"))] += 1
    lg = get_logger()
    if lg.isEnabledFor(logging.INFO):
        lg.info("%s %s", kind, " ".join(f"{k}={v}" for k, v in kv.items()))
