"""Wall-clock helpers (counterpart of ``slcl_tpu/utils/timer.py``;
reference utils/timer.py:4-55) and a ``torch.profiler`` trace of a block.

``profile_trace(log_dir, cuda=...)`` records the block's CPU activity, and
the device's when ``cuda`` is true, and writes one Chrome-trace JSON,
``trace_<pid>_<n>.json``, under ``log_dir`` (``chrome://tracing`` or
Perfetto open it). With ``log_dir=None`` or ``""`` it does nothing, as the
JAX package's does.
"""
from __future__ import annotations

import contextlib
import functools
import itertools
import os
import time
from pathlib import Path
from typing import Dict, Optional

_TRACES = itertools.count()


def timeit(fn):
    """Print wall-clock of the wrapped call (reference @timer.timeit)."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        print(f"[timeit] {fn.__qualname__}: {time.perf_counter() - t0:.3f}s")
        return out
    return wrapper


class TimeChecker:
    """Named split-timer (reference timer.py:30-55)."""

    def __init__(self):
        self._t0 = time.perf_counter()
        self._splits: Dict[str, float] = {}

    def check(self, name: str) -> float:
        now = time.perf_counter()
        dt = now - self._t0
        self._splits[name] = self._splits.get(name, 0.0) + dt
        self._t0 = now
        return dt

    def summary(self) -> Dict[str, float]:
        return dict(self._splits)


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str] = None, cuda: bool = False):
    """A ``torch.profiler`` trace of the block, CUDA activity included when
    ``cuda``, exported to ``<log_dir>/trace_<pid>_<n>.json`` on exit;
    no-op when ``log_dir`` is None or empty."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    path = out / f"trace_{os.getpid()}_{next(_TRACES)}.json"
    prof.export_chrome_trace(str(path))
    print(f"profiler trace written to {path}")
