"""Timing harness.

Reference: the `test_time` lambda (Simulation/main3.cu:707-735): one warm-up
call, then geometric loop-doubling until at least `min_loop` seconds have
elapsed; report duration / loop_count.

jax dispatch is async, so every timed call must end in a completed
result: the chained harness makes each call *depend on the previous
call's output*, and both harnesses fetch one leaf of the final result to
host.
"""

from __future__ import annotations

import time
from typing import Callable, TypeVar

T = TypeVar("T")


def _fetch(x) -> None:
    """Force completion by copying one leaf to host."""
    import jax
    import numpy as np
    leaves = jax.tree_util.tree_leaves(x)
    if leaves:
        np.asarray(leaves[0])


def test_time_chained(fn: Callable[[T], T], init: T,
                      min_loop: float = 1.0, warmup: bool = True) -> float:
    """Average seconds per call of a chainable fn (state -> state).

    Loop-doubling as in the reference harness; calls are serialized by data
    dependency (each output is the next input), so device execution cannot
    be elided or reordered.
    """
    state = init
    if warmup:
        state = fn(state)
        _fetch(state)

    loop_counter = 0
    loop_n = 1
    begin = time.perf_counter()
    while True:
        for _ in range(loop_n):
            state = fn(state)
        _fetch(state)
        duration = time.perf_counter() - begin
        loop_counter += loop_n
        loop_n *= 2
        if duration >= min_loop:
            return duration / loop_counter


def test_time(fn: Callable[[], object], min_loop: float = 0.0,
              warmup: bool = True) -> float:
    """Average seconds per call of a nullary fn.

    The result of every call is fetched (one leaf) to guarantee completion;
    prefer :func:`test_time_chained` for hot-loop benchmarking since the
    per-call host fetch adds a fixed overhead here.
    """
    if warmup:
        _fetch(fn())

    loop_counter = 0
    loop_n = 1
    begin = time.perf_counter()
    while True:
        for _ in range(loop_n):
            _fetch(fn())
        duration = time.perf_counter() - begin
        loop_counter += loop_n
        loop_n *= 2
        if duration >= min_loop:
            return duration / loop_counter
