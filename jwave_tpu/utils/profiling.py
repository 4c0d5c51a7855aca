"""Profiling & timing helpers.

The reference has no product tracing — only test-side System.nanoTime
wrappers (PerformanceTestUtils.java:72-140). This module provides this
library's observability: jax.profiler trace capture and a throughput timer
that is safe against async dispatch.
"""
from __future__ import annotations

import contextlib
import time

import jax


@contextlib.contextmanager
def trace(log_dir: str = "/tmp/jwave_tpu_trace"):
    """Capture a jax.profiler trace (view with TensorBoard / xprof)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


def time_fn(fn, *args, warmup: int = 2, iters: int = 10) -> float:
    """Mean seconds per call, blocking on device completion each iteration."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        jax.block_until_ready(fn(*args))
    return (time.perf_counter() - t0) / iters


def throughput(fn, *args, samples: int, **kw) -> float:
    """Msamples/s for a transform processing ``samples`` per call."""
    return samples / time_fn(fn, *args, **kw) / 1e6
