"""Wall-clock timers and profiling hooks.

Counterpart of `puflow_tpu.utils.timers`: `ElapseTimer`, `context_timer`
and `func_timer` are host wall clocks, as there (a CUDA launch returns
before the card is done: synchronise inside the timed block to time
device work). `profile_trace` records a `torch.profiler` trace where the
JAX package records a `jax.profiler` one.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time

import torch


class ElapseTimer:
    """Accumulating stopwatch: start()/stop() pairs, total in seconds."""

    def __init__(self):
        self.total = 0.0
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()
        return self

    def stop(self) -> float:
        if self._t0 is None:
            return self.total
        self.total += time.perf_counter() - self._t0
        self._t0 = None
        return self.total

    def reset(self):
        self.total, self._t0 = 0.0, None


@contextlib.contextmanager
def context_timer(label: str = "", log_fn=print):
    t0 = time.perf_counter()
    yield
    log_fn(f"{label or 'block'}: {time.perf_counter() - t0:.4f}s")


def func_timer(fn=None, *, log_fn=print):
    """Decorator printing each call's wall time."""
    def deco(f):
        @functools.wraps(f)
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            out = f(*args, **kwargs)
            log_fn(f"{f.__name__}: {time.perf_counter() - t0:.4f}s")
            return out
        return wrapper
    return deco(fn) if fn is not None else deco


@contextlib.contextmanager
def profile_trace(logdir: str):
    """Record a `torch.profiler` trace of the block, host and (where there
    is a card) CUDA activity, into ``logdir/trace.json`` (Chrome trace
    format: chrome://tracing, Perfetto, or TensorBoard's profiler).

    Usage: ``with profile_trace('runs/trace') as prof: step(...)``; ``prof``
    is the `torch.profiler.profile` (``prof.key_averages()``). The trace
    is written when the block ends, also when it raises; the exception
    then propagates (the JAX package's version swallows it).

    Seen on an H100 with torch 2.11: once a process has run CUDA child
    processes, each trace it records lacks its first kernel records, one
    for each such child; launch a few throwaway kernels first where every
    kernel of the block must be in the trace.
    """
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    try:
        with prof:
            yield prof
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    finally:
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
