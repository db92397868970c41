"""Profiling harness — the reference's timer taxonomy on the accelerator.

The reference instruments phases (model_step/sw/tracers/sync pack/mpi/
unpack/wait, mpp.f90:37-52) and per-kernel times, printed at finalize.
On the accelerator the in-step phases live inside one XLA program, so the
equivalents are:

- :func:`trace`: wrap any region in a jax.profiler trace (XProf dump) —
  open with xprof/tensorboard to see per-fusion and per-collective times,
  the direct analog of the per-kernel table; named annotations keep the
  reference's taxonomy;
- :func:`time_fn`: steady-state wall timing with compile split off;
- :func:`comm_fraction_estimate`: halo-overlap accounting. The reference
  aspired to overlap sync with compute (_MPP_HYBRID_BLOCK_MODE_, dead);
  XLA schedules the ppermutes asynchronously, and the *measurable* is the
  step-time inflation of the sharded run vs the same-size unsharded run.
"""

from __future__ import annotations

import contextlib
import time

import jax


@contextlib.contextmanager
def trace(logdir: str, name: str = "step"):
    """jax.profiler trace around a region, with a named annotation."""
    with jax.profiler.trace(logdir):
        with jax.profiler.TraceAnnotation(name):
            yield


annotate = jax.profiler.TraceAnnotation


def time_fn(fn, *args, warmup: int = 1, reps: int = 5):
    """(compile_seconds, steady_seconds_per_call). ``fn`` must return
    something blockable."""
    t0 = time.perf_counter()
    out = fn(*args)
    jax.block_until_ready(out)
    compile_s = time.perf_counter() - t0
    for _ in range(max(0, warmup - 1)):
        out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return compile_s, (time.perf_counter() - t0) / reps


def comm_fraction_estimate(t_sharded: float, t_local: float) -> float:
    """Un-overlapped communication share of the sharded step: both times
    are per-step for the SAME per-device domain size; 0 means the halo
    exchange fully hides behind compute (the reference's unrealized
    hybrid-block goal), 1 means comm dominates."""
    if t_sharded <= t_local:
        return 0.0
    return (t_sharded - t_local) / t_sharded
