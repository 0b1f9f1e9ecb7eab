"""Wall-clock measurement harness.

Equivalent of the reference's chrono phase accumulators
(reference: serial_newblock_clock.cpp:24-35, per-phase brackets; SURVEY.md §5):
device timings use ``block_until_ready`` fences, separate compile (first call)
from steady state, and report medians over several iterations.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Sequence


@dataclasses.dataclass
class Timing:
    name: str
    compile_ms: float
    median_ms: float
    min_ms: float
    iters: int

    def __str__(self) -> str:
        return (
            f"{self.name}: {self.median_ms:.3f} ms median "
            f"(min {self.min_ms:.3f}, compile {self.compile_ms:.1f}, n={self.iters})"
        )


def _ready(x):
    """Block until the computation behind ``x`` has finished."""
    import jax

    return jax.block_until_ready(x)


def measure(fn: Callable, *args, name: str = "fn", warmup: int = 1, iters: int = 5) -> Timing:
    """Times ``fn(*args)`` on device: first call = compile+run, then ``warmup``
    discarded runs, then ``iters`` timed runs."""
    t0 = time.perf_counter()
    _ready(fn(*args))
    compile_ms = (time.perf_counter() - t0) * 1e3
    for _ in range(warmup):
        _ready(fn(*args))
    samples = []
    for _ in range(iters):
        t0 = time.perf_counter()
        _ready(fn(*args))
        samples.append((time.perf_counter() - t0) * 1e3)
    samples.sort()
    return Timing(
        name=name,
        compile_ms=compile_ms,
        median_ms=samples[len(samples) // 2],
        min_ms=samples[0],
        iters=iters,
    )


def measure_device_loop(
    step: Callable,
    init,
    consts: tuple = (),
    *,
    name: str = "fn",
    iters: int = 16,
    repeats: int = 3,
) -> Timing:
    """Per-iteration device time of ``step`` with dispatch cancelled out.

    ``step(carry, *consts) -> carry`` must chain a data dependence (e.g. fold
    a full reduction of the output back into the next input) so XLA executes
    the iterations sequentially and cannot dead-code-eliminate them.  We jit
    ``fori_loop(0, n, step)`` for n=1 and n=iters and report
    (t_iters - t_1) / (iters - 1), which cancels the per-call dispatch and
    synchronization.  This is device time, not end-to-end time.

    Pass every large device array via ``consts`` (jit arguments), NOT closure
    capture — captured arrays are embedded as constants in the program.

    The trip count is a TRACED argument so n=1 and n=iters share ONE compiled
    program (fori_loop with a dynamic bound lowers to while_loop).
    """
    import jax
    import jax.numpy as jnp

    @jax.jit
    def run_(n, c, *ks):
        return jax.lax.fori_loop(0, n, lambda i, cc: step(cc, *ks), c)

    n1 = jnp.int32(1)
    nN = jnp.int32(iters)
    run1 = lambda c: run_(n1, c, *consts)
    runN = lambda c: run_(nN, c, *consts)
    t0 = time.perf_counter()
    _ready(run1(init))
    _ready(runN(init))
    compile_ms = (time.perf_counter() - t0) * 1e3
    samples = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        _ready(run1(init))
        t1 = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        _ready(runN(init))
        tN = (time.perf_counter() - t0) * 1e3
        samples.append(max((tN - t1) / (iters - 1), 0.0))
    samples.sort()
    return Timing(
        name=name,
        compile_ms=compile_ms,
        median_ms=samples[len(samples) // 2],
        min_ms=samples[0],
        iters=iters * repeats,
    )


def measure_host(fn: Callable, *args, name: str = "fn", iters: int = 3) -> Timing:
    """Times a host-side function (no device fences); min over iters."""
    samples = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args)
        samples.append((time.perf_counter() - t0) * 1e3)
    samples.sort()
    return Timing(
        name=name,
        compile_ms=0.0,
        median_ms=samples[len(samples) // 2],
        min_ms=samples[0],
        iters=iters,
    )
