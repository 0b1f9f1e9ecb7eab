"""Device profiling — per-op time breakdown of a jitted computation.

Replacement for the reference's chrono phase accumulators
(reference: serial_newblock_clock.cpp:24-35 — 12 global wall-clock counters
bracketing each pass; SURVEY.md §5): ``profile_fn`` captures a
``jax.profiler`` trace of one execution and aggregates device time per HLO
fusion, attributed back to Python source lines via the compiled module's
metadata.

The device's own events are picked by the running platform
(:func:`device_events`): on a GPU the ``/device:GPU:N`` planes, on the CPU
backend the XLA op events of the host plane.  A trace without device events
is an error, not an empty profile.
"""

from __future__ import annotations

import collections
import dataclasses
import glob
import gzip
import json
import os
import re
import tempfile
from typing import Callable, Sequence


@dataclasses.dataclass
class OpTime:
    name: str  #: HLO fusion name
    ms: float  #: device time
    source: str  #: "file:line (op_name)" when attributable
    bytes_accessed: int = 0

    def __str__(self) -> str:
        gbs = self.bytes_accessed / (self.ms * 1e-3) / 1e9 if self.ms else 0.0
        return f"{self.ms:9.2f} ms  {gbs:7.1f} GB/s  {self.name:<14} {self.source}"


@dataclasses.dataclass
class Profile:
    total_device_ms: float
    ops: list  #: list[OpTime], descending by time

    def top(self, n: int = 15) -> str:
        lines = [f"device total: {self.total_device_ms:.1f} ms"]
        lines += [str(o) for o in self.ops[:n]]
        return "\n".join(lines)

    def by_source(self) -> dict:
        agg = collections.defaultdict(float)
        for o in self.ops:
            agg[o.source or "?"] += o.ms
        return dict(sorted(agg.items(), key=lambda kv: -kv[1]))


def _source_map(compiled_text: str) -> dict:
    """fusion name -> 'file:line (op_name)' from compiled HLO metadata."""
    out = {}
    pat = re.compile(
        r"%(\S+?) = .*?metadata=\{[^}]*?op_name=\"([^\"]*)\""
        r"[^}]*?source_file=\"([^\"]*)\"[^}]*?source_line=(\d+)"
    )
    for m in pat.finditer(compiled_text):
        out[m.group(1)] = f"{os.path.basename(m.group(3))}:{m.group(4)} ({m.group(2).split('/')[-1]})"
    return out


def device_events(trace: dict, platform: str) -> list:
    """Complete ("X") events of the device that ran the program, from a
    Chrome-format trace.  ``platform`` is ``jax.Device.platform``: "gpu"
    keeps the ``/device:GPU:N`` processes (their stream lines: kernels, which
    name their HLO op, and memsets); "cpu" keeps the ``/host:CPU`` events
    that name an HLO op.  Raises ValueError when the trace has no such
    events."""
    evs = trace.get("traceEvents", [])
    pids = {
        e["pid"]: str(e.get("args", {}).get("name", ""))
        for e in evs
        if e.get("ph") == "M" and e.get("name") == "process_name"
    }
    xs = [e for e in evs if e.get("ph") == "X"]
    if platform == "gpu":
        dev = {p for p, n in pids.items() if n.startswith("/device:GPU:")}
        xs = [e for e in xs if e.get("pid") in dev]
    elif platform == "cpu":
        host = {p for p, n in pids.items() if n.startswith("/host:CPU")}
        xs = [e for e in xs if e.get("pid") in host and "hlo_op" in e.get("args", {})]
    else:
        raise ValueError(f"no device-plane rule for platform {platform!r}")
    if not xs:
        raise ValueError(f"trace has no {platform} device events")
    return xs


def reduce_trace(trace: dict, platform: str, srcmap: dict | None = None) -> "Profile":
    """Device time per op (HLO op name where the event carries one)."""
    agg = collections.Counter()
    abytes = collections.Counter()
    for e in device_events(trace, platform):
        args = e.get("args", {})
        name = args.get("hlo_op") or e["name"]
        agg[name] += e.get("dur", 0)
        try:
            abytes[name] += int(args.get("bytes_accessed", 0))
        except (TypeError, ValueError):
            pass
    srcmap = srcmap or {}
    ops = [
        OpTime(name=k, ms=v / 1e3, source=srcmap.get(k, ""), bytes_accessed=abytes[k])
        for k, v in agg.most_common()
    ]
    return Profile(total_device_ms=sum(o.ms for o in ops), ops=ops)


def profile_fn(fn: Callable, *args, fence: Callable | None = None, **kwargs) -> Profile:
    """Run ``fn(*args, **kwargs)`` once under a profiler trace and aggregate
    device-side op times.  ``fn`` should be jitted (or call jitted code);
    ``fence`` (default: ``jax.block_until_ready``) forces completion inside
    the trace window."""
    import shutil

    import jax

    # warm (compile outside the trace)
    out = fn(*args, **kwargs)
    _fence(out, fence)

    tmp = tempfile.mkdtemp(prefix="spmm_prof_")
    try:
        with jax.profiler.trace(tmp):
            out = fn(*args, **kwargs)
            _fence(out, fence)

        # source attribution via the jitted function's compiled text
        srcmap = {}
        if getattr(fn, "lower", None) is not None:
            try:
                srcmap = _source_map(fn.lower(*args, **kwargs).compile().as_text())
            except Exception:
                srcmap = {}

        traces = sorted(glob.glob(os.path.join(tmp, "plugins/profile/*/*.trace.json.gz")))
        if not traces:
            raise RuntimeError("jax.profiler wrote no trace")
        with gzip.open(traces[-1]) as f:
            d = json.load(f)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return reduce_trace(d, jax.devices()[0].platform, srcmap)


def _fence(out, fence):
    import jax

    if fence is not None:
        fence(out)
        return
    jax.block_until_ready(out)
