"""The device trace of a traced run: ``torch.profiler`` (CUPTI) around a
window the benchmark marks, reduced to what the per-layer metrics read.

The window is a host span named ``bench.window``, opened by ``start`` and
closed by ``stop`` after a device sync, so its ends are on the profiler's
own clock.  Every device activity (kernels, copies, sets) is clipped to
it.  ``busy_s`` is the union of those intervals, ``kernel_s`` their
summed time by name, and each idle gap is named by the innermost host
event under its midpoint (what the host was doing while the card
waited).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch

WINDOW = "bench.window"
# kernel families whose busy time (the union of their intervals) a trace
# keeps, matched in lower case: NCCL's collectives
FAMILIES = ("nccl",)


def _ns(event, end: bool = False) -> int:
    if hasattr(event, "start_ns"):
        return event.end_ns() if end else event.start_ns()
    return int((event.end_us() if end else event.start_us()) * 1000)


def _short(name: str) -> str:
    """A kernel's name without its return type, namespace of anonymous
    units and argument list, at most 100 characters."""
    name = name.replace("(anonymous namespace)::", "").strip()
    if name.startswith("void "):
        name = name[5:]
    return name.split("(")[0].strip()[:100]


def _annotation(event) -> bool:
    """A host span the profiler mirrors onto the device's timeline (the
    benchmark's own ``bench.*`` spans): no device activity."""
    flag = getattr(event, "is_user_annotation", None)
    return bool(flag and flag()) or event.name().startswith("bench.")


def union(intervals) -> list[tuple[int, int]]:
    """Sorted, merged (start, end) intervals."""
    out: list[list[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def covered(intervals) -> int:
    return sum(b - a for a, b in union(intervals))


@dataclass
class DeviceTrace:
    """What a traced window holds, in seconds."""
    window_s: float
    busy_s: float
    kernel_s: dict = field(default_factory=dict)     # short name -> s
    kernel_n: dict = field(default_factory=dict)     # short name -> count
    gaps: list = field(default_factory=list)         # [(host name, s)]
    parse_s: float = 0.0
    # name -> the time in which some kernel of that family ran (a union)
    union_s: dict = field(default_factory=dict)

    def seconds(self, match) -> float:
        """Summed device time of the kernels whose short name ``match``
        accepts."""
        return sum(s for n, s in self.kernel_s.items() if match(n))

    def count(self, match) -> int:
        return sum(c for n, c in self.kernel_n.items() if match(n))

    def breakdown(self) -> dict:
        ops = sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in self.gaps[:10]]}


class Tracer:
    """``start`` / ``stop`` around the traced window; ``result`` after."""

    def __init__(self):
        self._prof = None
        self._span = None
        self.result: DeviceTrace | None = None

    def start(self) -> None:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.start()
        self._span = torch.profiler.record_function(WINDOW)
        self._span.__enter__()

    def stop(self) -> DeviceTrace:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._span.__exit__(None, None, None)
        t0 = time.perf_counter()
        self._prof.stop()
        self.result = reduce(self._prof.profiler.kineto_results.events())
        self.result.parse_s = time.perf_counter() - t0
        self._prof = self._span = None
        return self.result


def reduce(events) -> DeviceTrace:
    """The window's device activity and host events, from kineto's raw
    events."""
    host, device = [], []
    w0 = w1 = None
    for e in events:
        a, b = _ns(e), _ns(e, end=True)
        if e.device_type() == torch.autograd.DeviceType.CPU:
            if e.name() == WINDOW:
                w0, w1 = a, b
            else:
                host.append((a, b, e.name()))
        elif b > a and not _annotation(e):
            device.append((a, b, _short(e.name())))
    if w0 is None:
        raise RuntimeError(f"the trace holds no {WINDOW} span")
    kernel_s, kernel_n, intervals = {}, {}, {}
    for a, b, name in device:
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        kernel_s[name] = kernel_s.get(name, 0.0) + (b - a) / 1e9
        kernel_n[name] = kernel_n.get(name, 0) + 1
        intervals.setdefault(name, []).append((a, b))
    busy = union(x for xs in intervals.values() for x in xs)
    gaps, prev = [], w0
    for a, b in busy + [(w1, w1)]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    gaps.sort(key=lambda g: g[0] - g[1])
    named = []
    for a, b in gaps[:10]:
        mid = (a + b) // 2
        under = [(hb - ha, n) for ha, hb, n in host if ha <= mid <= hb]
        named.append(["host: " + (min(under)[1] if under else "python"),
                      (b - a) / 1e9])
    families = {f: covered(x for n, xs in intervals.items()
                           if f in n.lower() for x in xs) / 1e9
                for f in FAMILIES}
    return DeviceTrace(window_s=(w1 - w0) / 1e9,
                       busy_s=sum(b - a for a, b in busy) / 1e9,
                       kernel_s=kernel_s, kernel_n=kernel_n, gaps=named,
                       union_s=families)
