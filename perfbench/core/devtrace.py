"""The device trace of a traced window, read from torch.profiler: each
card's activity (kernels, copies, fills) as time intervals, the union of
them (busy time), the time of each named kernel, and the longest idle gaps
with what the host was doing then.  The arithmetic of busy against wall is
chip_smoke.py's `step_split` / `device_split`, with the union of
intervals in place of the sum of kernel times, so overlapping work on one
card is counted once."""
from __future__ import annotations

import dataclasses
import re
from collections import defaultdict
from typing import Dict, List, Tuple


@dataclasses.dataclass
class DeviceTrace:
    """`window_s`: the traced window's wall seconds (host clock, ending in
    a synchronize).  `intervals[d]`: (start_s, end_s, name) of every
    device activity on card d, sorted, in seconds from the window's start.
    `host[...]`: (start_s, end_s, name) of the host's profiled events, same
    clock.  `devices`: the cards the run uses (a card with no activity
    counts as idle)."""
    window_s: float
    intervals: Dict[int, List[Tuple[float, float, str]]]
    host: List[Tuple[float, float, str]]
    devices: Tuple[int, ...]

    def busy_s(self, device: int) -> float:
        """Seconds in which something ran on `device` (the union)."""
        return sum(b - a for a, b in _merged(self.intervals.get(device, [])))

    def idle_pct(self, device: int) -> float:
        return 100.0 * (1.0 - self.busy_s(device) / self.window_s)

    def mean_busy_s(self) -> float:
        return sum(self.busy_s(d) for d in self.devices) / len(self.devices)

    def kernels(self, names) -> Tuple[float, int]:
        """(device seconds, launches) of the kernels named in `names`
        (`__global__` function names, matched whole in the mangled or
        demangled symbol), over every card."""
        secs, n = 0.0, 0
        for ivs in self.intervals.values():
            for a, b, sym in ivs:
                if any(is_kernel(sym, k) for k in names):
                    secs += b - a
                    n += 1
        return secs, n

    def kernel_count(self) -> int:
        """Kernels of every card (copies and fills left out)."""
        return sum(1 for ivs in self.intervals.values() for _, _, sym in ivs
                   if not sym.startswith(("Memcpy", "Memset")))

    def top_ops(self, k: int = 10) -> List[list]:
        """[[name, seconds]] of the k device activities that took most time
        (summed by name, mean over the cards used)."""
        by = defaultdict(float)
        for ivs in self.intervals.values():
            for a, b, name in ivs:
                by[name] += b - a
        top = sorted(by.items(), key=lambda kv: -kv[1])[:k]
        return [[name[:120], secs / len(self.devices)] for name, secs in top]

    def idle_gaps(self, k: int = 10) -> List[list]:
        """[[what the host was doing, seconds]] of the k longest gaps on any
        card between device activities (and the window's ends): the
        innermost host event at the gap's middle names it."""
        gaps = []
        for d in self.devices:
            t = 0.0
            for a, b in _merged(self.intervals.get(d, [])) + [(self.window_s, self.window_s)]:
                if a > t:
                    gaps.append((a - t, t, a))
                t = max(t, b)
        gaps.sort(reverse=True)
        out = []
        for length, a, b in gaps[:k]:
            mid = 0.5 * (a + b)
            at = sorted((e - s, name) for s, e, name in self.host if s <= mid <= e)
            spans = [n[len("perfbench."):] for _, n in at if n.startswith("perfbench.")]
            ops = [n for _, n in at if not n.startswith("perfbench.")]
            what = " / ".join(x for x in (spans[0] if spans else "", ops[0] if ops else "")
                              if x) or "host"
            out.append([what[:120], length])
        return out


def is_kernel(symbol: str, kernel: str) -> bool:
    """Whether `symbol` (mangled or demangled) names the function `kernel`
    as a whole: wf_cull_kernel is not wf_cull_compact_kernel."""
    return (symbol.startswith(f"_Z{len(kernel)}{kernel}")
            or re.search(rf"(?<!\w){kernel}(?!\w)", symbol) is not None)


def _merged(ivs) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b, *_ in sorted(ivs):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def from_profile(prof, marker: str, devices) -> DeviceTrace:
    """The DeviceTrace of a finished torch.profiler.profile over the host
    span named `marker` (a record_function around the traced window, which
    ends in a synchronize): its start is time 0, its length the window;
    activity outside it is clipped off."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    events = prof.events()
    spans = [e for e in events if e.name == marker and e.device_type != cuda]
    if not spans:
        raise RuntimeError(f"the trace holds no span {marker!r}")
    t0 = min(e.time_range.start for e in spans)
    window_s = (max(e.time_range.end for e in spans) - t0) * 1e-6
    intervals: Dict[int, list] = defaultdict(list)
    host = []
    for e in events:
        a = max(0.0, (e.time_range.start - t0) * 1e-6)
        b = min(window_s, (e.time_range.end - t0) * 1e-6)
        if b <= a:
            continue
        if e.device_type == cuda:
            if getattr(e, "is_user_annotation", False) or e.name.startswith("perfbench."):
                continue   # a host span's shadow on the device timeline, not work
            intervals[int(e.device_index)].append((a, b, e.name))
        elif e.name != marker:
            host.append((a, b, e.name))
    for ivs in intervals.values():
        ivs.sort()
    return DeviceTrace(window_s=window_s, intervals=dict(intervals), host=host,
                       devices=tuple(devices))
