"""Reduction of a torch.profiler trace to what the per-layer metrics read:
the device's operations (kernels, copies, fills) with their intervals, the
host's spans, the union of device time, and the breakdown (the device
operations that took most time, and the longest idle gaps by what the host
was doing)."""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict

DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')
HOST_CATS = ('cpu_op', 'user_annotation', 'cuda_runtime', 'cuda_driver')


class Trace:
    """Events of one traced window: ``device`` and ``host`` are lists of
    (name, category, start us, duration us)."""

    def __init__(self, events):
        self.device, self.host = [], []
        for e in events:
            cat = e.get('cat', '')
            if e.get('ph') != 'X' or 'dur' not in e:
                continue
            rec = (e.get('name', ''), cat, float(e['ts']), float(e['dur']))
            if cat in DEVICE_CATS:
                self.device.append(rec)
            elif cat in HOST_CATS:
                self.host.append(rec)
        self.device.sort(key=lambda r: r[2])
        self.host.sort(key=lambda r: r[2])
        self._host_starts = [r[2] for r in self.host]

    @classmethod
    def from_profiler(cls, prof):
        """Read a finished torch.profiler.profile through its chrome trace,
        written to a temporary file and removed."""
        fd, path = tempfile.mkstemp(suffix='.json')
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                data = json.load(f)
        finally:
            os.remove(path)
        return cls(data['traceEvents'] if isinstance(data, dict) else data)

    def kernels(self, *patterns):
        """Kernel events whose name holds one of patterns (all without)."""
        return [r for r in self.device if r[1] == 'kernel'
                and (not patterns or any(p in r[0] for p in patterns))]

    def busy_s(self, events=None):
        """Seconds of the union of the events' intervals (default: every
        device operation), so overlapping launches count once."""
        return union_us(self.device if events is None else events) * 1e-6

    def gaps(self):
        """(start us, length us) of each idle stretch between device
        operations."""
        out, end = [], None
        for _, _, ts, dur in self.device:
            if end is not None and ts > end:
                out.append((end, ts - end))
            end = ts + dur if end is None else max(end, ts + dur)
        return out

    def host_at(self, t, look_back=500):
        """The host span running at time t (us) that started last, which
        is the innermost of nested spans, or 'host: no span'."""
        i = bisect.bisect_right(self._host_starts, t)
        for name, _, ts, dur in reversed(self.host[max(0, i - look_back):i]):
            if ts + dur >= t:
                return name
        return 'host: no span'

    def breakdown(self, top=10):
        """The device operations with the most time and the idle gaps
        summed by what the host was doing, each [[name, seconds], ...]."""
        ops = defaultdict(float)
        for name, _, _, dur in self.device:
            ops[short(name)] += dur * 1e-6
        idle = defaultdict(float)
        for start, length in sorted(self.gaps(), key=lambda g: -g[1])[:2000]:
            idle[short(self.host_at(start + length / 2))] += length * 1e-6
        first = sorted(ops.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
        return dict(device_ops=[list(kv) for kv in first],
                    idle_gaps=[list(kv) for kv in gaps])


def short(name, n=120):
    return name if len(name) <= n else name[:n - 3] + '...'


def union_us(events):
    total, end = 0.0, None
    for _, _, ts, dur in sorted(events, key=lambda r: r[2]):
        if end is None or ts > end:
            total += dur
            end = ts + dur
        elif ts + dur > end:
            total += ts + dur - end
            end = ts + dur
    return total
