"""A traced block of calls, and its reduction to layers, busy time and gaps.

``traced_calls`` runs calls under ``torch.profiler`` with a range opened by
the harness around each decomposition and around each call into a layer
that ``layers.json`` names (a module attribute, patched for the block and
restored after it).  ``reduce_trace`` reads the profiler's Chrome trace: a
device operation (kernel, memcpy, memset) belongs to the innermost named
range around the host call that launched it (matched by the launch's
correlation id), or, where the trace holds no launch for it, to the
innermost device-side copy of a range around its start.  An idle gap is
named by the innermost host event around its middle.  Device time is
clipped to the traced window; busy time is the union of the device
intervals, so overlapping work is counted once.
"""

from __future__ import annotations

import bisect
import contextlib
import importlib
import json
import math
import os
import tempfile
import time
from collections import defaultdict

DECOMP_RANGE = "bench.decomposition"
WINDOW_RANGE = "bench.window"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
_HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
_NAME_CHARS = 120  # a kernel's demangled name, cut for the breakdown


@contextlib.contextmanager
def layer_ranges(layers: dict[str, list[str]]):
    """Patch each ``module:attr`` of ``layers`` (layer name -> targets) with
    a wrapper that opens a range named ``module.attr`` around the call."""
    import torch
    saved = []
    try:
        for targets in layers.values():
            for target in targets:
                mod_name, attr = target.split(":")
                mod = importlib.import_module(mod_name)
                fn = getattr(mod, attr)
                saved.append((mod, attr, fn))
                setattr(mod, attr, _ranged(torch, f"{mod_name}.{attr}", fn))
        yield
    finally:
        for mod, attr, fn in reversed(saved):
            setattr(mod, attr, fn)


def _ranged(torch, name: str, fn):
    def call(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)
    return call


def traced_calls(torch, calls, layers: dict[str, list[str]]) -> tuple[dict, float]:
    """Run each zero-argument call of ``calls`` under the profiler, a
    synchronize after each as in the window; return the reduced trace and
    the host seconds the reduction took."""
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize()
    with layer_ranges(layers), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW_RANGE):
            for call in calls:
                with record_function(DECOMP_RANGE):
                    call()
                torch.cuda.synchronize()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    names = {f"{t.replace(':', '.')}": layer
             for layer, targets in layers.items() for t in targets}
    return reduce_trace(events, names), time.perf_counter() - t0


class Timeline:
    """The innermost of a set of (name, start, end) spans at any instant,
    looked up by bisection: the spans, each holding its end, are swept once
    into a list of boundaries, each with the open span that started last
    from it on (the innermost where spans nest, as a thread's host events
    and the harness's ranges do)."""

    def __init__(self, spans):
        spans = list(spans)
        points = sorted([(sp[1], 1, -sp[2], i) for i, sp in enumerate(spans)]
                        + [(math.nextafter(sp[2], math.inf), 0, 0, i)
                           for i, sp in enumerate(spans)])
        self.times, self.spans = [], []
        stack, closed = [], set()
        for t, opens, _, i in points:
            if opens:
                stack.append(i)
            else:
                closed.add(i)
            while stack and stack[-1] in closed:
                stack.pop()
            top = spans[stack[-1]] if stack else None
            if self.times and self.times[-1] == t:
                self.spans[-1] = top
            else:
                self.times.append(t)
                self.spans.append(top)

    def at(self, t: float):
        """The innermost (name, start, end) that holds ``t``, or None."""
        i = bisect.bisect_right(self.times, t) - 1
        return self.spans[i] if i >= 0 else None


def _union(intervals):
    out = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return out


def reduce_trace(events: list[dict], names: dict[str, str]) -> dict:
    """Seconds of device time by layer, busy and window seconds, the top
    device operations and the idle gaps by what the host was doing.
    ``names`` maps a range's name to its layer; device time inside a
    decomposition but in no named range is ``other``, outside any
    decomposition ``outside``."""
    xs = [e for e in events if e.get("ph") == "X"]
    window = [e for e in xs if e.get("name") == WINDOW_RANGE
              and e.get("cat") == "user_annotation"]
    if not window:
        raise ValueError("the trace holds no window range")
    w0 = float(window[0]["ts"])
    w1 = w0 + float(window[0]["dur"])
    host_tid = window[0].get("tid")
    wanted = set(names) | {DECOMP_RANGE}
    host_ranges = defaultdict(list)
    device_ranges = []
    launches = {}
    host_events = []
    for e in xs:
        cat, name = e.get("cat"), e.get("name")
        start, end = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))
        if cat == "user_annotation" and name in wanted:
            host_ranges[e.get("tid")].append((name, start, end))
        elif cat == "gpu_user_annotation" and name in wanted:
            device_ranges.append((name, start, end))
        if cat in _LAUNCH_CATS and "correlation" in e.get("args", {}):
            launches[e["args"]["correlation"]] = e
        if cat in _HOST_CATS and e.get("tid") == host_tid and name != WINDOW_RANGE:
            host_events.append((name, start, end))

    host_lines = {tid: Timeline(spans) for tid, spans in host_ranges.items()}
    device_line = Timeline(device_ranges)
    layer_s = defaultdict(float)
    by_op = defaultdict(float)
    intervals = []
    unmatched = 0
    for e in xs:
        if e.get("cat") not in _DEVICE_CATS:
            continue
        start = max(float(e["ts"]), w0)
        end = min(float(e["ts"]) + float(e.get("dur", 0)), w1)
        if end <= start:
            continue
        launch = launches.get(e.get("args", {}).get("correlation"))
        if launch is not None:
            line = host_lines.get(launch.get("tid"))
            span = line.at(float(launch["ts"])) if line else None
        else:
            unmatched += 1
            span = device_line.at(float(e["ts"]))
        name = span[0] if span else None
        layer = names.get(name, "other" if name == DECOMP_RANGE else "outside")
        layer_s[layer] += (end - start) * 1e-6
        by_op[e.get("name", "?")[:_NAME_CHARS]] += (end - start) * 1e-6
        intervals.append((start, end))

    busy = _union(intervals)
    busy_s = sum(end - start for start, end in busy) * 1e-6
    gaps, prev = [], w0
    for start, end in busy:
        if start > prev:
            gaps.append((prev, start))
        prev = max(prev, end)
    if w1 > prev:
        gaps.append((prev, w1))
    host_line = Timeline(host_events)
    by_host = defaultdict(float)
    for start, end in gaps:
        span = host_line.at(0.5 * (start + end))
        by_host[span[0] if span else "host python"] += (end - start) * 1e-6
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"window_s": (w1 - w0) * 1e-6, "busy_s": busy_s,
            "layers": dict(layer_s), "device_ops": top(by_op),
            "idle_gaps": top(by_host), "unmatched": unmatched,
            "device_events": len(intervals)}
