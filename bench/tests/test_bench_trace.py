"""The trace reduction on a hand-made Chrome trace."""

import pytest

from bench import devtrace

NAMES = {"repro_torch.core.projection.sketch": "projection",
         "torch.linalg.qr": "linalg"}


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, "pid": 1, "args": args}


def _events():
    return [
        _x("user_annotation", devtrace.WINDOW_RANGE, 0, 100),
        _x("user_annotation", devtrace.DECOMP_RANGE, 0, 90),
        _x("user_annotation", "repro_torch.core.projection.sketch", 5, 10),
        _x("user_annotation", "torch.linalg.qr", 20, 10),
        _x("cpu_op", "aten::matmul", 40, 5),
        # launches on the host, then their device work
        _x("cuda_runtime", "cudaLaunchKernel", 6, 1, correlation=1),
        _x("cuda_runtime", "cudaLaunchKernel", 21, 1, correlation=2),
        _x("cuda_runtime", "cudaLaunchKernel", 41, 1, correlation=3),
        _x("kernel", "fused_kernel", 10, 20, tid=7, correlation=1),
        _x("kernel", "geqrf", 25, 15, tid=7, correlation=2),  # overlaps
        _x("kernel", "gemm", 50, 10, tid=7, correlation=3),
        # no launch in the trace: the device-side range decides
        _x("gpu_user_annotation", "torch.linalg.qr", 60, 30, tid=7),
        _x("gpu_memcpy", "Memcpy DtoD", 70, 5, tid=7, correlation=99),
        # outside the window: clipped away
        _x("kernel", "late", 150, 5, tid=7, correlation=4),
    ]


def test_layers_busy_and_gaps():
    t = devtrace.reduce_trace(_events(), NAMES)
    assert t["window_s"] == pytest.approx(100e-6)
    assert t["layers"]["projection"] == pytest.approx(20e-6)
    assert t["layers"]["linalg"] == pytest.approx(20e-6)
    assert t["layers"]["other"] == pytest.approx(10e-6)
    # union: [10, 40] + [50, 60] + [70, 75] = 45 us
    assert t["busy_s"] == pytest.approx(45e-6)
    assert t["unmatched"] == 1 and t["device_events"] == 4
    gaps = dict(t["idle_gaps"])
    # [0, 10] starts in the decomposition's range; [40, 50] in aten::matmul
    assert gaps["aten::matmul"] == pytest.approx(10e-6)
    assert sum(gaps.values()) == pytest.approx(55e-6)
    assert t["device_ops"][0] == ["fused_kernel", pytest.approx(20e-6)]


def test_no_window_raises():
    with pytest.raises(ValueError):
        devtrace.reduce_trace(_events()[1:], NAMES)


def test_layer_ranges_patch_and_restore():
    import torch
    before = torch.linalg.qr
    with devtrace.layer_ranges({"linalg": ["torch.linalg:qr"]}):
        assert torch.linalg.qr is not before
        q, _ = torch.linalg.qr(torch.eye(3))
        assert torch.equal(q.abs(), torch.eye(3))
    assert torch.linalg.qr is before


def _innermost_by_scan(spans, t):
    best = None
    for name, start, end in spans:
        if start <= t <= end and (best is None or end - start < best[2] - best[1]):
            best = (name, start, end)
    return best


def test_timeline_is_the_innermost_span():
    import random
    rng = random.Random(5)
    spans = []

    def nest(lo, hi, depth):
        t = lo
        while t < hi and depth < 4:
            a = t + rng.randint(0, 3)
            b = min(hi, a + rng.randint(0, 12))
            if a >= hi:
                break
            spans.append((f"s{len(spans)}", float(a), float(b)))
            nest(a, b, depth + 1)
            t = b + rng.randint(1, 2)  # siblings do not touch
    nest(0, 200, 0)
    line = devtrace.Timeline(spans)
    for k in range(0, 2010):
        t = k / 10
        got, want = line.at(t), _innermost_by_scan(spans, t)
        assert (got is None) == (want is None), t
        if want is not None:
            assert got[2] - got[1] == want[2] - want[1], (t, got, want)


def test_timeline_holds_ends_and_adjacent_spans():
    line = devtrace.Timeline([("a", 0.0, 10.0), ("b", 10.0, 20.0),
                              ("c", 12.0, 15.0)])
    assert line.at(-1.0) is None and line.at(21.0) is None
    assert line.at(5.0)[0] == "a" and line.at(10.0)[0] == "b"
    assert line.at(15.0)[0] == "c" and line.at(16.0)[0] == "b"
    assert line.at(20.0)[0] == "b"
