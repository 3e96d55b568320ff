"""SLO metrics of the serving stack (port of ``repro/serve/metrics.py``;
pure Python, the same arithmetic).

``ServeMetrics`` collects per-request lifecycle timestamps (submit, admit,
first token, finish) on whatever clock the scheduler runs — the
deterministic ``VirtualClock`` in the tests and ``chip_smoke.py``, so p50/p99
numbers are exact across machines — and derives the serving SLOs:

- TTFT  (time to first token): first_token_s - submit_s
- TPOT  (time per output token): (finish_s - first_token_s) / (n_out - 1)
- latency: finish_s - submit_s; queue_wait: admit_s - submit_s

plus throughput (completed output tokens / span), queue-depth and
concurrency samples, swappable-KV byte samples (``kv_bytes_report`` dense
vs compressed) and the reject count from bounded-queue backpressure.

``accounting()`` is the conservation check: every submitted request is
rejected, completed, or still in flight — none may vanish unreported.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


def percentile(values: list[float], pct: float) -> float:
    """Nearest-rank percentile (exact on small samples, no interpolation —
    deterministic across numpy versions)."""
    if not values:
        return 0.0
    xs = sorted(values)
    k = max(0, min(len(xs) - 1, int(round(pct / 100.0 * len(xs) + 0.5)) - 1))
    return float(xs[k])


@dataclasses.dataclass
class RequestRecord:
    rid: int
    submit_s: float
    prompt_len: int = 0
    max_new: int = 0
    admit_s: Optional[float] = None
    first_token_s: Optional[float] = None
    finish_s: Optional[float] = None
    n_out: int = 0
    evicted: bool = False      # hit max_seq before max_new tokens

    @property
    def ttft(self) -> Optional[float]:
        if self.first_token_s is None:
            return None
        return self.first_token_s - self.submit_s

    @property
    def tpot(self) -> Optional[float]:
        if self.finish_s is None or self.first_token_s is None:
            return None
        if self.n_out <= 1:
            return 0.0
        return (self.finish_s - self.first_token_s) / (self.n_out - 1)

    @property
    def latency(self) -> Optional[float]:
        if self.finish_s is None:
            return None
        return self.finish_s - self.submit_s

    @property
    def queue_wait(self) -> Optional[float]:
        if self.admit_s is None:
            return None
        return self.admit_s - self.submit_s


def format_slo_table(summary: dict) -> str:
    """Human-readable SLO summary table for the serving CLI (launch/serve) —
    virtual-clock seconds unless noted."""
    acct = summary["accounting"]
    rows = [
        ("completed", f"{summary['completed']}"),
        ("rejected (backpressure)", f"{acct['rejected']}"),
        ("evicted (hit max_seq)", f"{acct['evicted']}"),
        ("output tokens", f"{summary['output_tokens']}"),
        ("tokens/sec", f"{summary['tokens_per_s']:.1f}"),
        ("latency p50 / p99", f"{summary['latency_p50_s']:.4f}s / "
                              f"{summary['latency_p99_s']:.4f}s"),
        ("TTFT p50 / p99", f"{summary['ttft_p50_s']:.4f}s / "
                           f"{summary['ttft_p99_s']:.4f}s"),
        ("TPOT p50 / p99", f"{summary['tpot_p50_s']:.4f}s / "
                           f"{summary['tpot_p99_s']:.4f}s"),
        ("queue depth max / mean", f"{summary['queue_depth_max']} / "
                                   f"{summary['queue_depth_mean']:.1f}"),
        ("concurrency max / mean", f"{summary['concurrency_max']} / "
                                   f"{summary['concurrency_mean']:.1f}"),
    ]
    if summary.get("hbm"):
        h = summary["hbm"]
        rows.append(("HBM headroom vs dense",
                     f"{h['headroom_bytes']} B "
                     f"({h['peak_compressed_bytes']} vs "
                     f"{h['peak_dense_bytes']} B)"))
    w = max(len(k) for k, _ in rows)
    return "\n".join(f"  {k:<{w}}  {v}" for k, v in rows)


class ServeMetrics:
    """Event-driven collector; the scheduler calls the on_* methods as a
    request moves through its lifecycle and ``sample()`` once per step."""

    def __init__(self):
        self.records: dict[int, RequestRecord] = {}
        self.rejected: list[dict] = []
        self.queue_depth_samples: list[int] = []
        self.concurrency_samples: list[int] = []
        self.hbm_samples: list[dict] = []
        self._t0: Optional[float] = None
        self._t_end: float = 0.0

    # -- lifecycle events --------------------------------------------------
    def on_submit(self, rid: int, now: float, prompt_len: int,
                  max_new: int) -> None:
        now = float(now)
        if self._t0 is None:
            self._t0 = now
        self.records[rid] = RequestRecord(rid=int(rid), submit_s=now,
                                          prompt_len=int(prompt_len),
                                          max_new=int(max_new))

    def on_reject(self, rid: int, now: float, queue_depth: int) -> None:
        self.rejected.append({"rid": int(rid), "t_s": float(now),
                              "queue_depth": int(queue_depth)})

    def on_admit(self, rid: int, now: float) -> None:
        self.records[rid].admit_s = float(now)

    def on_token(self, rid: int, now: float) -> None:
        rec = self.records[rid]
        now = float(now)
        if rec.first_token_s is None:
            rec.first_token_s = now
        rec.n_out += 1
        self._t_end = max(self._t_end, now)

    def on_finish(self, rid: int, now: float, *,
                  evicted: bool = False) -> None:
        rec = self.records[rid]
        now = float(now)
        rec.finish_s = now
        rec.evicted = evicted
        self._t_end = max(self._t_end, now)

    def sample(self, queue_depth: int, concurrency: int,
               hbm: Optional[dict] = None) -> None:
        self.queue_depth_samples.append(int(queue_depth))
        self.concurrency_samples.append(int(concurrency))
        if hbm is not None:
            self.hbm_samples.append({"dense_bytes": int(hbm["dense_bytes"]),
                                     "compressed_bytes":
                                         int(hbm["compressed_bytes"])})

    # -- rollups -----------------------------------------------------------
    def accounting(self, expected: Optional[int] = None) -> dict:
        """Conservation check: every request the producer offered is either
        rejected (with a logged depth), completed, or still in flight.
        ``unaccounted`` compares the offered count (``expected``, e.g. the
        trace length) against what the collector saw — it must be 0, and a
        drained run must also show ``in_flight == 0`` (CI asserts both)."""
        completed = sum(1 for r in self.records.values()
                        if r.finish_s is not None)
        in_flight = len(self.records) - completed
        attempted = len(self.records) + len(self.rejected)
        return {
            "attempted": attempted,
            "submitted": len(self.records),
            "rejected": len(self.rejected),
            "completed": completed,
            "in_flight": in_flight,
            "evicted": sum(1 for r in self.records.values() if r.evicted),
            "unaccounted": (expected - attempted) if expected is not None
            else 0,
        }

    def summary(self, expected: Optional[int] = None) -> dict:
        done = [r for r in self.records.values() if r.finish_s is not None]
        lat = [r.latency for r in done]
        ttft = [r.ttft for r in done if r.ttft is not None]
        tpot = [r.tpot for r in done if r.tpot is not None]
        span = (self._t_end - self._t0) if (self._t0 is not None
                                            and self._t_end > self._t0) else 0.0
        out_tokens = sum(r.n_out for r in done)
        hbm = {}
        if self.hbm_samples:
            peak = max(self.hbm_samples,
                       key=lambda h: h["dense_bytes"])
            hbm = {
                "peak_dense_bytes": peak["dense_bytes"],
                "peak_compressed_bytes": peak["compressed_bytes"],
                "headroom_bytes": peak["dense_bytes"]
                - peak["compressed_bytes"],
            }
        return {
            "completed": len(done),
            "output_tokens": out_tokens,
            "span_s": span,
            "tokens_per_s": (out_tokens / span) if span else 0.0,
            "latency_p50_s": percentile(lat, 50),
            "latency_p99_s": percentile(lat, 99),
            "ttft_p50_s": percentile(ttft, 50),
            "ttft_p99_s": percentile(ttft, 99),
            "tpot_p50_s": percentile(tpot, 50),
            "tpot_p99_s": percentile(tpot, 99),
            "queue_depth_max": max(self.queue_depth_samples, default=0),
            "queue_depth_mean": (sum(self.queue_depth_samples)
                                 / len(self.queue_depth_samples))
            if self.queue_depth_samples else 0.0,
            "concurrency_max": max(self.concurrency_samples, default=0),
            "concurrency_mean": (sum(self.concurrency_samples)
                                 / len(self.concurrency_samples))
            if self.concurrency_samples else 0.0,
            "hbm": hbm,
            "accounting": self.accounting(expected),
        }
