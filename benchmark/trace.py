"""The traced run's profile: `torch.profiler` over a few seconds in the
middle of the window, started and stopped between two calls, read in
memory (nothing is written to disk).

`Window.summarize` gives, for each card, the union of its operations'
spans (`busy_s`), of its kernels' spans (`kernel_busy_s`), the forwards
that ran there (the Rice cost-table kernel runs twice a forward) and the
kernel's mean time; and the `breakdown`: the device operations that took
most time, and the idle time of the cards by what the caller's thread was
doing (its ``FLACENC_TIMELINE=1`` spans: read, submit, drain; "other"
inside a call; "between_calls" outside one), with "+issue" where the
dispatch lane was issuing; gaps under 50 us, between the kernels of one
program, are "kernel_gaps".
"""

from __future__ import annotations

import bisect
import time
from typing import Dict, List

RICE_KERNEL = "rice_cost_tables"
# idle gaps shorter than this lie between the kernels of one program
KERNEL_GAP_NS = 50_000


class Window:
    def __init__(self, on_card: bool, settings: dict):
        self.on_card = on_card
        self.start_share = settings["start_share"]
        self.seconds = settings["profile_s"]
        self.prof = None
        self.t0 = self.t1 = None  # perf_counter of the profiled span
        self.offset_ns = None     # time_ns - perf_counter_ns
        self.done = False

    def prime(self) -> None:
        """One empty session in set-up: the first start of the device
        tracer takes seconds, which would otherwise fall in the window."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        if self.on_card:
            with profile(activities=[ProfilerActivity.CUDA]):
                torch.zeros(1, device="cuda").add_(1)
                torch.cuda.synchronize()

    def tick(self, elapsed: float, window: float) -> None:
        """Called before each call: starts or stops the profiler."""
        if self.done:
            return
        if self.prof is None and elapsed >= self.start_share * window:
            self._start()
        elif self.prof is not None and time.perf_counter() - self.t0 >= self.seconds:
            self.stop()

    def _start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CUDA] if self.on_card else [ProfilerActivity.CPU]
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.offset_ns = min(time.time_ns() - time.perf_counter_ns() for _ in range(5))
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        # no synchronize: a capture thread may be capturing, which a
        # device-wide synchronize would break
        if self.prof is None or self.done:
            return
        self.t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)
        self.done = True

    def _events(self):
        import torch

        want = torch.autograd.DeviceType.CUDA if self.on_card else torch.autograd.DeviceType.CPU
        lo = int(self.t0 * 1e9) + self.offset_ns
        hi = int(self.t1 * 1e9) + self.offset_ns
        out: Dict[int, list] = {}
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() != want:
                continue
            a = max(e.start_ns(), lo)
            b = min(e.start_ns() + e.duration_ns(), hi)
            if b > a:
                out.setdefault(e.device_index() if self.on_card else 0, []).append(
                    (a, b, e.name(), e.duration_ns()))
        return out, lo, hi

    def summarize(self, calls: List[dict]) -> dict:
        if not self.done:
            return {"cards": [], "window_s": None, "breakdown": {"device_ops": [], "idle_gaps": []}}
        events, lo, hi = self._events()
        labels = _CallerSpans(calls, self.offset_ns)
        cards, op_time, idle = [], {}, {}
        for card in sorted(events):
            evs = sorted(events[card])
            kernels = [e for e in evs if not e[2].startswith(("Memcpy", "Memset"))]
            rice = [e[3] for e in kernels if RICE_KERNEL in e[2]]
            busy, gaps = _union(evs, lo, hi)
            cards.append({"card": card, "busy_s": busy, "kernel_busy_s": _union(kernels, lo, hi)[0],
                          "forwards": len(rice) / 2, "rice_mean_s":
                          (sum(rice) / len(rice) / 1e9) if rice else None})
            for e in evs:
                op_time[e[2]] = op_time.get(e[2], 0.0) + (e[1] - e[0]) / 1e9
            for a, b in gaps:
                lab = "kernel_gaps" if b - a < KERNEL_GAP_NS else labels.at((a + b) // 2)
                idle[lab] = idle.get(lab, 0.0) + (b - a) / 1e9
        n = max(1, len(cards))
        top = sorted(op_time.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(((k, v / n) for k, v in idle.items()), key=lambda kv: -kv[1])[:10]
        return {"cards": cards, "window_s": (hi - lo) / 1e9,
                "breakdown": {"device_ops": [[k[:120], v] for k, v in top],
                              "idle_gaps": [[k, v] for k, v in gaps]}}


def _union(evs, lo: int, hi: int) -> tuple:
    """(seconds covered by the spans, [the gaps between lo and hi])."""
    busy, gaps, end = 0, [], lo
    for a, b, *_ in evs:
        if a > end:
            gaps.append((end, a))
        if b > end:
            busy += b - max(a, end)
            end = b
    if hi > end:
        gaps.append((end, hi))
    return busy / 1e9, gaps


class _CallerSpans:
    """What the caller's thread, and the dispatch lane, were doing at a
    time, from the calls' timelines (perf_counter stamps)."""

    def __init__(self, calls: List[dict], offset_ns: int):
        # the span rules of `overlap.analyze` and `overlap._issue_spans`
        self.offset_ns = offset_ns
        self.calls = [(c["t0"], c["t1"]) for c in calls]
        self.spans = []   # (start, end, label) of the caller
        self.issue = []   # (start, end) of the lane
        for c in calls:
            ev = sorted(c["stats"].get("timeline") or [], key=lambda e: e[2])
            open_t, packed, cursor = {}, {}, None
            for name, idx, t, *_ in ev:
                if name == "read_start":
                    open_t["read"] = t
                elif name == "read_done" and "read" in open_t:
                    self.spans.append((open_t.pop("read"), t, "read"))
                elif name == "submit":
                    open_t[("submit", idx)] = t
                elif name == "packed":
                    packed[idx] = t
                    if ("submit", idx) in open_t:
                        self.spans.append((open_t.pop(("submit", idx)), t, "submit"))
                elif name == "drain_start":
                    open_t["drain"] = t
                elif name == "drain_done" and "drain" in open_t:
                    self.spans.append((open_t.pop("drain"), t, "drain"))
                elif name == "issued" and idx in packed:
                    start = packed.pop(idx)
                    self.issue.append((start if cursor is None else max(start, cursor), t))
                    cursor = t

        self.spans.sort()
        self.issue.sort()
        self.starts = [s[0] for s in self.spans]
        self.issue_starts = [s[0] for s in self.issue]
        self.call_starts = [c[0] for c in self.calls]

    @staticmethod
    def _covering(spans, starts, t, back: int = 8) -> list:
        i = bisect.bisect_right(starts, t)
        return [s for s in spans[max(0, i - back):i] if s[0] <= t < s[1]]

    def at(self, ns: int) -> str:
        t = (ns - self.offset_ns) / 1e9
        # a drain may sit inside a submit: the innermost span names the time
        inside = self._covering(self.spans, self.starts, t)
        if inside:
            label = min(inside, key=lambda s: s[1] - s[0])[2]
        elif self._covering(self.calls, self.call_starts, t, 1):
            label = "other"
        else:
            label = "between_calls"
        if self._covering(self.issue, self.issue_starts, t):
            label += "+issue"
        return label


def bound_note(cfg: dict, per_card_batch: int) -> dict:
    """The least time of one forward and the class of work that sets it."""
    from . import roofline

    fmt = cfg["format"]
    work = roofline.forward_work(per_card_batch, fmt["channels"], cfg["block_size"],
                                 fmt["bits_per_sample"], cfg["encoder"])
    ms, cls = roofline.bound_ms(work)
    return {"forward_bound_ms": ms, "bound_by": cls}
