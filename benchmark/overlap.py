"""Where the wall of one streamed encode went, from its stage timeline
(``FLACENC_TIMELINE=1`` puts the runner's event stamps in
``stats["timeline"]``).

Frozen copy of `analyze` and `_issue_spans` of
``flacenc_tpu_torch/tools/overlap.py`` at commit 4f28b57, with its
rounding taken out. The
caller's thread is partitioned into read (read_start -> read_done), submit
CPU (submit -> packed), drain-blocked (drain_start -> drain_done) and the
rest; the issue (`issue_s`, the dispatch lane's busy seconds: a batch's
runs from `packed`, or from the end of the lane's previous task, to
`issued`) and the fetch walls overlap them.
"""

from __future__ import annotations

import numpy as np


def analyze(timeline, wall_s):
    """Classify the wall from the event stamps (see module docstring)."""
    ev = sorted(timeline, key=lambda e: e[2])
    spans = {"read": [], "submit": [], "drain": []}
    open_t = {}
    for e in ev:
        name, idx, t = e[0], e[1], e[2]
        if name == "read_start":
            open_t["read"] = t
        elif name == "read_done" and "read" in open_t:
            spans["read"].append((open_t.pop("read"), t))
        elif name == "submit":
            open_t[("submit", idx)] = t
        elif name == "packed" and ("submit", idx) in open_t:
            # close at the `packed` mark: the upload and launch follow it on
            # the dispatch lane, which stamps `issued` (on the caller's
            # thread only under FLACENC_INLINE_DISPATCH, then in "other"),
            # and `issued` would also take in the lane's queue
            spans["submit"].append((open_t.pop(("submit", idx)), t))
        elif name == "drain_start":
            open_t["drain"] = t
        elif name == "drain_done" and "drain" in open_t:
            spans["drain"].append((open_t.pop("drain"), t))
    # drain spans can nest INSIDE submit spans (submit() calls drain_one
    # at depth): subtract overlap so the classes partition the wall
    def total(key):
        return sum(b - a for a, b in spans[key])

    drain_in_submit = 0.0
    for a, b in spans["drain"]:
        for c, d in spans["submit"]:
            lo, hi = max(a, c), min(b, d)
            if hi > lo:
                drain_in_submit += hi - lo
    sub = {
        "read_s": total("read"),
        "submit_cpu_s": total("submit") - drain_in_submit,
        "drain_blocked_s": total("drain"),
    }
    sub["other_s"] = (
        wall_s - sub["read_s"] - sub["submit_cpu_s"]
        - sub["drain_blocked_s"]
    )
    # io-thread stage walls (overlap the above; reported for attribution)
    fetch = {}
    io = {"fetch_walls": [], "gtrip_walls": []}
    for e in ev:
        name, idx, t = e[0], e[1], e[2]
        if name == "fetch_start":
            fetch[idx] = t
        elif name == "fetch_done" and idx in fetch:
            io["fetch_walls"].append(t - fetch.pop(idx))
        elif name == "gtrip_start":
            # idx is a per-group id: concurrent group round trips must not
            # clobber each other's start stamps under one shared key
            fetch[("g", idx)] = t
        elif name == "gasm_done" and ("g", idx) in fetch:
            io["gtrip_walls"].append(t - fetch.pop(("g", idx)))
    sub["fetch_wall_mean_s"] = (
        float(np.mean(io["fetch_walls"])) if io["fetch_walls"] else None)
    sub["gtrip_wall_mean_s"] = (
        float(np.mean(io["gtrip_walls"])) if io["gtrip_walls"] else None)
    sub["n_fetches"] = len(io["fetch_walls"])
    sub["n_group_trips"] = len(io["gtrip_walls"])
    sub.update(_issue_spans(ev))
    return sub


def _issue_spans(ev) -> dict:
    """The issue's busy seconds from the time-ordered events (see the
    module docstring): the lane runs one task at a time in submit order, so
    a launch starts at its batch's `packed` mark or at the end of the
    lane's previous task, whichever is later; the launches of a partial
    group lie inside its round trip, so the spans are merged before they
    are summed."""
    packed, group, spans = {}, {}, []
    cursor = None  # where the lane's current task began, or its previous one ended
    for e in ev:
        name, idx, t = e[0], e[1], e[2]
        if name == "packed":
            packed[idx] = t
        elif name == "gtrip_start":
            group[idx] = cursor = t
        elif name == "issued" and idx in packed:
            start = packed.pop(idx)
            spans.append((start if cursor is None else max(start, cursor), t))
            cursor = t
        elif name == "gissued" and idx in group:
            spans.append((group.pop(idx), t))
            cursor = t
    busy, end = 0.0, None
    for a, b in sorted(spans):
        if end is not None:
            a = max(a, end)
        busy += max(0.0, b - a)
        end = b if end is None else max(end, b)
    return {"issue_s": busy, "n_issues": len(spans)}
