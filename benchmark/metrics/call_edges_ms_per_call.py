"""Milliseconds a call of the stream entry's work around its batches: the
``call.setup`` (runner and MD5 context made), ``call.close`` (runner closed,
MD5 worker joined), ``call.tail`` (the oracle's tail frame) and
``call.assemble`` (frames added, MD5 digest, report) spans of each call's
``stats["spans"]``, summed over the window's finished calls that carry
spans, over those calls: the time no caller span of the timeline covers."""

EDGES = ("call.setup", "call.close", "call.tail", "call.assemble")


def read(run):
    done = [c for c in run.calls if not c["error"] and c["stats"].get("spans") is not None]
    ns = [s["end_ns"] - s["start_ns"] for c in done for s in c["stats"]["spans"]
          if s["name"] in EDGES]
    if not done or not ns:
        return None
    return sum(ns) / 1e6 / len(done)
