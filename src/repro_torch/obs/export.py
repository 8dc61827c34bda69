"""Trace exporters: Chrome trace-event JSON, per-request timelines (the
port's own copy of ``repro.obs.export``).

``to_chrome`` renders a :class:`~repro_torch.obs.trace.Tracer` as the Chrome
trace-event format (the JSON object form), loadable in Perfetto
(https://ui.perfetto.dev) or ``chrome://tracing``:

  * process 0 — engine phases, one thread lane per ``engine/<phase>``
    track (tick, admission, prefix, prefill, decode, sync, sample,
    preempt, evict, kernel);
  * process 1 — requests, one thread lane per ``req/<uid>`` track, so
    a request's whole life (submit -> admit -> prefill chunks ->
    tokens -> retire) reads as one horizontal line.

Timestamps are microseconds (the format's native unit) since tracer
construction.  ``validate_chrome`` structurally checks an export —
tests and CI run it on real serve traces so a malformed artifact fails
loudly instead of silently refusing to load in Perfetto.

``timeline``/``format_timeline`` are the host-side view: a flat,
time-ordered table of one request's (or every request's) events for
terminals and logs — no browser required.
"""
from __future__ import annotations

import json
from typing import List, Optional

from repro_torch.obs.trace import SCHEMA_VERSION, Tracer

_ENGINE_PID = 0
_REQ_PID = 1


def _track_lanes(tracks: List[str]):
    """Map track names onto (pid, tid) lanes; engine phases keep their
    catalogue order, request lanes sort by uid when numeric."""
    lanes = {}
    eng = [t for t in tracks if t.startswith("engine/")]
    req = [t for t in tracks if not t.startswith("engine/")]

    def _uid_key(t):
        tail = t.split("/", 1)[-1]
        return (0, int(tail)) if tail.lstrip("-").isdigit() else (1, tail)

    for tid, t in enumerate(eng):
        lanes[t] = (_ENGINE_PID, tid)
    for tid, t in enumerate(sorted(req, key=_uid_key)):
        lanes[t] = (_REQ_PID, tid)
    return lanes


def to_chrome(tracer: Tracer) -> dict:
    """Chrome trace-event JSON object for ``tracer``'s current ring."""
    lanes = _track_lanes(tracer.tracks())
    events = []
    for pid, pname in ((_ENGINE_PID, "engine phases"),
                       (_REQ_PID, "requests")):
        events.append({"name": "process_name", "ph": "M", "pid": pid,
                       "tid": 0, "args": {"name": pname}})
    for track, (pid, tid) in lanes.items():
        events.append({"name": "thread_name", "ph": "M", "pid": pid,
                       "tid": tid, "args": {"name": track}})
    for ev in sorted(tracer.events, key=lambda e: e["ts"]):
        pid, tid = lanes[ev["track"]]
        out = {"name": ev["name"], "cat": ev.get("cat", "engine"),
               "ph": ev["ph"], "ts": ev["ts"], "pid": pid, "tid": tid,
               "args": ev.get("args", {})}
        if ev["ph"] == "X":
            out["dur"] = ev.get("dur", 0.0)
        if ev["ph"] == "i":
            out["s"] = "t"                      # instant scope: thread
        events.append(out)
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "schema_version": SCHEMA_VERSION,
            "events": len(tracer.events),
            "dropped": tracer.dropped,
        },
    }


def save_chrome(tracer: Tracer, path: str) -> str:
    """Write the Chrome trace JSON; returns ``path``."""
    with open(path, "w") as f:
        json.dump(to_chrome(tracer), f, indent=1, sort_keys=True)
        f.write("\n")
    return path


def validate_chrome(obj: dict) -> List[str]:
    """Structural checks on a Chrome trace export; returns a list of
    problems (empty == valid).  Checks the invariants Perfetto's loader
    and the trajectory gate rely on: every event carries the required
    fields, complete spans have non-negative durations, and every lane
    referenced by a real event has a ``thread_name`` metadata record."""
    errs = []
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        return ["missing traceEvents"]
    meta = obj.get("otherData", {})
    if meta.get("schema_version") != SCHEMA_VERSION:
        errs.append(f"schema_version {meta.get('schema_version')!r} != "
                    f"{SCHEMA_VERSION}")
    named = set()
    used = set()
    for i, ev in enumerate(obj["traceEvents"]):
        for field in ("name", "ph", "pid", "tid"):
            if field not in ev:
                errs.append(f"event {i}: missing {field!r}")
        ph = ev.get("ph")
        if ph == "M":
            if ev.get("name") == "thread_name":
                named.add((ev["pid"], ev["tid"], ev["args"]["name"]))
            continue
        if ph not in ("X", "i"):
            errs.append(f"event {i}: unexpected ph {ph!r}")
            continue
        if not isinstance(ev.get("ts"), (int, float)) or ev["ts"] < 0:
            errs.append(f"event {i}: bad ts {ev.get('ts')!r}")
        if ph == "X" and (not isinstance(ev.get("dur"), (int, float))
                          or ev["dur"] < 0):
            errs.append(f"event {i}: X span with bad dur {ev.get('dur')!r}")
        used.add((ev["pid"], ev["tid"]))
    lanes_named = {(p, t) for p, t, _ in named}
    for lane in used - lanes_named:
        errs.append(f"lane {lane} has events but no thread_name metadata")
    return errs


# ---------------------------------------------------------------------------
# host-side timeline table
# ---------------------------------------------------------------------------

def timeline(tracer: Tracer, uid=None) -> List[dict]:
    """Flat time-ordered rows; ``uid`` filters to one request's track
    plus the engine events that name it in their args."""
    rows = []
    want = None if uid is None else f"req/{uid}"
    for ev in sorted(tracer.events, key=lambda e: e["ts"]):
        args = ev.get("args", {})
        if want is not None and ev["track"] != want \
                and args.get("uid") != uid:
            continue
        rows.append({
            "ts_ms": ev["ts"] / 1e3,
            "dur_ms": ev.get("dur", 0.0) / 1e3,
            "track": ev["track"],
            "name": ev["name"],
            "tick": args.get("tick", ""),
            "args": {k: v for k, v in args.items() if k != "tick"},
        })
    return rows


def format_timeline(tracer: Tracer, uid=None,
                    max_rows: Optional[int] = None) -> str:
    """Fixed-width text rendering of :func:`timeline`."""
    rows = timeline(tracer, uid)
    clipped = 0
    if max_rows is not None and len(rows) > max_rows:
        clipped = len(rows) - max_rows
        rows = rows[:max_rows]
    head = f"{'ts_ms':>10} {'dur_ms':>9} {'tick':>5}  " \
           f"{'track':<18} {'event':<24} args"
    lines = [head, "-" * len(head)]
    for r in rows:
        args = " ".join(f"{k}={v}" for k, v in r["args"].items()
                        if not isinstance(v, dict))
        lines.append(f"{r['ts_ms']:>10.3f} {r['dur_ms']:>9.3f} "
                     f"{str(r['tick']):>5}  {r['track']:<18} "
                     f"{r['name']:<24} {args}")
    if clipped:
        lines.append(f"... ({clipped} more rows)")
    return "\n".join(lines)
