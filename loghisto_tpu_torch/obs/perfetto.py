"""Span-ring export as Chrome ``trace_events`` JSON, which Perfetto opens
(counterpart of ``loghisto_tpu/obs/perfetto.py``; the same document for
the same spans and process name).

``trace_events()`` turns the recorder's closed spans into the legacy
Chrome JSON trace format (the ``traceEvents`` array form), which
https://ui.perfetto.dev opens directly:

  * every recording thread becomes one track (``tid`` minted per thread
    name, named by ``"M"`` thread_name metadata events);
  * every span becomes one ``"X"`` complete event: ``ts``/``dur`` in
    microseconds on the ``perf_counter_ns`` timebase, the stage as the
    event name, and the interval sequence number in ``args.seq``;
  * each interval's spans are chained with flow events (``"s"`` on the
    interval's first span, ``"t"`` on the rest, ``id`` = the interval
    seq), so selecting one commit in Perfetto draws arrows through every
    stage that interval touched, across threads.

A ``torch.profiler`` capture (``utils/trace.py``, ``LOGHISTO_TRACE_DIR``)
is a Chrome trace too, of the card's kernels and the host's regions;
Perfetto opens both beside each other.

Spans carrying a cross-process flow id (``Span.flow``) also emit
``cat="fed"`` flow events keyed on that id, and every dump records a
(wall_ns, perf_ns) clock-anchor pair taken at dump time.
``merge_traces()`` uses the anchors to shift each process's
perf_counter timeline onto the shared wall clock and re-threads the fed
flows globally, so one merged trace shows a frame's arrow crossing the
process boundary.
"""

from __future__ import annotations

import json
import time
from typing import Dict, Iterable, List, Optional

from loghisto_tpu_torch.obs.spans import Span

_PID = 1  # single-process trace: one process group in the UI


def trace_events(
    recorder,
    process_name: str = "loghisto_tpu_torch",
    seqs: Optional[Iterable[int]] = None,
) -> List[dict]:
    """The ``traceEvents`` list for the recorder's current ring
    contents (optionally restricted to the given interval seqs)."""
    spans: List[Span] = sorted(recorder.spans(), key=lambda s: s.start_ns)
    if seqs is not None:
        wanted = set(seqs)
        spans = [s for s in spans if s.seq in wanted]

    events: List[dict] = [{
        "ph": "M", "pid": _PID, "tid": 0, "name": "process_name",
        "args": {"name": process_name},
    }]
    tids: Dict[str, int] = {}
    for s in spans:
        if s.thread not in tids:
            tid = tids[s.thread] = len(tids) + 1
            events.append({
                "ph": "M", "pid": _PID, "tid": tid,
                "name": "thread_name", "args": {"name": s.thread},
            })

    flow_started: Dict[int, bool] = {}
    fed_started: Dict[int, bool] = {}
    for s in spans:
        tid = tids[s.thread]
        ts = s.start_ns / 1e3  # µs, perf_counter timebase
        args = {"seq": s.seq}
        flow = getattr(s, "flow", None)
        if flow:
            args["flow"] = flow
        events.append({
            "ph": "X", "pid": _PID, "tid": tid, "name": s.stage,
            "cat": "pipeline", "ts": ts, "dur": s.duration_us,
            "args": args,
        })
        if s.seq:  # chain this interval's spans with flow arrows
            ph = "t" if flow_started.get(s.seq) else "s"
            flow_started[s.seq] = True
            events.append({
                "ph": ph, "pid": _PID, "tid": tid, "name": "interval",
                "cat": "interval", "id": s.seq, "ts": ts,
            })
        if flow:  # cross-process chain: re-threaded by merge_traces()
            ph = "t" if fed_started.get(flow) else "s"
            fed_started[flow] = True
            events.append({
                "ph": ph, "pid": _PID, "tid": tid, "name": "fed",
                "cat": "fed", "id": flow, "ts": ts,
            })
    return events


def dump_perfetto(
    recorder,
    path: str,
    process_name: str = "loghisto_tpu_torch",
    seqs: Optional[Iterable[int]] = None,
) -> int:
    """Write the trace as ``{"traceEvents": [...], ...}`` JSON to
    ``path``; returns the number of events written."""
    events = trace_events(recorder, process_name=process_name, seqs=seqs)
    doc = {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "source": "loghisto_tpu_torch.obs",
            "clock": "perf_counter_ns",
            "process": process_name,
            # clock-anchor pair for merge_traces(): both clocks read
            # back to back, so wall - perf maps this dump's perf
            # timeline onto the wall clock (same-host error = the gap
            # between the two reads, nanoseconds)
            "wall_anchor_ns": time.time_ns(),
            "perf_anchor_ns": time.perf_counter_ns(),
        },
    }
    with open(path, "w") as f:
        json.dump(doc, f)
    return len(events)


def merge_traces(traces, out_path: Optional[str] = None) -> dict:
    """Merge per-process ``dump_perfetto`` outputs into one trace.

    ``traces``: trace documents (dicts) or paths to dumped JSON files,
    one per process.  Each document's events keep their thread tracks
    but move to their own ``pid``; timestamps are shifted from the
    process-local perf_counter timebase onto the wall clock via the
    dump's anchor pair, then normalized so the merged trace starts at
    ts 0.  ``cat="fed"`` flow events are re-threaded globally (first
    event of each flow id becomes the ``"s"``, every later one a
    ``"t"``) so a frame's arrow crosses the process boundary.  Dumps
    without an anchor pair (older format) merge unshifted.
    """
    docs = []
    for t in traces:
        if isinstance(t, (str, bytes)):
            with open(t) as f:
                docs.append(json.load(f))
        else:
            docs.append(t)

    shifted: List[List[dict]] = []
    names: List[str] = []
    t_min = None
    for i, doc in enumerate(docs):
        od = doc.get("otherData", {})
        wall = od.get("wall_anchor_ns")
        perf = od.get("perf_anchor_ns")
        shift_us = (wall - perf) / 1e3 if wall and perf else 0.0
        names.append(od.get("process", f"process-{i}"))
        evs = []
        for ev in doc.get("traceEvents", []):
            ev = dict(ev)
            ev["pid"] = i + 1
            if "ts" in ev:
                ev["ts"] = ev["ts"] + shift_us
                if t_min is None or ev["ts"] < t_min:
                    t_min = ev["ts"]
            evs.append(ev)
        shifted.append(evs)

    merged: List[dict] = []
    for evs in shifted:
        for ev in evs:
            if "ts" in ev:
                ev["ts"] -= t_min or 0.0
            merged.append(ev)
    # re-thread fed flows on the now-global timeline
    fed = sorted(
        (ev for ev in merged if ev.get("cat") == "fed"),
        key=lambda ev: ev["ts"],
    )
    fed_started: Dict[int, bool] = {}
    for ev in fed:
        fid = ev["id"]
        ev["ph"] = "t" if fed_started.get(fid) else "s"
        fed_started[fid] = True
    doc = {
        "traceEvents": merged,
        "displayTimeUnit": "ms",
        "otherData": {
            "source": "loghisto_tpu_torch.obs.merge",
            "clock": "wall_ns",
            "merged_from": names,
        },
    }
    if out_path is not None:
        with open(out_path, "w") as f:
            json.dump(doc, f)
    return doc
