"""Structured tracing + latency attribution for the serve engine
(DESIGN.md SS15).

One event vocabulary threaded through every serving layer: the engine,
scheduler, KV manager / ``SimulatedTierDevice`` and the drafters emit
spans and instant events onto the SS13 virtual clock, and this recorder
turns them into three exports:

* **Chrome trace-event JSON** (``to_chrome`` / ``save``) — one track per
  request plus engine and DMA-channel tracks, loadable in Perfetto /
  ``chrome://tracing``.
* **Per-request latency breakdown** (``breakdown`` / ``breakdowns``) —
  each request's end-to-end latency partitioned into
  ``queue / prefill / recompute / decode / stall / draft`` seconds that
  sum to it *exactly* (conservation by construction: the recorder tiles
  each request's lifetime with contiguous segments; unattributed time —
  waiting while other requests hold the engine, host bookkeeping — is
  queue time).
* **SLO goodput report** (``slo_report``) — which requests met their
  TTFT/ITL targets, and for the violators, which phase to blame. This is
  the readout ROADMAP item 1's SLO-aware scheduler consumes.

``reconcile`` audits ``ServeStats`` against the trace after every serve:
total stall, per-request stall attribution, the TTFT/ITL sample sets and
the emitted-token count must all match the events within float
tolerance, so the aggregate counters can no longer silently drift from
what actually happened.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.serving import metrics

# ---- phase vocabulary (per-request latency attribution) ---- #
QUEUE = "queue"          # waiting: for admission, or for the engine while
                         # other requests hold it (incl. host bookkeeping)
PREFILL = "prefill"      # this request's own prefill-chunk compute
RECOMPUTE = "recompute"  # re-prefill of KV lost to a preemption
DECODE = "decode"        # fused decode blocks / spec verify passes
STALL = "stall"          # fetch-wait on THIS request's offload pages
DRAFT = "draft"          # speculative draft proposal overhead
PHASES = (QUEUE, PREFILL, RECOMPUTE, DECODE, STALL, DRAFT)

# ---- Chrome trace track model ---- #
PID_REQUESTS = 1         # one thread (track) per request id
PID_DEVICE = 2           # engine + stream + DMA-channel tracks
TID_ENGINE = 0
TID_DMA_IN = 1           # fetch: offload -> fast
TID_DMA_OUT = 2          # spill/write-back: fast -> offload
TID_PREFILL = 3          # prefill stream (overlapped engine, SS16)
TID_DECODE = 4           # decode stream
TID_CHIP_IN = 5          # chiplet link: promotion (base -> chiplet, SS17)
TID_CHIP_OUT = 6         # chiplet link: demotion (chiplet -> base)
_DEVICE_TIDS = {"engine": TID_ENGINE, "in": TID_DMA_IN, "out": TID_DMA_OUT,
                "prefill": TID_PREFILL, "decode": TID_DECODE,
                "chiplet:in": TID_CHIP_IN, "chiplet:out": TID_CHIP_OUT}


@dataclass
class _ReqTrace:
    rid: int
    t_submit: float
    cursor: float                      # end of the last tiled segment
    segments: List[Tuple[str, float, float]] = field(default_factory=list)
    token_t: List[float] = field(default_factory=list)
    prefill_hw: int = 0                # token extent ever computed (for
                                       # labelling re-prefill as recompute)
    n_preemptions: int = 0
    done: bool = False


class TraceRecorder:
    """Collects virtual-clock spans/instants and exports trace,
    breakdown, and SLO reports. All times are seconds on the engine's
    virtual clock (wall + absorbed migration stall)."""

    def __init__(self) -> None:
        self._req: Dict[int, _ReqTrace] = {}
        self._events: List[dict] = []      # chrome events, ts/dur in raw s
        self.stall_total = 0.0             # sum of absorbed batch stalls
        # DMA bytes by "src->dst" label, accumulated from device spans —
        # reconciled against the KV manager's channel_bytes counters
        self.dma_bytes: Dict[str, float] = {}
        self._t_base: Optional[float] = None
        self.t_final: Optional[float] = None

    # ------------------------- raw event plumbing ---------------------- #
    def _base(self, t: float) -> None:
        if self._t_base is None or t < self._t_base:
            self._t_base = t

    def _span_event(self, pid: int, tid: int, name: str, t0: float,
                    t1: float, args: Optional[dict] = None) -> None:
        self._base(t0)
        ev = {"ph": "X", "pid": pid, "tid": tid, "name": name,
              "ts_s": t0, "dur_s": t1 - t0}
        if args:
            ev["args"] = args
        self._events.append(ev)

    def _instant_event(self, pid: int, tid: int, name: str, t: float,
                       args: Optional[dict] = None) -> None:
        self._base(t)
        ev = {"ph": "i", "pid": pid, "tid": tid, "name": name,
              "ts_s": t, "s": "t"}
        if args:
            ev["args"] = args
        self._events.append(ev)

    def instant(self, name: str, t: float, *, rid: Optional[int] = None,
                track: str = "engine", args: Optional[dict] = None) -> None:
        """Generic instant event — on a request track when ``rid`` is
        given, else on the named device track (engine/in/out)."""
        if rid is not None:
            self._instant_event(PID_REQUESTS, rid, name, t, args)
        else:
            self._instant_event(PID_DEVICE, _DEVICE_TIDS[track], name, t,
                                args)

    def engine_span(self, name: str, t0: float, t1: float,
                    args: Optional[dict] = None,
                    track: str = "engine") -> None:
        """Engine-side span. ``track`` routes it: the overlapped engine
        puts prefill chunks on the ``prefill`` stream track and decode /
        verify blocks on ``decode``, so concurrent spans land on distinct
        tids instead of overlapping illegibly on one engine row."""
        self._span_event(PID_DEVICE, _DEVICE_TIDS[track], name, t0,
                         max(t1, t0), args)

    def device_span(self, channel: str, t0: float, t1: float,
                    n_bytes: float, *, link: str = "hbs",
                    label: Optional[str] = None,
                    slice_idx: Optional[int] = None) -> None:
        """One batched DMA transfer (or one layer slice of a chained
        descriptor, ``slice_idx`` set) — emitted by
        ``SimulatedTierDevice.transfer`` / ``transfer_sliced``. ``link``
        routes chiplet-link migrations to their own tracks; ``label`` is
        the "src->dst" tier pair whose bytes are accumulated for the
        per-channel reconcile."""
        track = channel if link != "chiplet" else f"chiplet:{channel}"
        name = "fetch" if channel == "in" else "spill"
        if link == "chiplet":
            name = "promote" if channel == "in" else "demote"
        args = {"bytes": n_bytes}
        if label is not None:
            args["link"] = label
            self.dma_bytes[label] = self.dma_bytes.get(label, 0.0) + n_bytes
        if slice_idx is not None:
            args["slice"] = slice_idx
        self._span_event(PID_DEVICE, _DEVICE_TIDS[track], name, t0,
                         max(t1, t0), args)

    def prefetch(self, page: int, hit: bool, t: float) -> None:
        """Prefetch-hit/miss resolution, from the KV manager's fetch-wait
        barrier."""
        self._instant_event(PID_DEVICE, TID_DMA_IN,
                            "prefetch_hit" if hit else "prefetch_miss", t,
                            {"page": page})

    def absorbed_stall(self, t0: float, dur: float,
                       track: str = "engine") -> None:
        """A fetch-wait barrier the batch absorbed (the max over its
        requests' own waits). Sum over these == ``ServeStats.stall_s``.
        ``track`` places the span on the stream that absorbed it."""
        if dur <= 0:
            return
        self.stall_total += dur
        self._span_event(PID_DEVICE, _DEVICE_TIDS[track], "stall", t0,
                         t0 + dur)

    # --------------------- per-request lifecycle ----------------------- #
    def submit(self, rid: int, t: float) -> None:
        self._base(t)
        self._req[rid] = _ReqTrace(rid=rid, t_submit=t, cursor=t)

    def _fill(self, r: _ReqTrace, t: float) -> None:
        """Tile the gap up to ``t`` as queue time (waiting for service)."""
        if t > r.cursor:
            r.segments.append((QUEUE, r.cursor, t))
            self._span_event(PID_REQUESTS, r.rid, QUEUE, r.cursor, t)
            r.cursor = t

    def admit(self, rid: int, t: float, *, cached_tokens: int = 0,
              slot: Optional[int] = None) -> None:
        r = self._req[rid]
        self._fill(r, t)                  # submit -> admit wait, explicit
        args = {"cached_tokens": cached_tokens}
        if slot is not None:
            args["slot"] = slot
        self._instant_event(PID_REQUESTS, rid, "admit", t, args)

    def span(self, rid: int, phase: str, t0: float, t1: float, *,
             args: Optional[dict] = None) -> None:
        """Attribute ``[t0, t1]`` of this request's lifetime to ``phase``.
        Overlap with already-tiled time is clamped away (e.g. a decode
        span launched at a block start whose stall span already covered
        the barrier), and any gap before it becomes queue time — so
        segments always tile ``[t_submit, cursor]`` exactly."""
        if phase not in PHASES:
            raise ValueError(f"unknown phase {phase!r}")
        r = self._req[rid]
        t0 = max(t0, r.cursor)
        t1 = max(t1, t0)
        self._fill(r, t0)
        if t1 > t0:
            r.segments.append((phase, t0, t1))
            self._span_event(PID_REQUESTS, rid, phase, t0, t1, args)
            r.cursor = t1

    def prefill_span(self, rid: int, t0: float, t1: float, start_tok: int,
                     end_tok: int) -> None:
        """A prefill chunk computing token positions ``[start_tok,
        end_tok)``. The portion under the request's computed-extent
        high-water mark was computed before (lost to preemption) and is
        labelled ``recompute``; the rest is first-time ``prefill``. The
        split is proportional in time within the chunk."""
        r = self._req[rid]
        n = max(end_tok - start_tok, 0)
        re_n = min(max(min(r.prefill_hw, end_tok) - start_tok, 0), n)
        t0 = max(t0, r.cursor)
        t1 = max(t1, t0)
        args = {"tokens": [start_tok, end_tok]}
        if n > 0 and re_n > 0:
            tm = t0 + (t1 - t0) * (re_n / n)
            self.span(rid, RECOMPUTE, t0, tm, args=args)
            self.span(rid, PREFILL, tm, t1, args=args)
        else:
            self.span(rid, PREFILL, t0, t1, args=args)
        r.prefill_hw = max(r.prefill_hw, end_tok)

    def token(self, rid: int, t: float, tok: int) -> None:
        r = self._req[rid]
        name = "first_token" if not r.token_t else "token"
        r.token_t.append(t)
        self._instant_event(PID_REQUESTS, rid, name, t, {"tok": tok})

    def preempt(self, rid: int, t: float, *, n_valid: int = 0) -> None:
        """LIFO recompute preemption: the request's pages are freed and it
        re-queues. ``n_valid`` (its landed KV extent) raises the computed
        high-water mark so the re-prefill is labelled recompute."""
        r = self._req[rid]
        r.n_preemptions += 1
        r.prefill_hw = max(r.prefill_hw, n_valid)
        self._instant_event(PID_REQUESTS, rid, "preempt", t,
                            {"n_valid": n_valid})

    def retire(self, rid: int, t: float) -> None:
        r = self._req[rid]
        self._fill(r, t)
        r.done = True
        self._instant_event(PID_REQUESTS, rid, "retire", t)

    def finalize(self, t: float) -> None:
        """Close the trace: any request still open (engine aborted
        mid-serve) is tiled out to ``t`` as queue time."""
        self.t_final = t
        for r in self._req.values():
            if not r.done:
                self._fill(r, t)

    # ------------------------- breakdown export ------------------------ #
    def breakdown(self, rid: int) -> Dict[str, object]:
        """Per-request phase partition. ``sum(<phase>_s) == e2e_s``
        exactly (segments tile the lifetime)."""
        r = self._req[rid]
        out: Dict[str, object] = {f"{p}_s": 0.0 for p in PHASES}
        for phase, t0, t1 in r.segments:
            out[f"{phase}_s"] += t1 - t0
        out["e2e_s"] = r.cursor - r.t_submit
        out["n_tokens"] = len(r.token_t)
        out["n_preemptions"] = r.n_preemptions
        out["ttft_s"] = (r.token_t[0] - r.t_submit if r.token_t else 0.0)
        out["itl_s"] = [b - a for a, b in zip(r.token_t, r.token_t[1:])]
        return out

    def breakdowns(self) -> Dict[int, Dict[str, object]]:
        return {rid: self.breakdown(rid) for rid in sorted(self._req)}

    def aggregate_breakdown_ms(self, ndigits: int = 3) -> Dict[str, float]:
        """Phase seconds summed across requests, in ms — the compact
        block the benchmark JSON sections embed."""
        total = {f"{p}_s": 0.0 for p in PHASES}
        e2e = 0.0
        for rid in self._req:
            bd = self.breakdown(rid)
            for p in PHASES:
                total[f"{p}_s"] += bd[f"{p}_s"]
            e2e += bd["e2e_s"]
        out = {f"{p}_ms": round(total[f"{p}_s"] * 1e3, ndigits)
               for p in PHASES}
        out["e2e_ms"] = round(e2e * 1e3, ndigits)
        return out

    # --------------------------- SLO goodput --------------------------- #
    def _window_phase(self, rid: int, t0: float, t1: float
                      ) -> Dict[str, float]:
        """Phase mass inside a time window (for blame attribution)."""
        out = {p: 0.0 for p in PHASES}
        for phase, a, b in self._req[rid].segments:
            ov = min(b, t1) - max(a, t0)
            if ov > 0:
                out[phase] += ov
        return out

    def slo_report(self, ttft_target_s: Optional[float] = None,
                   itl_target_s: Optional[float] = None,
                   ndigits: int = 3) -> Dict[str, object]:
        """Goodput vs the TTFT/ITL targets, with per-phase blame for each
        violator: the dominant phase of the violated window
        ([submit, first token] for TTFT; [first token, retire] for
        ITL)."""
        reqs, viol = [], []
        ttfts: List[float] = []
        itls: List[float] = []
        for rid in sorted(self._req):
            r = self._req[rid]
            bd = self.breakdown(rid)
            ttft = bd["ttft_s"]
            itl = bd["itl_s"]
            ttfts.append(ttft)
            itls.extend(itl)
            itl_p95 = metrics.percentile(itl, 95)
            ok_ttft = (ttft_target_s is None or not r.token_t
                       or ttft <= ttft_target_s)
            ok_itl = (itl_target_s is None or not itl
                      or itl_p95 <= itl_target_s)
            row = {"rid": rid,
                   "ttft_ms": round(ttft * 1e3, ndigits),
                   "itl_p95_ms": round(itl_p95 * 1e3, ndigits),
                   "meets_ttft": ok_ttft, "meets_itl": ok_itl}
            reqs.append(row)
            if not (ok_ttft and ok_itl):
                if not ok_ttft and r.token_t:
                    win = self._window_phase(rid, r.t_submit, r.token_t[0])
                elif r.token_t:
                    win = self._window_phase(rid, r.token_t[0], r.cursor)
                else:
                    win = self._window_phase(rid, r.t_submit, r.cursor)
                blame = max(win, key=lambda p: win[p]) if any(
                    win.values()) else DECODE
                viol.append({**row, "blame": blame,
                             "blame_window_ms": {
                                 p: round(v * 1e3, ndigits)
                                 for p, v in win.items() if v > 0},
                             "breakdown_ms": {
                                 f"{p}_ms": round(bd[f"{p}_s"] * 1e3,
                                                  ndigits)
                                 for p in PHASES}})
        n = len(reqs)
        met = sum(1 for r in reqs if r["meets_ttft"] and r["meets_itl"])
        return {
            "targets": {
                "ttft_ms": (None if ttft_target_s is None
                            else round(ttft_target_s * 1e3, ndigits)),
                "itl_ms": (None if itl_target_s is None
                           else round(itl_target_s * 1e3, ndigits))},
            "n_requests": n,
            "n_met_slo": met,
            "goodput_frac": round(met / n, 4) if n else 1.0,
            "ttft": metrics.latency_summary_ms(ttfts, ndigits=ndigits),
            "itl": metrics.latency_summary_ms(itls, ndigits=ndigits),
            "violators": viol,
        }

    # -------------------------- reconciliation ------------------------- #
    def reconcile(self, *, stall_s: float, ttft: Sequence[float],
                  itl: Sequence[float], new_tokens: int,
                  stall_by_rid: Optional[Dict[int, float]] = None,
                  channel_bytes: Optional[Dict[str, float]] = None,
                  tol: float = 1e-6, strict: bool = True
                  ) -> Dict[str, object]:
        """Audit ``ServeStats`` aggregates against the trace events.

        Conservation invariants checked (the SS15 contract):
        * each request's phase partition sums to its end-to-end latency
          (exact tiling, checked to ``tol``);
        * the trace's absorbed-stall spans sum to ``stall_s``;
        * each request's stall segments sum to its ``stall_by_rid`` entry;
        * the trace's token instants reproduce the TTFT and ITL sample
          sets and the emitted-token count;
        * the per-"src->dst" DMA span bytes match the manager's
          ``channel_bytes`` counters (SS17 per-channel accounting), when
          given.

        Returns a report dict; with ``strict`` raises ``AssertionError``
        listing every failed check (counters may not silently drift)."""
        fails: List[str] = []

        def close(a: float, b: float) -> bool:
            return abs(a - b) <= tol

        if channel_bytes is not None:
            for key in sorted(set(self.dma_bytes) | set(channel_bytes)):
                got = self.dma_bytes.get(key, 0.0)
                want = channel_bytes.get(key, 0.0)
                if abs(got - want) > max(tol, 1e-9 * max(got, want)):
                    fails.append(f"channel {key}: trace {got:.3f}B != "
                                 f"stats {want:.3f}B")

        for rid in self._req:
            bd = self.breakdown(rid)
            parts = sum(bd[f"{p}_s"] for p in PHASES)
            if not close(parts, bd["e2e_s"]):
                fails.append(f"req {rid}: phase sum {parts:.9f} != "
                             f"e2e {bd['e2e_s']:.9f}")

        if not close(self.stall_total, stall_s):
            fails.append(f"stall: trace {self.stall_total:.9f} != "
                         f"stats {stall_s:.9f}")

        if stall_by_rid is not None:
            for rid in set(self._req) | set(stall_by_rid):
                want = stall_by_rid.get(rid, 0.0)
                got = (self.breakdown(rid)["stall_s"]
                       if rid in self._req else 0.0)
                if not close(got, want):
                    fails.append(f"req {rid} stall: trace {got:.9f} != "
                                 f"stats {want:.9f}")

        t_ttft = sorted(self.breakdown(rid)["ttft_s"]
                        for rid in self._req if self._req[rid].token_t)
        s_ttft = sorted(ttft)
        if len(t_ttft) != len(s_ttft) or any(
                not close(a, b) for a, b in zip(t_ttft, s_ttft)):
            fails.append(f"ttft samples differ: trace {len(t_ttft)} vs "
                         f"stats {len(s_ttft)}")

        t_itl = sorted(x for rid in self._req
                       for x in self.breakdown(rid)["itl_s"])
        s_itl = sorted(itl)
        if len(t_itl) != len(s_itl) or any(
                not close(a, b) for a, b in zip(t_itl, s_itl)):
            fails.append(f"itl samples differ: trace {len(t_itl)} vs "
                         f"stats {len(s_itl)}")

        n_tok = sum(len(r.token_t) for r in self._req.values())
        if n_tok != new_tokens:
            fails.append(f"tokens: trace {n_tok} != stats {new_tokens}")

        report = {"ok": not fails, "failures": fails,
                  "n_requests": len(self._req), "n_tokens": n_tok,
                  "stall_s": self.stall_total}
        if strict and fails:
            raise AssertionError(
                "trace/stats drift detected:\n  " + "\n  ".join(fails))
        return report

    # ------------------------- Chrome trace export --------------------- #
    def to_chrome(self) -> Dict[str, object]:
        """Chrome trace-event JSON (Perfetto-loadable): ``ph: "X"``
        complete spans and ``ph: "i"`` instants with µs timestamps
        rebased to the first event, plus process/thread naming
        metadata."""
        base = self._t_base or 0.0
        events: List[dict] = [
            {"ph": "M", "pid": PID_REQUESTS, "tid": 0,
             "name": "process_name", "args": {"name": "requests"}},
            {"ph": "M", "pid": PID_DEVICE, "tid": 0,
             "name": "process_name", "args": {"name": "device"}},
            {"ph": "M", "pid": PID_DEVICE, "tid": TID_ENGINE,
             "name": "thread_name", "args": {"name": "engine"}},
            {"ph": "M", "pid": PID_DEVICE, "tid": TID_DMA_IN,
             "name": "thread_name", "args": {"name": "dma:in (fetch)"}},
            {"ph": "M", "pid": PID_DEVICE, "tid": TID_DMA_OUT,
             "name": "thread_name", "args": {"name": "dma:out (spill)"}},
            {"ph": "M", "pid": PID_DEVICE, "tid": TID_PREFILL,
             "name": "thread_name", "args": {"name": "stream:prefill"}},
            {"ph": "M", "pid": PID_DEVICE, "tid": TID_DECODE,
             "name": "thread_name", "args": {"name": "stream:decode"}},
            {"ph": "M", "pid": PID_DEVICE, "tid": TID_CHIP_IN,
             "name": "thread_name",
             "args": {"name": "chiplet:in (promote)"}},
            {"ph": "M", "pid": PID_DEVICE, "tid": TID_CHIP_OUT,
             "name": "thread_name",
             "args": {"name": "chiplet:out (demote)"}},
        ]
        for rid in sorted(self._req):
            events.append({"ph": "M", "pid": PID_REQUESTS, "tid": rid,
                           "name": "thread_name",
                           "args": {"name": f"req {rid}"}})
        for ev in self._events:
            out = {"ph": ev["ph"], "pid": ev["pid"], "tid": ev["tid"],
                   "name": ev["name"],
                   "ts": round((ev["ts_s"] - base) * 1e6, 3)}
            if ev["ph"] == "X":
                out["dur"] = round(ev["dur_s"] * 1e6, 3)
            if ev["ph"] == "i":
                out["s"] = ev.get("s", "t")
            if "args" in ev:
                out["args"] = ev["args"]
            events.append(out)
        return {"displayTimeUnit": "ms", "traceEvents": events,
                "metadata": {"clock": "virtual (wall + absorbed stall)",
                             "breakdowns": {
                                 str(rid): bd for rid, bd in
                                 self.breakdowns().items()}}}

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f, indent=1)


def validate_chrome_trace(doc: object) -> Dict[str, int]:
    """Structural validation of a Chrome trace-event document (what the
    CI smoke step and the golden-trace test assert). Raises ``ValueError``
    on the first violation; returns event counts by phase type."""
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        raise ValueError("trace must be an object with 'traceEvents'")
    events = doc["traceEvents"]
    if not isinstance(events, list) or not events:
        raise ValueError("'traceEvents' must be a non-empty list")
    counts = {"X": 0, "i": 0, "M": 0}
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            raise ValueError(f"event {i} is not an object")
        ph = ev.get("ph")
        if ph not in counts:
            raise ValueError(f"event {i}: unsupported ph {ph!r}")
        for key in ("name", "pid", "tid"):
            if key not in ev:
                raise ValueError(f"event {i} ({ph}): missing {key!r}")
        if ph in ("X", "i"):
            ts = ev.get("ts")
            if not isinstance(ts, (int, float)) or ts < 0:
                raise ValueError(f"event {i}: bad ts {ts!r}")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                raise ValueError(f"event {i}: bad dur {dur!r}")
        if ph == "M" and "args" not in ev:
            raise ValueError(f"event {i}: metadata event missing args")
        counts[ph] += 1
    if counts["M"] == 0:
        raise ValueError("no track-naming metadata events")
    return counts
