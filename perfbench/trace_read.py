"""Reading a ``torch.profiler`` trace (its Chrome-trace JSON) into the
numbers the per-layer metrics take.

Each device activity (a kernel, a copy, a fill) is tied to the host call
that launched it by the trace's correlation id, and that call to the
host events around it on its thread: the innermost operator (``cpu_op``,
with its input shapes) and the benchmark's own spans
(``record_function``, ``user_annotation``).  Nothing matches kernel
names: a kernel counts where it was launched.
"""
from __future__ import annotations

import json
from collections import Counter, defaultdict
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation")
# the benchmark's own spans: the loop's parts, and the attention entries
LOOP_SPAN = "perfbench.loop."
ATTN_SPANS = {"fwd": "perfbench.attn_fwd", "bwd": "perfbench.attn_bwd"}


def _host_context(events: List[dict]) -> Dict[int, Tuple[dict, List[str]]]:
    """For each launch's correlation id: (its innermost operator or None,
    the names of the spans around it)."""
    by_thread = defaultdict(list)
    for e in events:
        cat = e.get("cat")
        if e.get("ph") != "X" or cat not in HOST_CATS + LAUNCH_CATS:
            continue
        if cat in LAUNCH_CATS:
            corr = e.get("args", {}).get("correlation")
            if corr is None:
                continue
            by_thread[(e["pid"], e["tid"])].append((e["ts"], 1, e, corr))
        else:
            by_thread[(e["pid"], e["tid"])].append((e["ts"], 0, e, None))
    out = {}
    for items in by_thread.values():
        items.sort(key=lambda it: (it[0], it[1], -it[2].get("dur", 0)))
        stack: List[dict] = []
        for ts, kind, e, corr in items:
            stack = [s for s in stack if s["ts"] + s.get("dur", 0) >= ts]
            if kind == 0:
                stack.append(e)
                continue
            ops = [s for s in stack if s["cat"] == "cpu_op"]
            spans = [s["name"] for s in stack if s["cat"] == "user_annotation"]
            out[corr] = (ops[-1] if ops else None, spans)
    return out


def _union_s(intervals: List[Tuple[float, float]]) -> Tuple[float, list]:
    """Seconds covered by the (start, end) µs intervals, and the gaps
    between them as (start, end) µs."""
    busy, gaps = 0.0, []
    cur = None
    for a, b in sorted(intervals):
        if cur is None:
            cur = [a, b]
        elif a > cur[1]:
            busy += cur[1] - cur[0]
            gaps.append((cur[1], a))
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    if cur is not None:
        busy += cur[1] - cur[0]
    return busy / 1e6, gaps


def _span_at(events: List[dict], thread, t: float, prefix: str) -> str:
    """The innermost span named ``prefix...`` on ``thread`` around µs
    ``t``, or "none"."""
    best = None
    for e in events:
        if (e.get("cat") == "user_annotation"
                and (e["pid"], e["tid"]) == thread
                and e["name"].startswith(prefix)
                and e["ts"] <= t <= e["ts"] + e.get("dur", 0)
                and (best is None or e["ts"] > best["ts"])):
            best = e
    return best["name"] if best else "none"


def _ints(dims) -> List[int]:
    """Every size in an operator's ``Input Dims``, however nested."""
    if isinstance(dims, int):
        return [dims]
    return [d for x in dims for d in _ints(x)] if isinstance(dims, list) \
        else []


def read(path: str) -> dict:
    """The trace at ``path``, reduced:

    - ``busy_s``: seconds in which some device activity ran (their union);
    - ``kernels_s``: device seconds by kernel or copy name;
    - ``ops``: [op name, input shapes, device seconds] for each launch
      whose innermost host operator is known;
    - ``spans_s``: device seconds of the launches made inside each span;
    - ``unplaced_s``: device seconds whose launch the trace does not hold;
    - ``idle_gaps``: [name, seconds] of the gaps between device
      activity, named by the loop's span (``LOOP_SPAN...``) on the
      loop's thread at the gap's start, longest first.
    """
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    context = _host_context(events)
    intervals, kernels, ops = [], defaultdict(float), []
    spans, unplaced = defaultdict(float), 0.0
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        dur = e.get("dur", 0)
        intervals.append((e["ts"], e["ts"] + dur))
        kernels[e["name"]] += dur / 1e6
        ctx = context.get(e.get("args", {}).get("correlation"))
        if ctx is None:
            unplaced += dur / 1e6
            continue
        op, names = ctx
        for name in set(names):
            spans[name] += dur / 1e6
        if op is not None:
            ops.append([op["name"], op.get("args", {}).get("Input Dims", []),
                        dur / 1e6])
    loop_threads = Counter((e["pid"], e["tid"]) for e in events
                           if e.get("cat") == "user_annotation"
                           and e["name"].startswith(LOOP_SPAN))
    main = loop_threads.most_common(1)[0][0] if loop_threads else None
    busy_s, gaps = _union_s(intervals)
    gaps.sort(key=lambda g: g[0] - g[1])
    idle = [[_span_at(events, main, a, LOOP_SPAN) if main else "none",
             (b - a) / 1e6] for a, b in gaps[:10]]
    return {"busy_s": busy_s, "kernels_s": dict(kernels), "ops": ops,
            "spans_s": dict(spans), "unplaced_s": unplaced,
            "idle_gaps": idle}


PRODUCT_OPS = ("aten::mm", "aten::bmm", "aten::addmm", "aten::baddbmm")


def products_ms(record: dict, head: bool):
    """Device ms a step, over the steps traced with the operators' shapes
    (``ops_steps``), of the products whose innermost operator is a matrix
    product: with ``head``, those with a vocabulary-sized dimension among
    their inputs' shapes, else the others.  None where the trace placed
    no product."""
    tr = record["trace"]
    rows = [(dims, s) for name, dims, s in tr["ops"] if name in PRODUCT_OPS]
    if not rows:
        return None
    vocab = record["vocab"]
    total = sum(s for dims, s in rows if (vocab in _ints(dims)) == head)
    return total / tr["ops_steps"] * 1e3


def roofline_pct(record: dict, backward: bool):
    """The attention calls' summed bound over the device time launched
    inside the benchmark's span around their entry, in %; None where the
    traced steps made no call or the span holds no device time."""
    from .workcount import attention_bound_s
    tr = record["trace"]
    kind = "bwd" if backward else "fwd"
    calls = tr["attention"][kind]
    device_s = tr["spans_s"].get(ATTN_SPANS[kind])
    if not calls or not device_s:
        return None
    bound = sum(attention_bound_s(c, backward) for c in calls)
    return 100.0 * bound / device_s
