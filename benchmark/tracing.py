"""What a traced run records, and the reduction of torch.profiler's trace.

A traced run (``--trace 1``) drives the cell's loop in four segments of
``trace_iters`` iterations after the warm-up: one with no instrumentation
(its host-clock time); one under torch.profiler recording the device alone
(device operations, busy time and launches against the segment's host-clock
window, with little host overhead); one under torch.profiler recording the
host too (the breakdown: the busiest device operations and the idle gaps
named by the host operation they fall in); and one with CUDA events on the
regressor heads' forward hooks. A training loop also counts the host syncs
of one step under ``torch.cuda.set_sync_debug_mode``. ``Trace`` holds the readings
that the per-layer metric readers (``metrics/<name>.py``) take their
numbers from.
"""

from __future__ import annotations

import collections
import time
import warnings
from typing import Callable, Dict, List, Optional, Tuple

import torch

Span = Tuple[str, float, float]     # name, start s, end s (profiler clock)


def _union(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


class Trace:
    """Readings of a traced run. Times in seconds."""

    def __init__(self, kind: str, model: Dict, batch: int):
        self.kind = kind                 # the loop: 'stream', 'eval', 'train'
        self.model = model               # the configuration's model group
        self.batch = batch
        self.plain_s: Optional[float] = None      # untraced segment
        self.plain_windows = 0
        self.window_s: Optional[float] = None     # device-profiled segment
        self.iters = 0
        self.windows = 0
        self.device_ops: List[Span] = []          # its device operations
        self.bd_window_s: Optional[float] = None  # host-and-device-profiled segment
        self.bd_device_ops: List[Span] = []
        self.host_ops: List[Span] = []
        self.heads_ms: Optional[float] = None     # device ms of both heads, summed
        self.heads_windows = 0
        self.syncs: Optional[int] = None
        self.sync_steps = 0
        self.sync_sites: Dict[str, int] = {}
        self.pairs: Optional[List[int]] = None    # sa1 selected pairs by scale, profiled windows
        self.device_name = ""

    # --- derived readings -------------------------------------------------
    def busy_s(self) -> float:
        """Seconds of the profiled window in which a device operation ran."""
        return sum(b - a for a, b in _union([(s, e) for _, s, e in self.device_ops]))

    def kernels(self) -> List[Span]:
        return [op for op in self.device_ops if not op[0].startswith(("Memcpy", "Memset"))]

    def kernel_seconds(self, needle: str) -> Tuple[float, int]:
        """(device seconds, launches) of the kernels whose name holds
        ``needle``."""
        hits = [e - s for n, s, e in self.kernels() if needle in n]
        return sum(hits), len(hits)

    def breakdown(self, top: int = 10) -> Dict[str, List]:
        """The busiest device operations, and the longest idle gaps named by
        what the host was doing in the middle of each."""
        by_name: Dict[str, float] = collections.defaultdict(float)
        for n, s, e in self.bd_device_ops:
            by_name[n] += e - s
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        busy = _union([(s, e) for _, s, e in self.bd_device_ops])
        gaps, t = [], 0.0
        for a, b in busy + [(self.bd_window_s, self.bd_window_s)]:
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
        return {"device_ops": [[n[:120], v] for n, v in ops],
                "idle_gaps": [[self._host_at((a + b) / 2), b - a] for a, b in gaps]}

    def _host_at(self, t: float) -> str:
        """'bench span > innermost host operation' running at time t (the
        middle of a gap)."""
        covering = [(s, n) for n, s, e in self.host_ops if s <= t < e]
        if not covering:
            return "host outside any recorded operation"
        bench = [n for s, n in sorted(covering) if n.startswith("bench.")]
        inner = max(covering)[1]
        return " > ".join(([bench[-1]] if bench and bench[-1] != inner else []) + [inner])[:120]


def _device_events(events, t0: float, window: float) -> List[Span]:
    """Device operations of a profile, from ``t0`` (us), clipped to the
    window; a range annotation mirrored on the device timeline is no work."""
    out = []
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if getattr(e, "is_user_annotation", False) or e.name.startswith("bench."):
            continue
        s = max((e.time_range.start - t0) / 1e6, 0.0)
        t = min((e.time_range.end - t0) / 1e6, window)
        if t > s:
            out.append((e.name, s, t))
    return out


def device_profiled(fn: Callable[[], None], trace: Trace, device) -> None:
    """Run ``fn`` under torch.profiler recording the device alone: its
    operations, from the first one's start, and the segment's host-clock
    window (the device synchronised at both ends)."""
    if torch.device(device).type != "cuda":
        trace.window_s = timed(fn, device)      # no device to record
        return
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        trace.window_s = timed(fn, device)
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if events:
        t0 = min(e.time_range.start for e in events)
        trace.device_ops = _device_events(events, t0, trace.window_s)


def host_profiled(fn: Callable[[], None], trace: Trace, device) -> None:
    """Run ``fn`` under torch.profiler recording host and device, for the
    breakdown (times from the start of the window)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function("bench.window"):
            fn()
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize()
    events = prof.events()
    win = [e for e in events if e.name == "bench.window"][0].time_range
    t0 = win.start
    trace.bd_window_s = (win.end - win.start) / 1e6
    trace.bd_device_ops = _device_events(events, t0, trace.bd_window_s)
    for e in events:
        s, t = (e.time_range.start - t0) / 1e6, (e.time_range.end - t0) / 1e6
        if (e.device_type != torch.autograd.DeviceType.CUDA and e.name != "bench.window"
                and 0 <= s <= trace.bd_window_s):
            trace.host_ops.append((e.name, s, t))


def head_hooks(modules, trace: Trace) -> Callable[[], None]:
    """CUDA events on the forward of each module in ``modules``; the
    returned function removes the hooks and adds the device ms to
    ``trace.heads_ms``."""
    pending, opened, handles = [], {}, []
    for i, m in enumerate(modules):
        def pre(mod, args, i=i):
            opened[i] = torch.cuda.Event(enable_timing=True)
            opened[i].record()

        def post(mod, args, out, i=i):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            pending.append((opened.pop(i), ev))

        handles += [m.register_forward_pre_hook(pre), m.register_forward_hook(post)]

    def close():
        for h in handles:
            h.remove()
        torch.cuda.synchronize()
        trace.heads_ms = sum(a.elapsed_time(b) for a, b in pending)

    return close


def host_syncs(fn: Callable[[], None]) -> Dict[str, int]:
    """The host syncs of one call of ``fn`` under
    ``torch.cuda.set_sync_debug_mode("warn")`` -> {"file:line": count}."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return dict(collections.Counter(
        f"{'/'.join(w.filename.split('/')[-2:])}:{w.lineno}"
        for w in caught if "synchroniz" in str(w.message)))


def timed(fn: Callable[[], None], device) -> float:
    """Host seconds of ``fn``, the device synchronised at both ends."""
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    if cuda:
        torch.cuda.synchronize()
    return time.perf_counter() - t
