"""Hierarchical span profiler for the proof system.

Re-design of the reference profiler
(triton-vm/src/profiler.rs:84-660): a process-global
profiler that records a tree of named, categorised spans, aggregates
repeated invocations of the same call path, and renders a report with
relative weights plus derived throughput lines (cycles/s, padded
height/s, LDT domain length/s).

Differences from the reference are deliberate:
- spans are identified by their name path (not source location) — Python
  has no cheap `here!()` macro, and name paths are stable across
  refactors;
- device work is asynchronous on a CUDA stream; callers that want honest
  device timings must synchronise before closing a span. `device_span`
  and the prover's stage markers do, but only while a session is open:
  an unprofiled prove runs without those synchronisations.

Besides the summed tree, a session keeps each span invocation as an
`Interval` on the host's wall clock (`time.time_ns`, the clock a device
trace can be put on) and counters (`count`) on the innermost open span.
`totals()` sums the seconds and counts of every finished session of the
process, by span path.

Usage::

    from triton_vm_tpu_torch.utils import profiler
    profiler.start("prove fib")
    with profiler.span("LDE", category="LDE"):
        profiler.count("rows", 1024)
        ...
    profile = profiler.finish().with_cycle_count(n)
    print(profile)
    profile.intervals()   # [Interval(path, start_ns, end_ns, counts)]

All hooks no-op unless `start()` was called, so library code can be
instrumented unconditionally.
"""

from __future__ import annotations

import logging
import time
from contextlib import contextmanager
from dataclasses import dataclass, field

__all__ = ["start", "finish", "span", "device_span", "count", "recording",
           "device_read", "totals", "reset_totals", "Interval", "Totals",
           "PerformanceProfile"]

# The counter family of the host's blocking reads of CUDA tensors
# (ops/gf.py): reads, bytes read, seconds the host waited in them.
DEVICE_READS = "device reads"
DEVICE_READ_BYTES = "device reads.bytes"
DEVICE_READ_SECONDS = "device reads.s"


@dataclass
class _Task:
    name: str
    parent: int | None
    depth: int
    category: str | None
    start_time: float = 0.0
    num_invocations: int = 0
    total_duration: float = 0.0
    counts: dict = field(default_factory=dict)


@dataclass
class Interval:
    """One span invocation: its path (the names from the session's
    top-level span down to it), its start and end on `time.time_ns`, and
    the counts made while it was the innermost open span."""
    path: tuple
    start_ns: int
    end_ns: int
    counts: dict


def _in_category(tasks, task) -> bool:
    """Whether an ancestor of `task` has its category."""
    parent = task.parent
    while parent is not None:
        if tasks[parent].category == task.category:
            return True
        parent = tasks[parent].parent
    return False


def _add_counts(into: dict, counts: dict) -> None:
    for name, n in counts.items():
        into[name] = into.get(name, 0) + n


class _Profiler:
    def __init__(self, name: str):
        self.name = name
        self.t0 = time.perf_counter()
        self.active: list[int] = []
        # per open invocation, innermost last: (start_ns, its counts)
        self.open: list[tuple[int, dict]] = []
        self.intervals: list[Interval] = []
        self.counts: dict = {}  # counts made while no span was open
        # keyed by invocation path (tuple of span names root->leaf) so a
        # span run repeatedly (e.g. per FRI round) aggregates, mirroring
        # profiler.rs:443-489's InvocationPath keying.
        self.tasks: dict[tuple, _Task] = {}
        self.order: list[tuple] = []

    def enter(self, name: str, category: str | None):
        parent = self.active[-1] if self.active else None
        parent_path = self.order[parent] if parent is not None else ()
        path = parent_path + (name,)
        task = self.tasks.get(path)
        if task is None:
            task = _Task(name, parent, len(self.active), category)
            self.tasks[path] = task
            self.order.append(path)
        task.num_invocations += 1
        self.active.append(self.order.index(path))
        self.open.append((time.time_ns(), {}))
        task.start_time = time.perf_counter()

    def _close(self) -> _Task:
        """Close the innermost open span."""
        path = self.order[self.active.pop()]
        task = self.tasks[path]
        task.total_duration += time.perf_counter() - task.start_time
        start_ns, counts = self.open.pop()
        self.intervals.append(Interval(path, start_ns, time.time_ns(),
                                       counts))
        _add_counts(task.counts, counts)
        return task

    def count(self, name: str, n):
        counts = self.open[-1][1] if self.open else self.counts
        counts[name] = counts.get(name, 0) + n

    def exit(self, name: str):
        """Close the innermost open span named `name`.

        Tolerant of disorder (a crash between low-level enter/exit
        markers must not poison the NEXT profiling session): if `name`
        is open somewhere on the stack, every span above it is closed
        too; if it is not open at all, this is a no-op."""
        names = [self.tasks[self.order[i]].name for i in self.active]
        if name not in names:
            # Tolerated for crash recovery, but loudly: a typo'd span
            # name would otherwise silently drop timing data.
            logging.getLogger(__name__).warning(
                "profiler: exit(%r) with no matching open span "
                "(open: %r)", name, names)
            return
        target = len(names) - 1 - names[::-1].index(name)
        while len(self.active) > target:
            self._close()

    def finish(self) -> "PerformanceProfile":
        total = time.perf_counter() - self.t0
        while self.active:  # close unfinished spans, tagging them
            self._close().name += " (unfinished)"
        tasks = [self.tasks[p] for p in self.order]
        category_times: dict[str, float] = {}
        for t in tasks:
            # a span inside one of its own category is counted there
            if t.category is not None and not _in_category(tasks, t):
                category_times[t.category] = (
                    category_times.get(t.category, 0.0) + t.total_duration)
        _TOTALS.sessions += 1
        for path in self.order:
            task = self.tasks[path]
            _TOTALS.seconds[path] = (_TOTALS.seconds.get(path, 0.0)
                                     + task.total_duration)
            if task.counts:
                _add_counts(_TOTALS.counts.setdefault(path, {}), task.counts)
        if self.counts:
            _add_counts(_TOTALS.counts.setdefault((), {}), self.counts)
        return PerformanceProfile(self.name, total, tasks, category_times,
                                  records=self.intervals, counts=self.counts)


@dataclass
class Totals:
    """Every finished session of the process since import or the last
    `reset_totals()`, summed: seconds by span path, counts by span path
    (() for counts made with no span open) and counter name."""
    sessions: int = 0
    seconds: dict = field(default_factory=dict)
    counts: dict = field(default_factory=dict)

    def count(self, name: str):
        """The counter `name` summed over every path."""
        return sum(c.get(name, 0) for c in self.counts.values())


_ACTIVE: _Profiler | None = None
_TOTALS = Totals()


def start(name: str) -> None:
    """Begin a profiling session (profiler.rs:84-93)."""
    global _ACTIVE
    _ACTIVE = _Profiler(name)


def finish() -> "PerformanceProfile":
    """End the session and return the report (profiler.rs:96-104)."""
    global _ACTIVE
    prof, _ACTIVE = _ACTIVE, None
    if prof is None:
        return PerformanceProfile("<no profile>", 0.0, [], {})
    return prof.finish()


@contextmanager
def span(name: str, category: str | None = None):
    """Record a named span; no-op if no session is active."""
    prof = _ACTIVE
    if prof is None:
        yield
        return
    prof.enter(name, category)
    try:
        yield
    finally:
        prof.exit(name)


@contextmanager
def device_span(name: str, category: str | None, device):
    """`span` for work enqueued on `device`: while a session is open, a
    CUDA device's stream is synchronised before the span closes, so it
    holds its own device work. Without a session nothing is synchronised."""
    with span(name, category):
        yield
        if _ACTIVE is not None and device.type == "cuda":
            import torch

            torch.cuda.synchronize(device)


def recording() -> bool:
    """Whether a session is open."""
    return _ACTIVE is not None


def count(name: str, n=1) -> None:
    """Add n to the counter `name` of the innermost open span (of the
    session where no span is open); no-op without a session."""
    if _ACTIVE is not None:
        _ACTIVE.count(name, n)


def device_read(nbytes: int, seconds: float) -> None:
    """Count one blocking read of a CUDA tensor by the host: its bytes and
    the seconds the host waited in it (the DEVICE_READS family)."""
    prof = _ACTIVE
    if prof is not None:
        prof.count(DEVICE_READS, 1)
        prof.count(DEVICE_READ_BYTES, nbytes)
        prof.count(DEVICE_READ_SECONDS, seconds)


def totals() -> Totals:
    """A copy of the process's totals over finished sessions."""
    return Totals(_TOTALS.sessions, dict(_TOTALS.seconds),
                  {path: dict(c) for path, c in _TOTALS.counts.items()})


def reset_totals() -> None:
    global _TOTALS
    _TOTALS = Totals()


def enter(name: str, category: str | None = None) -> None:
    """Low-level span open (for stage-marker style callers)."""
    if _ACTIVE is not None:
        _ACTIVE.enter(name, category)


def exit(name: str) -> None:
    """Low-level span close; must match the innermost open span."""
    if _ACTIVE is not None:
        _ACTIVE.exit(name)


@dataclass
class PerformanceProfile:
    """Finished profile; str() renders the report (profiler.rs:591-864)."""

    name: str
    total_time: float
    tasks: list[_Task]
    category_times: dict[str, float]
    cycle_count: int | None = None
    padded_height: int | None = None
    ldt_domain_len: int | None = None
    records: list[Interval] = field(default_factory=list)
    counts: dict = field(default_factory=dict)  # made with no span open

    def with_cycle_count(self, n: int) -> "PerformanceProfile":
        self.cycle_count = n
        return self

    def with_padded_height(self, n: int) -> "PerformanceProfile":
        self.padded_height = n
        return self

    def with_ldt_domain_len(self, n: int) -> "PerformanceProfile":
        self.ldt_domain_len = n
        return self

    def spans(self) -> list[tuple[str, float, str | None]]:
        """Top-level (name, seconds, category) triples, report order —
        for embedding a stage profile in machine-readable output."""
        return [(t.name, t.total_duration, t.category)
                for t in self.tasks if t.parent is None]

    def intervals(self) -> list[Interval]:
        """Every span invocation of the session, in the order they
        closed, on `time.time_ns`."""
        return list(self.records)

    def _tree_prefix(self, index: int) -> str:
        task = self.tasks[index]
        if task.parent is None:
            return ""
        # is this task the last child of its parent?
        def is_last(i):
            t = self.tasks[i]
            return not any(u.parent == t.parent
                           for j, u in enumerate(self.tasks) if j > i)
        parts = []
        # walk ancestry: for each ancestor level, draw a vertical rule if
        # that ancestor has younger siblings
        chain = []
        cur = index
        while cur is not None:
            chain.append(cur)
            cur = self.tasks[cur].parent
        chain.reverse()  # root .. self
        for anc in chain[1:-1]:
            parts.append("  " if is_last(anc) else "│ ")
        parts.append("└─" if is_last(index) else "├─")
        return "".join(parts)

    def __str__(self) -> str:
        lines = [f"### {self.name}", ""]
        name_col = max([len(self._tree_prefix(i) + t.name)
                        for i, t in enumerate(self.tasks)] + [10]) + 2
        header = f"{'task':{name_col}} {'time':>10}  {'%':>6}  category"
        lines.append(header)
        lines.append("-" * len(header))
        for i, t in enumerate(self.tasks):
            rel = t.total_duration / self.total_time if self.total_time else 0
            label = self._tree_prefix(i) + t.name
            extra = f" ({t.num_invocations}x)" if t.num_invocations > 1 else ""
            cat = ""
            if t.category is not None:
                cat_total = self.category_times.get(t.category, 0.0)
                cat_rel = (t.total_duration / cat_total) if cat_total else 0
                cat = f"{t.category} ({cat_rel:5.1%})"
            lines.append(f"{label + extra:{name_col}} "
                         f"{_fmt_dur(t.total_duration):>10}  {rel:6.1%}  "
                         f"{cat}{_fmt_counts(t.counts)}".rstrip())
        lines.append("-" * len(header))
        lines.append(f"{'total':{name_col}} "
                     f"{_fmt_dur(self.total_time):>10}  {1:6.1%}"
                     f"{_fmt_counts(self.counts)}")
        if self.category_times:
            lines.append("")
            lines.append("categories:")
            for cat, t in sorted(self.category_times.items(),
                                 key=lambda kv: -kv[1]):
                rel = t / self.total_time if self.total_time else 0
                lines.append(f"  {cat:24} {_fmt_dur(t):>10}  {rel:6.1%}")
        for label, count in (("cycles", self.cycle_count),
                             ("padded height", self.padded_height),
                             ("LDT domain length", self.ldt_domain_len)):
            if count is not None and self.total_time > 0:
                lines.append(f"{label}: {count} "
                             f"({count / self.total_time:,.0f}/s)")
        return "\n".join(lines)


def _fmt_counts(counts: dict) -> str:
    if not counts:
        return ""
    return "  [" + ", ".join(
        f"{name} {n}" if isinstance(n, int) else f"{name} {n:.4g}"
        for name, n in counts.items()) + "]"


def _fmt_dur(seconds: float) -> str:
    if seconds >= 100:
        return f"{seconds:.0f}s"
    if seconds >= 1:
        return f"{seconds:.2f}s"
    if seconds >= 1e-3:
        return f"{seconds * 1e3:.2f}ms"
    return f"{seconds * 1e6:.0f}µs"
