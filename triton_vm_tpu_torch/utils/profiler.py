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
  device timings must synchronise before closing a span (the prover
  does at every stage boundary).

Usage::

    from triton_vm_tpu_torch.utils import profiler
    profiler.start("prove fib")
    with profiler.span("LDE", category="LDE"):
        ...
    profile = profiler.finish().with_cycle_count(n)
    print(profile)

All hooks no-op unless `start()` was called, so library code can be
instrumented unconditionally.
"""

from __future__ import annotations

import logging
import time
from contextlib import contextmanager
from dataclasses import dataclass, field

__all__ = ["start", "finish", "span", "PerformanceProfile"]


@dataclass
class _Task:
    name: str
    parent: int | None
    depth: int
    category: str | None
    start_time: float = 0.0
    num_invocations: int = 0
    total_duration: float = 0.0


class _Profiler:
    def __init__(self, name: str):
        self.name = name
        self.t0 = time.perf_counter()
        self.active: list[int] = []
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
        task.start_time = time.perf_counter()
        task.num_invocations += 1
        self.active.append(self.order.index(path))

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
            idx = self.active.pop()
            task = self.tasks[self.order[idx]]
            task.total_duration += time.perf_counter() - task.start_time

    def finish(self) -> "PerformanceProfile":
        total = time.perf_counter() - self.t0
        while self.active:  # close unfinished spans, tagging them
            idx = self.active.pop()
            task = self.tasks[self.order[idx]]
            task.total_duration += time.perf_counter() - task.start_time
            task.name += " (unfinished)"
        category_times: dict[str, float] = {}
        for t in self.tasks.values():
            if t.category is not None:
                category_times[t.category] = (
                    category_times.get(t.category, 0.0) + t.total_duration)
        tasks = [self.tasks[p] for p in self.order]
        return PerformanceProfile(self.name, total, tasks, category_times)


_ACTIVE: _Profiler | None = None


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
    """`span` for work enqueued on `device`: on a CUDA device the stream
    is synchronised before the span closes, so it holds its own device
    work."""
    with span(name, category):
        yield
        if device.type == "cuda":
            import torch

            torch.cuda.synchronize(device)


def enter(name: str, category: str | None = None) -> None:
    """Low-level span open (for stage-marker style callers)."""
    if _ACTIVE is not None:
        _ACTIVE.enter(name, category)


def exit(name: str) -> None:
    """Low-level span close; must match the innermost open span."""
    if _ACTIVE is not None:
        _ACTIVE.exit(name)


def _weight(relative: float) -> int:
    """0..6 weight bucket (profiler.rs:552-563)."""
    for i, threshold in enumerate((0.4, 0.3, 0.2, 0.1, 0.07, 0.04)):
        if relative >= threshold:
            return 6 - i
    return 0


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
                         f"{cat}".rstrip())
        lines.append("-" * len(header))
        lines.append(f"{'total':{name_col}} "
                     f"{_fmt_dur(self.total_time):>10}  {1:6.1%}")
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


def _fmt_dur(seconds: float) -> str:
    if seconds >= 100:
        return f"{seconds:.0f}s"
    if seconds >= 1:
        return f"{seconds:.2f}s"
    if seconds >= 1e-3:
        return f"{seconds * 1e3:.2f}ms"
    return f"{seconds * 1e6:.0f}µs"
