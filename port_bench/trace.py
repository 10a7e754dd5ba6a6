"""Reading a traced run: device operations from `torch.profiler`'s CUDA
activity, the port's stage spans as host intervals, and the kernels'
launch shapes from a wrapper around their entry points.

All times are nanoseconds on the host's wall clock (`time.time_ns`). The
profiler's device timestamps are moved onto it by a marker operation run
between two host readings just after the profiler starts.
"""

from __future__ import annotations

import functools
import re
import time
from dataclasses import dataclass, field

import numpy as np

# K1-K4: the port's hand-written kernels, by the names the profiler shows
KERNELS = {
    "K1": re.compile(r"tip5_permutation_kernel"),
    "K2": re.compile(r"tip5_sponge_rows_kernel"),
    "K3": re.compile(r"quotient_rows_kernel|quotient_out_kernel"
                     r"|(?<![A-Za-z])seg_\d+"),
    "K4": re.compile(r"ntt_pass_kernel"),
}


def kernel_of(name: str) -> str | None:
    for k, pattern in KERNELS.items():
        if pattern.search(name):
            return k
    return None


@dataclass
class Span:
    path: tuple
    start: int
    end: int


class DeviceOps:
    """The device's operations as arrays: `names` (the distinct names),
    and per operation `name_id`, `start` and `end` (int64 ns, host
    clock). A window of eager int64 work holds millions of them."""

    def __init__(self, names, name_id, start, end):
        self.names = list(names)
        self.name_id = np.asarray(name_id, np.int64)
        self.start = np.asarray(start, np.int64)
        self.end = np.asarray(end, np.int64)
        self._union = None

    @classmethod
    def of(cls, ops):
        """From (name, start, end) triples."""
        ids = {}
        name_id = [ids.setdefault(n, len(ids)) for n, _, _ in ops]
        return cls(list(ids), name_id, [s for _, s, _ in ops],
                   [e for _, _, e in ops])

    def __len__(self):
        return len(self.start)

    def duration(self):
        return self.end - self.start

    def mask_of(self, predicate):
        """Per operation, whether its name satisfies `predicate`."""
        by_name = np.array([bool(predicate(n)) for n in self.names] or
                           [False], bool)
        return by_name[self.name_id] if len(self) else np.zeros(0, bool)

    def union(self):
        """The union of the operations' intervals: (starts, ends, the
        covered length before each interval)."""
        if self._union is None:
            order = np.argsort(self.start, kind="stable")
            s, e = self.start[order], self.end[order]
            reach = np.maximum.accumulate(e) if len(e) else e
            new = np.ones(len(s), bool)
            new[1:] = s[1:] > reach[:-1]
            starts = s[new]
            last = np.ones(len(s), bool)
            last[:-1] = new[1:]
            ends = reach[last]
            before = np.concatenate([[0], np.cumsum(ends - starts)])
            self._union = (starts, ends, before)
        return self._union

    def covered(self, lo, hi):
        """Length of each [lo, hi] (scalars or arrays) that the union of
        the operations covers."""
        starts, ends, before = self.union()
        lo = np.asarray(lo, np.int64)
        hi = np.asarray(hi, np.int64)

        def upto(t):
            # covered length of (-inf, t]
            i = np.searchsorted(starts, t, side="right")
            inside = np.where(i > 0, np.minimum(t, ends[np.maximum(i - 1, 0)])
                              - starts[np.maximum(i - 1, 0)], 0)
            return before[np.maximum(i - 1, 0)] * (i > 0) + np.maximum(inside,
                                                                       0)
        if len(starts) == 0:
            return np.zeros(np.broadcast(lo, hi).shape, np.int64)
        return upto(hi) - upto(lo)


@dataclass
class Trace:
    """What a traced window recorded."""
    ops: DeviceOps = None                          # on the host clock
    spans: list = field(default_factory=list)      # Span of the port
    launches: list = field(default_factory=list)   # (kernel, shape dict)
    offset_ns: int = 0
    marker_slack_ns: int = 0
    read_s: float = 0.0                            # reading the profiler


# ------------------------------------------------------------ spans

def innermost_span(spans, t):
    """The deepest span open at time t, or None."""
    best = None
    for sp in spans:
        if sp.start <= t < sp.end and (best is None
                                       or len(sp.path) > len(best.path)):
            best = sp
    return best


# ------------------------------------------------------------ profiler

def read_device(kineto_results):
    """(names, name ids, starts, ends) of the device's operations, in the
    profiler's clock."""
    ids = {}
    name_id, start, end = [], [], []
    for ev in kineto_results.events():
        if "CUDA" not in str(ev.device_type()):
            continue
        try:
            s = ev.start_ns()
            d = ev.duration_ns()
        except AttributeError:
            s = int(ev.start_us() * 1000)
            d = int(ev.duration_us() * 1000)
        name_id.append(ids.setdefault(ev.name(), len(ids)))
        start.append(s)
        end.append(s + d)
    return list(ids), name_id, start, end


def on_host_clock(kineto_results, before_ns: int, after_ns: int):
    """The device's operations on the host clock, and (offset, slack):
    the trace's first device operation is a marker run between the host
    readings before_ns and after_ns; the operations after it are
    returned."""
    names, name_id, start, end = read_device(kineto_results)
    ops = DeviceOps(names, name_id, start, end)
    if not len(ops):
        return ops, 0, 0
    first = int(np.argmin(ops.start))
    offset = (before_ns + after_ns) // 2 - int(
        ops.start[first] + ops.end[first]) // 2
    keep = ops.start + offset >= after_ns
    out = DeviceOps(ops.names, ops.name_id[keep], ops.start[keep] + offset,
                    ops.end[keep] + offset)
    return out, offset, (after_ns - before_ns) // 2


# ------------------------------------------------------------ recorders

class SpanRecorder:
    """Records the port's profiler spans (utils/profiler.py) as host
    intervals, by wrapping its session's enter and exit while a traced
    window runs."""

    def __init__(self, profiler_module):
        self.module = profiler_module
        self.spans = []
        self._open = []

    def __enter__(self):
        cls = self.module._Profiler
        self._orig = (cls.enter, cls.exit)
        orig_enter, orig_exit = self._orig
        rec = self

        def enter(prof, name, category=None):
            rec._open.append((name, time.time_ns()))
            return orig_enter(prof, name, category)

        def exit_(prof, name):
            names = [n for n, _ in rec._open]
            if name in names:
                target = len(names) - 1 - names[::-1].index(name)
                now = time.time_ns()
                while len(rec._open) > target:
                    path = tuple(n for n, _ in rec._open)
                    _, start = rec._open.pop()
                    rec.spans.append(Span(path, start, now))
            return orig_exit(prof, name)

        cls.enter, cls.exit = enter, exit_
        return self

    def __exit__(self, *exc):
        cls = self.module._Profiler
        cls.enter, cls.exit = self._orig
        self._open.clear()
        return False


class LaunchRecorder:
    """Records the shape of every call of the port's kernel entry points
    (K1, K2: ops/tip5_cuda.py; K3: ops/quotient_cuda.py; K4:
    ops/ntt_cuda.py) that reaches a CUDA device, by wrapping the module
    attributes the port calls them through."""

    def __init__(self, tip5_cuda, tip5_kernel, ntt_cuda, quotient_cuda):
        self.launches = []
        # (module, attribute, shape of a call, the argument on the device)
        self._patches = [
            (tip5_cuda, "permutation", self._k1, 0),
            (tip5_kernel, "permutation", self._k1, 0),
            (tip5_cuda, "sponge_absorb_rows", self._k2, 0),
            (tip5_kernel, "sponge_absorb_rows", self._k2, 0),
            (ntt_cuda, "ntt_rows", self._k4, 0),
            (quotient_cuda, "quotients_on_rows", self._k3, 1)]
        self._saved = []

    @staticmethod
    def _k1(state, *a, **kw):
        return "K1", {"batch": int(state.shape[1])}

    @staticmethod
    def _k2(rows, *a, **kw):
        return "K2", {"rows": int(rows.shape[0]), "width": int(rows.shape[1])}

    @staticmethod
    def _k4(x, root, length, pre=None, post=None, out=None):
        rows, n_in = (int(d) for d in x.shape)
        return "K4", {"rows": rows, "n_in": n_in, "length": int(length),
                      "scaled_words": (n_in if pre is not None else 0)
                      + (int(length) if post is not None else 0)}

    @staticmethod
    def _k3(tape, main, aux, points, shift, trace_len, *a, **kw):
        return "K3", {"rows": int(points.n), "trace_len": int(trace_len)}

    def __enter__(self):
        for mod, name, shape, on_device in self._patches:
            orig = getattr(mod, name)
            self._saved.append((mod, name, orig))
            setattr(mod, name, self._wrap(orig, shape, on_device))
        return self

    def _wrap(self, orig, shape, on_device):
        @functools.wraps(orig)
        def wrapper(*a, **kw):
            if a[on_device].device.type == "cuda":
                self.launches.append(shape(*a, **kw))
            return orig(*a, **kw)
        return wrapper

    def __exit__(self, *exc):
        for mod, name, orig in reversed(self._saved):
            setattr(mod, name, orig)
        self._saved.clear()
        return False
