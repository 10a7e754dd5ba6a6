"""table_fill.s: seconds a prove in the host's fill of the main table's
nine tables (tables/master.py::fill_main_table, the span `host table
fill`): every span path of the profiler's totals that ends in one of its
per-table sub-spans (`RAM table` holds the RAM Bezout on the device;
`table padding` pads all nine), summed over the traced window's
sessions, over their number; None untraced, where no session ran, or
where the program has no such sub-span."""

SPANS = ("op stack table", "RAM table", "jump stack table",
         "processor table", "program table", "hash table",
         "cascade and lookup tables", "U32 table", "table padding")


def read(run):
    if not run.trace:
        return None
    from triton_vm_tpu_torch.utils import profiler

    totals = getattr(profiler, "totals", None)
    if totals is None:
        return None
    t = totals()
    paths = [p for p in t.seconds if p and p[-1] in SPANS]
    if not t.sessions or not paths:
        return None
    return sum(t.seconds[p] for p in paths) / t.sessions
