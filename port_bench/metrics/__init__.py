"""One reader a metric: metrics/<name>.py, whose `read(run)` returns the
metric's value from a run (run.Run), or None where the run holds nothing
for it to read. common.py holds what several readers share."""
