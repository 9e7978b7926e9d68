"""One reader per metric, ``metrics/<name>.py``, found by the metric's
name in ``BENCHMARK.json``.  A reader has ``read(run)``, which returns the
number from the run's clocks, counters or trace (see ``harness.Run``), or
None where it finds nothing to read; the harness then leaves the metric
out.  A reader may also have ``probe(run)``, which the harness calls in a
traced run, after the traced trials and while the program's state is
alive, for work of the metric's own; what it returns is
``run.probes[<name>]``."""
