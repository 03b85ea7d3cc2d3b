"""Device selection, numeric settings, metrics logging, checkpoints,
gallery artifacts, and tracing (``profiling``: the profiler's trace and the
program's spans, phases and counters)."""
