"""Device selection, numeric settings, metrics logging, checkpoints,
gallery artifacts, and tracing and timing (``profiling``)."""
