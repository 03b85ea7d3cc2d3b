"""Device selection, numeric settings, metrics logging, checkpoints and
gallery artifacts."""
