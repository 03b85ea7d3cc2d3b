"""Device selection, numeric settings and gallery artifacts."""
