"""Data of the port: synthetic image splits, batching and preprocessing."""
