"""Data of the port: preprocessing and synthetic image splits."""
