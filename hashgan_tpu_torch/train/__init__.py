"""Encoding (the training steps come with the stage-II slice)."""
