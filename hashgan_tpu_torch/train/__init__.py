"""Stage-II training: the encoder's state and step, encoding, and the
``Experiment`` loop."""
