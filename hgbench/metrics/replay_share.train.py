"""replay_share.train: the share of the GAN cycles in the traced window
that ran as a replay of the cycle's CUDA graph (the program's counter
``gan.replays`` over ``train.steps``), in percent. A program without the
counter gives None."""

from hgbench import program_spans


def read(run):
    snap = program_spans.snapshot()
    replays = (snap or {}).get("counters", {}).get("gan.replays")
    if replays is None:
        return None
    return program_spans.per_count(100.0 * replays, "train.steps", 1.0, snap)
