"""feed_ms_per_step.train: the host's time in the training loop's batch
feed (``train.feed``: the host's draw, the numpy gather, the pinned copy's
enqueue), in milliseconds a GAN cycle or encoder step, from the program's
spans in the traced window."""

from hgbench import program_spans


def read(run):
    snap = program_spans.snapshot()
    t = program_spans.total_ns(snap, "train.feed")
    return None if t is None else program_spans.per_count(
        t, "train.steps", 1e6, snap)
