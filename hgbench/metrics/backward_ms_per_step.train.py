"""backward_ms_per_step.train: the self time of the backward passes (the
spans whose names end in ``.backward``: the gradient penalty's input
gradient, each network's parameter gradients), in milliseconds a GAN
cycle or encoder step, from the program's spans in the traced window."""

from hgbench import program_spans


def read(run):
    snap = program_spans.snapshot()
    t = program_spans.self_ns_ending(snap, ".backward")
    return None if t is None else program_spans.per_count(
        t, "train.steps", 1e6, snap)
