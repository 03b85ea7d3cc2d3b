"""forward_ms_per_step.train: the self time of the forward passes (the
spans whose names end in ``.forward``: the critic's and the generator's
forward and losses; the encoder's augment, G's fakes, the 256 -> 227
geometry, AlexNet and the WML loss), in milliseconds a GAN cycle or
encoder step, from the program's spans in the traced window. Self time
leaves out the spans nested inside: the penalty's backward, inside the
critic's forward, counts as backward."""

from hgbench import program_spans


def read(run):
    snap = program_spans.snapshot()
    t = program_spans.self_ns_ending(snap, ".forward")
    return None if t is None else program_spans.per_count(
        t, "train.steps", 1e6, snap)
