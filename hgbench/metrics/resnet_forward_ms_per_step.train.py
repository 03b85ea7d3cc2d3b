"""resnet_forward_ms_per_step.train: the self time of the ResNet encoder's
forward (the spans whose names begin ``enc.resnet.``: the stem, the four
stages and the head, each inside ``enc.forward``), in milliseconds an
encoder step, from the program's spans in the traced window. A program
without these spans gives None."""

from hgbench import program_spans


def read(run):
    snap = program_spans.snapshot()
    spans = [s for name, s in (snap or {}).get("spans", {}).items()
             if name.startswith("enc.resnet.")]
    if not spans:
        return None
    return program_spans.per_count(sum(float(s["self_ns"]) for s in spans),
                                   "train.steps", 1e6, snap)
