"""checkpoint_s.fit: seconds of the traced fit's ``psfmc.checkpoint`` spans
(every ``save_database``: the trace table, the resume payload's device
reads, the FITS write and its re-read), mid-phase and each round's."""
from portbench.harness import program_spans


def read(rec):
    return program_spans.seconds(rec, "psfmc.fit", "psfmc.checkpoint")
