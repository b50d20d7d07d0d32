"""readout_s.fit: seconds of the traced fit's ``psfmc.readout`` spans (a
segment's accept counts, its chain and lnprob copied to the host, and
their concatenation onto the chain)."""
from portbench.harness import program_spans


def read(rec):
    return program_spans.seconds(rec, "psfmc.fit", "psfmc.readout")
