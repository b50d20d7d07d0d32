"""capture_s.fit: seconds of the traced fit's ``psfmc.capture`` spans (each
a step variant's warm-up and CUDA graph capture; a new sampler a fit
captures its three variants); 0 where nothing was captured."""
from portbench.harness import program_spans


def read(rec):
    return program_spans.seconds(rec, "psfmc.fit", "psfmc.capture")
