"""model_s.fit: seconds of the traced fit's ``psfmc.model`` span (the model
file parsed, its FITS inputs read, the posterior and the sampler built)
and its ``psfmc.prior_draws`` span (the walkers' start)."""
from portbench.harness import program_spans


def read(rec):
    return program_spans.seconds(rec, "psfmc.fit", "psfmc.model", "psfmc.prior_draws")
