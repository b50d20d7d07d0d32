"""batch_prepare_s.survey: seconds of the traced fit_batch call's
``psfmc.batch.prepare`` spans (the stacks prepared, the walkers' start
drawn, the observation planes made) and its ``psfmc.batch.start`` spans
(the stacks and the start copied in, the start evaluated)."""
from portbench.harness import program_spans


def read(rec):
    return program_spans.seconds(rec, "psfmc.fit_batch", "psfmc.batch.prepare",
                                 "psfmc.batch.start")
