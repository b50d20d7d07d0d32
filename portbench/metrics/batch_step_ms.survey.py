"""batch_step_ms.survey: the traced fit_batch call's ``psfmc.batch.steps``
spans (burn and retained steps, ending in the first read of the results,
which waits for them) less the ``psfmc.capture`` spans inside them, over
its steps, in ms."""
from portbench.harness import program_spans


def read(rec):
    s = program_spans.self_seconds(rec, "psfmc.fit_batch", "psfmc.batch.steps",
                                   "psfmc.capture")
    return None if s is None else 1e3 * s / rec["cell"]["steps"]
