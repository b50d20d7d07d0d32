"""replay_ms_per_step.fit: the traced fit's ``psfmc.steps`` spans (each
segment's graph replays, ending in the accept counts' copy, which waits
for them) less the ``psfmc.capture`` spans inside them, over its steps,
in ms: the sampler loop with the checkpoints, readouts and captures out."""
from portbench.harness import program_spans


def read(rec):
    s = program_spans.self_seconds(rec, "psfmc.fit", "psfmc.steps", "psfmc.capture")
    return None if s is None else 1e3 * s / rec["cell"]["steps"]
