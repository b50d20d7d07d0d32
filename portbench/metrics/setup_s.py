"""setup_s: seconds from the process's start to the first timed unit (imports,
the CUDA context, the kernels' build or load, the inputs, one warm-up unit)."""


def read(rec):
    return rec["setup_s"]
