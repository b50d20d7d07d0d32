"""device_idle.survey: the share of the traced fit_batch call's span in which
nothing ran on the device (1 - the union of kernel, copy and set
intervals / span), in %."""
from portbench.harness import layers


def read(rec):
    return layers.idle_share(rec)
