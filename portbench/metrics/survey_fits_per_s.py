"""survey_fits_per_s: targets fitted per wall second, whole batches times
their targets over the window."""


def read(rec):
    w = rec["window"]
    return w["fits"] / w["seconds"] if w["fits"] else None
