"""fit_s: the window's wall seconds over the whole fits it completed (every
fit whole, the one in flight at the deadline finished)."""


def read(rec):
    w = rec["window"]
    return w["seconds"] / w["fits"] if w["fits"] else None
