"""driver_host_s.fit: the traced fit's init and images phases (the driver's
own host-clock phase_seconds, each ending in a device synchronize)."""


def read(rec):
    t = rec["traced"]
    if t is None or "phase_seconds" not in t:
        return None
    ph = t["phase_seconds"]
    if "init" not in ph or "images" not in ph:
        return None
    return ph["init"] + ph["images"]
