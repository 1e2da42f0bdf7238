"""Share of the traced window with no device work under it: 1 - the union
of the device intervals over the window's wall (%)."""


def read(rec):
    t = rec.get("trace")
    if rec.get("kind") != "eval" or not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
