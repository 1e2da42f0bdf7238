"""Set-up: pool, collation, models and weights, the warming pass (s)."""


def read(rec):
    return rec.get("setup_s")
