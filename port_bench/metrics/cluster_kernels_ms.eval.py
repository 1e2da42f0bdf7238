"""Device ms per request of the clustering kernels (B1-B4) in the traced
window."""


def read(rec):
    t, n = rec.get("trace"), rec.get("requests")
    if rec.get("kind") != "eval" or not t or not n:
        return None
    v = t["by_family_s"].get("clustering kernels")
    return None if v is None else v * 1e3 / n
