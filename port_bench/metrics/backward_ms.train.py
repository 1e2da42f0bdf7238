"""Device ms per train step of the kernels launched under the autograd
engine (the backward) in the traced window."""


def read(rec):
    t, n = rec.get("trace"), rec.get("requests")
    if rec.get("kind") != "train" or not t or not n or t["backward_s"] <= 0:
        return None
    return t["backward_s"] * 1e3 / n
