"""Device ms per request of the gather/index and copy/cat/fill kernel
families (the sparse convs' row gathers and their operand copies) in the
traced window."""


def read(rec):
    t, n = rec.get("trace"), rec.get("requests")
    if rec.get("kind") != "eval" or not t or not n:
        return None
    f = t["by_family_s"]
    return (f.get("gather/index", 0.0) + f.get("copy/cat/fill", 0.0)) * 1e3 / n
