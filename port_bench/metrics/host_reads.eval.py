"""Reads of a device tensor by the host (each waits for the device) the
port counts in ``host_reads`` per request of the traced window, from
``pbnet_torch.telemetry``."""


def read(rec):
    if rec.get("kind") != "eval" or not rec.get("trace") or not rec.get("requests"):
        return None
    try:
        from pbnet_torch import telemetry
    except ImportError:  # a port that counts no reads
        return None
    c = telemetry.collected()["counts"].get("host_reads")
    return c["total"] / rec["requests"] if c else None
