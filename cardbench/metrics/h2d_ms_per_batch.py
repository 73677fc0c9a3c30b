"""Device time of host-to-device copies in the device slice, per batch
served there, milliseconds."""

from cardbench import trace


def read(ctx):
    us = sum(float(e["dur"]) for e in trace.complete(
        ctx.device_events, ("gpu_memcpy",)) if "HtoD" in e["name"])
    if us <= 0:
        return None
    return 1e-3 * us / ctx.batches
