"""Device milliseconds of host-to-device copies a call in the traced
window."""


def read(run):
    if run.trace is None or not run.units.get("calls"):
        return None
    copies = sum(t - s for s, t, name, cat in run.trace.device
                 if cat == "gpu_memcpy" and "HtoD" in name) / 1e6
    return 1e3 * copies / run.units["calls"]
