"""Kernel launches per control step: the host's launch calls (runtime and
driver API) inside the profiled steps, over their count."""


def read(rec):
    launches = rec.get("span_launches", {}).get("simbench.step")
    if rec.get("platform") != "gpu" or rec.get("driver") != "vector_env" or not launches:
        return None
    return launches / rec["steps"]
