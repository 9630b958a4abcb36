"""Device ms per control step of the kernels launched inside the
``physics.step`` spans (every substep)."""


def read(rec):
    if rec.get("platform") != "gpu" or rec.get("driver") != "vector_env" or "physics.step" not in rec.get("spans", {}):
        return None
    return rec["span_device_s"]["physics.step"] * 1e3 / rec["steps"]
