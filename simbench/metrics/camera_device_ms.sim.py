"""Device ms per control step of the kernels launched inside the cameras'
``get_obs`` spans (render prep, the two raster kernels, the obs's texture)."""


def read(rec):
    if rec.get("platform") != "gpu" or rec.get("driver") != "vector_env" or "camera.get_obs" not in rec.get("spans", {}):
        return None
    return rec["span_device_s"]["camera.get_obs"] * 1e3 / rec["steps"]
