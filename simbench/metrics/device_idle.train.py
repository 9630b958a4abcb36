"""Share of the profiled PPO iteration in which no kernel, copy or memset
ran on the device (one less the union of their intervals over it)."""


def read(rec):
    if rec.get("platform") != "gpu" or rec.get("driver") != "ppo" or not rec.get("window_s"):
        return None
    return 1.0 - rec["busy_s"] / rec["window_s"]
