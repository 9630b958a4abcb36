"""Host-clock ms per ``PPOTrainer.rollout`` call, synchronised at its ends,
over every iteration of the traced run's window."""
import statistics


def read(rec):
    times = rec.get("rollout_s") or []
    if rec.get("driver") != "ppo" or not times:
        return None
    return statistics.median(times) * 1e3
