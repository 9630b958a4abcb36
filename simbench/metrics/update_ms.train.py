"""Host-clock ms per ``PPOTrainer.update`` call (its epochs of minibatch
steps), synchronised at its ends, over every iteration of the traced run's
window."""
import statistics


def read(rec):
    times = rec.get("update_s") or []
    if rec.get("driver") != "ppo" or not times:
        return None
    return statistics.median(times) * 1e3
