"""The 90th percentile of the host-clock time of every control step of the
traced run's window, in ms (each step ends at the vector env's own sync)."""
import statistics


def read(rec):
    steps = rec.get("step_s") or []
    if rec.get("driver") != "vector_env" or len(steps) < 10:
        return None
    return statistics.quantiles([s * 1e3 for s in steps], n=10)[-1]
