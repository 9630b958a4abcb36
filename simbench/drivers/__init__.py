"""Drivers, found by the ``driver`` key of a cell: each has ``REPORTS`` (the
end-to-end metrics it measures) and ``run(ctx)``."""
