"""Browser-streamed interactive viewer (counterpart of maniskill_tpu/viewer):
the human render camera streams as MJPEG to any browser, and keyboard and
mouse events stream back as teleoperation input."""
from .server import BrowserViewer

__all__ = ["BrowserViewer"]
