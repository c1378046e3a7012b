"""Time series: watermarks and moving windows with trace GC. Counterpart
of ``dbsp_tpu/timeseries/`` (the rolling aggregate is not ported yet).
Importing the package registers the ``watermark_monotonic`` and
``window`` stream methods."""

from dbsp_tpu_torch.timeseries import watermark, window  # noqa: F401
from dbsp_tpu_torch.timeseries.watermark import WatermarkMonotonic
from dbsp_tpu_torch.timeseries.window import WindowOp

__all__ = ["WatermarkMonotonic", "WindowOp"]
