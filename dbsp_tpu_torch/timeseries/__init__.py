"""Time series: watermarks, moving windows with trace GC, and
partitioned rolling aggregates over the radix time index. Counterpart of
``dbsp_tpu/timeseries/``. Importing the package registers the
``watermark_monotonic``, ``window`` and ``partitioned_rolling_aggregate``
stream methods."""

from dbsp_tpu_torch.timeseries import rolling, watermark, window  # noqa: F401
from dbsp_tpu_torch.timeseries.radix_tree import RadixTimeIndex
from dbsp_tpu_torch.timeseries.rolling import RollingAggregateOp
from dbsp_tpu_torch.timeseries.watermark import WatermarkMonotonic
from dbsp_tpu_torch.timeseries.window import WindowOp

__all__ = ["RadixTimeIndex", "RollingAggregateOp", "WatermarkMonotonic",
           "WindowOp"]
