"""Operator library of the port. Importing this package attaches the
Stream sugar (map_rows/filter_rows/flat_map_rows/index_by/join_index/
aggregate/distinct/stream_distinct/plus/minus/neg/sum_with/apply/apply2/
inspect/stream_fold/keys_distinct/semijoin/antijoin/topk/join_range/
stream_join_range/output, and the time series' watermark_monotonic/window/
partitioned_rolling_aggregate)."""

# importing the modules registers their Stream methods
from dbsp_tpu_torch.operators import (  # noqa: F401
    aggregate, basic, distinct, filter_map, io_handles, join, join_range,
    semijoin, topk, trace_op)
import dbsp_tpu_torch.timeseries  # noqa: F401, E402  (time series)
from dbsp_tpu_torch.operators.aggregate import (Average, Count, Fold, Max,
                                                Min, Sum)
from dbsp_tpu_torch.operators.aggregate_linear import (LinearAverage,
                                                       LinearCount)
from dbsp_tpu_torch.operators.io_handles import (InputHandle, OutputHandle,
                                                 add_input_zset)

__all__ = ["InputHandle", "OutputHandle", "add_input_zset", "Average",
           "Count", "Fold", "Max", "Min", "Sum", "LinearAverage",
           "LinearCount"]
