from dbsp_tpu_torch.zset.batch import Batch, bucket_cap, concat_batches

__all__ = ["Batch", "bucket_cap", "concat_batches"]
