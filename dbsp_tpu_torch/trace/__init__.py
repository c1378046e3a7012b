from dbsp_tpu_torch.trace.spine import Spine

__all__ = ["Spine"]
