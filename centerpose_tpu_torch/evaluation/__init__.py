from centerpose_tpu_torch.evaluation.iou3d import OrientedBox, box_iou_3d  # noqa: F401
from centerpose_tpu_torch.evaluation.metrics import AveragePrecision, HitMiss  # noqa: F401
