"""Evaluation (counterpart of ``papc_tpu/eval/``): the official KITTI
detection metrics (``kitti_eval``)."""
