"""The KITTI pipeline (counterpart of ``papc_tpu/detect/kitti/``): label
and calib I/O (``common``), offline data preparation (``create_data``),
augmentation (``augment``), the ground-truth database sampler
(``sampling``) and the per-frame prep with its dataset
(``preprocess``)."""
