"""PointPillars detection (counterpart of ``papc_tpu/detect/``).

Ported so far: the serving path from raw lidar points to rotated-NMS
detections (``train.make_predict_step``, ``train.evaluate``), with the
car config carried as Python data (``config.CAR_CONFIG``). Training, the
KITTI pipeline and the CLI are listed in ``ROADMAP.md``, Queue 1 item 6.
"""
