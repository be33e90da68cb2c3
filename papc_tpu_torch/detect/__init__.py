"""PointPillars detection (counterpart of ``papc_tpu/detect/``).

Ported: the serving path from raw lidar points to rotated-NMS detections
(``train.make_predict_step``, ``train.evaluate``) and the training step
(``train.make_detection_train_step``: the network in training mode, the
focal and smooth-L1 loss of ``detector.compute_loss``, the optimizers
and rate schedules of ``builders.build_optimizer``), with target
assignment on the host (``target.TargetAssigner``) and the car config
carried as Python data (``config.car_config()``). The KITTI pipeline, the
training loop over it and the CLI are listed in ``ROADMAP.md``, Queue 1
item 6.
"""
