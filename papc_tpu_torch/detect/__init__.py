"""PointPillars detection (counterpart of ``papc_tpu/detect/``).

Ported: the serving path from raw lidar points to rotated-NMS detections
(``train.make_predict_step``, ``train.predict_frames``), the training
step (``train.make_detection_train_step``: the network in training mode,
the focal and smooth-L1 loss of ``detector.compute_loss``, the
optimizers and rate schedules of ``builders.build_optimizer``) with
target assignment on the host (``target.TargetAssigner``), the KITTI
pipeline (``kitti/``: data preparation, augmentation, the ground-truth
database sampler, the dataset), the training loop ``train.train`` with
its checkpoints and worker pool, ``train.evaluate`` (KITTI annos),
``train.evaluate_checkpoint`` with the official mAP and the CLI
(``python -m papc_tpu_torch.detect.train``). The car config is carried
as Python data and read and written as JSON (``config``). Not ported:
``ROADMAP.md``, Queue 1 items 4 (``SCAN_STEPS``) and 6.2-6.4.
"""
