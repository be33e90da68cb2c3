"""PointPillars detection (counterpart of ``papc_tpu/detect/``).

Ported: the serving path from lidar points to rotated-NMS detections
(``train.make_predict_step``, ``train.predict_frames``), the training
step (``train.make_detection_train_step``: the network in training mode,
the focal and smooth-L1 loss of ``detector.compute_loss``, the
optimizers and rate schedules of ``builders.build_optimizer``) with
target assignment on the host (``target.TargetAssigner``), the KITTI
pipeline (``kitti/``: data preparation, augmentation, the ground-truth
database sampler, the dataset), the training loop ``train.train`` with
its checkpoints and worker pool, ``train.evaluate`` (KITTI annos),
``train.evaluate_checkpoint`` with the official mAP and the CLI
(``python -m papc_tpu_torch.detect.train``). Both shipped configs, the
car config and the 3-class one (Car, Pedestrian, Cyclist, with its
per-class NMS ``detector.predict_multiclass`` and the host
``nms_extra``), are carried as Python data, named on the CLI or read and
written as JSON (``config``); the builders take range anchors, the BEV
box coder and the GroupNorm RPN too. The pillars come from the device
voxelizer or from the host's (``voxelize_np``: ``MODEL.DEVICE_PILLARIZE``
false), into the padded grid or the flat points of the flat PFN
(``pfn_fast``, ``MODEL.PFN_FLAT``); both steps run in f32 or bf16
(``TRAIN_CONFIG.PRECISION``). Not ported: ``ROADMAP.md``, Queue 1 item 4
(``SCAN_STEPS``).
"""
