"""Offline KITTI data preparation (counterpart of
``papc_tpu/detect/kitti/create_data.py``): the info files
(``kitti_infos_{train,val,trainval,test}.pkl``), the reduced point clouds
(``velodyne_reduced/``, the points inside the camera's frustum) and the
ground-truth database (``gt_database/`` and ``kitti_dbinfos_train.pkl``).
The ``.pkl`` files hold dicts of numpy arrays and plain values only, so
the JAX package's and the port's read in the other. Run the three
steps in order as

    python -m papc_tpu_torch.detect.kitti.create_data STEP --data_path ROOT

with STEP ``create_kitti_info_file`` (``--imageset_dir`` defaults to
``./kitti``; a tree from ``data.synthetic_kitti.write_kitti`` keeps its
splits in ``ROOT/ImageSets``), ``create_reduced_point_cloud`` and
``create_groundtruth_database``.
"""

from __future__ import annotations

import pathlib
import pickle

import numpy as np

from papc_tpu_torch.detect import box_np
from papc_tpu_torch.detect.kitti import common as kitti

KITTI_CLASSES = (
    "Car", "Pedestrian", "Cyclist", "Van", "Person_sitting",
    "Truck", "Tram", "Misc",
)


def _read_imageset_file(path):
    with open(path) as f:
        return [int(line) for line in f.readlines()]


def _calculate_num_points_in_gt(
    data_path, infos, relative_path, remove_outside=True, num_features=4
):
    for info in infos:
        v_path = (
            str(pathlib.Path(data_path) / info["velodyne_path"])
            if relative_path
            else info["velodyne_path"]
        )
        points = np.fromfile(v_path, dtype=np.float32).reshape(
            [-1, num_features]
        )
        rect = info["calib/R0_rect"]
        Trv2c = info["calib/Tr_velo_to_cam"]
        P2 = info["calib/P2"]
        if remove_outside:
            points = box_np.remove_outside_points(
                points, rect, Trv2c, P2, info["img_shape"]
            )
        annos = info["annos"]
        num_obj = len([n for n in annos["name"] if n != "DontCare"])
        gt_boxes_camera = np.concatenate(
            [
                annos["location"][:num_obj],
                annos["dimensions"][:num_obj],
                annos["rotation_y"][:num_obj, None],
            ],
            axis=1,
        )
        gt_boxes_lidar = box_np.box_camera_to_lidar(
            gt_boxes_camera, rect, Trv2c
        )
        indices = box_np.points_in_rbbox(points[:, :3], gt_boxes_lidar)
        num_points_in_gt = indices.sum(0)
        num_ignored = len(annos["dimensions"]) - num_obj
        annos["num_points_in_gt"] = np.concatenate(
            [num_points_in_gt, -np.ones([num_ignored])]
        ).astype(np.int32)


def create_kitti_info_file(
    data_path, save_path=None, relative_path=True, imageset_dir=None
):
    imageset_dir = pathlib.Path(imageset_dir or "./kitti")
    train_ids = _read_imageset_file(imageset_dir / "train.txt")
    val_ids = _read_imageset_file(imageset_dir / "val.txt")
    test_ids = _read_imageset_file(imageset_dir / "test.txt")
    save_path = pathlib.Path(save_path or data_path)

    def build(ids, training):
        infos = kitti.get_kitti_image_info(
            data_path,
            training=training,
            velodyne=True,
            calib=True,
            image_ids=ids,
            relative_path=relative_path,
            label_info=training,
        )
        if training:
            _calculate_num_points_in_gt(data_path, infos, relative_path)
        return infos

    infos_train = build(train_ids, True)
    with open(save_path / "kitti_infos_train.pkl", "wb") as f:
        pickle.dump(infos_train, f)
    infos_val = build(val_ids, True)
    with open(save_path / "kitti_infos_val.pkl", "wb") as f:
        pickle.dump(infos_val, f)
    with open(save_path / "kitti_infos_trainval.pkl", "wb") as f:
        pickle.dump(infos_train + infos_val, f)
    infos_test = build(test_ids, False)
    with open(save_path / "kitti_infos_test.pkl", "wb") as f:
        pickle.dump(infos_test, f)


def _create_reduced_point_cloud(
    data_path, info_path, save_path=None, back=False
):
    with open(info_path, "rb") as f:
        infos = pickle.load(f)
    for info in infos:
        v_path = pathlib.Path(data_path) / info["velodyne_path"]
        points = np.fromfile(str(v_path), dtype=np.float32).reshape(
            [-1, 4]
        )
        rect = info["calib/R0_rect"]
        P2 = info["calib/P2"]
        Trv2c = info["calib/Tr_velo_to_cam"]
        if back:
            points[:, 0] = -points[:, 0]
        points = box_np.remove_outside_points(
            points, rect, Trv2c, P2, info["img_shape"]
        )
        if save_path is None:
            save_dir = v_path.parent.parent / (
                v_path.parent.stem + "_reduced"
            )
            save_dir.mkdir(exist_ok=True)
            save_filename = str(save_dir / v_path.name)
        else:
            save_filename = str(pathlib.Path(save_path) / v_path.name)
        if back:
            save_filename += "_back"
        points.astype(np.float32).tofile(save_filename)


def create_reduced_point_cloud(
    data_path,
    train_info_path=None,
    val_info_path=None,
    test_info_path=None,
    save_path=None,
    with_back=False,
):
    root = pathlib.Path(data_path)
    train_info_path = train_info_path or root / "kitti_infos_train.pkl"
    val_info_path = val_info_path or root / "kitti_infos_val.pkl"
    test_info_path = test_info_path or root / "kitti_infos_test.pkl"
    for p in (train_info_path, val_info_path, test_info_path):
        if pathlib.Path(p).exists():
            _create_reduced_point_cloud(data_path, p, save_path)
            if with_back:
                _create_reduced_point_cloud(
                    data_path, p, save_path, back=True
                )


def create_groundtruth_database(
    data_path,
    info_path=None,
    used_classes=None,
    database_save_path=None,
    db_info_save_path=None,
    relative_path=True,
):
    root_path = pathlib.Path(data_path)
    info_path = info_path or root_path / "kitti_infos_train.pkl"
    database_save_path = pathlib.Path(
        database_save_path or root_path / "gt_database"
    )
    db_info_save_path = (
        db_info_save_path or root_path / "kitti_dbinfos_train.pkl"
    )
    database_save_path.mkdir(parents=True, exist_ok=True)
    with open(info_path, "rb") as f:
        kitti_infos = pickle.load(f)
    if used_classes is None:
        used_classes = list(KITTI_CLASSES)
    all_db_infos = {name: [] for name in used_classes}
    group_counter = 0
    for info in kitti_infos:
        velodyne_path = info["velodyne_path"]
        if relative_path:
            velodyne_path = str(root_path / velodyne_path)
        num_features = info.get("pointcloud_num_features", 4)
        points = np.fromfile(velodyne_path, dtype=np.float32).reshape(
            [-1, num_features]
        )
        image_idx = info["image_idx"]
        rect = info["calib/R0_rect"]
        P2 = info["calib/P2"]
        Trv2c = info["calib/Tr_velo_to_cam"]
        points = box_np.remove_outside_points(
            points, rect, Trv2c, P2, info["img_shape"]
        )
        annos = info["annos"]
        names = annos["name"]
        difficulty = annos["difficulty"]
        gt_idxes = annos["index"]
        num_obj = int(np.sum(annos["index"] >= 0))
        rbbox_cam = kitti.anno_to_rbboxes(annos)[:num_obj]
        rbbox_lidar = box_np.box_camera_to_lidar(rbbox_cam, rect, Trv2c)
        group_ids = annos.get(
            "group_ids", np.arange(len(names), dtype=np.int64)
        )
        group_dict = {}
        point_indices = box_np.points_in_rbbox(points, rbbox_lidar)
        for i in range(num_obj):
            filename = f"{image_idx}_{names[i]}_{gt_idxes[i]}.bin"
            filepath = database_save_path / filename
            gt_points = points[point_indices[:, i]].copy()
            gt_points[:, :3] -= rbbox_lidar[i, :3]
            gt_points.astype(np.float32).tofile(str(filepath))
            if names[i] in used_classes:
                db_path = (
                    str(database_save_path.stem + "/" + filename)
                    if relative_path
                    else str(filepath)
                )
                db_info = {
                    "name": names[i],
                    "path": db_path,
                    "image_idx": image_idx,
                    "gt_idx": int(gt_idxes[i]),
                    "box3d_lidar": rbbox_lidar[i],
                    "num_points_in_gt": gt_points.shape[0],
                    "difficulty": int(difficulty[i]),
                }
                gid = group_ids[i]
                if gid not in group_dict:
                    group_dict[gid] = group_counter
                    group_counter += 1
                db_info["group_id"] = group_dict[gid]
                if "score" in annos:
                    db_info["score"] = annos["score"][i]
                all_db_infos[names[i]].append(db_info)
    with open(db_info_save_path, "wb") as f:
        pickle.dump(all_db_infos, f)
    return all_db_infos


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(description="KITTI data preparation")
    sub = parser.add_subparsers(dest="command", required=True)
    p1 = sub.add_parser("create_kitti_info_file")
    p1.add_argument("--data_path", required=True)
    p1.add_argument("--save_path", default=None)
    p1.add_argument("--imageset_dir", default=None)
    p2 = sub.add_parser("create_reduced_point_cloud")
    p2.add_argument("--data_path", required=True)
    p3 = sub.add_parser("create_groundtruth_database")
    p3.add_argument("--data_path", required=True)
    p3.add_argument("--info_path", default=None)
    args = parser.parse_args(argv)
    if args.command == "create_kitti_info_file":
        create_kitti_info_file(
            args.data_path, args.save_path, imageset_dir=args.imageset_dir
        )
    elif args.command == "create_reduced_point_cloud":
        create_reduced_point_cloud(args.data_path)
    elif args.command == "create_groundtruth_database":
        create_groundtruth_database(args.data_path, args.info_path)


if __name__ == "__main__":
    main()
