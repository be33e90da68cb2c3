"""Official KITTI mAP (11-point interpolated AP over 41 recall samples,
and AOS) and the COCO-style sweep (counterpart of
``papc_tpu/eval/kitti_eval.py``): ``get_thresholds``, the difficulty and
neighbour-class rules of ``clean_data``, the bbox / BEV / 3D overlaps
(the BEV ones on ``detect.box_np.rotate_iou_cpu``), the per-frame
TP / FP / FN / AOS statistics and ``eval_class`` per class, difficulty
and metric, in numpy. Where the JAX package takes its C++ passes
(``cc.kitti_eval_*``, ``cc.d3_box_overlap``, ``cc.rbbox_iou``) this is
the numpy path they fall back to: the statistics loop runs in Python, a
frame and a threshold at a time.
"""

from __future__ import annotations

import io as sysio

import numpy as np

from papc_tpu_torch.detect import box_np

CLASS_TO_NAME = {
    0: "Car",
    1: "Pedestrian",
    2: "Cyclist",
    3: "Van",
    4: "Person_sitting",
    5: "car",
    6: "tractor",
    7: "trailer",
}
NAME_TO_CLASS = {v: n for n, v in CLASS_TO_NAME.items()}

_CLASS_NAMES_LOWER = [
    "car", "pedestrian", "cyclist", "van", "person_sitting",
    "car", "tractor", "trailer",
]
MIN_HEIGHT = [40, 25, 25]
MAX_OCCLUSION = [0, 1, 2]
MAX_TRUNCATION = [0.15, 0.3, 0.5]
N_SAMPLE_PTS = 41
NO_DETECTION = -10000000


def get_mAP(prec: np.ndarray) -> np.ndarray:
    """11-point interpolated AP over the 41 recall samples."""
    return np.sum(prec[..., ::4], axis=-1) / 11 * 100


def get_thresholds(scores: np.ndarray, num_gt: int,
                   num_sample_pts: int = N_SAMPLE_PTS):
    scores = np.sort(scores)[::-1]
    current_recall = 0.0
    thresholds = []
    for i, score in enumerate(scores):
        l_recall = (i + 1) / num_gt
        r_recall = (i + 2) / num_gt if i < len(scores) - 1 else l_recall
        if (
            (r_recall - current_recall) < (current_recall - l_recall)
        ) and i < len(scores) - 1:
            continue
        thresholds.append(score)
        current_recall += 1 / (num_sample_pts - 1.0)
    return thresholds


# neighbor classes are ignored rather than counted as FPs
_NEIGHBOR_CLASS = {"car": "van", "pedestrian": "person_sitting"}


def clean_data(gt_anno, dt_anno, current_class: int, difficulty: int):
    """Per-frame GT/DT validity labels: 0 evaluated, 1 ignored, -1 other
    class. Neighbor classes (Van↔Car, Person_sitting↔Pedestrian) are
    ignored rather than counted as FPs. Vectorized (the per-name python
    loop was ~25% of official-eval wall time at val-split scale)."""
    cls = _CLASS_NAMES_LOWER[current_class]
    gt_names = np.char.lower(np.asarray(gt_anno["name"], dtype=str))
    gt_bbox = np.asarray(gt_anno["bbox"], np.float64).reshape(-1, 4)
    # gt validity: 1 = current class, 0 = ignored neighbor, -1 = other
    valid = np.where(gt_names == cls, 1, -1)
    neighbor = _NEIGHBOR_CLASS.get(cls)
    if neighbor is not None:
        valid = np.where(gt_names == neighbor, 0, valid)
    height = gt_bbox[:, 3] - gt_bbox[:, 1]
    ignore = (
        (np.asarray(gt_anno["occluded"]) > MAX_OCCLUSION[difficulty])
        | (np.asarray(gt_anno["truncated"]) > MAX_TRUNCATION[difficulty])
        | (height <= MIN_HEIGHT[difficulty])
    )
    counted = (valid == 1) & ~ignore
    ignored_gt = np.where(
        counted, 0, np.where(valid >= 0, 1, -1)
    ).astype(np.int64)
    num_valid_gt = int(counted.sum())
    dc_bboxes = list(gt_bbox[np.asarray(gt_anno["name"]) == "DontCare"])

    dt_names = np.char.lower(np.asarray(dt_anno["name"], dtype=str))
    dt_bbox = np.asarray(dt_anno["bbox"], np.float64).reshape(-1, 4)
    dt_height = np.abs(dt_bbox[:, 3] - dt_bbox[:, 1])
    ignored_dt = np.where(
        dt_height < MIN_HEIGHT[difficulty], 1,
        np.where(dt_names == cls, 0, -1),
    ).astype(np.int64)
    return num_valid_gt, ignored_gt, ignored_dt, dc_bboxes


def image_box_overlap(boxes, query_boxes, criterion=-1):
    """2D bbox overlap [N, K] with selectable denominator."""
    N, K = len(boxes), len(query_boxes)
    out = np.zeros((N, K), dtype=np.float64)
    if N == 0 or K == 0:
        return out
    b = boxes[:, None, :]
    q = query_boxes[None, :, :]
    iw = np.minimum(b[..., 2], q[..., 2]) - np.maximum(b[..., 0], q[..., 0])
    ih = np.minimum(b[..., 3], q[..., 3]) - np.maximum(b[..., 1], q[..., 1])
    inter = np.clip(iw, 0, None) * np.clip(ih, 0, None)
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    area_q = (q[..., 2] - q[..., 0]) * (q[..., 3] - q[..., 1])
    if criterion == -1:
        ua = area_b + area_q - inter
    elif criterion == 0:
        ua = np.broadcast_to(area_b, inter.shape)
    elif criterion == 1:
        ua = np.broadcast_to(area_q, inter.shape)
    else:
        ua = np.ones_like(inter)
    valid = (iw > 0) & (ih > 0) & (ua > 0)
    return np.where(valid, inter / np.where(ua > 0, ua, 1.0), 0.0)


def bev_box_overlap(boxes, qboxes, criterion=-1):
    """Camera-frame BEV rotated overlap: boxes [N, 5] (x, z, l, w, ry)."""
    return box_np.rotate_iou_cpu(boxes, qboxes, criterion=criterion)


def d3_box_overlap(boxes, qboxes, criterion=-1):
    """3D overlap in CAMERA coords: boxes [N, 7] (x, y, z, l, h, w, ry).
    BEV rotated intersection × height overlap (reference :131-162),
    vectorized over the whole [N, K] matrix (the JAX package's fused
    ``cc.d3_box_overlap`` computes the same)."""
    boxes = np.asarray(boxes)
    qboxes = np.asarray(qboxes)
    rinc = box_np.rotate_iou_cpu(
        boxes[:, [0, 2, 3, 5, 6]], qboxes[:, [0, 2, 3, 5, 6]], criterion=2
    )
    # y is the box BOTTOM in camera frame: overlap of [y-h, y] intervals
    iw = np.minimum(boxes[:, None, 1], qboxes[None, :, 1]) - np.maximum(
        boxes[:, None, 1] - boxes[:, None, 4],
        qboxes[None, :, 1] - qboxes[None, :, 4],
    )
    inc = iw * rinc
    vol1 = np.prod(boxes[:, 3:6], axis=1)[:, None]
    vol2 = np.prod(qboxes[:, 3:6], axis=1)[None, :]
    if criterion == -1:
        ua = vol1 + vol2 - inc
    elif criterion == 0:
        ua = np.broadcast_to(vol1, inc.shape)
    elif criterion == 1:
        ua = np.broadcast_to(vol2, inc.shape)
    else:
        ua = np.ones_like(inc)
    valid = (rinc > 0) & (iw > 0) & (ua > 0)
    return np.where(valid, inc / np.where(ua > 0, ua, 1.0), 0.0)


def compute_statistics(
    overlaps,  # [num_dt, num_gt]
    gt_datas,  # [num_gt, 5] bbox + alpha
    dt_datas,  # [num_dt, 6] bbox + alpha + score
    ignored_gt,
    ignored_det,
    dc_bboxes,
    metric,
    min_overlap,
    thresh=0.0,
    compute_fp=False,
    compute_aos=False,
):
    """One frame's TP/FP/FN/similarity at one score threshold
    (reference ``compute_statistics_jit`` :165-285)."""
    det_size = dt_datas.shape[0]
    gt_size = gt_datas.shape[0]
    dt_scores = dt_datas[:, -1]
    dt_alphas = dt_datas[:, 4]
    gt_alphas = gt_datas[:, 4]
    dt_bboxes = dt_datas[:, :4]

    assigned_detection = [False] * det_size
    ignored_threshold = [
        compute_fp and dt_scores[i] < thresh for i in range(det_size)
    ]
    tp, fp, fn, similarity = 0, 0, 0, 0.0
    thresholds = []
    delta = []
    for i in range(gt_size):
        if ignored_gt[i] == -1:
            continue
        det_idx = -1
        valid_detection = NO_DETECTION
        max_overlap = 0.0
        assigned_ignored_det = False
        for j in range(det_size):
            if ignored_det[j] == -1 or assigned_detection[j]:
                continue
            if ignored_threshold[j]:
                continue
            overlap = overlaps[j, i]
            dt_score = dt_scores[j]
            if (
                not compute_fp
                and overlap > min_overlap
                and dt_score > valid_detection
            ):
                det_idx = j
                valid_detection = dt_score
            elif (
                compute_fp
                and overlap > min_overlap
                and (overlap > max_overlap or assigned_ignored_det)
                and ignored_det[j] == 0
            ):
                max_overlap = overlap
                det_idx = j
                valid_detection = 1
                assigned_ignored_det = False
            elif (
                compute_fp
                and overlap > min_overlap
                and valid_detection == NO_DETECTION
                and ignored_det[j] == 1
            ):
                det_idx = j
                valid_detection = 1
                assigned_ignored_det = True
        if valid_detection == NO_DETECTION and ignored_gt[i] == 0:
            fn += 1
        elif valid_detection != NO_DETECTION and (
            ignored_gt[i] == 1 or ignored_det[det_idx] == 1
        ):
            assigned_detection[det_idx] = True
        elif valid_detection != NO_DETECTION:
            tp += 1
            thresholds.append(dt_scores[det_idx])
            if compute_aos:
                delta.append(gt_alphas[i] - dt_alphas[det_idx])
            assigned_detection[det_idx] = True
    if compute_fp:
        for i in range(det_size):
            if not (
                assigned_detection[i]
                or ignored_det[i] in (-1, 1)
                or ignored_threshold[i]
            ):
                fp += 1
        nstuff = 0
        if metric == 0 and len(dc_bboxes):
            dc = np.asarray(dc_bboxes).reshape(-1, 4)
            overlaps_dt_dc = image_box_overlap(dt_bboxes, dc, 0)
            for i in range(dc.shape[0]):
                for j in range(det_size):
                    if assigned_detection[j]:
                        continue
                    if ignored_det[j] in (-1, 1) or ignored_threshold[j]:
                        continue
                    if overlaps_dt_dc[j, i] > min_overlap:
                        assigned_detection[j] = True
                        nstuff += 1
        fp -= nstuff
        if compute_aos:
            tmp = [0.0] * fp + [
                (1.0 + np.cos(d)) / 2.0 for d in delta
            ]
            similarity = float(np.sum(tmp)) if (tp > 0 or fp > 0) else -1.0
    return tp, fp, fn, similarity, np.asarray(thresholds)


def _metric_boxes(anno, metric):
    """One frame's boxes in the metric's geometry."""
    n = len(anno["name"])
    if metric == 0:
        return np.asarray(anno["bbox"], np.float64).reshape(-1, 4)
    if metric == 1:
        if not n:
            return np.zeros((0, 5))
        return np.concatenate(
            [
                anno["location"][:, [0, 2]],
                anno["dimensions"][:, [0, 2]],
                anno["rotation_y"][..., None],
            ],
            axis=1,
        )
    if metric == 2:
        if not n:
            return np.zeros((0, 7))
        return np.concatenate(
            [
                anno["location"],
                anno["dimensions"],
                anno["rotation_y"][..., None],
            ],
            axis=1,
        )
    raise ValueError("unknown metric")


def _frame_overlaps(gt_annos, dt_annos, metric, frames_per_part=1):
    """Per-frame [num_dt, num_gt] overlap matrices.

    ``frames_per_part > 1`` computes frame-concatenated parts (the
    reference's ``calculate_iou_partly`` chunking, one overlap call a
    part, the per-frame diagonal blocks sliced out); per frame is the
    default."""
    overlap_fn = {
        0: image_box_overlap,
        1: lambda d, g: bev_box_overlap(d, g).astype(np.float64),
        2: lambda d, g: d3_box_overlap(d, g).astype(np.float64),
    }[metric]
    if frames_per_part <= 1:
        return [
            overlap_fn(
                _metric_boxes(dt, metric), _metric_boxes(gt, metric)
            )
            for gt, dt in zip(gt_annos, dt_annos)
        ]
    overlaps = []
    n_frames = len(gt_annos)
    for start in range(0, n_frames, frames_per_part):
        gts = gt_annos[start:start + frames_per_part]
        dts = dt_annos[start:start + frames_per_part]
        gt_boxes = [_metric_boxes(a, metric) for a in gts]
        dt_boxes = [_metric_boxes(a, metric) for a in dts]
        big = overlap_fn(
            np.concatenate(dt_boxes, axis=0),
            np.concatenate(gt_boxes, axis=0),
        )
        r0 = 0
        c0 = 0
        for db, gb in zip(dt_boxes, gt_boxes):
            overlaps.append(
                big[r0:r0 + len(db), c0:c0 + len(gb)]
            )
            r0 += len(db)
            c0 += len(gb)
    return overlaps


def _prepare_data(gt_annos, dt_annos, current_class, difficulty):
    gt_datas_list, dt_datas_list = [], []
    ignored_gts, ignored_dets, dontcares = [], [], []
    total_num_valid_gt = 0
    for gt, dt in zip(gt_annos, dt_annos):
        num_valid_gt, ignored_gt, ignored_det, dc = clean_data(
            gt, dt, current_class, difficulty
        )
        ignored_gts.append(np.asarray(ignored_gt, np.int64))
        ignored_dets.append(np.asarray(ignored_det, np.int64))
        dontcares.append(
            np.stack(dc, 0).astype(np.float64)
            if dc
            else np.zeros((0, 4))
        )
        total_num_valid_gt += num_valid_gt
        gt_datas_list.append(
            np.concatenate(
                [
                    np.asarray(gt["bbox"]).reshape(-1, 4),
                    np.asarray(gt["alpha"]).reshape(-1, 1),
                ],
                axis=1,
            )
        )
        dt_datas_list.append(
            np.concatenate(
                [
                    np.asarray(dt["bbox"]).reshape(-1, 4),
                    np.asarray(dt["alpha"]).reshape(-1, 1),
                    np.asarray(dt["score"]).reshape(-1, 1),
                ],
                axis=1,
            )
        )
    return (
        gt_datas_list,
        dt_datas_list,
        ignored_gts,
        ignored_dets,
        dontcares,
        total_num_valid_gt,
    )


def eval_class(
    gt_annos,
    dt_annos,
    current_class: int,
    difficulty: int,
    metric: int,
    min_overlap: float,
    compute_aos: bool = False,
    overlaps=None,
):
    """41-point precision/recall(/AOS) for one class+difficulty+metric.

    ``overlaps`` may carry precomputed ``_frame_overlaps(..., metric)``
    — they depend only on the metric, so callers sweeping difficulties
    and min-overlap settings (``do_eval``) share one computation."""
    assert len(gt_annos) == len(dt_annos)
    if overlaps is None:
        overlaps = _frame_overlaps(gt_annos, dt_annos, metric)
    (
        gt_datas_list,
        dt_datas_list,
        ignored_gts,
        ignored_dets,
        dontcares,
        total_num_valid_gt,
    ) = _prepare_data(gt_annos, dt_annos, current_class, difficulty)

    thresholdss = []
    for i in range(len(gt_annos)):
        _, _, _, _, th = compute_statistics(
            overlaps[i],
            gt_datas_list[i],
            dt_datas_list[i],
            ignored_gts[i],
            ignored_dets[i],
            dontcares[i],
            metric,
            min_overlap,
            thresh=0.0,
            compute_fp=False,
        )
        thresholdss += th.tolist()
    thresholds = np.asarray(
        get_thresholds(np.asarray(thresholdss), total_num_valid_gt)
    )
    pr = np.zeros([len(thresholds), 4], dtype=np.float64)
    for i in range(len(gt_annos)):
        for t, thresh in enumerate(thresholds):
            tp, fp, fn, similarity, _ = compute_statistics(
                overlaps[i],
                gt_datas_list[i],
                dt_datas_list[i],
                ignored_gts[i],
                ignored_dets[i],
                dontcares[i],
                metric,
                min_overlap,
                thresh=thresh,
                compute_fp=True,
                compute_aos=compute_aos,
            )
            pr[t, 0] += tp
            pr[t, 1] += fp
            pr[t, 2] += fn
            if similarity != -1:
                pr[t, 3] += similarity

    precision = np.zeros([N_SAMPLE_PTS])
    recall = np.zeros([N_SAMPLE_PTS])
    aos = np.zeros([N_SAMPLE_PTS])
    for i in range(len(thresholds)):
        recall[i] = pr[i, 0] / max(pr[i, 0] + pr[i, 2], 1e-9)
        precision[i] = pr[i, 0] / max(pr[i, 0] + pr[i, 1], 1e-9)
        if compute_aos:
            aos[i] = pr[i, 3] / max(pr[i, 0] + pr[i, 1], 1e-9)
    # right-max interpolation
    for i in range(len(thresholds)):
        precision[i] = np.max(precision[i:])
        recall[i] = np.max(recall[i:])
        if compute_aos:
            aos[i] = np.max(aos[i:])
    return {"recall": recall, "precision": precision, "orientation": aos}


def do_eval(
    gt_annos, dt_annos, current_class, min_overlaps, compute_aos=False,
    overlap_cache=None,
):
    """min_overlaps: [bbox_overlap, bev_overlap, 3d_overlap]. Returns
    (mAP_bbox, mAP_bev, mAP_3d, mAP_aos) each per-difficulty list.
    ``overlap_cache`` (a dict, keyed by metric) shares the per-frame
    overlap matrices across difficulties, classes, and min-overlap
    settings — they depend only on the metric."""
    if overlap_cache is None:
        overlap_cache = {}

    def _overlaps(metric):
        if metric not in overlap_cache:
            overlap_cache[metric] = _frame_overlaps(
                gt_annos, dt_annos, metric
            )
        return overlap_cache[metric]

    mAP_bbox, mAP_aos, mAP_bev, mAP_3d = [], [], [], []
    for d in range(3):
        ret = eval_class(
            gt_annos, dt_annos, current_class, d, 0,
            min_overlaps[0], compute_aos, overlaps=_overlaps(0),
        )
        mAP_bbox.append(float(get_mAP(ret["precision"])))
        if compute_aos:
            mAP_aos.append(float(get_mAP(ret["orientation"])))
    for d in range(3):
        ret = eval_class(
            gt_annos, dt_annos, current_class, d, 1, min_overlaps[1],
            overlaps=_overlaps(1),
        )
        mAP_bev.append(float(get_mAP(ret["precision"])))
    for d in range(3):
        ret = eval_class(
            gt_annos, dt_annos, current_class, d, 2, min_overlaps[2],
            overlaps=_overlaps(2),
        )
        mAP_3d.append(float(get_mAP(ret["precision"])))
    return mAP_bbox, mAP_bev, mAP_3d, mAP_aos


OVERLAP_0_7 = np.array(
    [[0.7, 0.5, 0.5, 0.7, 0.5, 0.7, 0.7, 0.7]] * 3
)
OVERLAP_0_5 = np.array(
    [
        [0.7, 0.5, 0.5, 0.7, 0.5, 0.5, 0.5, 0.5],
        [0.5, 0.25, 0.25, 0.5, 0.25, 0.5, 0.5, 0.5],
        [0.5, 0.25, 0.25, 0.5, 0.25, 0.5, 0.5, 0.5],
    ]
)


def _print_str(value, sstream=None):
    if sstream is None:
        sstream = sysio.StringIO()
    sstream.truncate(0)
    sstream.seek(0)
    print(value, file=sstream)
    return sstream.getvalue()


def get_official_eval_result(
    gt_annos, dt_annos, current_classes, return_data=False
):
    """Official KITTI results at the moderate/easy overlap matrices for
    each requested class (reference :791-855)."""
    if not isinstance(current_classes, (list, tuple)):
        current_classes = [current_classes]
    current_classes = [
        NAME_TO_CLASS[c] if isinstance(c, str) else c
        for c in current_classes
    ]
    compute_aos = False
    for anno in dt_annos:
        if anno["alpha"].shape[0] != 0:
            if anno["alpha"][0] != -10:
                compute_aos = True
            break
    result = ""
    data = {}
    overlap_cache = {}  # per-frame overlaps depend only on the metric
    for cls in current_classes:
        for tag, overlaps in (("0.7", OVERLAP_0_7), ("0.5", OVERLAP_0_5)):
            mo = overlaps[:, cls]
            # per-metric thresholds: bbox/bev/3d all use the class column
            mAPbbox, mAPbev, mAP3d, mAPaos = do_eval(
                gt_annos, dt_annos, cls, [mo[0], mo[1], mo[2]],
                compute_aos, overlap_cache=overlap_cache,
            )
            result += _print_str(
                f"{CLASS_TO_NAME[cls]} "
                f"AP@{mo[0]:.2f}, {mo[1]:.2f}, {mo[2]:.2f}:"
            )
            result += _print_str(
                f"bbox AP:{mAPbbox[0]:.2f}, {mAPbbox[1]:.2f}, "
                f"{mAPbbox[2]:.2f}"
            )
            result += _print_str(
                f"bev  AP:{mAPbev[0]:.2f}, {mAPbev[1]:.2f}, "
                f"{mAPbev[2]:.2f}"
            )
            result += _print_str(
                f"3d   AP:{mAP3d[0]:.2f}, {mAP3d[1]:.2f}, {mAP3d[2]:.2f}"
            )
            if compute_aos:
                result += _print_str(
                    f"aos  AP:{mAPaos[0]:.2f}, {mAPaos[1]:.2f}, "
                    f"{mAPaos[2]:.2f}"
                )
            data[(cls, tag)] = {
                "bbox": mAPbbox, "bev": mAPbev, "3d": mAP3d,
                "aos": mAPaos,
            }
    if return_data:
        return result, data
    return result


def get_coco_eval_result(gt_annos, dt_annos, current_classes):
    """COCO-style AP averaged over an overlap sweep (reference
    :856-931): 10 thresholds linearly spanning the class's range."""
    class_to_range = {
        0: [0.5, 0.95, 10],
        1: [0.25, 0.7, 10],
        2: [0.25, 0.7, 10],
        3: [0.5, 0.95, 10],
        4: [0.25, 0.7, 10],
    }
    if not isinstance(current_classes, (list, tuple)):
        current_classes = [current_classes]
    current_classes = [
        NAME_TO_CLASS[c] if isinstance(c, str) else c
        for c in current_classes
    ]
    compute_aos = False
    for anno in dt_annos:
        if anno["alpha"].shape[0] != 0:
            if anno["alpha"][0] != -10:
                compute_aos = True
            break
    result = ""
    for cls in current_classes:
        lo, hi, n = class_to_range[cls]
        sweep = np.linspace(lo, hi, int(n))
        acc = np.zeros((4, 3))
        aos_valid = compute_aos
        for mo in sweep:
            mAPbbox, mAPbev, mAP3d, mAPaos = do_eval(
                gt_annos, dt_annos, cls, [mo, mo, mo], compute_aos
            )
            acc[0] += np.asarray(mAPbbox)
            acc[1] += np.asarray(mAPbev)
            acc[2] += np.asarray(mAP3d)
            if compute_aos:
                acc[3] += np.asarray(mAPaos)
        acc /= len(sweep)
        o_range = [lo, hi]
        result += _print_str(
            f"{CLASS_TO_NAME[cls]} coco "
            f"AP@{o_range[0]:.2f}:{(sweep[1]-sweep[0]):.2f}:"
            f"{o_range[1]:.2f}:"
        )
        result += _print_str(
            f"bbox AP:{acc[0][0]:.2f}, {acc[0][1]:.2f}, {acc[0][2]:.2f}"
        )
        result += _print_str(
            f"bev  AP:{acc[1][0]:.2f}, {acc[1][1]:.2f}, {acc[1][2]:.2f}"
        )
        result += _print_str(
            f"3d   AP:{acc[2][0]:.2f}, {acc[2][1]:.2f}, {acc[2][2]:.2f}"
        )
        if aos_valid:
            result += _print_str(
                f"aos  AP:{acc[3][0]:.2f}, {acc[3][1]:.2f}, "
                f"{acc[3][2]:.2f}"
            )
    return result
