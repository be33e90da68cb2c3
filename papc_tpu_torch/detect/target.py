"""Anchor → ground-truth target assignment on the host, in numpy
(counterpart of ``papc_tpu/detect/target.py``).

Labels: -1 ignore, 0 background, > 0 the class. Positives are the
anchors that share a ground truth's best overlap (forced matches, ties
included; a ground truth whose best overlap is 0 matches nothing) and
the anchors at or above ``matched_threshold``; negatives lie below
``unmatched_threshold``; ``positive_fraction`` subsamples both with the
caller's ``RandomState``. The JAX package takes the overlap block in one
C++ pass (``cc.iou2d_assign``) when its library loads; this is the numpy
block it falls back to, and gives the same labels, targets and weights.
"""

from __future__ import annotations

import numpy as np

from papc_tpu_torch.detect.similarity import NearestIouSimilarity


def unmap(data, count, inds, fill=0):
    """``data`` of the rows ``inds`` scattered into ``count`` rows filled
    with ``fill``."""
    if count == len(inds):
        return data
    ret = np.full((count,) + data.shape[1:], fill, dtype=data.dtype)
    ret[inds] = data
    return ret


def create_target_np(all_anchors, gt_boxes, similarity_fn, box_encoding_fn,
                     prune_anchor_fn=None, gt_classes=None,
                     matched_threshold=0.6, unmatched_threshold=0.45,
                     positive_fraction=None, rpn_batch_size=300,
                     norm_by_num_examples=False, box_code_size=7,
                     rng: np.random.RandomState | None = None):
    """Labels, box targets and their weights of ``all_anchors [A, 7]``
    against ``gt_boxes [G, 7]`` → ``{"labels" [A], "bbox_targets" [A,
    code], "bbox_outside_weights" [A], "assigned_anchors_overlap",
    "positive_gt_id", "assigned_anchors_inds"}``."""
    total_anchors = all_anchors.shape[0]
    if prune_anchor_fn is not None:
        inds_inside = prune_anchor_fn(all_anchors)
        anchors = all_anchors[inds_inside]
        if not isinstance(matched_threshold, float):
            matched_threshold = matched_threshold[inds_inside]
        if not isinstance(unmatched_threshold, float):
            unmatched_threshold = unmatched_threshold[inds_inside]
    else:
        anchors = all_anchors
        inds_inside = None
    num_inside = len(anchors)
    if gt_classes is None:
        gt_classes = np.ones([len(gt_boxes)], dtype=np.int32)
    if rng is None:
        rng = np.random.RandomState()

    labels = np.full((num_inside,), -1, dtype=np.int32)
    gt_ids = np.full((num_inside,), -1, dtype=np.int32)

    have_work = len(gt_boxes) > 0 and num_inside > 0
    if have_work:
        overlap = similarity_fn(anchors, gt_boxes)  # [A, G]
        anchor_to_gt_argmax = overlap.argmax(axis=1)
        anchor_to_gt_max = overlap.max(axis=1)
        # a ground truth whose best overlap is 0 matches nothing
        gt_to_anchor_max = overlap.max(axis=0)
        gt_to_anchor_max = np.where(gt_to_anchor_max == 0, -1.0,
                                    gt_to_anchor_max)
        # forced matches: the anchors tying each ground truth's best
        # overlap (an anchor appears once a tied ground truth; the label
        # writes are idempotent, all by the anchor's own row argmax)
        anchors_with_max_overlap = np.where(overlap == gt_to_anchor_max)[0]
        gt_inds_force = anchor_to_gt_argmax[anchors_with_max_overlap]
        labels[anchors_with_max_overlap] = gt_classes[gt_inds_force]
        gt_ids[anchors_with_max_overlap] = gt_inds_force
        pos = anchor_to_gt_max >= matched_threshold
        labels[pos] = gt_classes[anchor_to_gt_argmax[pos]]
        gt_ids[pos] = anchor_to_gt_argmax[pos]
        bg_inds = np.where(anchor_to_gt_max < unmatched_threshold)[0]
    else:
        bg_inds = np.arange(num_inside)

    fg_inds = np.where(labels > 0)[0]
    fg_max_overlap = anchor_to_gt_max[fg_inds] if have_work else None
    gt_pos_ids = gt_ids[fg_inds]

    if positive_fraction is not None:
        num_fg = int(positive_fraction * rpn_batch_size)
        if len(fg_inds) > num_fg:
            disable = rng.choice(fg_inds, size=len(fg_inds) - num_fg,
                                 replace=False)
            labels[disable] = -1
            fg_inds = np.where(labels > 0)[0]
        num_bg = rpn_batch_size - np.sum(labels > 0)
        if len(bg_inds) > num_bg:
            enable = bg_inds[rng.randint(len(bg_inds), size=num_bg)]
            labels[enable] = 0
    elif not have_work:
        labels[:] = 0
    else:
        labels[bg_inds] = 0
        # forced positives win over the background label
        labels[anchors_with_max_overlap] = gt_classes[gt_inds_force]

    bbox_targets = np.zeros((num_inside, box_code_size),
                            dtype=all_anchors.dtype)
    if have_work and len(fg_inds) > 0:
        bbox_targets[fg_inds] = box_encoding_fn(
            gt_boxes[anchor_to_gt_argmax[fg_inds]], anchors[fg_inds])

    bbox_outside_weights = np.zeros((num_inside,), all_anchors.dtype)
    if norm_by_num_examples:
        num_examples = max(1.0, float(np.sum(labels >= 0)))
        bbox_outside_weights[labels > 0] = 1.0 / num_examples
    else:
        bbox_outside_weights[labels > 0] = 1.0

    if inds_inside is not None:
        labels = unmap(labels, total_anchors, inds_inside, fill=-1)
        bbox_targets = unmap(bbox_targets, total_anchors, inds_inside)
        bbox_outside_weights = unmap(bbox_outside_weights, total_anchors,
                                     inds_inside)
        assigned_inds = inds_inside[fg_inds]
    else:
        assigned_inds = fg_inds
    return {
        "labels": labels,
        "bbox_targets": bbox_targets,
        "bbox_outside_weights": bbox_outside_weights,
        "assigned_anchors_overlap": fg_max_overlap,
        "positive_gt_id": gt_pos_ids,
        "assigned_anchors_inds": assigned_inds,
    }


class TargetAssigner:
    """A box coder, the per-class anchor generators and a similarity
    calculator bound together."""

    def __init__(self, box_coder, anchor_generators,
                 region_similarity_calculator=None, positive_fraction=None,
                 sample_size=512):
        self._similarity = region_similarity_calculator
        self._box_coder = box_coder
        self._anchor_generators = anchor_generators
        self._positive_fraction = positive_fraction
        self._sample_size = sample_size

    @property
    def box_coder(self):
        return self._box_coder

    def assign(self, anchors, gt_boxes, anchors_mask=None, gt_classes=None,
               matched_thresholds=None, unmatched_thresholds=None, rng=None,
               anchors_bv=None):
        """Targets of ``anchors [A, 7]`` (see :func:`create_target_np`);
        ``anchors_bv``: the standup boxes of all anchors, precomputed for
        the nearest-IoU similarity."""
        if anchors_mask is not None:
            inds_inside = np.where(anchors_mask)[0]
            prune_fn = lambda _: inds_inside  # noqa: E731
        else:
            inds_inside = None
            prune_fn = None
        bv = None
        if anchors_bv is not None and isinstance(self._similarity,
                                                 NearestIouSimilarity):
            bv = anchors_bv[inds_inside] if inds_inside is not None \
                else anchors_bv

        def similarity_fn(anchors_, gt_boxes_):
            a5 = anchors_[:, [0, 1, 3, 4, 6]]
            g5 = gt_boxes_[:, [0, 1, 3, 4, 6]]
            if bv is not None:
                return self._similarity.compare(a5, g5, boxes1_bv=bv)
            return self._similarity.compare(a5, g5)

        return create_target_np(
            anchors, gt_boxes, similarity_fn, self._box_coder.encode,
            prune_anchor_fn=prune_fn, gt_classes=gt_classes,
            matched_threshold=matched_thresholds,
            unmatched_threshold=unmatched_thresholds,
            positive_fraction=self._positive_fraction,
            rpn_batch_size=self._sample_size, norm_by_num_examples=False,
            box_code_size=self._box_coder.code_size, rng=rng)

    def generate_anchors(self, feature_map_size):
        """``{"anchors" [D, H, W, n, 7], "matched_thresholds" [A],
        "unmatched_thresholds" [A]}`` over all generators."""
        anchors_list, match_list, unmatch_list = [], [], []
        for gen in self._anchor_generators:
            anchors = gen.generate(feature_map_size)
            anchors = anchors.reshape([*anchors.shape[:3], -1, 7])
            anchors_list.append(anchors)
            n = int(np.prod(anchors.shape[:-1]))
            match_list.append(np.full([n], gen.match_threshold,
                                      anchors.dtype))
            unmatch_list.append(np.full([n], gen.unmatch_threshold,
                                        anchors.dtype))
        return {
            "anchors": np.concatenate(anchors_list, axis=-2),
            "matched_thresholds": np.concatenate(match_list, axis=0),
            "unmatched_thresholds": np.concatenate(unmatch_list, axis=0),
        }

    @property
    def num_anchors_per_location(self) -> int:
        return sum(g.num_anchors_per_localization
                   for g in self._anchor_generators)
