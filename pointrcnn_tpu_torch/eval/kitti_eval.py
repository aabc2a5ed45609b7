"""Official KITTI AP evaluator — 11-point interpolated protocol.

Re-implementation of the reference's metric evaluator
(tools/kitti_object_eval_python/eval.py + kitti_common.py): same 41-recall-
sample thresholds (eval.py:8-25), same clean_data difficulty gates
(eval.py:28-81), same greedy per-threshold matching with don't-care regions
(eval.py:155-270), same every-4th-sample / 11 mAP (eval.py:551-555).

Differences in *implementation* only: the hot loops (rotated-overlap
matrices and the per-threshold greedy matching) run in the native C++
library (csrc/host_ops.cpp — the reference uses numba JIT + a numba.cuda
kernel, eval.py:155 / rotate_iou.py:262-329, but numba is unavailable in
this image). The pure-Python forms below remain as the no-toolchain
fallback and as the semantic oracle for the protocol-equivalence tests.
"""

from __future__ import annotations

import io as sysio
import os

import numpy as np

from pointrcnn_tpu_torch.utils import native
from pointrcnn_tpu_torch.utils.np_geometry import _bev_polygons, _clip_convex


# ------------------------------------------------------------ annotations


def get_label_annos(label_folder: str, image_ids=None) -> list[dict]:
    """Parse KITTI label/result txts into anno dicts
    (reference kitti_common.get_label_annos:293-346)."""
    if image_ids is None:
        files = sorted(f for f in os.listdir(label_folder) if f.endswith(".txt"))
        image_ids = [int(f[:-4]) for f in files]
    return [
        get_label_anno(os.path.join(label_folder, "%06d.txt" % idx))
        for idx in image_ids
    ]


def get_label_anno(label_path: str) -> dict:
    annotations = {
        k: []
        for k in (
            "name", "truncated", "occluded", "alpha", "bbox",
            "dimensions", "location", "rotation_y", "score",
        )
    }
    with open(label_path) as f:
        lines = [l.strip().split(" ") for l in f.readlines() if l.strip()]
    for x in lines:
        annotations["name"].append(x[0])
        annotations["truncated"].append(float(x[1]))
        annotations["occluded"].append(int(float(x[2])))
        annotations["alpha"].append(float(x[3]))
        annotations["bbox"].append([float(v) for v in x[4:8]])
        # KITTI txt order hwl -> store as lhw (reference kitti_common.py:320)
        annotations["dimensions"].append([float(x[10]), float(x[8]), float(x[9])])
        annotations["location"].append([float(v) for v in x[11:14]])
        annotations["rotation_y"].append(float(x[14]))
        # score-less (gt) files: 0.0, matching the reference parser
        # (kitti_common.py:327-329); the value is never read for gt annos
        annotations["score"].append(float(x[15]) if len(x) == 16 else 0.0)
    n = len(lines)
    return {
        "name": np.array(annotations["name"]),
        "truncated": np.array(annotations["truncated"]),
        "occluded": np.array(annotations["occluded"]),
        "alpha": np.array(annotations["alpha"]),
        "bbox": np.array(annotations["bbox"]).reshape(n, 4),
        "dimensions": np.array(annotations["dimensions"]).reshape(n, 3),
        "location": np.array(annotations["location"]).reshape(n, 3),
        "rotation_y": np.array(annotations["rotation_y"]),
        "score": np.array(annotations["score"]),
    }


# ------------------------------------------------------------ overlaps


def image_box_overlap(boxes: np.ndarray, query_boxes: np.ndarray, criterion=-1):
    """(N, 4) x (K, 4) -> (N, K) 2D IoU (reference eval.py:85-112)."""
    N, K = boxes.shape[0], query_boxes.shape[0]
    if N == 0 or K == 0:
        return np.zeros((N, K))
    iw = np.minimum(boxes[:, None, 2], query_boxes[None, :, 2]) - np.maximum(
        boxes[:, None, 0], query_boxes[None, :, 0]
    )
    ih = np.minimum(boxes[:, None, 3], query_boxes[None, :, 3]) - np.maximum(
        boxes[:, None, 1], query_boxes[None, :, 1]
    )
    inter = np.clip(iw, 0, None) * np.clip(ih, 0, None)
    area = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    qarea = (query_boxes[:, 2] - query_boxes[:, 0]) * (query_boxes[:, 3] - query_boxes[:, 1])
    if criterion == -1:
        ua = area[:, None] + qarea[None, :] - inter
    elif criterion == 0:
        ua = np.broadcast_to(area[:, None], inter.shape)
    elif criterion == 1:
        ua = np.broadcast_to(qarea[None, :], inter.shape)
    else:
        ua = np.ones_like(inter)
    out = np.where(ua > 0, inter / np.where(ua > 0, ua, 1.0), 0.0)
    out[iw <= 0] = 0.0
    out[ih <= 0] = 0.0
    return out


def _camera_boxes(anno) -> np.ndarray:
    """annos -> (N, 7) [x, y, z, l, h, w, ry] camera boxes."""
    return np.concatenate(
        [anno["location"], anno["dimensions"], anno["rotation_y"][..., None]], axis=1
    )


def _camera_bev_rects(b: np.ndarray) -> np.ndarray:
    """camera boxes (N, 7)[x,y,z,l,h,w,ry] -> (N, 5) [x1, z1, x2, z2, ry]."""
    half_l, half_w = b[:, 3] / 2.0, b[:, 5] / 2.0
    return np.stack(
        [b[:, 0] - half_l, b[:, 2] - half_w, b[:, 0] + half_l, b[:, 2] + half_w,
         b[:, 6]],
        axis=1,
    ).astype(np.float32)


def _rotated_overlap_area(boxes_a: np.ndarray, boxes_b: np.ndarray) -> np.ndarray:
    """BEV intersection areas for camera boxes (N, 7)[x,y,z,l,h,w,ry]."""
    if len(boxes_a) and len(boxes_b) and native.get_lib() is not None:
        return native.bev_overlap(_camera_bev_rects(boxes_a), _camera_bev_rects(boxes_b))

    def polys(b):
        # to box3d layout [x, y, z, h, w, l, ry] for np_geometry
        b7 = np.stack([b[:, 0], b[:, 1], b[:, 2], b[:, 4], b[:, 5], b[:, 3], b[:, 6]], 1)
        return _bev_polygons(b7.astype(np.float32))

    pa, pb = polys(boxes_a), polys(boxes_b)
    out = np.zeros((len(boxes_a), len(boxes_b)), np.float32)
    for i in range(len(boxes_a)):
        d2 = (boxes_a[i, 0] - boxes_b[:, 0]) ** 2 + (boxes_a[i, 2] - boxes_b[:, 2]) ** 2
        r = (boxes_a[i, 3] + boxes_a[i, 5]) / 2 + (boxes_b[:, 3] + boxes_b[:, 5]) / 2
        for j in np.nonzero(d2 <= r ** 2)[0]:
            out[i, j] = _clip_convex(pa[i], pb[j])
    return out


def bev_box_overlap(boxes_a: np.ndarray, boxes_b: np.ndarray) -> np.ndarray:
    """Rotated BEV IoU (reference eval.py:114-116)."""
    inter = _rotated_overlap_area(boxes_a, boxes_b)
    area_a = (boxes_a[:, 3] * boxes_a[:, 5])[:, None]
    area_b = (boxes_b[:, 3] * boxes_b[:, 5])[None, :]
    ua = area_a + area_b - inter
    return np.where(ua > 0, inter / np.where(ua > 0, ua, 1.0), 0.0)


def d3_box_overlap(boxes_a: np.ndarray, boxes_b: np.ndarray) -> np.ndarray:
    """3D IoU for camera boxes (reference eval.py:119-152): rotated BEV
    intersection x height overlap (y-down, bottom-anchored)."""
    inter_bev = _rotated_overlap_area(boxes_a, boxes_b)
    ymax = np.minimum(boxes_a[:, 1][:, None], boxes_b[:, 1][None, :])
    ymin = np.maximum(
        (boxes_a[:, 1] - boxes_a[:, 4])[:, None],
        (boxes_b[:, 1] - boxes_b[:, 4])[None, :],
    )
    ih = np.clip(ymax - ymin, 0, None)
    inter = inter_bev * ih
    vol_a = (boxes_a[:, 3] * boxes_a[:, 4] * boxes_a[:, 5])[:, None]
    vol_b = (boxes_b[:, 3] * boxes_b[:, 4] * boxes_b[:, 5])[None, :]
    ua = vol_a + vol_b - inter
    return np.where((inter > 0) & (ua > 0), inter / np.where(ua > 0, ua, 1.0), 0.0)


# ------------------------------------------------------------ protocol


def get_thresholds(scores: np.ndarray, num_gt: int, num_sample_pts: int = 41):
    """(reference eval.py:8-25)."""
    scores = np.sort(scores)[::-1]
    current_recall = 0.0
    thresholds = []
    for i, score in enumerate(scores):
        l_recall = (i + 1) / num_gt
        r_recall = (i + 2) / num_gt if i < len(scores) - 1 else l_recall
        if ((r_recall - current_recall) < (current_recall - l_recall)) and (
            i < len(scores) - 1
        ):
            continue
        thresholds.append(score)
        current_recall += 1 / (num_sample_pts - 1.0)
    return np.array(thresholds)


CLASS_NAMES = ["car", "pedestrian", "cyclist", "van", "person_sitting"]
MIN_HEIGHT = [40, 25, 25]
MAX_OCCLUSION = [0, 1, 2]
MAX_TRUNCATION = [0.15, 0.3, 0.5]


def clean_data(gt_anno, dt_anno, current_class: int, difficulty: int):
    """(reference eval.py:28-81)."""
    current_cls_name = CLASS_NAMES[current_class]
    dc_bboxes, ignored_gt, ignored_dt = [], [], []
    num_valid_gt = 0
    for i in range(len(gt_anno["name"])):
        gt_name = gt_anno["name"][i].lower()
        height = gt_anno["bbox"][i, 3] - gt_anno["bbox"][i, 1]
        if gt_name == current_cls_name:
            valid_class = 1
        elif current_cls_name == "pedestrian" and gt_name == "person_sitting":
            valid_class = 0
        elif current_cls_name == "car" and gt_name == "van":
            valid_class = 0
        else:
            valid_class = -1
        ignore = (
            gt_anno["occluded"][i] > MAX_OCCLUSION[difficulty]
            or gt_anno["truncated"][i] > MAX_TRUNCATION[difficulty]
            or height <= MIN_HEIGHT[difficulty]
        )
        if valid_class == 1 and not ignore:
            ignored_gt.append(0)
            num_valid_gt += 1
        elif valid_class == 0 or (ignore and valid_class == 1):
            ignored_gt.append(1)
        else:
            ignored_gt.append(-1)
        if gt_anno["name"][i] == "DontCare":
            dc_bboxes.append(gt_anno["bbox"][i])
    for i in range(len(dt_anno["name"])):
        valid_class = 1 if dt_anno["name"][i].lower() == current_cls_name else -1
        height = abs(dt_anno["bbox"][i, 3] - dt_anno["bbox"][i, 1])
        if height < MIN_HEIGHT[difficulty]:
            ignored_dt.append(1)
        elif valid_class == 1:
            ignored_dt.append(0)
        else:
            ignored_dt.append(-1)
    return num_valid_gt, ignored_gt, ignored_dt, dc_bboxes


def compute_statistics(
    overlaps,
    gt_datas,
    dt_datas,
    ignored_gt,
    ignored_det,
    dc_bboxes,
    metric,
    min_overlap,
    thresh=0.0,
    compute_fp=False,
    compute_aos=False,
):
    """Greedy per-frame matching (reference eval.py:155-270).
    overlaps: (num_dt, num_gt)."""
    det_size = dt_datas.shape[0]
    gt_size = gt_datas.shape[0]
    dt_scores = dt_datas[:, -1]
    dt_alphas = dt_datas[:, 4]
    gt_alphas = gt_datas[:, 4]
    dt_bboxes = dt_datas[:, :4]

    assigned_detection = [False] * det_size
    ignored_threshold = [False] * det_size
    if compute_fp:
        for i in range(det_size):
            if dt_scores[i] < thresh:
                ignored_threshold[i] = True
    NO_DETECTION = -10000000
    tp = fp = fn = 0
    similarity = 0.0
    thresholds = np.zeros((gt_size,))
    thresh_idx = 0
    delta = np.zeros((gt_size,))
    delta_idx = 0
    for i in range(gt_size):
        if ignored_gt[i] == -1:
            continue
        det_idx = -1
        valid_detection = NO_DETECTION
        max_overlap = 0.0
        assigned_ignored_det = False
        for j in range(det_size):
            if ignored_det[j] == -1 or assigned_detection[j] or ignored_threshold[j]:
                continue
            overlap = overlaps[j, i]
            dt_score = dt_scores[j]
            if not compute_fp and overlap > min_overlap and dt_score > valid_detection:
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
            thresholds[thresh_idx] = dt_scores[det_idx]
            thresh_idx += 1
            if compute_aos:
                delta[delta_idx] = gt_alphas[i] - dt_alphas[det_idx]
                delta_idx += 1
            assigned_detection[det_idx] = True
    if compute_fp:
        for i in range(det_size):
            if not (
                assigned_detection[i]
                or ignored_det[i] == -1
                or ignored_det[i] == 1
                or ignored_threshold[i]
            ):
                fp += 1
        nstuff = 0
        if metric == 0 and len(dc_bboxes) > 0:
            dc = np.asarray(dc_bboxes).reshape(-1, 4)
            overlaps_dt_dc = image_box_overlap(dt_bboxes, dc, 0)
            for i in range(dc.shape[0]):
                for j in range(det_size):
                    if (
                        assigned_detection[j]
                        or ignored_det[j] in (-1, 1)
                        or ignored_threshold[j]
                    ):
                        continue
                    if overlaps_dt_dc[j, i] > min_overlap:
                        assigned_detection[j] = True
                        nstuff += 1
        fp -= nstuff
        if compute_aos:
            tmp = np.zeros((fp + delta_idx,))
            for i in range(delta_idx):
                tmp[i + fp] = (1.0 + np.cos(delta[i])) / 2.0
            similarity = np.sum(tmp) if (tp > 0 or fp > 0) else -1.0
    return tp, fp, fn, similarity, thresholds[:thresh_idx]


def _prepare_data(gt_annos, dt_annos, current_class, difficulty):
    """(reference eval.py:~400-440)."""
    gt_datas_list, dt_datas_list = [], []
    ignored_gts, ignored_dets, dontcares = [], [], []
    total_num_valid_gt = 0
    for gt, dt in zip(gt_annos, dt_annos):
        num_valid_gt, ignored_gt, ignored_det, dc_bboxes = clean_data(
            gt, dt, current_class, difficulty
        )
        ignored_gts.append(np.array(ignored_gt, dtype=np.int64))
        ignored_dets.append(np.array(ignored_det, dtype=np.int64))
        dontcares.append(
            np.asarray(dc_bboxes).reshape(-1, 4) if dc_bboxes else np.zeros((0, 4))
        )
        total_num_valid_gt += num_valid_gt
        gt_datas_list.append(
            np.concatenate([gt["bbox"], gt["alpha"][..., None]], axis=1)
        )
        dt_datas_list.append(
            np.concatenate(
                [dt["bbox"], dt["alpha"][..., None], dt["score"][..., None]], axis=1
            )
        )
    return (
        gt_datas_list, dt_datas_list, ignored_gts, ignored_dets, dontcares,
        total_num_valid_gt,
    )


def _calculate_overlaps(dt_annos, gt_annos, metric):
    """Per-frame (num_dt, num_gt) overlap matrices."""
    out = []
    for dt, gt in zip(dt_annos, gt_annos):
        if metric == 0:
            out.append(image_box_overlap(dt["bbox"], gt["bbox"]))
        elif metric == 1:
            out.append(bev_box_overlap(_camera_boxes(dt), _camera_boxes(gt)))
        elif metric == 2:
            out.append(d3_box_overlap(_camera_boxes(dt), _camera_boxes(gt)))
        else:
            raise ValueError(metric)
    return out


N_SAMPLE_PTS = 41


def eval_class(
    gt_annos,
    dt_annos,
    current_classes,
    difficultys,
    metric,
    min_overlaps,
    compute_aos=False,
):
    """(reference eval.py:443-545)."""
    assert len(gt_annos) == len(dt_annos)
    overlaps = _calculate_overlaps(dt_annos, gt_annos, metric)

    num_class = len(current_classes)
    num_difficulty = len(difficultys)
    num_minoverlap = len(min_overlaps)
    precision = np.zeros([num_class, num_difficulty, num_minoverlap, N_SAMPLE_PTS])
    recall = np.zeros_like(precision)
    aos = np.zeros_like(precision)

    # det-vs-DontCare overlap matrices (criterion 0) are threshold-, class-
    # and difficulty-independent; compute once per frame for the image metric
    dc_overlaps = None
    if metric == 0:
        dc_overlaps = []
        for gt, dt in zip(gt_annos, dt_annos):
            dc = gt["bbox"][gt["name"] == "DontCare"].reshape(-1, 4)
            dc_overlaps.append(
                image_box_overlap(dt["bbox"], dc, 0) if dc.shape[0] else None
            )

    for m, current_class in enumerate(current_classes):
        for l, difficulty in enumerate(difficultys):
            (
                gt_datas_list, dt_datas_list, ignored_gts, ignored_dets,
                dontcares, total_num_valid_gt,
            ) = _prepare_data(gt_annos, dt_annos, current_class, difficulty)
            for k, min_overlap in enumerate(min_overlaps[:, metric, m]):
                thresholdss = []
                for i in range(len(gt_annos)):
                    th = native.ap_match_scores(
                        overlaps[i], dt_datas_list[i][:, -1],
                        ignored_gts[i], ignored_dets[i], min_overlap,
                    )
                    if th is None:  # no native library: Python oracle path
                        _, _, _, _, th = compute_statistics(
                            overlaps[i], gt_datas_list[i], dt_datas_list[i],
                            ignored_gts[i], ignored_dets[i], dontcares[i],
                            metric, min_overlap=min_overlap,
                            thresh=0.0, compute_fp=False,
                        )
                    thresholdss += th.tolist()
                if total_num_valid_gt == 0:
                    continue
                thresholds = get_thresholds(np.array(thresholdss), total_num_valid_gt)
                pr = np.zeros([len(thresholds), 4])
                for i in range(len(gt_annos)):
                    done = native.ap_compute_pr(
                        overlaps[i], dt_datas_list[i][:, -1],
                        dt_datas_list[i][:, 4], gt_datas_list[i][:, 4],
                        dc_overlaps[i] if dc_overlaps is not None else None,
                        ignored_gts[i], ignored_dets[i], metric, min_overlap,
                        thresholds, compute_aos, pr,
                    )
                    if done:
                        continue
                    for t, thresh in enumerate(thresholds):
                        tp, fp, fn, similarity, _ = compute_statistics(
                            overlaps[i], gt_datas_list[i], dt_datas_list[i],
                            ignored_gts[i], ignored_dets[i], dontcares[i],
                            metric, min_overlap=min_overlap, thresh=thresh,
                            compute_fp=True, compute_aos=compute_aos,
                        )
                        pr[t, 0] += tp
                        pr[t, 1] += fp
                        pr[t, 2] += fn
                        if similarity != -1:
                            pr[t, 3] += similarity
                for i in range(len(thresholds)):
                    recall[m, l, k, i] = pr[i, 0] / (pr[i, 0] + pr[i, 2])
                    precision[m, l, k, i] = pr[i, 0] / (pr[i, 0] + pr[i, 1])
                    if compute_aos:
                        aos[m, l, k, i] = pr[i, 3] / (pr[i, 0] + pr[i, 1])
                # right-cummax interpolation (reference eval.py:536-541)
                for i in range(len(thresholds)):
                    precision[m, l, k, i] = np.max(precision[m, l, k, i:], axis=-1)
                    recall[m, l, k, i] = np.max(recall[m, l, k, i:], axis=-1)
                    if compute_aos:
                        aos[m, l, k, i] = np.max(aos[m, l, k, i:], axis=-1)
    return {"recall": recall, "precision": precision, "orientation": aos}


def get_mAP(prec: np.ndarray) -> np.ndarray:
    """11-point interpolated AP: every 4th of the 41 samples / 11
    (reference eval.py:551-555)."""
    sums = 0
    for i in range(0, prec.shape[-1], 4):
        sums = sums + prec[..., i]
    return sums / 11 * 100


def do_eval(gt_annos, dt_annos, current_classes, min_overlaps, compute_aos=False):
    difficultys = [0, 1, 2]
    ret = eval_class(gt_annos, dt_annos, current_classes, difficultys, 0,
                     min_overlaps, compute_aos)
    mAP_bbox = get_mAP(ret["precision"])
    mAP_aos = get_mAP(ret["orientation"]) if compute_aos else None
    ret = eval_class(gt_annos, dt_annos, current_classes, difficultys, 1, min_overlaps)
    mAP_bev = get_mAP(ret["precision"])
    ret = eval_class(gt_annos, dt_annos, current_classes, difficultys, 2, min_overlaps)
    mAP_3d = get_mAP(ret["precision"])
    return mAP_bbox, mAP_bev, mAP_3d, mAP_aos


def filter_annos_low_score(image_annos, thresh):
    """(reference kitti_common.py:190-201)."""
    out = []
    for anno in image_annos:
        keep = [i for i, s in enumerate(anno["score"]) if s >= thresh]
        out.append({k: v[keep] for k, v in anno.items()})
    return out


def do_coco_style_eval(gt_annos, dt_annos, current_classes, overlap_ranges,
                       compute_aos):
    """AP averaged over a linspace of overlap thresholds
    (reference eval.py:590-606).  overlap_ranges: (3, metric, class)."""
    min_overlaps = np.zeros([10, *overlap_ranges.shape[1:]])
    for i in range(overlap_ranges.shape[1]):
        for j in range(overlap_ranges.shape[2]):
            lo, hi, n = overlap_ranges[:, i, j]
            min_overlaps[:, i, j] = np.linspace(lo, hi, int(n))
    mAP_bbox, mAP_bev, mAP_3d, mAP_aos = do_eval(
        gt_annos, dt_annos, current_classes, min_overlaps, compute_aos)
    mAP_bbox = mAP_bbox.mean(-1)
    mAP_bev = mAP_bev.mean(-1)
    mAP_3d = mAP_3d.mean(-1)
    if mAP_aos is not None:
        mAP_aos = mAP_aos.mean(-1)
    return mAP_bbox, mAP_bev, mAP_3d, mAP_aos


def get_coco_eval_result(gt_annos, dt_annos, current_classes):
    """COCO-style AP@[lo:hi] sweep (reference eval.py:681-740)."""
    class_to_name = {0: "Car", 1: "Pedestrian", 2: "Cyclist", 3: "Van",
                     4: "Person_sitting"}
    class_to_range = {0: [0.5, 0.95, 10], 1: [0.25, 0.7, 10],
                      2: [0.25, 0.7, 10], 3: [0.5, 0.95, 10],
                      4: [0.25, 0.7, 10]}
    name_to_class = {v: n for n, v in class_to_name.items()}
    if not isinstance(current_classes, (list, tuple)):
        current_classes = [current_classes]
    current_classes = [
        name_to_class[c] if isinstance(c, str) else c for c in current_classes
    ]
    overlap_ranges = np.zeros([3, 3, len(current_classes)])
    for i, curcls in enumerate(current_classes):
        overlap_ranges[:, :, i] = np.array(class_to_range[curcls])[:, np.newaxis]

    compute_aos = False
    for anno in dt_annos:
        if anno["alpha"].shape[0] != 0:
            if anno["alpha"][0] != -10:
                compute_aos = True
            break

    mAPbbox, mAPbev, mAP3d, mAPaos = do_coco_style_eval(
        gt_annos, dt_annos, current_classes, overlap_ranges, compute_aos)

    result = sysio.StringIO()
    ret_dict = {}
    for j, curcls in enumerate(current_classes):
        o_range = np.array(class_to_range[curcls])[[0, 2, 1]]
        o_range[1] = (o_range[2] - o_range[0]) / (o_range[1] - 1)
        name = class_to_name[curcls]
        print("{} coco AP@{:.2f}:{:.2f}:{:.2f}:".format(name, *o_range),
              file=result)
        print(f"bbox AP:{mAPbbox[j, 0]:.2f}, {mAPbbox[j, 1]:.2f}, "
              f"{mAPbbox[j, 2]:.2f}", file=result)
        print(f"bev  AP:{mAPbev[j, 0]:.2f}, {mAPbev[j, 1]:.2f}, "
              f"{mAPbev[j, 2]:.2f}", file=result)
        print(f"3d   AP:{mAP3d[j, 0]:.2f}, {mAP3d[j, 1]:.2f}, "
              f"{mAP3d[j, 2]:.2f}", file=result)
        if compute_aos:
            print(f"aos  AP:{mAPaos[j, 0]:.2f}, {mAPaos[j, 1]:.2f}, "
                  f"{mAPaos[j, 2]:.2f}", file=result)
        ret_dict[f"{name}_coco_3d_easy"] = mAP3d[j, 0]
        ret_dict[f"{name}_coco_3d_moderate"] = mAP3d[j, 1]
        ret_dict[f"{name}_coco_3d_hard"] = mAP3d[j, 2]
    return result.getvalue(), ret_dict


def get_official_eval_result(gt_annos, dt_annos, current_classes):
    """(reference eval.py:608-678)."""
    overlap_0_7 = np.array(
        [[0.7, 0.5, 0.5, 0.7, 0.5], [0.7, 0.5, 0.5, 0.7, 0.5], [0.7, 0.5, 0.5, 0.7, 0.5]]
    )
    overlap_0_5 = np.array(
        [[0.7, 0.5, 0.5, 0.7, 0.5], [0.5, 0.25, 0.25, 0.5, 0.25], [0.5, 0.25, 0.25, 0.5, 0.25]]
    )
    min_overlaps = np.stack([overlap_0_7, overlap_0_5], axis=0)  # [2, 3, 5]
    class_to_name = {0: "Car", 1: "Pedestrian", 2: "Cyclist", 3: "Van", 4: "Person_sitting"}
    name_to_class = {v: n for n, v in class_to_name.items()}
    if not isinstance(current_classes, (list, tuple)):
        current_classes = [current_classes]
    current_classes = [
        name_to_class[c] if isinstance(c, str) else c for c in current_classes
    ]
    min_overlaps = min_overlaps[:, :, current_classes]

    compute_aos = False
    for anno in dt_annos:
        if anno["alpha"].shape[0] != 0:
            if anno["alpha"][0] != -10:
                compute_aos = True
            break

    mAPbbox, mAPbev, mAP3d, mAPaos = do_eval(
        gt_annos, dt_annos, current_classes, min_overlaps, compute_aos
    )

    result = sysio.StringIO()
    ret_dict = {}
    for j, curcls in enumerate(current_classes):
        for i in range(min_overlaps.shape[0]):
            print(
                "{} AP@{:.2f}, {:.2f}, {:.2f}:".format(
                    class_to_name[curcls], *min_overlaps[i, :, j]
                ),
                file=result,
            )
            print(
                f"bbox AP:{mAPbbox[j, 0, i]:.4f}, {mAPbbox[j, 1, i]:.4f}, {mAPbbox[j, 2, i]:.4f}",
                file=result,
            )
            print(
                f"bev  AP:{mAPbev[j, 0, i]:.4f}, {mAPbev[j, 1, i]:.4f}, {mAPbev[j, 2, i]:.4f}",
                file=result,
            )
            print(
                f"3d   AP:{mAP3d[j, 0, i]:.4f}, {mAP3d[j, 1, i]:.4f}, {mAP3d[j, 2, i]:.4f}",
                file=result,
            )
            if compute_aos:
                print(
                    f"aos  AP:{mAPaos[j, 0, i]:.2f}, {mAPaos[j, 1, i]:.2f}, {mAPaos[j, 2, i]:.2f}",
                    file=result,
                )
    # per-class AP keys for EVERY evaluated class (multi-class runs — e.g.
    # CLASSES=People -> Pedestrian + Cyclist — need both asserted; reference
    # eval.py:608-678 prints every class's table the same way)
    for i, curcls in enumerate(current_classes):
        name = class_to_name[curcls]
        ret_dict[f"{name}_3d_easy"] = mAP3d[i, 0, 0]
        ret_dict[f"{name}_3d_moderate"] = mAP3d[i, 1, 0]
        ret_dict[f"{name}_3d_hard"] = mAP3d[i, 2, 0]
        ret_dict[f"{name}_bev_easy"] = mAPbev[i, 0, 0]
        ret_dict[f"{name}_bev_moderate"] = mAPbev[i, 1, 0]
        ret_dict[f"{name}_bev_hard"] = mAPbev[i, 2, 0]
        ret_dict[f"{name}_image_easy"] = mAPbbox[i, 0, 0]
        ret_dict[f"{name}_image_moderate"] = mAPbbox[i, 1, 0]
        ret_dict[f"{name}_image_hard"] = mAPbbox[i, 2, 0]
        if compute_aos and mAPaos is not None:
            ret_dict[f"{name}_aos_easy"] = mAPaos[i, 0, 0]
            ret_dict[f"{name}_aos_moderate"] = mAPaos[i, 1, 0]
            ret_dict[f"{name}_aos_hard"] = mAPaos[i, 2, 0]
    return result.getvalue(), ret_dict


def evaluate(label_dir: str, result_dir: str, label_split_file: str,
             current_classes=(0,)):
    """End-to-end (reference evaluate.py:14-28)."""
    with open(label_split_file) as f:
        image_ids = [int(x) for x in f.readlines() if x.strip()]
    dt_annos = get_label_annos(result_dir, image_ids)
    gt_annos = get_label_annos(label_dir, image_ids)
    return get_official_eval_result(gt_annos, dt_annos, list(current_classes))


def main(argv=None):
    """Standalone AP CLI (counterpart of ``tools/evaluate.py``; reference
    tools/kitti_object_eval_python/evaluate.py): official 11-point or
    COCO-style AP over a result dir + label dir + split file, optional
    low-score filtering.

        python -m pointrcnn_tpu_torch.eval.kitti_eval --label_path .../label_2 \\
            --result_path .../final_result/data \\
            --label_split_file .../ImageSets/val.txt [--current_class 0]
            [--coco] [--score_thresh 0.3]
    """
    import argparse

    p = argparse.ArgumentParser(description="Official KITTI AP evaluator")
    p.add_argument("--label_path", type=str, required=True)
    p.add_argument("--result_path", type=str, required=True)
    p.add_argument("--label_split_file", type=str, required=True)
    p.add_argument("--current_class", type=int, nargs="+", default=[0],
                   help="0=Car 1=Pedestrian 2=Cyclist 3=Van 4=Person_sitting")
    p.add_argument("--coco", action="store_true",
                   help="COCO-style AP@[lo:hi] sweep instead of the official "
                        "11-point protocol (reference eval.py:681-740)")
    p.add_argument("--score_thresh", type=float, default=-1.0,
                   help="drop detections below this score before evaluating "
                        "(reference kitti_common.filter_annos_low_score)")
    args = p.parse_args(argv)

    with open(args.label_split_file) as f:
        image_ids = [int(x) for x in f.readlines() if x.strip()]
    dt_annos = get_label_annos(args.result_path, image_ids)
    if args.score_thresh > 0:
        dt_annos = filter_annos_low_score(dt_annos, args.score_thresh)
    gt_annos = get_label_annos(args.label_path, image_ids)
    fn = get_coco_eval_result if args.coco else get_official_eval_result
    result_str, _ = fn(gt_annos, dt_annos, list(args.current_class))
    print(result_str)
    return result_str


if __name__ == "__main__":
    main()
