// Native host-side point-cloud ops for the data pipeline and evaluator.
//
// TPU-native counterpart of the reference's CPU extension ops
// (lib/utils/roipool3d/src/roipool3d.cpp:97-195): the device path runs on
// XLA/Pallas, but data-loader workers and the metric evaluator still need
// fast host geometry. Exposed through a plain C ABI consumed via ctypes
// (pointrcnn_tpu_torch/utils/native.py).
//
// Build: g++ -O3 -march=native -shared -fPIC host_ops.cpp -o libhost_ops.so

#include <cmath>
#include <cstdint>
#include <cstring>
#include <algorithm>

namespace {

// Per-box constants hoisted out of the point loop.
struct BoxFrame {
    float cx, cy, cz, hh, hw, hl, cosa, sina, gate;
};

inline BoxFrame make_box_frame(const float* box) {
    // box: [cx, bottom_y, cz, h, w, l, ry]; semantics match
    // pt_in_box3d (roipool3d_kernel.cu:14-28) incl. its 10 m pre-gate —
    // tightened to the box circumradius when that is smaller (points beyond
    // it cannot be inside the rotated rect, so results are identical).
    BoxFrame f;
    f.cx = box[0];
    f.cz = box[2];
    const float h = box[3], w = box[4], l = box[5], ry = box[6];
    f.cy = box[1] - h * 0.5f;
    f.hh = h * 0.5f;
    f.hw = w * 0.5f;
    f.hl = l * 0.5f;
    f.cosa = std::cos(ry);
    f.sina = std::sin(ry);
    f.gate = std::min(10.0f, std::sqrt(f.hw * f.hw + f.hl * f.hl));
    return f;
}

inline bool pt_in_box3d(float x, float y, float z, const BoxFrame& f) {
    const float dx = x - f.cx, dz = z - f.cz;
    if (std::fabs(dx) > f.gate || std::fabs(y - f.cy) > f.hh ||
        std::fabs(dz) > f.gate)
        return false;
    const float x_rot = dx * f.cosa - dz * f.sina;
    const float z_rot = dx * f.sina + dz * f.cosa;
    return x_rot >= -f.hl && x_rot <= f.hl && z_rot >= -f.hw && z_rot <= f.hw;
}

struct Pt {
    double x, y;
};

inline double crs(const Pt& a, const Pt& b, const Pt& o) {
    return (a.x - o.x) * (b.y - o.y) - (b.x - o.x) * (a.y - o.y);
}

}  // namespace

extern "C" {

// pts (N,3) f32, boxes (M,7) f32 -> mask (M,N) uint8
void points_in_boxes3d(const float* pts, int64_t n, const float* boxes,
                       int64_t m, uint8_t* mask) {
    for (int64_t k = 0; k < m; ++k) {
        const BoxFrame f = make_box_frame(boxes + k * 7);
        uint8_t* row = mask + k * n;
        for (int64_t i = 0; i < n; ++i) {
            const float* p = pts + i * 3;
            row[i] = pt_in_box3d(p[0], p[1], p[2], f) ? 1 : 0;
        }
    }
}

// Sequential first-K-in-order RoI pooling for loader workers
// (reference roipool3d.cpp:127-195). pts (N,3), feats (N,C), boxes (M,7)
// -> pooled (M,K,3+C), empty (M,) uint8. Boxes are pre-enlarged by caller.
void roipool3d_cpu(const float* pts, const float* feats, int64_t n, int64_t c,
                   const float* boxes, int64_t m, int64_t k_samples,
                   float* pooled, uint8_t* empty) {
    const int64_t stride = 3 + c;
    for (int64_t b = 0; b < m; ++b) {
        const BoxFrame f = make_box_frame(boxes + b * 7);
        float* out = pooled + b * k_samples * stride;
        int64_t cnt = 0;
        for (int64_t i = 0; i < n && cnt < k_samples; ++i) {
            const float* p = pts + i * 3;
            if (!pt_in_box3d(p[0], p[1], p[2], f)) continue;
            float* dst = out + cnt * stride;
            std::memcpy(dst, p, 3 * sizeof(float));
            std::memcpy(dst + 3, feats + i * c, c * sizeof(float));
            ++cnt;
        }
        empty[b] = cnt == 0 ? 1 : 0;
        if (cnt == 0) {
            std::memset(out, 0, k_samples * stride * sizeof(float));
        } else {
            // cyclic duplication (roipool3d_kernel.cu:152-159)
            for (int64_t k = cnt; k < k_samples; ++k)
                std::memcpy(out + k * stride, out + (k % cnt) * stride,
                            stride * sizeof(float));
        }
    }
}

// Rotated BEV overlap of two convex quads; boxes (x1,z1,x2,z2,ry).
// Same construction as box_overlap (iou3d_kernel.cu:108-212).
double bev_pair_overlap(const float* box_a, const float* box_b) {
    Pt ca[5], cb[5];
    auto corners = [](const float* b, Pt* out) {
        const double cx = (b[0] + b[2]) * 0.5, cy = (b[1] + b[3]) * 0.5;
        const double cosa = std::cos((double)b[4]), sina = std::sin((double)b[4]);
        const double xs[4] = {(double)b[0], (double)b[2], (double)b[2], (double)b[0]};
        const double ys[4] = {(double)b[1], (double)b[1], (double)b[3], (double)b[3]};
        for (int i = 0; i < 4; ++i) {
            const double dx = xs[i] - cx, dy = ys[i] - cy;
            out[i].x = dx * cosa + dy * sina + cx;
            out[i].y = -dx * sina + dy * cosa + cy;
        }
        out[4] = out[0];
    };
    corners(box_a, ca);
    corners(box_b, cb);

    Pt cand[24];
    int cnt = 0;
    // edge-edge intersections
    for (int i = 0; i < 4; ++i) {
        for (int j = 0; j < 4; ++j) {
            const Pt &p0 = ca[i], &p1 = ca[i + 1], &q0 = cb[j], &q1 = cb[j + 1];
            const double s1 = crs(q0, p1, p0), s2 = crs(p1, q1, p0);
            const double s3 = crs(p0, q1, q0), s4 = crs(q1, p1, q0);
            if (!(s1 * s2 > 0 && s3 * s4 > 0)) continue;
            const double s5 = crs(q1, p1, p0);
            const double denom = s5 - s1;
            Pt ans;
            if (std::fabs(denom) > 1e-8) {
                ans.x = (s5 * q0.x - s1 * q1.x) / denom;
                ans.y = (s5 * q0.y - s1 * q1.y) / denom;
            } else {
                const double a0 = p0.y - p1.y, b0 = p1.x - p0.x,
                             c0 = p0.x * p1.y - p1.x * p0.y;
                const double a1 = q0.y - q1.y, b1 = q1.x - q0.x,
                             c1 = q0.x * q1.y - q1.x * q0.y;
                const double D = a0 * b1 - a1 * b0;
                ans.x = (b0 * c1 - b1 * c0) / D;
                ans.y = (a1 * c0 - a0 * c1) / D;
            }
            cand[cnt++] = ans;
        }
    }
    // contained corners
    auto in_box = [](const float* b, const Pt& p) {
        const double cx = (b[0] + b[2]) * 0.5, cy = (b[1] + b[3]) * 0.5;
        const double cosa = std::cos(-(double)b[4]), sina = std::sin(-(double)b[4]);
        const double rx = (p.x - cx) * cosa + (p.y - cy) * sina + cx;
        const double ry = -(p.x - cx) * sina + (p.y - cy) * cosa + cy;
        const double M = 1e-5;
        return rx > b[0] - M && rx < b[2] + M && ry > b[1] - M && ry < b[3] + M;
    };
    for (int k = 0; k < 4; ++k) {
        if (in_box(box_a, cb[k])) cand[cnt++] = cb[k];
        if (in_box(box_b, ca[k])) cand[cnt++] = ca[k];
    }
    if (cnt < 3) return 0.0;

    Pt center{0, 0};
    for (int i = 0; i < cnt; ++i) {
        center.x += cand[i].x;
        center.y += cand[i].y;
    }
    center.x /= cnt;
    center.y /= cnt;
    std::sort(cand, cand + cnt, [&](const Pt& a, const Pt& b) {
        return std::atan2(a.y - center.y, a.x - center.x) <
               std::atan2(b.y - center.y, b.x - center.x);
    });
    double area = 0;
    for (int k = 0; k < cnt - 1; ++k)
        area += crs(cand[k], cand[k + 1], cand[0]);
    return std::fabs(area) * 0.5;
}

// all-pairs overlap areas: a (N,5), b (M,5) -> out (N,M) f32.
// Cheap circumradius prefilter: centers farther apart than the sum of the
// rect circumradii cannot overlap, so the polygon clip is skipped.
void bev_overlap(const float* boxes_a, int64_t n, const float* boxes_b,
                 int64_t m, float* out) {
    auto center_radius = [](const float* b, double& cx, double& cy, double& r) {
        cx = (b[0] + b[2]) * 0.5;
        cy = (b[1] + b[3]) * 0.5;
        const double hx = (b[2] - b[0]) * 0.5, hy = (b[3] - b[1]) * 0.5;
        r = std::sqrt(hx * hx + hy * hy);
    };
    for (int64_t i = 0; i < n; ++i) {
        double cax, cay, ra;
        center_radius(boxes_a + i * 5, cax, cay, ra);
        for (int64_t j = 0; j < m; ++j) {
            double cbx, cby, rb;
            center_radius(boxes_b + j * 5, cbx, cby, rb);
            const double dx = cax - cbx, dy = cay - cby, rr = ra + rb;
            if (dx * dx + dy * dy > rr * rr) {
                out[i * m + j] = 0.0f;
                continue;
            }
            out[i * m + j] =
                (float)bev_pair_overlap(boxes_a + i * 5, boxes_b + j * 5);
        }
    }
}

// ---------------------------------------------------------------- AP kernels
//
// Hot loops of the KITTI AP protocol (reference eval.py:155-441, which uses
// numba JIT + numba.cuda; numba is unavailable here so they live in C++).
// Semantics are pinned by the pure-Python oracle in
// pointrcnn_tpu_torch/eval/kitti_eval.py and a protocol-equivalence test.
// All matrices are double, row-major; overlaps is (ndt, ngt).

// First matching pass: collect scores of true-positive detections for
// threshold selection. Returns number of scores written to out_scores.
int64_t ap_match_scores(const double* overlaps, const double* dt_scores,
                        const int64_t* ignored_gt, const int64_t* ignored_det,
                        int64_t ndt, int64_t ngt, double min_overlap,
                        double* out_scores) {
    constexpr double kNoDetection = -10000000.0;
    int64_t n_out = 0;
    bool assigned[4096];
    if (ndt > 4096) return -1;  // caller guards; KITTI frames are far smaller
    for (int64_t j = 0; j < ndt; ++j) assigned[j] = false;
    for (int64_t i = 0; i < ngt; ++i) {
        if (ignored_gt[i] == -1) continue;
        int64_t det_idx = -1;
        double valid_detection = kNoDetection;
        for (int64_t j = 0; j < ndt; ++j) {
            if (ignored_det[j] == -1 || assigned[j]) continue;
            const double ov = overlaps[j * ngt + i];
            if (ov > min_overlap && dt_scores[j] > valid_detection) {
                det_idx = j;
                valid_detection = dt_scores[j];
            }
        }
        if (valid_detection == kNoDetection) continue;
        if (ignored_gt[i] == 1 || ignored_det[det_idx] == 1) {
            assigned[det_idx] = true;
        } else {
            out_scores[n_out++] = dt_scores[det_idx];
            assigned[det_idx] = true;
        }
    }
    return n_out;
}

// Second pass: tp/fp/fn/similarity for every threshold, accumulated into
// pr (n_thresh, 4) with +=. overlaps_dt_dc is (ndt, ndc) det-vs-DontCare
// overlap (criterion 0), only consulted when metric == 0 and ndc > 0.
void ap_compute_pr(const double* overlaps, const double* dt_scores,
                   const double* dt_alphas, const double* gt_alphas,
                   const double* overlaps_dt_dc, const int64_t* ignored_gt,
                   const int64_t* ignored_det, int64_t ndt, int64_t ngt,
                   int64_t ndc, int64_t metric, double min_overlap,
                   const double* threshs, int64_t n_thresh,
                   int64_t compute_aos, double* pr) {
    constexpr double kNoDetection = -10000000.0;
    bool assigned[4096];
    if (ndt > 4096) return;
    for (int64_t t = 0; t < n_thresh; ++t) {
        const double thresh = threshs[t];
        for (int64_t j = 0; j < ndt; ++j) assigned[j] = false;
        int64_t tp = 0, fp = 0, fn = 0;
        double similarity = 0.0;
        for (int64_t i = 0; i < ngt; ++i) {
            if (ignored_gt[i] == -1) continue;
            int64_t det_idx = -1;
            double valid_detection = kNoDetection;
            double max_overlap = 0.0;
            bool assigned_ignored_det = false;
            for (int64_t j = 0; j < ndt; ++j) {
                if (ignored_det[j] == -1 || assigned[j] ||
                    dt_scores[j] < thresh)
                    continue;
                const double ov = overlaps[j * ngt + i];
                if (ov > min_overlap &&
                    (ov > max_overlap || assigned_ignored_det) &&
                    ignored_det[j] == 0) {
                    max_overlap = ov;
                    det_idx = j;
                    valid_detection = 1.0;
                    assigned_ignored_det = false;
                } else if (ov > min_overlap &&
                           valid_detection == kNoDetection &&
                           ignored_det[j] == 1) {
                    det_idx = j;
                    valid_detection = 1.0;
                    assigned_ignored_det = true;
                }
            }
            if (valid_detection == kNoDetection && ignored_gt[i] == 0) {
                ++fn;
            } else if (valid_detection != kNoDetection &&
                       (ignored_gt[i] == 1 || ignored_det[det_idx] == 1)) {
                assigned[det_idx] = true;
            } else if (valid_detection != kNoDetection) {
                ++tp;
                if (compute_aos)
                    similarity +=
                        (1.0 + std::cos(gt_alphas[i] - dt_alphas[det_idx])) /
                        2.0;
                assigned[det_idx] = true;
            }
        }
        for (int64_t j = 0; j < ndt; ++j) {
            if (!(assigned[j] || ignored_det[j] == -1 || ignored_det[j] == 1 ||
                  dt_scores[j] < thresh))
                ++fp;
        }
        if (metric == 0 && ndc > 0) {
            int64_t nstuff = 0;
            for (int64_t i = 0; i < ndc; ++i) {
                for (int64_t j = 0; j < ndt; ++j) {
                    if (assigned[j] || ignored_det[j] == -1 ||
                        ignored_det[j] == 1 || dt_scores[j] < thresh)
                        continue;
                    if (overlaps_dt_dc[j * ndc + i] > min_overlap) {
                        assigned[j] = true;
                        ++nstuff;
                    }
                }
            }
            fp -= nstuff;
        }
        pr[t * 4 + 0] += (double)tp;
        pr[t * 4 + 1] += (double)fp;
        pr[t * 4 + 2] += (double)fn;
        if (compute_aos && (tp > 0 || fp > 0)) pr[t * 4 + 3] += similarity;
    }
}

}  // extern "C"
