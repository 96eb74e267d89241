// Host-side post-processing of the SFD face detector.
//
// Greedy NMS (semantics of reference lib/evaluation/sfd/bbox.py:44-67,
// including the +1 area convention): boxes are visited in descending score
// order; a box is kept if its IoU with every previously kept box is <= thresh.
// The O(n^2) suppression loop is sequential and branchy, a poor fit for a
// device and for Python, hence this C++ implementation on the host. The
// order is the caller's: the reference's scores.argsort()[::-1], whose sort
// numpy does not keep stable, so that under equal scores the visit (and what
// is kept) is the reference's; no sort written here matches numpy's there.

#include <algorithm>
#include <vector>

extern "C" {

// dets: n rows of (x1, y1, x2, y2, score); order: the n row indices in the
// order of the visit. keep_out: caller-allocated n ints. Returns the number of
// kept indices written to keep_out.
int wgs_nms(const float* dets, const int* order, int n, float thresh, int* keep_out) {
  if (n <= 0) return 0;
  std::vector<float> areas(n);
  for (int i = 0; i < n; ++i) {
    const float* d = dets + i * 5;
    areas[i] = (d[2] - d[0] + 1.0f) * (d[3] - d[1] + 1.0f);
  }

  std::vector<char> suppressed(n, 0);
  int n_keep = 0;
  for (int oi = 0; oi < n; ++oi) {
    int i = order[oi];
    if (suppressed[i]) continue;
    keep_out[n_keep++] = i;
    const float* di = dets + i * 5;
    for (int oj = oi + 1; oj < n; ++oj) {
      int j = order[oj];
      if (suppressed[j]) continue;
      const float* dj = dets + j * 5;
      float xx1 = std::max(di[0], dj[0]);
      float yy1 = std::max(di[1], dj[1]);
      float xx2 = std::min(di[2], dj[2]);
      float yy2 = std::min(di[3], dj[3]);
      float w = std::max(0.0f, xx2 - xx1 + 1.0f);
      float h = std::max(0.0f, yy2 - yy1 + 1.0f);
      float inter = w * h;
      float ovr = inter / (areas[i] + areas[j] - inter);
      if (ovr > thresh) suppressed[j] = 1;
    }
  }
  return n_keep;
}

}  // extern "C"
