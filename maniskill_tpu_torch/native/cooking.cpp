// Host-side asset cooking for the PyTorch/CUDA package (its own copy of
// maniskill_tpu/native/cooking.cpp): closed-mesh mass properties, PCA OBB
// and capsule fits (the URDF loader's mesh colliders), and support-point
// scans for convex hull proxies. Load time only; the step runs on the
// card. Exposed through ctypes.
//
// Build: g++ -O2 -shared -fPIC -o libcooking.so cooking.cpp
#include <cmath>
#include <cstdint>
#include <cstring>
#include <algorithm>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Mass properties of a closed triangle mesh via the divergence theorem
// (Mirtich-style). verts: (nv, 3) float64, tris: (nt, 3) int32.
// out: [volume, com(3), Ixx, Iyy, Izz, Ixy, Ixz, Iyz] about the COM for
// unit density.
int mesh_mass_properties(const double* verts, int64_t nv, const int32_t* tris,
                         int64_t nt, double* out) {
  double vol = 0.0;
  double com[3] = {0, 0, 0};
  // second moments about origin
  double xx = 0, yy = 0, zz = 0, xy = 0, xz = 0, yz = 0;

  for (int64_t t = 0; t < nt; ++t) {
    const double* a = verts + 3 * tris[3 * t + 0];
    const double* b = verts + 3 * tris[3 * t + 1];
    const double* c = verts + 3 * tris[3 * t + 2];
    // signed volume of tetra (origin, a, b, c)
    double v = (a[0] * (b[1] * c[2] - b[2] * c[1]) -
                a[1] * (b[0] * c[2] - b[2] * c[0]) +
                a[2] * (b[0] * c[1] - b[1] * c[0])) /
               6.0;
    vol += v;
    for (int i = 0; i < 3; ++i) com[i] += v * (a[i] + b[i] + c[i]) / 4.0;
    // tetra second moments (about origin), standard closed forms
    auto sq = [&](int i) {
      return a[i] * a[i] + b[i] * b[i] + c[i] * c[i] + a[i] * b[i] +
             a[i] * c[i] + b[i] * c[i];
    };
    auto pr = [&](int i, int j) {
      return 2.0 * (a[i] * a[j] + b[i] * b[j] + c[i] * c[j]) + a[i] * b[j] +
             a[j] * b[i] + a[i] * c[j] + a[j] * c[i] + b[i] * c[j] + b[j] * c[i];
    };
    xx += v * sq(0) / 10.0;
    yy += v * sq(1) / 10.0;
    zz += v * sq(2) / 10.0;
    xy += v * pr(0, 1) / 20.0;
    xz += v * pr(0, 2) / 20.0;
    yz += v * pr(1, 2) / 20.0;
  }
  if (std::fabs(vol) < 1e-12) return -1;
  for (int i = 0; i < 3; ++i) com[i] /= vol;

  // inertia about COM (unit density): I = integral(r^2 delta - r r^T)
  double Ixx = (yy + zz) - vol * (com[1] * com[1] + com[2] * com[2]);
  double Iyy = (xx + zz) - vol * (com[0] * com[0] + com[2] * com[2]);
  double Izz = (xx + yy) - vol * (com[0] * com[0] + com[1] * com[1]);
  double Ixy = xy - vol * com[0] * com[1];
  double Ixz = xz - vol * com[0] * com[2];
  double Iyz = yz - vol * com[1] * com[2];

  out[0] = vol;
  out[1] = com[0];
  out[2] = com[1];
  out[3] = com[2];
  out[4] = Ixx;
  out[5] = Iyy;
  out[6] = Izz;
  out[7] = Ixy;
  out[8] = Ixz;
  out[9] = Iyz;
  return 0;
}

// ---------------------------------------------------------------------------
// 3x3 symmetric eigen-decomposition (Jacobi rotations) — helper for PCA fits.
static void eig_sym3(double m[3][3], double evec[3][3], double eval[3]) {
  double a[3][3];
  std::memcpy(a, m, sizeof(a));
  double v[3][3] = {{1, 0, 0}, {0, 1, 0}, {0, 0, 1}};
  for (int sweep = 0; sweep < 32; ++sweep) {
    double off = std::fabs(a[0][1]) + std::fabs(a[0][2]) + std::fabs(a[1][2]);
    if (off < 1e-14) break;
    for (int p = 0; p < 2; ++p) {
      for (int q = p + 1; q < 3; ++q) {
        if (std::fabs(a[p][q]) < 1e-18) continue;
        double theta = (a[q][q] - a[p][p]) / (2.0 * a[p][q]);
        double t = (theta >= 0 ? 1.0 : -1.0) /
                   (std::fabs(theta) + std::sqrt(theta * theta + 1.0));
        double c = 1.0 / std::sqrt(t * t + 1.0), s = t * c;
        for (int k = 0; k < 3; ++k) {
          double akp = a[k][p], akq = a[k][q];
          a[k][p] = c * akp - s * akq;
          a[k][q] = s * akp + c * akq;
        }
        for (int k = 0; k < 3; ++k) {
          double apk = a[p][k], aqk = a[q][k];
          a[p][k] = c * apk - s * aqk;
          a[q][k] = s * apk + c * aqk;
        }
        for (int k = 0; k < 3; ++k) {
          double vkp = v[k][p], vkq = v[k][q];
          v[k][p] = c * vkp - s * vkq;
          v[k][q] = s * vkp + c * vkq;
        }
      }
    }
  }
  for (int i = 0; i < 3; ++i) eval[i] = a[i][i];
  std::memcpy(evec, v, sizeof(v));
}

// PCA-fit an oriented bounding box to a point cloud.
// out: [center(3), quat_wxyz(4), half_extents(3)]
int fit_obb(const double* pts, int64_t n, double* out) {
  if (n < 3) return -1;
  double mean[3] = {0, 0, 0};
  for (int64_t i = 0; i < n; ++i)
    for (int d = 0; d < 3; ++d) mean[d] += pts[3 * i + d];
  for (int d = 0; d < 3; ++d) mean[d] /= (double)n;

  double cov[3][3] = {{0}};
  for (int64_t i = 0; i < n; ++i) {
    double d0 = pts[3 * i] - mean[0], d1 = pts[3 * i + 1] - mean[1],
           d2 = pts[3 * i + 2] - mean[2];
    cov[0][0] += d0 * d0;
    cov[0][1] += d0 * d1;
    cov[0][2] += d0 * d2;
    cov[1][1] += d1 * d1;
    cov[1][2] += d1 * d2;
    cov[2][2] += d2 * d2;
  }
  cov[1][0] = cov[0][1];
  cov[2][0] = cov[0][2];
  cov[2][1] = cov[1][2];

  double evec[3][3], eval[3];
  eig_sym3(cov, evec, eval);
  // right-handed basis
  double det = evec[0][0] * (evec[1][1] * evec[2][2] - evec[1][2] * evec[2][1]) -
               evec[0][1] * (evec[1][0] * evec[2][2] - evec[1][2] * evec[2][0]) +
               evec[0][2] * (evec[1][0] * evec[2][1] - evec[1][1] * evec[2][0]);
  if (det < 0)
    for (int k = 0; k < 3; ++k) evec[k][2] = -evec[k][2];

  double lo[3] = {1e300, 1e300, 1e300}, hi[3] = {-1e300, -1e300, -1e300};
  for (int64_t i = 0; i < n; ++i) {
    for (int axis = 0; axis < 3; ++axis) {
      double p = 0;
      for (int d = 0; d < 3; ++d)
        p += (pts[3 * i + d] - mean[d]) * evec[d][axis];
      lo[axis] = std::min(lo[axis], p);
      hi[axis] = std::max(hi[axis], p);
    }
  }
  double half[3], cl[3];
  for (int axis = 0; axis < 3; ++axis) {
    half[axis] = (hi[axis] - lo[axis]) / 2.0;
    cl[axis] = (hi[axis] + lo[axis]) / 2.0;
  }
  double center[3];
  for (int d = 0; d < 3; ++d) {
    center[d] = mean[d];
    for (int axis = 0; axis < 3; ++axis) center[d] += evec[d][axis] * cl[axis];
  }
  // rotation matrix (columns = axes) -> quaternion wxyz
  double tr = evec[0][0] + evec[1][1] + evec[2][2];
  double qw, qx, qy, qz;
  if (tr > 0) {
    double s = std::sqrt(tr + 1.0) * 2;
    qw = 0.25 * s;
    qx = (evec[2][1] - evec[1][2]) / s;
    qy = (evec[0][2] - evec[2][0]) / s;
    qz = (evec[1][0] - evec[0][1]) / s;
  } else if (evec[0][0] > evec[1][1] && evec[0][0] > evec[2][2]) {
    double s = std::sqrt(1.0 + evec[0][0] - evec[1][1] - evec[2][2]) * 2;
    qw = (evec[2][1] - evec[1][2]) / s;
    qx = 0.25 * s;
    qy = (evec[0][1] + evec[1][0]) / s;
    qz = (evec[0][2] + evec[2][0]) / s;
  } else if (evec[1][1] > evec[2][2]) {
    double s = std::sqrt(1.0 + evec[1][1] - evec[0][0] - evec[2][2]) * 2;
    qw = (evec[0][2] - evec[2][0]) / s;
    qx = (evec[0][1] + evec[1][0]) / s;
    qy = 0.25 * s;
    qz = (evec[1][2] + evec[2][1]) / s;
  } else {
    double s = std::sqrt(1.0 + evec[2][2] - evec[0][0] - evec[1][1]) * 2;
    qw = (evec[1][0] - evec[0][1]) / s;
    qx = (evec[0][2] + evec[2][0]) / s;
    qy = (evec[1][2] + evec[2][1]) / s;
    qz = 0.25 * s;
  }
  out[0] = center[0];
  out[1] = center[1];
  out[2] = center[2];
  out[3] = qw;
  out[4] = qx;
  out[5] = qy;
  out[6] = qz;
  out[7] = half[0];
  out[8] = half[1];
  out[9] = half[2];
  return 0;
}

// Fit a capsule along the dominant PCA axis.
// out: [center(3), quat_wxyz(4), radius, half_length]
int fit_capsule(const double* pts, int64_t n, double* out) {
  double obb[10];
  if (fit_obb(pts, n, obb) != 0) return -1;
  // dominant axis = largest half extent; radius from the other two
  int major = 0;
  for (int i = 1; i < 3; ++i)
    if (obb[7 + i] > obb[7 + major]) major = i;
  double radius = 0, half_len = obb[7 + major];
  for (int i = 0; i < 3; ++i)
    if (i != major) radius = std::max(radius, obb[7 + i]);
  half_len = std::max(1e-6, half_len - radius);

  // rotate so capsule +z aligns with the major axis: reorder via quat compose
  // (handled on the python side using the OBB quaternion + axis index)
  std::memcpy(out, obb, 7 * sizeof(double));
  out[7] = radius;
  out[8] = half_len;
  out[9] = (double)major;
  return 0;
}

// Convex hull volume proxy: simplified support-based decimation. Returns the
// k extreme points of the cloud along n_dirs uniformly distributed directions
// (a cheap convex approximation for collision pre-visualization).
int support_points(const double* pts, int64_t n, const double* dirs,
                   int64_t n_dirs, int32_t* out_idx) {
  for (int64_t d = 0; d < n_dirs; ++d) {
    double best = -1e300;
    int64_t arg = 0;
    for (int64_t i = 0; i < n; ++i) {
      double dot = pts[3 * i] * dirs[3 * d] + pts[3 * i + 1] * dirs[3 * d + 1] +
                   pts[3 * i + 2] * dirs[3 * d + 2];
      if (dot > best) {
        best = dot;
        arg = i;
      }
    }
    out_idx[d] = (int32_t)arg;
  }
  return 0;
}

}  // extern "C"
