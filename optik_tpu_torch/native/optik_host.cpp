// optik_host: native host-side kinematics + single-solve IK runtime.
//
// Role in the framework: the TPU path (JAX/XLA) is the throughput engine;
// this C++ library is the *latency* engine for single queries, where a
// device round-trip (~100us+) would dominate the solve itself, and the
// native counterpart of the reference's C ABI / C++ layer
// (kylc/optik crates/optik-cpp/src/lib.rs:26-183, include/optik.hpp:29-105).
//
// Same math as optik_tpu/math + ops (which carry the reference citations):
// SE(3) log + right Jacobian with Taylor guards, folded-chain FK, EE-frame
// geometric Jacobian, and a damped Gauss-Newton (Levenberg-Marquardt) solver
// with box projection and Nielsen damping — the scalar twin of
// solver/lm_soa.py.  Exposed through a minimal C ABI consumed by ctypes
// (optik_tpu/native/host.py).
//
// This file is optik_tpu_torch's own copy of optik_tpu/native/optik_host.cpp
// (the same code), bound by optik_tpu_torch/native/host.py.  Keep the two
// equal: tests/test_torch_native.py holds the bindings bitwise equal.
//
// No external dependencies: plain C++17, hand-rolled 3x3/6x6 linear algebra.

#include <algorithm>
#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <fstream>
#include <limits>
#include <map>
#include <random>
#include <sstream>
#include <stdexcept>
#include <string>
#include <utility>
#include <vector>

#include "include/optik_host.h"

namespace {

constexpr double kEps = 1e-6;  // Taylor switch threshold (math.rs:7)

struct Vec3 {
  double x, y, z;
};

struct Mat3 {
  double m[3][3];
};

inline Vec3 operator+(Vec3 a, Vec3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
inline Vec3 operator-(Vec3 a, Vec3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
inline Vec3 operator*(double s, Vec3 a) { return {s * a.x, s * a.y, s * a.z}; }
inline double dot(Vec3 a, Vec3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
inline Vec3 cross(Vec3 a, Vec3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

inline Mat3 matmul(const Mat3& a, const Mat3& b) {
  Mat3 r;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      double s = 0;
      for (int k = 0; k < 3; ++k) s += a.m[i][k] * b.m[k][j];
      r.m[i][j] = s;
    }
  return r;
}

inline Vec3 matvec(const Mat3& a, Vec3 v) {
  return {a.m[0][0] * v.x + a.m[0][1] * v.y + a.m[0][2] * v.z,
          a.m[1][0] * v.x + a.m[1][1] * v.y + a.m[1][2] * v.z,
          a.m[2][0] * v.x + a.m[2][1] * v.y + a.m[2][2] * v.z};
}

inline Vec3 mattvec(const Mat3& a, Vec3 v) {
  return {a.m[0][0] * v.x + a.m[1][0] * v.y + a.m[2][0] * v.z,
          a.m[0][1] * v.x + a.m[1][1] * v.y + a.m[2][1] * v.z,
          a.m[0][2] * v.x + a.m[1][2] * v.y + a.m[2][2] * v.z};
}

inline Mat3 identity3() { return {{{1, 0, 0}, {0, 1, 0}, {0, 0, 1}}}; }

// R = I + sin(q) K + (1 - cos(q)) K^2 for unit axis k.
Mat3 rodrigues(Vec3 k, double q) {
  const double s = std::sin(q), c1 = 1.0 - std::cos(q);
  Mat3 r;
  r.m[0][0] = 1.0 + c1 * (-k.y * k.y - k.z * k.z);
  r.m[0][1] = -s * k.z + c1 * k.x * k.y;
  r.m[0][2] = s * k.y + c1 * k.x * k.z;
  r.m[1][0] = s * k.z + c1 * k.x * k.y;
  r.m[1][1] = 1.0 + c1 * (-k.x * k.x - k.z * k.z);
  r.m[1][2] = -s * k.x + c1 * k.y * k.z;
  r.m[2][0] = -s * k.y + c1 * k.x * k.z;
  r.m[2][1] = s * k.x + c1 * k.y * k.z;
  r.m[2][2] = 1.0 + c1 * (-k.x * k.x - k.y * k.y);
  return r;
}

// Rotation matrix -> rotation vector (Shepperd quaternion + atan2 log).
Vec3 mat_log(const Mat3& r) {
  const double tw = 1.0 + r.m[0][0] + r.m[1][1] + r.m[2][2];
  const double tx = 1.0 + r.m[0][0] - r.m[1][1] - r.m[2][2];
  const double ty = 1.0 - r.m[0][0] + r.m[1][1] - r.m[2][2];
  const double tz = 1.0 - r.m[0][0] - r.m[1][1] + r.m[2][2];
  double q[4];  // x, y, z, w
  if (tw >= tx && tw >= ty && tw >= tz) {
    const double s = std::sqrt(tw > 0 ? tw : 0) * 2.0;  // 4w
    q[0] = (r.m[2][1] - r.m[1][2]) / s;
    q[1] = (r.m[0][2] - r.m[2][0]) / s;
    q[2] = (r.m[1][0] - r.m[0][1]) / s;
    q[3] = 0.25 * s;
  } else if (tx >= ty && tx >= tz) {
    const double s = std::sqrt(tx) * 2.0;
    q[0] = 0.25 * s;
    q[1] = (r.m[0][1] + r.m[1][0]) / s;
    q[2] = (r.m[0][2] + r.m[2][0]) / s;
    q[3] = (r.m[2][1] - r.m[1][2]) / s;
  } else if (ty >= tz) {
    const double s = std::sqrt(ty) * 2.0;
    q[0] = (r.m[0][1] + r.m[1][0]) / s;
    q[1] = 0.25 * s;
    q[2] = (r.m[1][2] + r.m[2][1]) / s;
    q[3] = (r.m[0][2] - r.m[2][0]) / s;
  } else {
    const double s = std::sqrt(tz) * 2.0;
    q[0] = (r.m[0][2] + r.m[2][0]) / s;
    q[1] = (r.m[1][2] + r.m[2][1]) / s;
    q[2] = 0.25 * s;
    q[3] = (r.m[1][0] - r.m[0][1]) / s;
  }
  double n = std::sqrt(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
  double x = q[0] / n, y = q[1] / n, z = q[2] / n, w = q[3] / n;
  if (w < 0) { x = -x; y = -y; z = -z; w = -w; }
  const double v2 = x * x + y * y + z * z;
  double t;
  if (v2 > kEps) {
    const double vn = std::sqrt(v2);
    t = std::atan2(vn, w) / vn;
  } else {
    const double w3 = w * w * w;
    t = 1.0 / w - v2 / (3.0 * w3) + v2 * v2 / (5.0 * w3 * w * w);
  }
  return {2.0 * x * t, 2.0 * y * t, 2.0 * z * t};
}

// diag + a*[w]_x + b*[w]_x^2
Mat3 hat_terms(double diag, Vec3 w, double a, double b) {
  const double w11 = w.x * w.x, w22 = w.y * w.y, w33 = w.z * w.z;
  const double w12 = w.x * w.y, w13 = w.x * w.z, w23 = w.y * w.z;
  Mat3 r;
  r.m[0][0] = diag + b * (-w22 - w33);
  r.m[0][1] = -a * w.z + b * w12;
  r.m[0][2] = a * w.y + b * w13;
  r.m[1][0] = a * w.z + b * w12;
  r.m[1][1] = diag + b * (-w11 - w33);
  r.m[1][2] = -a * w.x + b * w23;
  r.m[2][0] = -a * w.y + b * w13;
  r.m[2][1] = a * w.x + b * w23;
  r.m[2][2] = diag + b * (-w11 - w22);
  return r;
}

Mat3 so3_right_jacobian(Vec3 w) {
  const double t2 = dot(w, w), t4 = t2 * t2;
  double a, b, c;
  if (t2 > kEps) {
    const double t = std::sqrt(t2), s = std::sin(t), co = std::cos(t);
    a = s / t;
    b = (1.0 - co) / t2;
    c = (1.0 - a) / t2;
  } else {
    a = 1.0 - t2 / 6.0 + t4 / 120.0;
    b = 0.5 - t2 / 24.0 + t4 / 720.0;
    c = 1.0 / 6.0 - t2 / 120.0 + t4 / 5040.0;
  }
  const double e = (b - 2.0 * c) / (2.0 * a);
  return hat_terms(1.0, w, 0.5, e);
}

// [v; w] = log6 of (r, t), with w precomputed.
void se3_log(const Vec3& w, Vec3 t, double out[6]) {
  const double t2 = dot(w, w);
  double coef;
  if (t2 > kEps * kEps) {
    const double th = std::sqrt(t2), s = std::sin(th), c = std::cos(th);
    coef = (1.0 - 0.5 * th * s / (1.0 - c)) / t2;
  } else {
    coef = 1.0 / 12.0 + t2 / 720.0 + t2 * t2 / 30240.0;
  }
  Mat3 vinv = hat_terms(1.0, w, -0.5, coef);
  Vec3 v = matvec(vinv, t);
  out[0] = v.x; out[1] = v.y; out[2] = v.z;
  out[3] = w.x; out[4] = w.y; out[5] = w.z;
}

// Q block of the SE(3) log right Jacobian (Pinocchio-style; math.rs:135-170).
Mat3 se3_q_block(Vec3 v, Vec3 w) {
  const double t2 = dot(w, w), t4 = t2 * t2;
  double a, b;
  if (t2 > kEps) {
    const double th = std::sqrt(t2), s = std::sin(th), c = std::cos(th);
    const double s_t = s / th, inv1mc = 1.0 / (2.0 * (1.0 - c));
    a = 1.0 / t2 - s_t * inv1mc;
    b = -2.0 / t4 + (1.0 + s_t) * inv1mc / t2;
  } else {
    a = 1.0 / 12.0 + t2 / 720.0;
    b = 1.0 / 360.0;
  }
  const double d = dot(w, v);
  Vec3 cv = (b * d) * w - (t2 * b + 2.0 * a) * v;
  Mat3 C;
  const double da = d * a;
  C.m[0][0] = cv.x * w.x + a * w.x * v.x + da;
  C.m[0][1] = -0.5 * v.z + cv.x * w.y + a * w.x * v.y;
  C.m[0][2] = 0.5 * v.y + cv.x * w.z + a * w.x * v.z;
  C.m[1][0] = 0.5 * v.z + cv.y * w.x + a * w.y * v.x;
  C.m[1][1] = cv.y * w.y + a * w.y * v.y + da;
  C.m[1][2] = -0.5 * v.x + cv.y * w.z + a * w.y * v.z;
  C.m[2][0] = -0.5 * v.y + cv.z * w.x + a * w.z * v.x;
  C.m[2][1] = 0.5 * v.x + cv.z * w.y + a * w.z * v.y;
  C.m[2][2] = cv.z * w.z + a * w.z * v.z + da;
  return matmul(C, so3_right_jacobian(w));
}

struct Chain {
  int n = 0;                    // articulated joints
  std::vector<Mat3> org_r;
  std::vector<Vec3> org_t;
  std::vector<Vec3> axis;
  std::vector<uint8_t> prismatic;
  std::vector<double> lower, upper;
  Mat3 tip_r = identity3();
  Vec3 tip_t{0, 0, 0};
};

struct Frame {
  Mat3 r;
  Vec3 t;
};

// Optional EE offset (a fixed transform composed after the chain tip),
// decoded from a row-major 4x4 or absent when the pointer is null.
struct EeOffset {
  bool has = false;
  Mat3 r = identity3();
  Vec3 t{0, 0, 0};

  static EeOffset from_ptr(const double* m16) {
    EeOffset o;
    if (!m16) return o;
    o.has = true;
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) o.r.m[i][j] = m16[i * 4 + j];
    o.t = {m16[3], m16[7], m16[11]};
    return o;
  }
};

// FK: frames for all joints + EE pose (tip + optional offset applied).
void fk(const Chain& c, const double* q, std::vector<Frame>& frames,
        Mat3& r_ee, Vec3& t_ee, const EeOffset& off = EeOffset{}) {
  Mat3 r = identity3();
  Vec3 t{0, 0, 0};
  frames.resize(c.n);
  for (int j = 0; j < c.n; ++j) {
    Mat3 lr;
    Vec3 lt;
    if (c.prismatic[j]) {
      lr = c.org_r[j];
      lt = c.org_t[j] + matvec(c.org_r[j], q[j] * c.axis[j]);
    } else {
      lr = matmul(c.org_r[j], rodrigues(c.axis[j], q[j]));
      lt = c.org_t[j];
    }
    t = t + matvec(r, lt);
    r = matmul(r, lr);
    frames[j] = {r, t};
  }
  t_ee = t + matvec(r, c.tip_t);
  r_ee = matmul(r, c.tip_r);
  if (off.has) {
    t_ee = t_ee + matvec(r_ee, off.t);
    r_ee = matmul(r_ee, off.r);
  }
}

// Residual e = log6(T_tgt^-1 T(q)) and task Jacobian Jlog6 * Jgeo (6 x n).
void residual_jac(const Chain& c, const double* q, const Mat3& tr,
                  const Vec3& tv, std::vector<Frame>& frames, double* e,
                  double* jt /* 6*n row-major, may be null */,
                  const EeOffset& off = EeOffset{}) {
  Mat3 r_ee;
  Vec3 t_ee;
  fk(c, q, frames, r_ee, t_ee, off);

  // X = T_tgt^-1 * T_ee
  Mat3 xr;
  {
    Mat3 trt;  // tr transposed
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) trt.m[i][j] = tr.m[j][i];
    xr = matmul(trt, r_ee);
  }
  Vec3 xt = mattvec(tr, t_ee - tv);
  Vec3 w = mat_log(xr);
  se3_log(w, xt, e);

  if (!jt) return;

  Mat3 jr = so3_right_jacobian(w);
  Mat3 qq = se3_q_block(xt, w);
  for (int j = 0; j < c.n; ++j) {
    Vec3 dir_w = matvec(frames[j].r, c.axis[j]);
    Vec3 lin_w, ang_w;
    if (c.prismatic[j]) {
      lin_w = dir_w;
      ang_w = {0, 0, 0};
    } else {
      ang_w = dir_w;
      lin_w = cross(dir_w, t_ee - frames[j].t);
    }
    Vec3 lin_l = mattvec(r_ee, lin_w);
    Vec3 ang_l = mattvec(r_ee, ang_w);
    const double col[6] = {lin_l.x, lin_l.y, lin_l.z, ang_l.x, ang_l.y,
                           ang_l.z};
    for (int i = 0; i < 3; ++i) {
      double top = 0, bot = 0;
      for (int k = 0; k < 3; ++k) {
        top += jr.m[i][k] * col[k] + qq.m[i][k] * col[3 + k];
        bot += jr.m[i][k] * col[3 + k];
      }
      jt[i * c.n + j] = top;
      jt[(3 + i) * c.n + j] = bot;
    }
  }
}

// 6x6 SPD solve (Cholesky), in place.
bool solve6(double a[6][6], const double b[6], double x[6]) {
  double l[6][6];
  for (int j = 0; j < 6; ++j) {
    double s = a[j][j];
    for (int k = 0; k < j; ++k) s -= l[j][k] * l[j][k];
    if (s <= 0) return false;
    l[j][j] = std::sqrt(s);
    for (int i = j + 1; i < 6; ++i) {
      double v = a[i][j];
      for (int k = 0; k < j; ++k) v -= l[i][k] * l[j][k];
      l[i][j] = v / l[j][j];
    }
  }
  double y[6];
  for (int i = 0; i < 6; ++i) {
    double s = b[i];
    for (int k = 0; k < i; ++k) s -= l[i][k] * y[k];
    y[i] = s / l[i][i];
  }
  for (int i = 5; i >= 0; --i) {
    double s = y[i];
    for (int k = i + 1; k < 6; ++k) s -= l[k][i] * x[k];
    x[i] = s / l[i][i];
  }
  return true;
}

double cost_at(const Chain& c, const double* q, const Mat3& tr,
               const Vec3& tv, std::vector<Frame>& frames) {
  double e[6];
  residual_jac(c, q, tr, tv, frames, e, nullptr);
  double f = 0;
  for (double v : e) f += v * v;
  return f;
}

// World-frame geometric Jacobian (6 x n, row-major [linear; angular]),
// the rotate-to-world step of diff-IK (reference lib.rs:184-189 composed
// with kinematics.rs:166-196).
void jac_world(const Chain& c, const std::vector<Frame>& frames,
               const Vec3& t_ee, double* jw) {
  for (int j = 0; j < c.n; ++j) {
    Vec3 dir_w = matvec(frames[j].r, c.axis[j]);
    Vec3 lin_w, ang_w;
    if (c.prismatic[j]) {
      lin_w = dir_w;
      ang_w = {0, 0, 0};
    } else {
      ang_w = dir_w;
      lin_w = cross(dir_w, t_ee - frames[j].t);
    }
    jw[0 * c.n + j] = lin_w.x;
    jw[1 * c.n + j] = lin_w.y;
    jw[2 * c.n + j] = lin_w.z;
    jw[3 * c.n + j] = ang_w.x;
    jw[4 * c.n + j] = ang_w.y;
    jw[5 * c.n + j] = ang_w.z;
  }
}

// ---------------------------------------------------------------------------
// URDF ingest (C++ twin of optik_tpu/models/urdf.py + chain.py, which carry
// the reference citations: graph build kinematics.rs:269-319, limits rule
// :299-303, cycle check :21, BFS path :35-43, fixed folding :54-97).
// ---------------------------------------------------------------------------

struct XmlNode {
  std::string tag;
  std::vector<std::pair<std::string, std::string>> attrs;
  std::vector<XmlNode> children;

  const std::string* attr(const char* name) const {
    for (const auto& kv : attrs)
      if (kv.first == name) return &kv.second;
    return nullptr;
  }
  const XmlNode* child(const char* t) const {
    for (const auto& ch : children)
      if (ch.tag == t) return &ch;
    return nullptr;
  }
};

struct XmlParser {
  const char* p;
  const char* end;

  explicit XmlParser(const std::string& s)
      : p(s.data()), end(s.data() + s.size()) {}

  [[noreturn]] void fail(const char* msg) {
    throw std::runtime_error(std::string("error parsing URDF file: ") + msg);
  }
  void skip_ws() {
    while (p < end && std::isspace(static_cast<unsigned char>(*p))) ++p;
  }
  bool starts(const char* s) const {
    const size_t len = std::strlen(s);
    return static_cast<size_t>(end - p) >= len && std::memcmp(p, s, len) == 0;
  }
  void skip_until(const char* s) {
    const char* q = std::search(p, end, s, s + std::strlen(s));
    if (q == end) fail("unterminated markup");
    p = q + std::strlen(s);
  }
  // Skip comments / processing instructions / doctype between elements.
  void skip_misc() {
    for (;;) {
      skip_ws();
      if (starts("<!--")) {
        skip_until("-->");
      } else if (starts("<?")) {
        skip_until("?>");
      } else if (starts("<!")) {
        skip_until(">");
      } else {
        return;
      }
    }
  }
  std::string name() {
    const char* s = p;
    while (p < end && (std::isalnum(static_cast<unsigned char>(*p)) ||
                       *p == '_' || *p == '-' || *p == ':' || *p == '.'))
      ++p;
    if (p == s) fail("expected a name");
    return std::string(s, p);
  }
  // Parse one element, cursor at '<'.
  XmlNode element() {
    if (p >= end || *p != '<') fail("expected '<'");
    ++p;
    XmlNode node;
    node.tag = name();
    for (;;) {
      skip_ws();
      if (p >= end) fail("unterminated tag");
      if (*p == '/') {
        ++p;
        if (p >= end || *p != '>') fail("malformed self-closing tag");
        ++p;
        return node;  // self-closing
      }
      if (*p == '>') {
        ++p;
        break;
      }
      std::string key = name();
      skip_ws();
      if (p >= end || *p != '=') fail("expected '=' in attribute");
      ++p;
      skip_ws();
      if (p >= end || (*p != '"' && *p != '\'')) fail("expected quoted value");
      const char quote = *p++;
      const char* s = p;
      while (p < end && *p != quote) ++p;
      if (p >= end) fail("unterminated attribute value");
      node.attrs.emplace_back(key, std::string(s, p));
      ++p;
    }
    // Children until matching close tag (text content is ignored).
    for (;;) {
      const char* q = static_cast<const char*>(
          std::memchr(p, '<', static_cast<size_t>(end - p)));
      if (!q) fail("missing close tag");
      p = q;
      if (starts("<!--")) {
        skip_until("-->");
        continue;
      }
      if (starts("</")) {
        p += 2;
        std::string close = name();
        if (close != node.tag) fail("mismatched close tag");
        skip_ws();
        if (p >= end || *p != '>') fail("malformed close tag");
        ++p;
        return node;
      }
      node.children.push_back(element());
    }
  }
  XmlNode parse() {
    skip_misc();
    XmlNode root = element();
    return root;
  }
};

void parse_floats(const std::string& s, double* out, int n) {
  std::istringstream is(s);
  for (int i = 0; i < n; ++i)
    if (!(is >> out[i]))
      throw std::runtime_error("expected " + std::to_string(n) + " floats, got '" +
                               s + "'");
  double extra;
  if (is >> extra)
    throw std::runtime_error("expected " + std::to_string(n) + " floats, got '" +
                             s + "'");
}

// URDF fixed-axis roll/pitch/yaw -> Rz(y) Ry(p) Rx(r)  (kinematics.rs:263-267).
Mat3 rpy_to_matrix(double r, double pch, double y) {
  const double cr = std::cos(r), sr = std::sin(r);
  const double cp = std::cos(pch), sp = std::sin(pch);
  const double cy = std::cos(y), sy = std::sin(y);
  const Mat3 rx = {{{1, 0, 0}, {0, cr, -sr}, {0, sr, cr}}};
  const Mat3 ry = {{{cp, 0, sp}, {0, 1, 0}, {-sp, 0, cp}}};
  const Mat3 rz = {{{cy, -sy, 0}, {sy, cy, 0}, {0, 0, 1}}};
  return matmul(rz, matmul(ry, rx));
}

enum JointType { kRevolute = 0, kPrismatic = 1, kFixed = 2 };

struct UrdfJoint {
  std::string name;
  int type;
  std::string parent, child;
  Mat3 origin_r;
  Vec3 origin_t;
  Vec3 axis;
  double lower, upper;
};

struct UrdfModel {
  std::vector<std::string> links;
  std::vector<UrdfJoint> joints;
};

UrdfModel parse_urdf(const std::string& xml) {
  XmlParser parser(xml);
  XmlNode root = parser.parse();
  if (root.tag != "robot")
    throw std::runtime_error("error parsing URDF file: missing <robot> root");

  UrdfModel model;
  for (const auto& ln : root.children)
    if (ln.tag == "link") {
      const std::string* nm = ln.attr("name");
      if (nm) model.links.push_back(*nm);
    }

  for (const auto& jt : root.children) {
    if (jt.tag != "joint") continue;
    UrdfJoint j;
    const std::string* nm = jt.attr("name");
    j.name = nm ? *nm : "";
    const std::string* ty = jt.attr("type");
    const std::string type_str = ty ? *ty : "";
    if (type_str == "revolute") {
      j.type = kRevolute;
    } else if (type_str == "prismatic") {
      j.type = kPrismatic;
    } else if (type_str == "fixed") {
      j.type = kFixed;
    } else {
      throw std::runtime_error("joint type not supported: '" + type_str + "'");
    }

    const XmlNode* parent = jt.child("parent");
    const XmlNode* child = jt.child("child");
    const std::string* pl = parent ? parent->attr("link") : nullptr;
    const std::string* cl = child ? child->attr("link") : nullptr;
    j.parent = pl ? *pl : "";
    j.child = cl ? *cl : "";
    auto has_link = [&](const std::string& l) {
      return std::find(model.links.begin(), model.links.end(), l) !=
             model.links.end();
    };
    if (!has_link(j.parent))
      throw std::runtime_error("joint parent link '" + j.parent +
                               "' does not exist");
    if (!has_link(j.child))
      throw std::runtime_error("joint child link '" + j.child +
                               "' does not exist");

    double xyz[3] = {0, 0, 0}, rpy[3] = {0, 0, 0};
    if (const XmlNode* origin = jt.child("origin")) {
      if (const std::string* s = origin->attr("xyz")) parse_floats(*s, xyz, 3);
      if (const std::string* s = origin->attr("rpy")) parse_floats(*s, rpy, 3);
    }
    j.origin_r = rpy_to_matrix(rpy[0], rpy[1], rpy[2]);
    j.origin_t = {xyz[0], xyz[1], xyz[2]};

    double ax[3] = {1, 0, 0};  // URDF default axis
    if (const XmlNode* axis = jt.child("axis"))
      if (const std::string* s = axis->attr("xyz")) parse_floats(*s, ax, 3);
    const double axn = std::sqrt(ax[0] * ax[0] + ax[1] * ax[1] + ax[2] * ax[2]);
    if (j.type != kFixed) {
      if (axn == 0.0)
        throw std::runtime_error("joint '" + j.name + "' has a zero axis");
      ax[0] /= axn;
      ax[1] /= axn;
      ax[2] /= axn;
    }
    j.axis = {ax[0], ax[1], ax[2]};

    // <limit> defaults lower=upper=0; non-positive span => unbounded
    // (kinematics.rs:299-303).
    double lower = 0, upper = 0;
    if (const XmlNode* lim = jt.child("limit")) {
      if (const std::string* s = lim->attr("lower")) parse_floats(*s, &lower, 1);
      if (const std::string* s = lim->attr("upper")) parse_floats(*s, &upper, 1);
    }
    if (!(upper - lower > 0.0)) {
      lower = -std::numeric_limits<double>::infinity();
      upper = std::numeric_limits<double>::infinity();
    }
    j.lower = lower;
    j.upper = upper;
    model.joints.push_back(std::move(j));
  }
  return model;
}

// Ordered base->EE joint sequence: cycle check + BFS over parent->child edges.
std::vector<const UrdfJoint*> find_chain(const UrdfModel& model,
                                         const std::string& base,
                                         const std::string& ee) {
  auto has_link = [&](const std::string& l) {
    return std::find(model.links.begin(), model.links.end(), l) !=
           model.links.end();
  };
  if (!has_link(base))
    throw std::runtime_error("base link '" + base + "' does not exist");
  if (!has_link(ee))
    throw std::runtime_error("EE link '" + ee + "' does not exist");

  std::map<std::string, std::vector<int>> children;
  for (size_t i = 0; i < model.joints.size(); ++i)
    children[model.joints[i].parent].push_back(static_cast<int>(i));

  // Cycle check (kinematics.rs:21): iterative coloring DFS.
  std::map<std::string, int> state;  // 0 unseen, 1 on stack, 2 done
  for (const auto& start : model.links) {
    if (state[start] != 0) continue;
    std::vector<std::pair<std::string, size_t>> stack{{start, 0}};
    state[start] = 1;
    while (!stack.empty()) {
      auto& [link, idx] = stack.back();
      const auto& kids = children[link];
      if (idx >= kids.size()) {
        state[link] = 2;
        stack.pop_back();
        continue;
      }
      const std::string& nxt = model.joints[kids[idx++]].child;
      const int s = state[nxt];
      if (s == 1) throw std::runtime_error("robot model contains loops");
      if (s == 0) {
        state[nxt] = 1;
        stack.emplace_back(nxt, 0);
      }
    }
  }

  // BFS shortest path following joint direction (kinematics.rs:35-43).
  std::map<std::string, std::pair<std::string, int>> prev;
  std::vector<std::string> frontier{base};
  std::map<std::string, bool> seen{{base, true}};
  while (!frontier.empty()) {
    std::vector<std::string> nxt_frontier;
    for (const auto& link : frontier)
      for (int ji : children[link]) {
        const std::string& child = model.joints[ji].child;
        if (!seen[child]) {
          seen[child] = true;
          prev[child] = {link, ji};
          nxt_frontier.push_back(child);
        }
      }
    frontier = std::move(nxt_frontier);
  }
  if (!seen[ee] && ee != base)
    throw std::runtime_error("no path from base to EE link");

  std::vector<const UrdfJoint*> path;
  std::string cur = ee;
  while (cur != base) {
    const auto& [pl, ji] = prev[cur];
    path.push_back(&model.joints[ji]);
    cur = pl;
  }
  std::reverse(path.begin(), path.end());
  return path;
}

// Fold fixed joints in FK composition order into a Chain
// (twin of ChainSpec.from_joints; fixed folding kinematics.rs:54-97).
Chain fold_chain(const std::vector<const UrdfJoint*>& joints) {
  Chain c;
  Mat3 acc_r = identity3();
  Vec3 acc_t{0, 0, 0};
  for (const UrdfJoint* j : joints) {
    if (j->type == kFixed) {
      acc_t = acc_t + matvec(acc_r, j->origin_t);
      acc_r = matmul(acc_r, j->origin_r);
      continue;
    }
    c.org_r.push_back(matmul(acc_r, j->origin_r));
    c.org_t.push_back(acc_t + matvec(acc_r, j->origin_t));
    acc_r = identity3();
    acc_t = {0, 0, 0};
    c.axis.push_back(j->axis);
    c.prismatic.push_back(j->type == kPrismatic ? 1 : 0);
    c.lower.push_back(j->lower);
    c.upper.push_back(j->upper);
  }
  c.n = static_cast<int>(c.axis.size());
  if (c.n == 0)  // kinematics.rs:102
    throw std::runtime_error("kinematic chain is empty");
  c.tip_r = acc_r;
  c.tip_t = acc_t;
  return c;
}

// ---------------------------------------------------------------------------
// Differential-IK QP (twin of solver/qp.py + solver/diffik.py: OSQP-style
// ADMM with fixed step-rho, over-relaxation 1.6, and an active-set polish;
// replaces the reference's Clarabel dependency, lib.rs:101-239).
// ---------------------------------------------------------------------------

// Dense LU solve with partial pivoting, in place; returns false if singular.
bool lu_solve(std::vector<double>& a, std::vector<double>& b, int n) {
  std::vector<int> piv(n);
  for (int k = 0; k < n; ++k) {
    int imax = k;
    double vmax = std::fabs(a[k * n + k]);
    for (int i = k + 1; i < n; ++i) {
      const double v = std::fabs(a[i * n + k]);
      if (v > vmax) {
        vmax = v;
        imax = i;
      }
    }
    if (vmax <= 0 || !std::isfinite(vmax)) return false;
    if (imax != k) {
      for (int j = 0; j < n; ++j) std::swap(a[k * n + j], a[imax * n + j]);
      std::swap(b[k], b[imax]);
    }
    const double inv = 1.0 / a[k * n + k];
    for (int i = k + 1; i < n; ++i) {
      const double f = a[i * n + k] * inv;
      a[i * n + k] = f;
      for (int j = k + 1; j < n; ++j) a[i * n + j] -= f * a[k * n + j];
      b[i] -= f * b[k];
    }
  }
  for (int i = n - 1; i >= 0; --i) {
    double s = b[i];
    for (int j = i + 1; j < n; ++j) s -= a[i * n + j] * b[j];
    b[i] = s / a[i * n + i];
  }
  return true;
}

// Dense Cholesky (lower) of SPD matrix, in place lower triangle; false if not PD.
bool chol_fact(std::vector<double>& a, int n) {
  for (int j = 0; j < n; ++j) {
    double s = a[j * n + j];
    for (int k = 0; k < j; ++k) s -= a[j * n + k] * a[j * n + k];
    if (s <= 0) return false;
    const double d = std::sqrt(s);
    a[j * n + j] = d;
    for (int i = j + 1; i < n; ++i) {
      double v = a[i * n + j];
      for (int k = 0; k < j; ++k) v -= a[i * n + k] * a[j * n + k];
      a[i * n + j] = v / d;
    }
  }
  return true;
}

void chol_solve_vec(const std::vector<double>& l, std::vector<double>& b, int n) {
  for (int i = 0; i < n; ++i) {
    double s = b[i];
    for (int k = 0; k < i; ++k) s -= l[i * n + k] * b[k];
    b[i] = s / l[i * n + i];
  }
  for (int i = n - 1; i >= 0; --i) {
    double s = b[i];
    for (int k = i + 1; k < n; ++k) s -= l[k * n + i] * b[k];
    b[i] = s / l[i * n + i];
  }
}

struct DiffIkResult {
  bool ok = false;
  double alpha = 0;
  std::vector<double> v;
};

DiffIkResult diff_ik_solve(const Chain& c, const double* x0,
                           const double* v_we /* 6 */,
                           const double* v_max /* n */, const EeOffset& off) {
  const int n = c.n;
  const int nv = n + 1;      // decision vector [v; alpha]
  const int m = 6 + n + 1;   // eq rows + velocity box + alpha box
  // Twin of solver/diffik.py: alpha reward -1 (NOT the reference's -100 —
  // any negative LP coefficient gives the same argmax and -100 inflates
  // the equality duals 100x, stalling ADMM on loosely-constrained states);
  // success gates on tracking + stationarity after box projection.
  constexpr double kReg = 1e-9, kAlphaReward = -1.0;
  constexpr double kSigma = 1e-6, kRhoBase = 1.0, kRhoEq = 1e3;
  constexpr double kRelax = 1.6, kPolishReg = 1e-11;
  constexpr double kTrackTol = 1e-5, kStatTol = 1e-3;
  constexpr int kIters = 800;

  // World-frame Jacobian at x0.
  std::vector<Frame> frames;
  Mat3 r_ee;
  Vec3 t_ee;
  fk(c, x0, frames, r_ee, t_ee, off);
  std::vector<double> jw(6 * n);
  jac_world(c, frames, t_ee, jw.data());

  // A rows: [J_W | -V] (equality), [I | 0] (velocity box), [0 | 1] (alpha box)
  std::vector<double> A(m * nv, 0.0), l(m), u(m), rho(m);
  for (int i = 0; i < 6; ++i) {
    for (int j = 0; j < n; ++j) A[i * nv + j] = jw[i * n + j];
    A[i * nv + n] = -v_we[i];
    l[i] = u[i] = 0.0;
    rho[i] = kRhoBase * kRhoEq;
  }
  for (int j = 0; j < n; ++j) {
    A[(6 + j) * nv + j] = 1.0;
    l[6 + j] = -v_max[j];
    u[6 + j] = v_max[j];
    rho[6 + j] = kRhoBase;
  }
  A[(6 + n) * nv + n] = 1.0;
  l[6 + n] = 0.0;
  u[6 + n] = 1.0;
  rho[6 + n] = kRhoBase;

  std::vector<double> q(nv, 0.0);
  q[n] = kAlphaReward;

  std::vector<double> x(nv, 0.0), z(m), y(m, 0.0), rhs(nv), zt(m);
  std::vector<double> K(nv * nv), rho_cur(m);
  for (int r = 0; r < m; ++r) z[r] = std::min(std::max(0.0, l[r]), u[r]);

  // Adaptive step size (OSQP sec. 5.2, twin of solver/qp.py): every
  // kRhoInterval iterations rebalance rho by sqrt(pr_rel / dr_rel) when the
  // residuals diverge by >5x, and refactor K.  Fixed-rho ADMM stalls on
  // poorly conditioned Jacobian blocks.
  constexpr int kRhoInterval = 100;
  double rho_scale = 1.0;
  for (int round = 0; round < kIters / kRhoInterval; ++round) {
    for (int r = 0; r < m; ++r) rho_cur[r] = rho[r] * rho_scale;
    std::fill(K.begin(), K.end(), 0.0);
    for (int i = 0; i < nv; ++i) K[i * nv + i] = kReg + kSigma;
    for (int r = 0; r < m; ++r)
      for (int i = 0; i < nv; ++i) {
        const double ari = A[r * nv + i] * rho_cur[r];
        if (ari == 0.0) continue;
        for (int j = 0; j < nv; ++j) K[i * nv + j] += ari * A[r * nv + j];
      }
    if (!chol_fact(K, nv)) return {};

    for (int it = 0; it < kRhoInterval; ++it) {
      for (int i = 0; i < nv; ++i) rhs[i] = kSigma * x[i] - q[i];
      for (int r = 0; r < m; ++r) {
        const double w = rho_cur[r] * z[r] - y[r];
        if (w == 0.0) continue;
        for (int i = 0; i < nv; ++i) rhs[i] += A[r * nv + i] * w;
      }
      chol_solve_vec(K, rhs, nv);
      x.swap(rhs);
      for (int r = 0; r < m; ++r) {
        double s = 0;
        for (int i = 0; i < nv; ++i) s += A[r * nv + i] * x[i];
        zt[r] = s;
      }
      for (int r = 0; r < m; ++r) {
        const double zr = kRelax * zt[r] + (1.0 - kRelax) * z[r];
        const double znew =
            std::min(std::max(zr + y[r] / rho_cur[r], l[r]), u[r]);
        y[r] += rho_cur[r] * (zr - znew);
        z[r] = znew;
      }
    }

    constexpr double kTiny = 1e-12;
    double pr = 0, ax_max = 0, z_max = 0;
    for (int r = 0; r < m; ++r) {
      double s = 0;
      for (int i = 0; i < nv; ++i) s += A[r * nv + i] * x[i];
      pr = std::max(pr, std::fabs(s - z[r]));
      ax_max = std::max(ax_max, std::fabs(s));
      z_max = std::max(z_max, std::fabs(z[r]));
    }
    const double pr_rel = pr / std::max(std::max(ax_max, z_max), kTiny);
    double dr = 0, px_max = 0, aty_max = 0, q_max = 0;
    for (int i = 0; i < nv; ++i) {
      const double px = kReg * x[i];
      double aty = 0;
      for (int r = 0; r < m; ++r) aty += A[r * nv + i] * y[r];
      dr = std::max(dr, std::fabs(px + q[i] + aty));
      px_max = std::max(px_max, std::fabs(px));
      aty_max = std::max(aty_max, std::fabs(aty));
      q_max = std::max(q_max, std::fabs(q[i]));
    }
    const double dr_rel =
        dr / std::max(std::max(px_max, std::max(aty_max, q_max)), kTiny);
    double scale = std::sqrt(pr_rel / std::max(dr_rel, kTiny));
    scale = std::min(std::max(scale, 1e-3), 1e3);
    if (scale > 5.0 || scale < 0.2) rho_scale *= scale;
  }

  auto residuals = [&](const std::vector<double>& xv,
                       const std::vector<double>& yv, double* pr, double* dr) {
    *pr = 0;
    for (int r = 0; r < m; ++r) {
      double s = 0;
      for (int i = 0; i < nv; ++i) s += A[r * nv + i] * xv[i];
      *pr = std::max(*pr, std::max(s - u[r], 0.0) + std::max(l[r] - s, 0.0));
    }
    *dr = 0;
    for (int i = 0; i < nv; ++i) {
      double s = kReg * xv[i] + q[i];
      for (int r = 0; r < m; ++r) s += A[r * nv + i] * yv[r];
      *dr = std::max(*dr, std::fabs(s));
    }
  };

  // Iterated polish (twin of qp.py): exact KKT solve on the detected
  // active set, re-detecting from the current best point over a widening
  // tolerance ladder; each candidate kept only if it improves residuals.
  double pr, dr;
  residuals(x, y, &pr, &dr);
  std::vector<double> x_best = x, y_best = y;
  const int kk = nv + m;
  std::vector<double> ax(m), mask(m), b_act(m), kkt(kk * kk), krhs(kk);
  for (const double tol : {1e-7, 1e-5, 1e-3}) {
    for (int r = 0; r < m; ++r) {
      double s = 0;
      for (int i = 0; i < nv; ++i) s += A[r * nv + i] * x_best[i];
      ax[r] = s;
    }
    for (int r = 0; r < m; ++r) {
      const bool is_eq = r < 6;
      const bool low = !is_eq &&
                       (ax[r] - l[r] <= tol * (1.0 + std::fabs(l[r]))) &&
                       y_best[r] < 0;
      const bool up = !is_eq &&
                      (u[r] - ax[r] <= tol * (1.0 + std::fabs(u[r]))) &&
                      y_best[r] > 0;
      mask[r] = (is_eq || low || up) ? 1.0 : 0.0;
      b_act[r] = up ? u[r] : l[r];
    }
    std::fill(kkt.begin(), kkt.end(), 0.0);
    for (int i = 0; i < nv; ++i) {
      kkt[i * kk + i] = kReg + kPolishReg;
      for (int r = 0; r < m; ++r) {
        kkt[i * kk + (nv + r)] = A[r * nv + i] * mask[r];
        kkt[(nv + r) * kk + i] = mask[r] * A[r * nv + i];
      }
      krhs[i] = -q[i];
    }
    for (int r = 0; r < m; ++r) {
      kkt[(nv + r) * kk + (nv + r)] = -(1.0 - mask[r]) - kPolishReg;
      krhs[nv + r] = mask[r] * b_act[r];
    }
    if (!lu_solve(kkt, krhs, kk)) continue;
    std::vector<double> x_p(krhs.begin(), krhs.begin() + nv);
    std::vector<double> y_p(krhs.begin() + nv, krhs.end());
    bool finite = true;
    for (double v : x_p) finite = finite && std::isfinite(v);
    if (!finite) continue;
    double pr_pol, dr_pol;
    residuals(x_p, y_p, &pr_pol, &dr_pol);
    if (pr_pol + dr_pol < pr + dr) {
      x_best = x_p;
      y_best = y_p;
      pr = pr_pol;
      dr = dr_pol;
    }
  }

  // Project onto the box (bound contracts hold exactly), then gate on the
  // Cartesian tracking residual + KKT stationarity (diffik.py:_finalize).
  DiffIkResult res;
  bool finite = true;
  for (double v : x_best) finite = finite && std::isfinite(v);
  for (int j = 0; j < n; ++j)
    x_best[j] = std::min(std::max(x_best[j], -v_max[j]), v_max[j]);
  x_best[n] = std::min(std::max(x_best[n], 0.0), 1.0);
  double track = 0;
  for (int r = 0; r < 6; ++r) {
    double s = 0;
    for (int i = 0; i < nv; ++i) s += A[r * nv + i] * x_best[i];
    track = std::max(track, std::fabs(s));
  }
  res.ok = finite && track < kTrackTol && dr < kStatTol;
  res.alpha = x_best[n];
  res.v.assign(x_best.begin(), x_best.begin() + n);
  return res;
}

}  // namespace

extern "C" {

// --- chain construction ----------------------------------------------------

void* optik_host_chain_new(int n, const double* origin_r /* n*9 */,
                           const double* origin_t /* n*3 */,
                           const double* axis /* n*3 */,
                           const uint8_t* prismatic /* n */,
                           const double* lower, const double* upper,
                           const double* tip_r /* 9 */,
                           const double* tip_t /* 3 */) {
  auto* c = new Chain();
  c->n = n;
  c->org_r.resize(n);
  c->org_t.resize(n);
  c->axis.resize(n);
  c->prismatic.assign(prismatic, prismatic + n);
  c->lower.assign(lower, lower + n);
  c->upper.assign(upper, upper + n);
  for (int j = 0; j < n; ++j) {
    std::memcpy(c->org_r[j].m, origin_r + 9 * j, 9 * sizeof(double));
    c->org_t[j] = {origin_t[3 * j], origin_t[3 * j + 1], origin_t[3 * j + 2]};
    c->axis[j] = {axis[3 * j], axis[3 * j + 1], axis[3 * j + 2]};
  }
  std::memcpy(c->tip_r.m, tip_r, 9 * sizeof(double));
  c->tip_t = {tip_t[0], tip_t[1], tip_t[2]};
  return c;
}

void optik_host_chain_free(void* chain) { delete static_cast<Chain*>(chain); }

// URDF ingest (parse + chain extraction + folding).  Returns a Chain handle,
// or null with a message in err (truncated to err_len, always NUL-terminated).
void* optik_host_chain_from_urdf_str(const char* xml, const char* base_link,
                                     const char* ee_link, char* err,
                                     int err_len) {
  try {
    UrdfModel model = parse_urdf(xml);
    auto path = find_chain(model, base_link, ee_link);
    return new Chain(fold_chain(path));
  } catch (const std::exception& e) {
    if (err && err_len > 0) {
      std::strncpy(err, e.what(), err_len - 1);
      err[err_len - 1] = '\0';
    }
    return nullptr;
  }
}

void* optik_host_chain_from_urdf_file(const char* path, const char* base_link,
                                      const char* ee_link, char* err,
                                      int err_len) {
  std::ifstream f(path, std::ios::binary);
  if (!f) {
    if (err && err_len > 0) {
      std::snprintf(err, err_len, "error parsing URDF file: cannot read '%s'",
                    path);
    }
    return nullptr;
  }
  std::ostringstream ss;
  ss << f.rdbuf();
  const std::string xml = ss.str();
  return optik_host_chain_from_urdf_str(xml.c_str(), base_link, ee_link, err,
                                        err_len);
}

int optik_host_num_positions(const void* chain) {
  return static_cast<const Chain*>(chain)->n;
}

void optik_host_joint_limits(const void* chain, double* lower, double* upper) {
  const auto& c = *static_cast<const Chain*>(chain);
  std::memcpy(lower, c.lower.data(), c.n * sizeof(double));
  std::memcpy(upper, c.upper.data(), c.n * sizeof(double));
}

// Uniform draw within joint limits (lib.rs:86-91); deterministic per seed,
// unbounded joints draw from [-pi, pi] as in the IK restart sampler.
void optik_host_random_configuration(const void* chain, uint64_t seed,
                                     double* out) {
  const auto& c = *static_cast<const Chain*>(chain);
  std::mt19937_64 rng(seed);
  for (int j = 0; j < c.n; ++j) {
    double lo = c.lower[j], hi = c.upper[j];
    if (!std::isfinite(lo)) lo = -3.14159265358979;
    if (!std::isfinite(hi)) hi = 3.14159265358979;
    std::uniform_real_distribution<double> d(lo, hi);
    out[j] = d(rng);
  }
}

// --- kinematics ------------------------------------------------------------

void optik_host_fk(const void* chain, const double* q,
                   const double* ee_offset /* 16 row-major or null */,
                   double* pose /* 16, row-major 4x4 */) {
  const auto& c = *static_cast<const Chain*>(chain);
  std::vector<Frame> frames;
  Mat3 r;
  Vec3 t;
  fk(c, q, frames, r, t, EeOffset::from_ptr(ee_offset));
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) pose[i * 4 + j] = r.m[i][j];
  }
  pose[3] = t.x; pose[7] = t.y; pose[11] = t.z;
  pose[12] = pose[13] = pose[14] = 0.0;
  pose[15] = 1.0;
}

void optik_host_jacobian(const void* chain, const double* q,
                         const double* ee_offset /* 16 row-major or null */,
                         double* jac /* 6*n row-major, EE frame */) {
  const auto& c = *static_cast<const Chain*>(chain);
  std::vector<Frame> frames;
  Mat3 r_ee;
  Vec3 t_ee;
  fk(c, q, frames, r_ee, t_ee, EeOffset::from_ptr(ee_offset));
  for (int j = 0; j < c.n; ++j) {
    Vec3 dir_w = matvec(frames[j].r, c.axis[j]);
    Vec3 lin_w, ang_w;
    if (c.prismatic[j]) {
      lin_w = dir_w;
      ang_w = {0, 0, 0};
    } else {
      ang_w = dir_w;
      lin_w = cross(dir_w, t_ee - frames[j].t);
    }
    Vec3 lin_l = mattvec(r_ee, lin_w);
    Vec3 ang_l = mattvec(r_ee, ang_w);
    jac[0 * c.n + j] = lin_l.x;
    jac[1 * c.n + j] = lin_l.y;
    jac[2 * c.n + j] = lin_l.z;
    jac[3 * c.n + j] = ang_l.x;
    jac[4 * c.n + j] = ang_l.y;
    jac[5 * c.n + j] = ang_l.z;
  }
}

// --- single-solve IK (latency path) ---------------------------------------
//
// Damped Gauss-Newton with box projection and Nielsen damping; restart i
// draws uniformly from the limits with a deterministic per-restart stream
// (mt19937 seeded rng_seed + i), restart 0 = x0.  Full solver-config
// semantics mirror the reference (crates/optik-cpp/src/lib.rs:11-20,
// crates/optik/src/lib.rs:241-415): per-axis world-frame weighting
// conjugated with the target rotation (objective.rs:7-38), tol_f/tol_df/
// tol_dx success classification (lib.rs:376-388), Speed = first success,
// Quality = min seed distance over all successful restarts (lib.rs:398-408).

optik_host_solver_config optik_host_solver_config_default(void) {
  optik_host_solver_config c;
  c.solution_mode = 2;  // speed
  c.max_time = 0.1;     // layout parity only; budgets are deterministic
  c.max_restarts = 64;
  c.tol_f = 1e-6;
  c.tol_df = -1.0;
  c.tol_dx = -1.0;
  for (int i = 0; i < 3; ++i) c.linear_weight[i] = 1.0;
  for (int i = 0; i < 3; ++i) c.angular_weight[i] = 1.0;
  c.max_iters = 64;
  c.rng_seed = 42;
  return c;
}

static int ik_solve_cfg(const Chain& c, const optik_host_solver_config& cfg,
                        const double* target, const double* x0,
                        const EeOffset& off, bool validate_seed,
                        double* x_out, double* f_out) {
  const int n = c.n;

  if (validate_seed) {
    // Reference panics "seed joint position outside of joint limits"
    // (lib.rs:251-254); the ABI reports -1 and the binding raises.
    for (int j = 0; j < n; ++j)
      if (x0[j] < c.lower[j] || x0[j] > c.upper[j]) return -1;
  }

  Mat3 tr;
  Vec3 tv{target[3], target[7], target[11]};
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) tr.m[i][j] = target[i * 4 + j];

  // Per-axis weighting M = R_tgt^T diag(w) R_tgt per 3-block: the residual
  // lives in the target-local frame, the weights in the world frame
  // (objective.rs:7-38; identity skip at IDENTITY_EPS, objective.rs:5).
  bool lin_id = true, ang_id = true;
  for (int i = 0; i < 3; ++i) {
    if (std::abs(cfg.linear_weight[i] - 1.0) > 1e-20) lin_id = false;
    if (std::abs(cfg.angular_weight[i] - 1.0) > 1e-20) ang_id = false;
  }
  const bool weighted = !(lin_id && ang_id);
  Mat3 ml = identity3(), ma = identity3();
  if (weighted) {
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) {
        double sl = 0, sa = 0;
        for (int k = 0; k < 3; ++k) {
          sl += tr.m[k][i] * cfg.linear_weight[k] * tr.m[k][j];
          sa += tr.m[k][i] * cfg.angular_weight[k] * tr.m[k][j];
        }
        ml.m[i][j] = sl;
        ma.m[i][j] = sa;
      }
  }

  std::vector<Frame> frames;
  std::vector<double> x(n), e(6), jt(6 * n), xt(n), tmp(6 * n);
  // Stall heuristic: tol_df = 1e-3 * tol_f when unset — stops the restart
  // but does NOT classify as a success (lib.rs:283-293, 376-388).
  const bool df_is_success = cfg.tol_df >= 0.0;
  const bool dx_is_success = cfg.tol_dx >= 0.0;
  const double tol_df = df_is_success ? cfg.tol_df : 1e-3 * cfg.tol_f;
  const int max_restarts = cfg.max_restarts > 0 ? cfg.max_restarts : 64;
  const bool quality = cfg.solution_mode == 1;

  // Weighted residual+Jacobian around residual_jac.
  auto eval = [&](const double* q, double* e_o, double* jt_o) {
    residual_jac(c, q, tr, tv, frames, e_o, jt_o, off);
    if (!weighted) return;
    double el[3], ea[3];
    for (int i = 0; i < 3; ++i) {
      el[i] = ml.m[i][0] * e_o[0] + ml.m[i][1] * e_o[1] + ml.m[i][2] * e_o[2];
      ea[i] =
          ma.m[i][0] * e_o[3] + ma.m[i][1] * e_o[4] + ma.m[i][2] * e_o[5];
    }
    for (int i = 0; i < 3; ++i) {
      e_o[i] = el[i];
      e_o[3 + i] = ea[i];
    }
    if (!jt_o) return;
    for (int p = 0; p < n; ++p) {
      double cl[3], ca[3];
      for (int i = 0; i < 3; ++i) {
        cl[i] = ml.m[i][0] * jt_o[0 * n + p] + ml.m[i][1] * jt_o[1 * n + p] +
                ml.m[i][2] * jt_o[2 * n + p];
        ca[i] = ma.m[i][0] * jt_o[3 * n + p] + ma.m[i][1] * jt_o[4 * n + p] +
                ma.m[i][2] * jt_o[5 * n + p];
      }
      for (int i = 0; i < 3; ++i) {
        jt_o[i * n + p] = cl[i];
        jt_o[(3 + i) * n + p] = ca[i];
      }
    }
  };

  bool any = false;
  double best_dist = std::numeric_limits<double>::infinity();
  std::vector<double> best_x(n);
  double best_f = 0;

  for (int restart = 0; restart < max_restarts; ++restart) {
    if (restart == 0) {
      std::memcpy(x.data(), x0, n * sizeof(double));
    } else {
      std::mt19937_64 rng(cfg.rng_seed + restart);
      for (int j = 0; j < n; ++j) {
        double lo = c.lower[j], hi = c.upper[j];
        if (!std::isfinite(lo)) lo = -3.14159265358979;
        if (!std::isfinite(hi)) hi = 3.14159265358979;
        std::uniform_real_distribution<double> d(lo, hi);
        x[j] = d(rng);
      }
    }

    eval(x.data(), e.data(), jt.data());
    double f = 0;
    for (double v : e) f += v * v;
    double lam = 1e-4, nu = 2.0;
    bool success = f <= cfg.tol_f;

    for (int it = 0; it < cfg.max_iters && !success; ++it) {
      double a[6][6];
      for (int i = 0; i < 6; ++i)
        for (int k = 0; k <= i; ++k) {
          double s = 0;
          for (int p = 0; p < n; ++p) s += jt[i * n + p] * jt[k * n + p];
          a[i][k] = a[k][i] = s;
        }
      for (int i = 0; i < 6; ++i) a[i][i] += lam;
      double z[6];
      if (!solve6(a, e.data(), z)) { lam *= nu; nu *= 2; continue; }
      double max_step = 0;
      for (int p = 0; p < n; ++p) {
        double d = 0;
        for (int i = 0; i < 6; ++i) d -= jt[i * n + p] * z[i];
        double v = x[p] + d;
        if (v < c.lower[p]) v = c.lower[p];
        if (v > c.upper[p]) v = c.upper[p];
        xt[p] = v;
        max_step = std::max(max_step, std::abs(v - x[p]));
      }
      double e_new[6];
      eval(xt.data(), e_new, tmp.data());
      double f_new = 0;
      for (double v : e_new) f_new += v * v;

      if (f_new < f) {
        // Gain ratio on the projected step.
        double wv[6] = {0, 0, 0, 0, 0, 0};
        for (int i = 0; i < 6; ++i)
          for (int p = 0; p < n; ++p)
            wv[i] += jt[i * n + p] * (xt[p] - x[p]);
        double pred = 0, rw = 0;
        for (int i = 0; i < 6; ++i) {
          rw += e[i] * wv[i];
          pred -= wv[i] * wv[i];
        }
        pred -= 2.0 * rw;
        const double df = f - f_new;
        if (pred > 0) {
          const double rho = df / pred;
          const double sh = 1.0 - std::pow(2.0 * rho - 1.0, 3.0);
          lam *= (sh > 1.0 / 3.0 ? sh : 1.0 / 3.0);
          nu = 2.0;
        }
        x = xt;
        std::memcpy(e.data(), e_new, 6 * sizeof(double));
        std::swap(jt, tmp);
        f = f_new;
        // Success classification (lib.rs:376-388): stopval always counts;
        // the df/dx criteria count only when the caller set them.
        if (f <= cfg.tol_f) { success = true; break; }
        if (df < tol_df) { success = df_is_success; break; }
        if (dx_is_success && max_step < cfg.tol_dx) { success = true; break; }
      } else {
        lam *= nu;
        nu = std::min(nu * 2.0, 64.0);
        if (lam > 1e10) break;  // stuck
      }
    }

    if (!success) continue;
    if (!quality) {
      // Speed: deterministic "first" success — lowest restart index
      // (the batched paths' replacement for find_any, lib.rs:409-412).
      std::memcpy(x_out, x.data(), n * sizeof(double));
      *f_out = f;
      return 1;
    }
    // Quality: min Euclidean distance to the caller's seed over ALL
    // successful restarts (lib.rs:398-408).
    double d2 = 0;
    for (int j = 0; j < n; ++j) d2 += (x[j] - x0[j]) * (x[j] - x0[j]);
    const double dist = std::sqrt(d2);
    if (dist < best_dist) {
      best_dist = dist;
      best_x = x;
      best_f = f;
      any = true;
    }
  }

  if (quality && any) {
    std::memcpy(x_out, best_x.data(), n * sizeof(double));
    *f_out = best_f;
    return 1;
  }
  return 0;
}

int optik_host_ik_cfg(const void* chain,
                      const optik_host_solver_config* config,
                      const double* target /* 16 row-major */,
                      const double* x0,
                      const double* ee_offset /* 16 row-major or null */,
                      double* x_out, double* f_out) {
  const auto& c = *static_cast<const Chain*>(chain);
  return ik_solve_cfg(c, *config, target, x0, EeOffset::from_ptr(ee_offset),
                      /*validate_seed=*/true, x_out, f_out);
}

int optik_host_ik(const void* chain, const double* target /* 16 row-major */,
                  const double* x0,
                  const double* ee_offset /* 16 row-major or null */,
                  double tol_f, int max_iters, int max_restarts,
                  uint64_t rng_seed, double* x_out, double* f_out) {
  const auto& c = *static_cast<const Chain*>(chain);
  optik_host_solver_config cfg = optik_host_solver_config_default();
  cfg.tol_f = tol_f;
  cfg.max_iters = max_iters;
  cfg.max_restarts = max_restarts;
  cfg.rng_seed = rng_seed;
  const int r = ik_solve_cfg(c, cfg, target, x0,
                             EeOffset::from_ptr(ee_offset),
                             /*validate_seed=*/false, x_out, f_out);
  return r == 1 ? 1 : 0;
}

// --- differential IK (velocity-limited Cartesian step) ---------------------
//
// max alpha s.t. 0 <= alpha <= 1, -v_max <= v <= v_max, J_W(x0) v = alpha V_WE
// (reference lib.rs:101-239, Clarabel replaced by ADMM + active-set polish).
// Returns 1 and writes (alpha, v) on success, else 0.

int optik_host_diff_ik(const void* chain, const double* x0,
                       const double* v_we /* 6 */, const double* v_max /* n */,
                       const double* ee_offset /* 16 row-major or null */,
                       double* alpha_out, double* v_out) {
  const auto& c = *static_cast<const Chain*>(chain);
  DiffIkResult res =
      diff_ik_solve(c, x0, v_we, v_max, EeOffset::from_ptr(ee_offset));
  if (!res.ok) return 0;
  *alpha_out = res.alpha;
  std::memcpy(v_out, res.v.data(), c.n * sizeof(double));
  return 1;
}

}  // extern "C"
