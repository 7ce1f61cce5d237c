// Native batch Dubins engine — host-side scenario/warm-start generation.
//
// Role: the data-loader/initialisation engine of the framework. Python
// builds one Dubins path at a time fast enough for interactive use, but
// scenario-batched solving (thousands of randomized courses per step,
// parallel/batched.py) needs warm-start geometry at rates Python can't
// deliver. This C++ core computes shortest Dubins paths and arc-length
// samples for whole batches in one call, multithreaded, exposed to Python
// via ctypes (aircraft_tpu_torch/native/__init__.py, which builds it with
// g++ into build/aircraft_tpu_torch/ on first use).
//
// The math mirrors aircraft_tpu_torch/dubins/dubins2d.py (Shkel–Lumelsky
// CSC closed forms + tangent-circle geometry for the CCC words); the
// Python implementation is the fallback and the test oracle
// (tests/test_torch_native_dubins.py).  The code is the JAX package's
// native/dubins.cpp, so both libraries return the same bits.
//
// Build:  g++ -O3 -shared -fPIC -std=c++17 -o libdubins.so dubins.cpp -lpthread

#include <cmath>
#include <cstdint>
#include <cstring>
#include <algorithm>
#include <thread>
#include <vector>

namespace {

constexpr double kTwoPi = 6.283185307179586476925286766559;
constexpr int kNone = -1;

double mod2pi(double t) {
  double r = std::fmod(t, kTwoPi);
  return r < 0 ? r + kTwoPi : r;
}

struct Word {
  int type;        // 0 LSL, 1 RSR, 2 LSR, 3 RSL, 4 RLR, 5 LRL
  double t, p, q;  // normalised segment lengths
  bool ok;
};

// segment letters per word: 0=L, 1=R, 2=S
const int kSegs[6][3] = {
    {0, 2, 0}, {1, 2, 1}, {0, 2, 1}, {1, 2, 0}, {1, 0, 1}, {0, 1, 0}};

Word lsl(double a, double b, double d) {
  double ca = std::cos(a), sa = std::sin(a), cb = std::cos(b), sb = std::sin(b);
  double p2 = 2 + d * d - 2 * std::cos(a - b) + 2 * d * (sa - sb);
  if (p2 < 0) return {0, 0, 0, 0, false};
  double tmp = std::atan2(cb - ca, d + sa - sb);
  return {0, mod2pi(-a + tmp), std::sqrt(p2), mod2pi(b - tmp), true};
}

Word rsr(double a, double b, double d) {
  double ca = std::cos(a), sa = std::sin(a), cb = std::cos(b), sb = std::sin(b);
  double p2 = 2 + d * d - 2 * std::cos(a - b) + 2 * d * (sb - sa);
  if (p2 < 0) return {1, 0, 0, 0, false};
  double tmp = std::atan2(ca - cb, d - sa + sb);
  return {1, mod2pi(a - tmp), std::sqrt(p2), mod2pi(-b + tmp), true};
}

Word lsr(double a, double b, double d) {
  double ca = std::cos(a), sa = std::sin(a), cb = std::cos(b), sb = std::sin(b);
  double p2 = -2 + d * d + 2 * std::cos(a - b) + 2 * d * (sa + sb);
  if (p2 < 0) return {2, 0, 0, 0, false};
  double p = std::sqrt(p2);
  double tmp = std::atan2(-ca - cb, d + sa + sb) - std::atan2(-2.0, p);
  return {2, mod2pi(-a + tmp), p, mod2pi(-mod2pi(b) + tmp), true};
}

Word rsl(double a, double b, double d) {
  double ca = std::cos(a), sa = std::sin(a), cb = std::cos(b), sb = std::sin(b);
  double p2 = -2 + d * d + 2 * std::cos(a - b) - 2 * d * (sa + sb);
  if (p2 < 0) return {3, 0, 0, 0, false};
  double p = std::sqrt(p2);
  double tmp = std::atan2(ca + cb, d - sa - sb) - std::atan2(2.0, p);
  return {3, mod2pi(a - tmp), p, mod2pi(b - tmp), true};
}

// CCC words via tangent-circle geometry (sign-robust for d < 4).
Word ccc(double a, double b, double d, bool first_left) {
  double sgn = first_left ? 1.0 : -1.0;
  double c0x = sgn * -std::sin(a), c0y = sgn * std::cos(a);
  double c1x = d + sgn * -std::sin(b), c1y = sgn * std::cos(b);
  double dx = c1x - c0x, dy = c1y - c0y;
  double D = std::hypot(dx, dy);
  int type = first_left ? 5 : 4;
  if (D > 4.0 || D < 1e-12) return {type, 0, 0, 0, false};
  double theta_d = std::atan2(dy, dx);
  double phi = std::acos(std::min(1.0, std::max(-1.0, D / 4.0)));

  Word best = {type, 0, 0, 0, false};
  for (double side : {+1.0, -1.0}) {
    double cmx = c0x + 2.0 * std::cos(theta_d + side * phi);
    double cmy = c0y + 2.0 * std::sin(theta_d + side * phi);
    double t1x = 0.5 * (c0x + cmx), t1y = 0.5 * (c0y + cmy);
    double t2x = 0.5 * (cmx + c1x), t2y = 0.5 * (cmy + c1y);
    double a0 = std::atan2(-c0y, -c0x);
    double a1 = std::atan2(t1y - c0y, t1x - c0x);
    double b1 = std::atan2(t1y - cmy, t1x - cmx);
    double b2 = std::atan2(t2y - cmy, t2x - cmx);
    double g1 = std::atan2(t2y - c1y, t2x - c1x);
    double g2 = std::atan2(-c1y, d - c1x);
    double t, p, q;
    if (first_left) {
      t = mod2pi(a1 - a0);
      p = mod2pi(b1 - b2);
      q = mod2pi(g2 - g1);
    } else {
      t = mod2pi(a0 - a1);
      p = mod2pi(b2 - b1);
      q = mod2pi(g1 - g2);
    }
    if (p <= M_PI - 1e-9) continue;  // middle arc of a true CCC exceeds pi
    if (!best.ok || t + p + q < best.t + best.p + best.q)
      best = {type, t, p, q, true};
  }
  return best;
}

struct Path {
  int word;
  double t, p, q;   // normalised lengths
  double length;    // real length
};

// shortest path in the normalised frame
bool shortest(double qi[3], double qf[3], double rho, double min_length,
              Path* out) {
  double dx = qf[0] - qi[0], dy = qf[1] - qi[1];
  double D = std::hypot(dx, dy);
  double d = D / rho;
  double theta = D > 1e-12 ? std::atan2(dy, dx) : 0.0;
  double a = mod2pi(qi[2] - theta), b = mod2pi(qf[2] - theta);

  Word words[6] = {lsl(a, b, d), rsr(a, b, d), lsr(a, b, d),
                   rsl(a, b, d), ccc(a, b, d, false), ccc(a, b, d, true)};
  bool found = false;
  double best_len = 0;
  for (const Word& w : words) {
    if (!w.ok) continue;
    double len = (w.t + w.p + w.q) * rho;
    if (min_length > 0 && len < min_length - 1e-9) continue;
    if (!found || len < best_len) {
      found = true;
      best_len = len;
      *out = {w.type, w.t, w.p, w.q, len};
    }
  }
  return found;
}

void propagate(double* x, double* y, double* psi, double t, int seg,
               double rho) {
  if (seg == 2) {  // S
    *x += rho * t * std::cos(*psi);
    *y += rho * t * std::sin(*psi);
    return;
  }
  double sgn = seg == 0 ? 1.0 : -1.0;  // L ccw, R cw
  double psi_new = *psi + sgn * t;
  *x += rho * (std::sin(psi_new) - std::sin(*psi)) * sgn;
  *y -= rho * (std::cos(psi_new) - std::cos(*psi)) * sgn;
  *psi = mod2pi(psi_new);
}

void sample_path(const Path& path, double qi[3], double rho, int n,
                 double* out /* n x 3 */) {
  double lens[3] = {path.t, path.p, path.q};
  const int* segs = kSegs[path.word];
  for (int i = 0; i < n; ++i) {
    double s = path.length * i / (n - 1) / rho;
    double x = qi[0], y = qi[1], psi = qi[2];
    for (int k = 0; k < 3; ++k) {
      double ds = std::min(s, lens[k]);
      propagate(&x, &y, &psi, ds, segs[k], rho);
      s -= ds;
      if (s <= 1e-12) break;
    }
    out[3 * i + 0] = x;
    out[3 * i + 1] = y;
    out[3 * i + 2] = psi;
  }
}

}  // namespace

extern "C" {

// Batch shortest paths: qis/qfs are (B,3) row-major; writes per-path
// (word, t, p, q, length) into out (B,5); ok[b] = 1 on success.
// min_lengths may be null (no constraint). Multithreaded over the batch.
void dubins_shortest_batch(const double* qis, const double* qfs,
                           const double* rhos, const double* min_lengths,
                           int batch, double* out, uint8_t* ok) {
  int n_threads = std::max(1u, std::thread::hardware_concurrency());
  n_threads = std::min(n_threads, std::max(1, batch / 64 + 1));
  std::vector<std::thread> threads;
  auto work = [&](int lo, int hi) {
    for (int b = lo; b < hi; ++b) {
      double qi[3] = {qis[3 * b], qis[3 * b + 1], qis[3 * b + 2]};
      double qf[3] = {qfs[3 * b], qfs[3 * b + 1], qfs[3 * b + 2]};
      double ml = min_lengths ? min_lengths[b] : -1.0;
      Path p;
      if (shortest(qi, qf, rhos[b], ml, &p)) {
        out[5 * b + 0] = p.word;
        out[5 * b + 1] = p.t;
        out[5 * b + 2] = p.p;
        out[5 * b + 3] = p.q;
        out[5 * b + 4] = p.length;
        ok[b] = 1;
      } else {
        std::memset(out + 5 * b, 0, 5 * sizeof(double));
        ok[b] = 0;
      }
    }
  };
  int chunk = (batch + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int lo = t * chunk, hi = std::min(batch, lo + chunk);
    if (lo >= hi) break;
    threads.emplace_back(work, lo, hi);
  }
  for (auto& th : threads) th.join();
}

// Batch path sampling: for each path b, write n uniformly-spaced (x,y,psi)
// samples into out (B, n, 3). paths is the (B,5) output of
// dubins_shortest_batch.
void dubins_sample_batch(const double* qis, const double* rhos,
                         const double* paths, int batch, int n, double* out) {
  int n_threads = std::max(1u, std::thread::hardware_concurrency());
  n_threads = std::min(n_threads, std::max(1, batch / 16 + 1));
  std::vector<std::thread> threads;
  auto work = [&](int lo, int hi) {
    for (int b = lo; b < hi; ++b) {
      double qi[3] = {qis[3 * b], qis[3 * b + 1], qis[3 * b + 2]};
      Path p = {(int)paths[5 * b], paths[5 * b + 1], paths[5 * b + 2],
                paths[5 * b + 3], paths[5 * b + 4]};
      sample_path(p, qi, rhos[b], n, out + (size_t)b * n * 3);
    }
  };
  int chunk = (batch + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int lo = t * chunk, hi = std::min(batch, lo + chunk);
    if (lo >= hi) break;
    threads.emplace_back(work, lo, hi);
  }
  for (auto& th : threads) th.join();
}

}  // extern "C"
