// U(1) heat-bath gauge-ensemble generator (native runtime component).
//
// The reference consumed ensembles from an external heat-bath MCMC code
// that is absent from its repo (reference gauge.h:44 reads
// phase_{L}_b{beta}.dat); this module is our replacement producer.
// Markov-chain sweeps are inherently sequential -> native C++, exposed
// through a C ABI consumed via ctypes (tpu_multigrid/utils/native.py).
//
// Physics: Wilson action S = -beta * sum_plaq Re P with
// P(x) = U0(x) U1(x+x^) conj(U0(x+y^)) conj(U1(x)).
// Single-link conditional is von Mises: p(theta) ~ exp(beta |V| cos(theta
// + arg V)) with V the staple sum; sampled by the Best-Fisher rejection
// method. Checkerboard ordering matches the Python fallback
// (models/gauge.py heatbath_ensemble) so both produce valid ensembles.
//
// Build: g++ -O3 -shared -fPIC heatbath.cpp refio.cpp -o libmgnative.so

#include <cmath>
#include <cstdint>
#include <random>

namespace {

constexpr double kTwoPi = 6.283185307179586476925286766559;

struct Idx {
  int L;
  inline long link(int mu, int x, int y) const {
    return (static_cast<long>(mu) * L + x) * L + y;  // theta[2][L][L]
  }
  inline int up(int a) const { return a + 1 == L ? 0 : a + 1; }
  inline int dn(int a) const { return a == 0 ? L - 1 : a - 1; }
};

// Staple sum V for link (mu, x, y): the plaquettes containing this link
// contribute Re[U * V]. Returns complex V as (re, im).
void staples(const double* th, Idx g, int mu, int x, int y, double* vr,
             double* vi) {
  auto U = [&](int m, int a, int b) {
    double t = th[g.link(m, a, b)];
    return std::pair<double, double>(std::cos(t), std::sin(t));
  };
  auto mul = [](std::pair<double, double> a, std::pair<double, double> b) {
    return std::pair<double, double>(a.first * b.first - a.second * b.second,
                                     a.first * b.second + a.second * b.first);
  };
  auto conj = [](std::pair<double, double> a) {
    return std::pair<double, double>(a.first, -a.second);
  };
  std::pair<double, double> v1, v2;
  if (mu == 0) {
    // v1 = U1(x+1,y) * conj(U0(x,y+1)) * conj(U1(x,y))
    v1 = mul(mul(U(1, g.up(x), y), conj(U(0, x, g.up(y)))), conj(U(1, x, y)));
    // v2 = conj(U1(x+1,y-1)) * conj(U0(x,y-1)) * U1(x,y-1)
    v2 = mul(mul(conj(U(1, g.up(x), g.dn(y))), conj(U(0, x, g.dn(y)))),
             U(1, x, g.dn(y)));
  } else {
    // v1 = conj(U1(x+1,y)) * conj(U0(x,y)) * U0(x,y+1)
    v1 = mul(mul(conj(U(1, g.up(x), y)), conj(U(0, x, y))), U(0, x, g.up(y)));
    // v2 = U0(x-1,y) * conj(U0(x-1,y+1)) * conj(U1(x-1,y))
    v2 = mul(mul(U(0, g.dn(x), y), conj(U(0, g.dn(x), g.up(y)))),
             conj(U(1, g.dn(x), y)));
  }
  *vr = v1.first + v2.first;
  *vi = v1.second + v2.second;
}

// Best-Fisher (1979) von Mises sampler: theta ~ exp(kappa cos(theta-mu)).
double sample_von_mises(std::mt19937_64& rng, double mu, double kappa) {
  std::uniform_real_distribution<double> unif(0.0, 1.0);
  if (kappa < 1e-8) {
    return mu + (unif(rng) - 0.5) * kTwoPi;
  }
  const double a = 1.0 + std::sqrt(1.0 + 4.0 * kappa * kappa);
  const double b = (a - std::sqrt(2.0 * a)) / (2.0 * kappa);
  const double r = (1.0 + b * b) / (2.0 * b);
  while (true) {
    double u1 = unif(rng), u2 = unif(rng), u3 = unif(rng);
    double z = std::cos(M_PI * u1);
    double f = (1.0 + r * z) / (r + z);
    double c = kappa * (r - f);
    if (c * (2.0 - c) - u2 > 0.0 || std::log(c / u2) + 1.0 - c >= 0.0) {
      double th = (u3 < 0.5 ? -1.0 : 1.0) * std::acos(f);
      return mu + th;
    }
  }
}

inline double wrap_pi(double t) {
  t = std::fmod(t + M_PI, kTwoPi);
  if (t < 0) t += kTwoPi;
  return t - M_PI;
}

}  // namespace

extern "C" {

// In-place heat-bath sweeps on theta[2*L*L]; checkerboard-ordered link
// updates (mu-major, parity within mu).
void mgn_heatbath_run(double* theta, int L, double beta, int sweeps,
                        uint64_t seed) {
  Idx g{L};
  std::mt19937_64 rng(seed);
  for (int s = 0; s < sweeps; ++s) {
    for (int mu = 0; mu < 2; ++mu) {
      for (int par = 0; par < 2; ++par) {
        for (int x = 0; x < L; ++x) {
          for (int y = 0; y < L; ++y) {
            if (((x + y) & 1) != par) continue;
            double vr, vi;
            staples(theta, g, mu, x, y, &vr, &vi);
            double mag = std::hypot(vr, vi);
            double mean = -std::atan2(vi, vr);
            theta[g.link(mu, x, y)] =
                wrap_pi(sample_von_mises(rng, mean, beta * mag));
          }
        }
      }
    }
  }
}

// Mean plaquette Re P over the lattice.
double mgn_mean_plaquette(const double* theta, int L) {
  Idx g{L};
  double acc = 0.0;
  for (int x = 0; x < L; ++x) {
    for (int y = 0; y < L; ++y) {
      double t = theta[g.link(0, x, y)] + theta[g.link(1, g.up(x), y)] -
                 theta[g.link(0, x, g.up(y))] - theta[g.link(1, x, y)];
      acc += std::cos(t);
    }
  }
  return acc / (static_cast<double>(L) * L);
}

}  // extern "C"
