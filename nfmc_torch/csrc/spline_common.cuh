// The elementwise monotone splines of the spline coupling kernels (spline.cu,
// spline_bwd.cu): rational-quadratic (RQS, Durkan et al. 2019) and
// linear-rational (LRS, Dolatabadi et al. 2020), each applied forward or
// inverse, and their VJPs written out by hand.
//
// One transformed element takes P raw conditioner outputs r[0 .. P-1]:
//   r[0, K)          bin widths (softmax)
//   r[K, 2K)         bin heights (softmax)
//   r[2K, 3K-1)      interior knot derivatives (softplus)
//   r[3K-1, 4K-1)    LRS only: each bin's interior point lambda (sigmoid)
// Knots (nfmc_torch/flows/spline.py::_make_knots, term for term):
//   size_k = 1e-3 + (1 - 1e-3 K) softmax(r)_k
//   cum_0 = -T, cum_j = (size_0 + ... + size_{j-1}) 2T - T, cum_K = T (pinned)
//   deriv_0 = deriv_K = 1, deriv_j = 1e-3 + softplus(r[2K + j - 1] + shift)
// The shift makes a zero conditioner output the identity map. The element's
// bin is the first k with x < cum_{k+1} (the last bin when there is none):
// the knots increase, so that is the count of knots 1..K at or below x,
// clipped to K - 1, as the plain version's searchsorted computes it.
// Elements with |x| > T pass through with log-det 0; the callers test that.
#pragma once
#include <cuda_runtime.h>

namespace {

constexpr float kMinBin = 1e-3f;
constexpr float kMinDeriv = 1e-3f;
constexpr float kDerivShift = 0.539742417236952f;  // log(expm1(1 - 1e-3))

__device__ __forceinline__ float softplus(float v) {
  return fmaxf(v, 0.f) + log1pf(expf(-fabsf(v)));
}

__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

// The guard of the LRS inverse's divisions.
__device__ __forceinline__ float guard(float den) { return fabsf(den) < 1e-12f ? 1e-12f : den; }

// Max and sum of exp(r_k - max) over K raw values: the softmax's constants.
struct Softmax {
  float m, s;
};

__device__ __forceinline__ Softmax softmax_of(const float* r, int K) {
  Softmax sm{r[0], 0.f};
  for (int k = 1; k < K; ++k) sm.m = fmaxf(sm.m, r[k]);
  for (int k = 0; k < K; ++k) sm.s += expf(r[k] - sm.m);
  return sm;
}

// The bin an element falls in and the quantities the spline reads there.
struct Bin {
  int k;
  float xk, w;   // left knot and width in x
  float yk, h;   // left knot and height in y
  float d0, d1;  // derivatives at the bin's two knots
  float lam;     // LRS: the bin's interior point
  Softmax sw, sh;
};

// Cotangents of a Bin's quantities.
struct BinGrad {
  float xk, w, yk, h, d0, d1, lam;
};

// Walk the knots in order until the bin of x (searched among the y knots
// when by_height, the x knots otherwise).
template <bool LRS>
__device__ Bin find_bin(const float* r, int K, float T, float x, bool by_height) {
  Bin b;
  b.sw = softmax_of(r, K);
  b.sh = softmax_of(r + K, K);
  const float scale = 1.f - kMinBin * K;
  float accw = 0.f, acch = 0.f, cw = -T, ch = -T, dprev = 1.f;
  for (int k = 0; k < K; ++k) {
    accw += kMinBin + scale * (expf(r[k] - b.sw.m) / b.sw.s);
    acch += kMinBin + scale * (expf(r[K + k] - b.sh.m) / b.sh.s);
    const bool last = k == K - 1;
    const float cw1 = last ? T : accw * (2.f * T) - T;
    const float ch1 = last ? T : acch * (2.f * T) - T;
    const float d1 = last ? 1.f : kMinDeriv + softplus(r[2 * K + k] + kDerivShift);
    if (last || x < (by_height ? ch1 : cw1)) {
      b.k = k;
      b.xk = cw;
      b.w = cw1 - cw;
      b.yk = ch;
      b.h = ch1 - ch;
      b.d0 = dprev;
      b.d1 = d1;
      b.lam = LRS ? 0.025f + 0.95f * sigmoid(r[3 * K - 1 + k]) : 0.f;
      break;
    }
    cw = cw1;
    ch = ch1;
    dprev = d1;
  }
  return b;
}

// ---- rational-quadratic ------------------------------------------------------
// forward: xi = (x - xk) / w, y = yk + h (s xi^2 + d0 xi(1-xi)) / denom
// inverse: xi is the root of the quadratic a xi^2 + b xi + c = 0 in [0, 1]
// denom = s + (d1 + d0 - 2 s) xi(1-xi), s = h / w,
// dy/dx = s^2 (d1 xi^2 + 2 s xi(1-xi) + d0 (1-xi)^2) / denom^2
__device__ float rqs_apply(const Bin& b, float x, bool inverse, float* ld) {
  const float s = b.h / b.w;
  const float corr = b.d1 + b.d0 - 2.f * s;
  float xi, out;
  if (!inverse) {
    xi = (x - b.xk) / b.w;
  } else {
    const float term = x - b.yk;
    const float a = b.h * (s - b.d0) + term * corr;
    const float bq = b.h * b.d0 - term * corr;
    const float c = -s * term;
    const float disc = fmaxf(bq * bq - 4.f * a * c, 0.f);
    xi = fminf(fmaxf((2.f * c) / (-bq - sqrtf(disc)), 0.f), 1.f);
  }
  const float xi1m = xi * (1.f - xi);
  const float denom = s + corr * xi1m;
  if (!inverse)
    out = b.yk + b.h * (s * xi * xi + b.d0 * xi1m) / denom;
  else
    out = b.xk + b.w * xi;
  const float om = 1.f - xi;
  const float dydx = (s * s * (b.d1 * xi * xi + 2.f * s * xi1m + b.d0 * om * om)) / (denom * denom);
  *ld = inverse ? -logf(dydx) : logf(dydx);
  return out;
}

// Returns the cotangent of x; writes those of the bin's quantities into g.
__device__ float rqs_vjp(const Bin& b, float x, bool inverse, float gy, float gl, BinGrad& g) {
  const float s = b.h / b.w;
  const float corr = b.d1 + b.d0 - 2.f * s;
  g = BinGrad{0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  // the forward quantities
  float xi, term = 0.f, a = 0.f, bq = 0.f, c = 0.f, disc0 = 0.f, sq = 0.f, den_r = 1.f,
            xi_raw = 0.f;
  if (!inverse) {
    xi = (x - b.xk) / b.w;
  } else {
    term = x - b.yk;
    a = b.h * (s - b.d0) + term * corr;
    bq = b.h * b.d0 - term * corr;
    c = -s * term;
    disc0 = bq * bq - 4.f * a * c;
    sq = sqrtf(fmaxf(disc0, 0.f));
    den_r = -bq - sq;
    xi_raw = (2.f * c) / den_r;
    xi = fminf(fmaxf(xi_raw, 0.f), 1.f);
  }
  const float xi1m = xi * (1.f - xi);
  const float denom = s + corr * xi1m;
  const float q = b.d1 * xi * xi + 2.f * s * xi1m + b.d0 * (1.f - xi) * (1.f - xi);

  // log-det = +-(2 log s + log q - 2 log denom)
  const float sg = inverse ? -gl : gl;
  float g_s = 2.f * sg / s, g_q = sg / q, g_denom = -2.f * sg / denom;
  float g_xi = 0.f, g_xi1m = 0.f, g_corr = 0.f, gx;
  if (!inverse) {  // y = yk + h num / denom
    const float num = s * xi * xi + b.d0 * xi1m;
    const float g_num = gy * b.h / denom;
    g.yk = gy;
    g.h = gy * num / denom;
    g_denom -= gy * b.h * num / (denom * denom);
    g_s += g_num * xi * xi;
    g_xi += g_num * 2.f * s * xi;
    g.d0 += g_num * xi1m;
    g_xi1m += g_num * b.d0;
  } else {  // x_out = xk + w xi
    g.xk = gy;
    g.w = gy * xi;
    g_xi += gy * b.w;
  }
  // q
  g.d1 += g_q * xi * xi;
  g_s += g_q * 2.f * xi1m;
  g.d0 += g_q * (1.f - xi) * (1.f - xi);
  g_xi += g_q * (2.f * b.d1 * xi - 2.f * b.d0 * (1.f - xi));
  g_xi1m += g_q * 2.f * s;
  // denom = s + corr xi1m
  g_s += g_denom;
  g_corr += g_denom * xi1m;
  g_xi1m += g_denom * corr;
  g_xi += g_xi1m * (1.f - 2.f * xi);
  if (!inverse) {  // xi = (x - xk) / w
    gx = g_xi / b.w;
    g.xk -= g_xi / b.w;
    g.w -= g_xi * xi / b.w;
  } else {
    // the clip passes the gradient inside [0, 1] (bounds included)
    const float g_xr = (xi_raw >= 0.f && xi_raw <= 1.f) ? g_xi : 0.f;
    // xi_raw = 2 c / den_r, den_r = -bq - sqrt(max(disc0, 0))
    float g_c = g_xr * 2.f / den_r;
    const float g_denr = -g_xr * xi_raw / den_r;
    float g_b = -g_denr;
    const float g_disc = disc0 >= 0.f ? -g_denr / (2.f * sq) : 0.f;
    g_b += g_disc * 2.f * bq;
    const float g_a = -4.f * c * g_disc;
    g_c -= 4.f * a * g_disc;
    // c = -s term
    g_s -= term * g_c;
    float g_term = -s * g_c;
    // bq = h d0 - term corr
    g.h += g_b * b.d0;
    g.d0 += g_b * b.h;
    g_term -= g_b * corr;
    g_corr -= g_b * term;
    // a = h (s - d0) + term corr
    g.h += g_a * (s - b.d0);
    g_s += g_a * b.h;
    g.d0 -= g_a * b.h;
    g_term += g_a * corr;
    g_corr += g_a * term;
    // term = x - yk
    gx = g_term;
    g.yk -= g_term;
  }
  // corr = d1 + d0 - 2 s
  g.d1 += g_corr;
  g.d0 += g_corr;
  g_s -= 2.f * g_corr;
  // s = h / w
  g.h += g_s / b.w;
  g.w -= g_s * s / b.w;
  return gx;
}

// ---- linear-rational ---------------------------------------------------------
// Each bin is two linear-rational segments meeting at phi = lambda, with
// weights wa = 1, wb = sqrt(d0 / d1), wc = (lam d0 + (1 - lam) wb d1) / s and
// the value yc = ((1 - lam) ya + lam wb yb) / ((1 - lam) + lam wb) there.
struct Lrs {
  float s, r, wb, wcn, wc, ya, yb, ycn, ycd, yc;
};

__device__ __forceinline__ Lrs lrs_of(const Bin& b) {
  Lrs q;
  q.s = b.h / b.w;
  q.r = b.d0 / b.d1;
  q.wb = sqrtf(q.r);
  q.wcn = b.lam * b.d0 + (1.f - b.lam) * q.wb * b.d1;
  q.wc = q.wcn / q.s;
  q.ya = b.yk;
  q.yb = b.yk + b.h;
  q.ycn = (1.f - b.lam) * q.ya + b.lam * q.wb * q.yb;
  q.ycd = (1.f - b.lam) + b.lam * q.wb;
  q.yc = q.ycn / q.ycd;
  return q;
}

__device__ float lrs_apply(const Bin& b, float x, bool inverse, float* ld) {
  const Lrs q = lrs_of(b);
  const float lam = b.lam;
  float phi, out;
  bool seg1;
  if (!inverse) {
    phi = (x - b.xk) / b.w;
    seg1 = phi <= lam;
  } else {
    seg1 = x <= q.yc;
    const float p = seg1 ? lam * (x - q.ya) / guard((x - q.ya) - q.wc * (x - q.yc))
                         : (q.wc * (x - q.yc) + lam * q.wb * (q.yb - x)) /
                               guard(q.wc * (x - q.yc) + q.wb * (q.yb - x));
    phi = fminf(fmaxf(p, 0.f), 1.f);
  }
  float dydx;
  if (seg1) {
    const float d1 = (lam - phi) + q.wc * phi;
    out = (q.ya * (lam - phi) + q.wc * q.yc * phi) / d1;
    dydx = lam * q.wc * (q.yc - q.ya) / (d1 * d1 * b.w);
  } else {
    const float d2 = q.wc * (1.f - phi) + q.wb * (phi - lam);
    out = (q.wc * q.yc * (1.f - phi) + q.wb * q.yb * (phi - lam)) / d2;
    dydx = (1.f - lam) * q.wb * q.wc * (q.yb - q.yc) / (d2 * d2 * b.w);
  }
  if (inverse) out = b.xk + b.w * phi;
  *ld = inverse ? -logf(dydx) : logf(dydx);
  return out;
}

__device__ float lrs_vjp(const Bin& b, float x, bool inverse, float gy, float gl, BinGrad& g) {
  const Lrs q = lrs_of(b);
  const float lam = b.lam, w = b.w;
  float g_lam = 0.f, g_wc = 0.f, g_wb = 0.f, g_ya = 0.f, g_yb = 0.f, g_yc = 0.f, g_w = 0.f,
        g_phi = 0.f, gx = 0.f, g_x0 = 0.f;
  float phi, p_raw = 0.f, n = 0.f, den = 1.f;
  bool seg1;
  if (!inverse) {
    phi = (x - b.xk) / w;
    seg1 = phi <= lam;
  } else {
    seg1 = x <= q.yc;
    if (seg1) {
      n = lam * (x - q.ya);
      den = (x - q.ya) - q.wc * (x - q.yc);
    } else {
      n = q.wc * (x - q.yc) + lam * q.wb * (q.yb - x);
      den = q.wc * (x - q.yc) + q.wb * (q.yb - x);
    }
    p_raw = n / guard(den);
    phi = fminf(fmaxf(p_raw, 0.f), 1.f);
  }
  // log-det = +-log dy/dx
  const float sg = inverse ? -gl : gl;
  if (seg1) {
    // log dy/dx = log lam + log wc + log(yc - ya) - 2 log D1 - log w
    const float d1 = (lam - phi) + q.wc * phi;
    g_lam += sg / lam;
    g_wc += sg / q.wc;
    g_yc += sg / (q.yc - q.ya);
    g_ya -= sg / (q.yc - q.ya);
    float g_d1 = -2.f * sg / d1;
    g_w -= sg / w;
    if (!inverse) {  // y = N1 / D1, N1 = ya (lam - phi) + wc yc phi
      const float g_n1 = gy / d1;
      g_d1 -= gy * ((q.ya * (lam - phi) + q.wc * q.yc * phi) / d1) / d1;
      g_ya += g_n1 * (lam - phi);
      g_lam += g_n1 * q.ya;
      g_phi += g_n1 * (q.wc * q.yc - q.ya);
      g_wc += g_n1 * q.yc * phi;
      g_yc += g_n1 * q.wc * phi;
    }
    // D1 = (lam - phi) + wc phi
    g_lam += g_d1;
    g_phi += g_d1 * (q.wc - 1.f);
    g_wc += g_d1 * phi;
  } else {
    // log dy/dx = log(1 - lam) + log wb + log wc + log(yb - yc) - 2 log D2 - log w
    const float d2 = q.wc * (1.f - phi) + q.wb * (phi - lam);
    g_lam -= sg / (1.f - lam);
    g_wb += sg / q.wb;
    g_wc += sg / q.wc;
    g_yb += sg / (q.yb - q.yc);
    g_yc -= sg / (q.yb - q.yc);
    float g_d2 = -2.f * sg / d2;
    g_w -= sg / w;
    if (!inverse) {  // y = N2 / D2, N2 = wc yc (1 - phi) + wb yb (phi - lam)
      const float g_n2 = gy / d2;
      g_d2 -= gy * ((q.wc * q.yc * (1.f - phi) + q.wb * q.yb * (phi - lam)) / d2) / d2;
      g_wc += g_n2 * q.yc * (1.f - phi);
      g_yc += g_n2 * q.wc * (1.f - phi);
      g_phi += g_n2 * (q.wb * q.yb - q.wc * q.yc);
      g_wb += g_n2 * q.yb * (phi - lam);
      g_yb += g_n2 * q.wb * (phi - lam);
      g_lam -= g_n2 * q.wb * q.yb;
    }
    // D2 = wc (1 - phi) + wb (phi - lam)
    g_wc += g_d2 * (1.f - phi);
    g_phi += g_d2 * (q.wb - q.wc);
    g_wb += g_d2 * (phi - lam);
    g_lam -= g_d2 * q.wb;
  }
  if (!inverse) {  // phi = (x - x0) / w
    gx = g_phi / w;
    g_x0 = -g_phi / w;
    g_w -= g_phi * phi / w;
  } else {  // x_out = x0 + w phi, phi = clip(n / guard(den), 0, 1)
    g_x0 = gy;
    g_w += gy * phi;
    g_phi += gy * w;
    const float g_p = (p_raw >= 0.f && p_raw <= 1.f) ? g_phi : 0.f;
    const float g_n = g_p / guard(den);
    const float g_den = fabsf(den) < 1e-12f ? 0.f : -g_p * p_raw / den;
    if (seg1) {
      // n = lam (x - ya), den = (x - ya) - wc (x - yc)
      g_lam += g_n * (x - q.ya);
      gx += g_n * lam;
      g_ya -= g_n * lam;
      gx += g_den * (1.f - q.wc);
      g_ya -= g_den;
      g_wc -= g_den * (x - q.yc);
      g_yc += g_den * q.wc;
    } else {
      // n = wc (x - yc) + lam wb (yb - x), den = wc (x - yc) + wb (yb - x)
      g_wc += (g_n + g_den) * (x - q.yc);
      gx += g_n * (q.wc - lam * q.wb) + g_den * (q.wc - q.wb);
      g_yc -= (g_n + g_den) * q.wc;
      g_lam += g_n * q.wb * (q.yb - x);
      g_wb += (g_n * lam + g_den) * (q.yb - x);
      g_yb += (g_n * lam + g_den) * q.wb;
    }
  }
  // yc = ycn / ycd
  const float g_ycn = g_yc / q.ycd;
  const float g_ycd = -g_yc * q.yc / q.ycd;
  g_lam += g_ycn * (q.wb * q.yb - q.ya) + g_ycd * (q.wb - 1.f);
  g_ya += g_ycn * (1.f - lam);
  g_wb += g_ycn * lam * q.yb + g_ycd * lam;
  g_yb += g_ycn * lam * q.wb;
  // wc = wcn / s, wcn = lam d0 + (1 - lam) wb d1
  const float g_wcn = g_wc / q.s;
  const float g_s = -g_wc * q.wc / q.s;
  g_lam += g_wcn * (b.d0 - q.wb * b.d1);
  g_wb += g_wcn * (1.f - lam) * b.d1;
  g.d0 = g_wcn * lam;
  g.d1 = g_wcn * (1.f - lam) * q.wb;
  // wb = sqrt(r), r = d0 / d1
  const float g_r = g_wb * 0.5f / q.wb;
  g.d0 += g_r / b.d1;
  g.d1 -= g_r * q.r / b.d1;
  // ya = yk, yb = yk + h, s = h / w
  g.yk = g_ya + g_yb;
  g.h = g_yb + g_s / w;
  g.w = g_w - g_s * q.s / w;
  g.xk = g_x0;
  g.lam = g_lam;
  return gx;
}

// ---- one element ---------------------------------------------------------------

// The spline of one element x (inside [-T, T]): (output, log-det).
template <bool LRS>
__device__ __noinline__ float2 spline_apply(const float* r, int K, float T, float x,
                                            bool inverse) {
  const Bin b = find_bin<LRS>(r, K, T, x, inverse);
  float2 o;
  o.x = LRS ? lrs_apply(b, x, inverse, &o.y) : rqs_apply(b, x, inverse, &o.y);
  return o;
}

// The VJP of one element (x inside [-T, T]) given the cotangents gy of its
// output and gl of its log-det: returns the cotangent of x and overwrites
// r[0 .. P-1] with the cotangents of the raw parameters. The bin lookup has
// no gradient; the pinned knots cum_0, cum_K, deriv_0 and deriv_K get none.
template <bool LRS>
__device__ __noinline__ float spline_vjp(float* r, int K, float T, float x, bool inverse,
                                         float gy, float gl) {
  const Bin b = find_bin<LRS>(r, K, T, x, inverse);
  BinGrad g;
  const float gx = LRS ? lrs_vjp(b, x, inverse, gy, gl, g) : rqs_vjp(b, x, inverse, gy, gl, g);
  const int k = b.k;
  // knots: x_k = cumw_k, w = cumw_{k+1} - cumw_k (the same for y and h);
  // cum_j = (size_0 + ... + size_{j-1}) 2T - T for 1 <= j <= K - 1, so
  // d cum_j / d size_m = 2T for m < j
  const float scale = 1.f - kMinBin * K;
  const float aw = k >= 1 ? g.xk - g.w : 0.f;  // cotangent of cumw_k
  const float bw = k + 1 <= K - 1 ? g.w : 0.f;  // of cumw_{k+1}
  const float ah = k >= 1 ? g.yk - g.h : 0.f;
  const float bh = k + 1 <= K - 1 ? g.h : 0.f;
  // the softmax: g_raw_m = p_m (g_p_m - sum_n p_n g_p_n), with
  // g_p_m = scale 2T ([m < k] a + [m <= k] b)
  float dot_w = 0.f, dot_h = 0.f;
  for (int m = 0; m <= k; ++m) {
    const float pw = expf(r[m] - b.sw.m) / b.sw.s;
    const float ph = expf(r[K + m] - b.sh.m) / b.sh.s;
    dot_w += pw * ((m < k ? aw : 0.f) + bw);
    dot_h += ph * ((m < k ? ah : 0.f) + bh);
  }
  const float c = scale * 2.f * T;
  for (int m = 0; m < K; ++m) {
    const float pw = expf(r[m] - b.sw.m) / b.sw.s;
    const float ph = expf(r[K + m] - b.sh.m) / b.sh.s;
    const float gw = m < k ? aw + bw : m == k ? bw : 0.f;
    const float gh = m < k ? ah + bh : m == k ? bh : 0.f;
    r[m] = pw * c * (gw - dot_w);
    r[K + m] = ph * c * (gh - dot_h);
  }
  // interior derivatives: deriv_j = 1e-3 + softplus(r[2K + j - 1] + shift)
  for (int j = 1; j < K; ++j) {
    float* rd = r + 2 * K + j - 1;
    const float gd = j == k ? g.d0 : j == k + 1 ? g.d1 : 0.f;
    *rd = gd * sigmoid(*rd + kDerivShift);
  }
  if (LRS) {  // lam = 0.025 + 0.95 sigmoid(r[3K - 1 + k])
    for (int m = 0; m < K; ++m) {
      float* rl = r + 3 * K - 1 + m;
      const float sg = sigmoid(*rl);
      *rl = m == k ? g.lam * 0.95f * sg * (1.f - sg) : 0.f;
    }
  }
  return gx;
}

}  // namespace
