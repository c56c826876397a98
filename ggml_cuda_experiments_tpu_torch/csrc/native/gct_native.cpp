// gct_native: the port's host-side block-quant codec (utils/native.py).
//
// A copy of the JAX package's native/gct_native.cpp, kept by the port so
// that it loads nothing of the JAX side: multithreaded Q8_0 / Q4_0 / Q4_K /
// Q6_K encode and decode, exposed through ctypes, with semantics
// bit-identical to the NumPy oracle (oracle/quant.py), which the port's
// tests enforce. It runs on the host; the card's path quantizes on the
// device (ops/quant_matmul.py).
//
// Build: utils/native.py compiles this file and gct_sched.cpp with g++
// (-O3 -std=c++17 -fPIC -pthread -shared) into build/native/ at first use.

#include <cstdint>
#include <cstring>
#include <cmath>
#include <cfenv>
#include <algorithm>
#include <thread>
#include <vector>

// ---------------------------------------------------------------------------
// fp16 helpers (IEEE round-to-nearest-even, matching numpy .astype(float16))
// ---------------------------------------------------------------------------

static inline uint16_t f32_to_f16_bits(float f) {
    uint32_t x;
    std::memcpy(&x, &f, 4);
    const uint32_t sign = (x >> 16) & 0x8000u;
    const uint32_t e8 = (x >> 23) & 0xFFu;
    uint32_t mant = x & 0x007FFFFFu;
    if (e8 == 0xFFu)                              // inf / nan
        return (uint16_t)(sign | 0x7C00u | (mant ? 0x200u : 0u));
    const int32_t e = (int32_t)e8 - 127 + 15;
    if (e >= 31) return (uint16_t)(sign | 0x7C00u);      // overflow -> inf
    if (e <= 0) {                                 // subnormal half
        if (e < -10) return (uint16_t)sign;       // underflow -> 0
        mant |= 0x800000u;                        // implicit bit
        const uint32_t shift = (uint32_t)(14 - e);
        uint32_t half = mant >> shift;
        const uint32_t rem = mant & ((1u << shift) - 1u);
        const uint32_t halfway = 1u << (shift - 1);
        if (rem > halfway || (rem == halfway && (half & 1u))) half += 1;
        return (uint16_t)(sign | half);
    }
    uint32_t half = ((uint32_t)e << 10) | (mant >> 13);  // normal, RNE
    const uint32_t rem = mant & 0x1FFFu;
    if (rem > 0x1000u || (rem == 0x1000u && (half & 1u))) half += 1;
    return (uint16_t)(sign | half);               // carry may bump exponent
}

static inline float f16_bits_to_f32(uint16_t h) {
    const uint32_t sign = (uint32_t)(h & 0x8000u) << 16;
    uint32_t exp = (h >> 10) & 0x1Fu;
    uint32_t mant = h & 0x3FFu;
    uint32_t x;
    if (exp == 0) {
        if (mant == 0) {
            x = sign;
        } else {                                   // subnormal
            exp = 127 - 15 + 1;
            while (!(mant & 0x400u)) { mant <<= 1; exp--; }
            mant &= 0x3FFu;
            x = sign | (exp << 23) | (mant << 13);
        }
    } else if (exp == 31) {
        x = sign | 0x7F800000u | (mant << 13);
    } else {
        x = sign | ((exp + 127 - 15) << 23) | (mant << 13);
    }
    float f;
    std::memcpy(&f, &x, 4);
    return f;
}

static inline float f16_round(float v) { return f16_bits_to_f32(f32_to_f16_bits(v)); }

// numpy round == rint with round-half-even (the default FP env)
static inline float rne(float v) { return std::nearbyintf(v); }

// ---------------------------------------------------------------------------
// Q8_0: 32-elem blocks, d = absmax/127 (fp16-rounded), q = clip(rne(x/d))
// ---------------------------------------------------------------------------

static void q8_0_rows(const float *x, int8_t *qs, float *d,
                      int64_t row0, int64_t row1, int64_t k) {
    const int64_t nb = k / 32;
    for (int64_t r = row0; r < row1; ++r) {
        const float *xr = x + r * k;
        int8_t *qr = qs + r * k;
        float *dr = d + r * nb;
        for (int64_t b = 0; b < nb; ++b) {
            const float *xb = xr + b * 32;
            float amax = 0.f;
            for (int j = 0; j < 32; ++j) amax = std::max(amax, std::fabs(xb[j]));
            const float dv = f16_round(amax / 127.0f);
            dr[b] = dv;
            const float inv = dv != 0.f ? 1.0f / dv : 0.0f;
            for (int j = 0; j < 32; ++j) {
                float q = rne(xb[j] * inv);
                q = std::min(127.f, std::max(-127.f, q));
                qr[b * 32 + j] = (int8_t)q;
            }
        }
    }
}

// ---------------------------------------------------------------------------
// Q4_0: 32-elem blocks, d = signed-absmax/-8, q = clip(rne(x/d)+8, 0, 15)
// ---------------------------------------------------------------------------

static void q4_0_rows(const float *x, uint8_t *qs, float *d,
                      int64_t row0, int64_t row1, int64_t k) {
    const int64_t nb = k / 32;
    for (int64_t r = row0; r < row1; ++r) {
        const float *xr = x + r * k;
        uint8_t *qr = qs + r * (k / 2);
        float *dr = d + r * nb;
        for (int64_t b = 0; b < nb; ++b) {
            const float *xb = xr + b * 32;
            float maxv = 0.f, amax = 0.f;
            for (int j = 0; j < 32; ++j) {
                const float a = std::fabs(xb[j]);
                if (a > amax) { amax = a; maxv = xb[j]; }
            }
            const float dv = f16_round(maxv / -8.0f);
            dr[b] = dv;
            const float inv = dv != 0.f ? 1.0f / dv : 0.0f;
            uint8_t tmp[32];
            for (int j = 0; j < 32; ++j) {
                float q = rne(xb[j] * inv) + 8.0f;
                q = std::min(15.f, std::max(0.f, q));
                tmp[j] = (uint8_t)q;
            }
            // per-32-block planar nibble packing (oracle pack_nibbles)
            for (int j = 0; j < 16; ++j)
                qr[b * 16 + j] = (uint8_t)(tmp[j] | (tmp[j + 16] << 4));
        }
    }
}

// ---------------------------------------------------------------------------
// Q4_K: 256-elem superblocks, 6-bit sub-scales/mins (oracle quantize_q4_k)
// ---------------------------------------------------------------------------

static void q4_k_rows(const float *x, uint8_t *qs, uint8_t *sc, uint8_t *mn,
                      float *d, float *dmin,
                      int64_t row0, int64_t row1, int64_t k) {
    const int64_t nsb = k / 256;
    for (int64_t r = row0; r < row1; ++r) {
        const float *xr = x + r * k;
        uint8_t *qr = qs + r * (k / 2);
        uint8_t *scr = sc + r * (k / 32);
        uint8_t *mnr = mn + r * (k / 32);
        float *drr = d + r * nsb;
        float *dmr = dmin + r * nsb;
        for (int64_t s = 0; s < nsb; ++s) {
            const float *xs = xr + s * 256;
            float scale_f[8], neg_mn[8];
            for (int j = 0; j < 8; ++j) {
                float lo = 0.f, hi = 0.f;
                for (int t = 0; t < 32; ++t) {
                    const float v = xs[j * 32 + t];
                    lo = std::min(lo, v);
                    hi = std::max(hi, v);
                }
                scale_f[j] = (hi - lo) / 15.0f;
                neg_mn[j] = -lo;
            }
            float smax = 0.f, mmax = 0.f;
            for (int j = 0; j < 8; ++j) {
                smax = std::max(smax, scale_f[j]);
                mmax = std::max(mmax, neg_mn[j]);
            }
            const float dv = f16_round(smax / 63.0f);
            const float dm = f16_round(mmax / 63.0f);
            drr[s] = dv;
            dmr[s] = dm;
            const float inv_d = dv != 0.f ? 1.0f / dv : 0.0f;
            const float inv_m = dm != 0.f ? 1.0f / dm : 0.0f;
            for (int j = 0; j < 8; ++j) {
                float scq = std::min(63.f, std::max(0.f, rne(scale_f[j] * inv_d)));
                float mnq = std::min(63.f, std::max(0.f, rne(neg_mn[j] * inv_m)));
                scr[s * 8 + j] = (uint8_t)scq;
                mnr[s * 8 + j] = (uint8_t)mnq;
                const float eff_s = dv * scq;
                const float eff_m = dm * mnq;
                const float inv_s = eff_s != 0.f ? 1.0f / eff_s : 0.0f;
                uint8_t tmp[32];
                for (int t = 0; t < 32; ++t) {
                    float q = rne((xs[j * 32 + t] + eff_m) * inv_s);
                    q = std::min(15.f, std::max(0.f, q));
                    tmp[t] = (uint8_t)q;
                }
                uint8_t *qb = qr + (s * 8 + j) * 16;
                for (int t = 0; t < 16; ++t)
                    qb[t] = (uint8_t)(tmp[t] | (tmp[t + 16] << 4));
            }
        }
    }
}

// ---------------------------------------------------------------------------
// Q6_K: 256-elem superblocks, 16 sub-blocks of 16, int8 sub-scales
// (oracle quantize_q6_k: d = max|scale|/127, scale = signed-absmax/-32)
// ---------------------------------------------------------------------------

static void q6_k_rows(const float *x, uint8_t *qs, int8_t *sc, float *d,
                      int64_t row0, int64_t row1, int64_t k) {
    const int64_t nsb = k / 256;
    for (int64_t r = row0; r < row1; ++r) {
        const float *xr = x + r * k;
        uint8_t *qr = qs + r * k;
        int8_t *scr = sc + r * (k / 16);
        float *drr = d + r * nsb;
        for (int64_t s = 0; s < nsb; ++s) {
            const float *xs = xr + s * 256;
            float scale_f[16];
            for (int j = 0; j < 16; ++j) {
                float maxv = 0.f, amax = 0.f;
                for (int t = 0; t < 16; ++t) {
                    const float v = xs[j * 16 + t];
                    const float a = std::fabs(v);
                    if (a > amax) { amax = a; maxv = v; }
                }
                scale_f[j] = maxv / -32.0f;
            }
            float smax = 0.f;
            for (int j = 0; j < 16; ++j)
                smax = std::max(smax, std::fabs(scale_f[j]));
            const float dv = f16_round(smax / 127.0f);
            drr[s] = dv;
            const float inv_d = dv != 0.f ? 1.0f / dv : 0.0f;
            for (int j = 0; j < 16; ++j) {
                float scq = std::min(127.f,
                                     std::max(-127.f, rne(scale_f[j] * inv_d)));
                scr[s * 16 + j] = (int8_t)scq;
                const float eff = dv * scq;
                const float inv_s = eff != 0.f ? 1.0f / eff : 0.0f;
                for (int t = 0; t < 16; ++t) {
                    float q = rne(xs[j * 16 + t] * inv_s);
                    q = std::min(31.f, std::max(-32.f, q));
                    qr[s * 256 + j * 16 + t] = (uint8_t)(q + 32.0f);
                }
            }
        }
    }
}

// ---------------------------------------------------------------------------
// threading wrapper + exported entry points
// ---------------------------------------------------------------------------

template <typename F>
static void run_rows(int64_t n, int nthreads, F fn) {
    if (nthreads <= 1 || n < 2) { fn(0, n); return; }
    nthreads = (int)std::min<int64_t>(nthreads, n);
    std::vector<std::thread> ts;
    const int64_t chunk = (n + nthreads - 1) / nthreads;
    for (int t = 0; t < nthreads; ++t) {
        const int64_t a = t * chunk, b = std::min(n, a + chunk);
        if (a >= b) break;
        ts.emplace_back([=] { fn(a, b); });
    }
    for (auto &t : ts) t.join();
}

extern "C" void gct_quantize_q8_0(const float *x, int8_t *qs, float *d,
                       int64_t n, int64_t k, int nthreads) {
    run_rows(n, nthreads, [&](int64_t a, int64_t b) { q8_0_rows(x, qs, d, a, b, k); });
}

extern "C" void gct_quantize_q4_0(const float *x, uint8_t *qs, float *d,
                       int64_t n, int64_t k, int nthreads) {
    run_rows(n, nthreads, [&](int64_t a, int64_t b) { q4_0_rows(x, qs, d, a, b, k); });
}

extern "C" void gct_quantize_q4_k(const float *x, uint8_t *qs, uint8_t *sc, uint8_t *mn,
                       float *d, float *dmin, int64_t n, int64_t k,
                       int nthreads) {
    run_rows(n, nthreads, [&](int64_t a, int64_t b) {
        q4_k_rows(x, qs, sc, mn, d, dmin, a, b, k);
    });
}

extern "C" void gct_quantize_q6_k(const float *x, uint8_t *qs, int8_t *sc,
                       float *d, int64_t n, int64_t k, int nthreads) {
    run_rows(n, nthreads, [&](int64_t a, int64_t b) {
        q6_k_rows(x, qs, sc, d, a, b, k);
    });
}

extern "C" void gct_dequantize_q6_k(const uint8_t *qs, const int8_t *sc,
                         const float *d, float *out,
                         int64_t n, int64_t k, int nthreads) {
    run_rows(n, nthreads, [&](int64_t r0, int64_t r1) {
        for (int64_t r = r0; r < r1; ++r)
            for (int64_t b = 0; b < k / 16; ++b) {
                const float eff = d[r * (k / 256) + b / 16]
                                  * (float)sc[r * (k / 16) + b];
                const uint8_t *qb = qs + r * k + b * 16;
                float *ob = out + r * k + b * 16;
                for (int j = 0; j < 16; ++j)
                    ob[j] = eff * (float)((int)qb[j] - 32);
            }
    });
}

extern "C" void gct_dequantize_q8_0(const int8_t *qs, const float *d, float *out,
                         int64_t n, int64_t k, int nthreads) {
    run_rows(n, nthreads, [&](int64_t r0, int64_t r1) {
        for (int64_t r = r0; r < r1; ++r)
            for (int64_t b = 0; b < k / 32; ++b) {
                const float dv = d[r * (k / 32) + b];
                for (int j = 0; j < 32; ++j)
                    out[r * k + b * 32 + j] = dv * qs[r * k + b * 32 + j];
            }
    });
}

extern "C" void gct_dequantize_q4_0(const uint8_t *qs, const float *d, float *out,
                         int64_t n, int64_t k, int nthreads) {
    run_rows(n, nthreads, [&](int64_t r0, int64_t r1) {
        for (int64_t r = r0; r < r1; ++r)
            for (int64_t b = 0; b < k / 32; ++b) {
                const float dv = d[r * (k / 32) + b];
                const uint8_t *qb = qs + r * (k / 2) + b * 16;
                float *ob = out + r * k + b * 32;
                for (int j = 0; j < 16; ++j) {
                    ob[j] = dv * (float)((qb[j] & 0x0F) - 8);
                    ob[j + 16] = dv * (float)((qb[j] >> 4) - 8);
                }
            }
    });
}

extern "C" void gct_dequantize_q4_k(const uint8_t *qs, const uint8_t *sc,
                         const uint8_t *mn, const float *d, const float *dmin,
                         float *out, int64_t n, int64_t k, int nthreads) {
    run_rows(n, nthreads, [&](int64_t r0, int64_t r1) {
        for (int64_t r = r0; r < r1; ++r)
            for (int64_t b = 0; b < k / 32; ++b) {
                const int64_t s = b / 8;
                const float eff_s = d[r * (k / 256) + s] * (float)sc[r * (k / 32) + b];
                const float eff_m = dmin[r * (k / 256) + s] * (float)mn[r * (k / 32) + b];
                const uint8_t *qb = qs + r * (k / 2) + b * 16;
                float *ob = out + r * k + b * 32;
                for (int j = 0; j < 16; ++j) {
                    ob[j] = eff_s * (float)(qb[j] & 0x0F) - eff_m;
                    ob[j + 16] = eff_s * (float)(qb[j] >> 4) - eff_m;
                }
            }
    });
}

extern "C" int gct_version(void) { return 1; }
