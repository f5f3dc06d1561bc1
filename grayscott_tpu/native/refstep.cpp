// Compiled (C++) transcription of the reference Gray-Scott kernels, for
// ground-truth cross-checking of the NumPy oracle.
//
// The repository's numerical truth chain is: reference Rust sources ->
// NumPy oracle (grayscott_tpu/oracle.py) -> every backend and golden
// file. No Rust toolchain exists in this image, so the oracle cannot be
// diffed against the reference binary itself; the defense is multiple
// INDEPENDENT transcriptions of the same sources. tests/test_transcription
// provides a second Python one; this file is a third, in a different
// language through a different compiler stack (g++ scalar/SSE codegen vs
// NumPy's vector loops), written directly from:
//
//   - compute/naive/src/lib.rs:43-82 (the `naive` boundary: per-pixel
//     clamped stencil window, weights indexed by position WITHIN the
//     window — the top/left anchoring quirk of
//     compute/regular/src/lib.rs:174-179), and
//   - compute/gpu/naive/src/main.comp:29-58 with ClampToBorder sampling
//     (compute/gpu/naive/src/pipeline.rs:105-113) (the `zero` boundary:
//     all nine taps, out-of-domain reads are 0, centered weights).
//
// Float32 discipline: every intermediate is a `float`, and the build
// passes -ffp-contract=off (grayscott_tpu/native/__init__.py) so the
// compiler neither fuses multiply-adds nor reassociates — each written
// operation rounds exactly once, the same contract rustc gives the
// reference's expression trees. Accumulation is row-major over the
// (clamped) window, matching compute/naive/src/lib.rs:62-70's
// indexed_iter order.
//
// gs_ref_ftz() reproduces the reference's DenormalsFlusher
// (compute/shared/src/lib.rs:123-213): it sets the SSE MXCSR FTZ+DAZ
// bits, the reference's benchmarking mode. At simulation
// concentrations (O(0.01..1)) no
// intermediate ever enters the denormal range, so FTZ on/off must not
// change results — tests assert exactly that.

#include <algorithm>
#include <cstdint>
#include <vector>

#if defined(__SSE2__)
#include <xmmintrin.h>
#endif

namespace {

// One `naive` step: out-of-window neighbors contribute nothing; the
// weight index is window-relative (anchoring quirk). Transcribed from
// compute/naive/src/lib.rs:43-82.
void step_naive(const float* u, const float* v, float* ou, float* ov,
                int rows, int cols, const float* w, float du_rate,
                float dv_rate, float feed, float kill, float dt) {
  const float one = 1.0f;
  const float fk = feed + kill;  // min_feed_kill, data/src/parameters.rs:67-69
  for (int r = 0; r < rows; ++r) {
    // stencil_start = out_pos.saturating_sub([1, 1]);
    // stencil_end   = (out_pos + [1, 1] + 1).min(shape)
    const int rs = std::max(r - 1, 0);
    const int re = std::min(r + 2, rows);
    for (int c = 0; c < cols; ++c) {
      const int cs = std::max(c - 1, 0);
      const int ce = std::min(c + 2, cols);
      const float uc = u[r * cols + c];
      const float vc = v[r * cols + c];
      float fu = 0.0f;
      float fv = 0.0f;
      // ndarray indexed_iter over the SLICE: (i, j) are window-relative
      for (int rr = rs; rr < re; ++rr) {
        for (int cc = cs; cc < ce; ++cc) {
          const float wt = w[(rr - rs) * 3 + (cc - cs)];
          fu = fu + wt * (u[rr * cols + cc] - uc);
          fv = fv + wt * (v[rr * cols + cc] - vc);
        }
      }
      const float uv2 = (uc * vc) * vc;
      const float du = ((du_rate * fu) - uv2) + (feed * (one - uc));
      const float dv = ((dv_rate * fv) + uv2) - (fk * vc);
      ou[r * cols + c] = uc + du * dt;
      ov[r * cols + c] = vc + dv * dt;
    }
  }
}

// One `zero` step: all nine taps, out-of-domain reads 0 (ClampToBorder),
// weights centered. Transcribed from compute/gpu/naive/src/main.comp:29-58;
// accumulation row-major like the oracle (the shader's own column-major
// order differs by a few ulps — tests/test_transcription.py covers that
// gap; this function is the oracle's order for bit-exact diffing).
void step_zero(const float* u, const float* v, float* ou, float* ov,
               int rows, int cols, const float* w, float du_rate,
               float dv_rate, float feed, float kill, float dt) {
  const float one = 1.0f;
  const float fk = feed + kill;
  for (int r = 0; r < rows; ++r) {
    for (int c = 0; c < cols; ++c) {
      const float uc = u[r * cols + c];
      const float vc = v[r * cols + c];
      float fu = 0.0f;
      float fv = 0.0f;
      for (int i = 0; i < 3; ++i) {
        for (int j = 0; j < 3; ++j) {
          const float wt = w[i * 3 + j];
          if (wt == 0.0f) continue;  // constant folding drops zero taps
          const int rr = r + i - 1;
          const int cc = c + j - 1;
          const bool in = rr >= 0 && rr < rows && cc >= 0 && cc < cols;
          const float tu = in ? u[rr * cols + cc] : 0.0f;
          const float tv = in ? v[rr * cols + cc] : 0.0f;
          fu = fu + wt * (tu - uc);
          fv = fv + wt * (tv - vc);
        }
      }
      const float uv2 = (uc * vc) * vc;
      const float du = ((du_rate * fu) - uv2) + (feed * (one - uc));
      const float dv = ((dv_rate * fv) + uv2) - (fk * vc);
      ou[r * cols + c] = uc + du * dt;
      ov[r * cols + c] = vc + dv * dt;
    }
  }
}

}  // namespace

extern "C" {

// Advance u, v (rows*cols float32, row-major) IN PLACE by `steps` steps.
// weights9: the 3x3 stencil row-major. boundary: 0 = naive, 1 = zero.
// Returns 0 on success, nonzero on bad arguments.
int gs_ref_steps(float* u, float* v, int rows, int cols,
                 const float* weights9, float du_rate, float dv_rate,
                 float feed, float kill, float dt, int steps,
                 int boundary) {
  if (rows <= 0 || cols <= 0 || steps < 0) return 1;
  if (boundary != 0 && boundary != 1) return 2;
  const size_t n = static_cast<size_t>(rows) * cols;
  std::vector<float> su(n), sv(n);
  const float* cu = u;
  const float* cv = v;
  float* ou = su.data();
  float* ov = sv.data();
  for (int s = 0; s < steps; ++s) {
    if (boundary == 0) {
      step_naive(cu, cv, ou, ov, rows, cols, weights9, du_rate, dv_rate,
                 feed, kill, dt);
    } else {
      step_zero(cu, cv, ou, ov, rows, cols, weights9, du_rate, dv_rate,
                feed, kill, dt);
    }
    // ping-pong: after the first step, cu/cv alias the scratch or the
    // caller buffers alternately (the double-buffered Species flip)
    std::swap(const_cast<float*&>(cu), ou);
    std::swap(const_cast<float*&>(cv), ov);
  }
  if (cu != u) {  // odd step count: result sits in scratch; copy back
    std::copy(cu, cu + n, u);
    std::copy(cv, cv + n, v);
  }
  return 0;
}

// Set (enable=1) or clear (enable=0) SSE flush-to-zero + denormals-are-
// zero — the reference's DenormalsFlusher. Returns the previous state
// (1 if FTZ was set), or -1 when unsupported on this architecture.
int gs_ref_ftz(int enable) {
#if defined(__SSE2__)
  const unsigned csr = _mm_getcsr();
  const int prev = (csr & 0x8000u) ? 1 : 0;  // FTZ bit
  if (enable) {
    _mm_setcsr(csr | 0x8040u);  // FTZ | DAZ
  } else {
    _mm_setcsr(csr & ~0x8040u);
  }
  return prev;
#else
  (void)enable;
  return -1;
#endif
}

}  // extern "C"
