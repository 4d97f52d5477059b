// The per-position steps of a sweep, shared by the staged kernels
// (tau_kernel.cu, swap_kernel.cu, gamma_kernel.cu) and the fused front-half
// kernel (fused_sweep.cu), and the top-2 tau kernel (tau_topk.cu). One warp
// runs each step for one position v; the lane that owns sample s handles
// s = lane, lane + 32, ... Because the staged and the fused kernels run the
// same code on the same values, the fused kernel is bitwise equal to the
// staged chain; the top-2 kernel runs the same sweep with each cell's terms
// taken at its observed bases only.
#pragma once

#include <cuda_runtime.h>

#include "warp.cuh"

namespace desman {

__device__ __forceinline__ void load_eta(const float* eta, float e[4][4]) {
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) e[a][b] = eta[a * 4 + b];
}

// (m @ eta)[b], the multiply-add order of the Pallas kernels' _eta_p.
__device__ __forceinline__ float mix_eta(const float4 m, const float e[4][4], int b) {
  return m.x * e[0][b] + m.y * e[1][b] + m.z * e[2][b] + m.w * e[3][b];
}

// sum_b n[b] * log max((m @ eta)[b], 1e-12): one (v, s) term of a
// per-sample log-likelihood.
__device__ __forceinline__ float cell_loglik(const float4 cnt, const float4 m,
                                             const float e[4][4]) {
  const float nb[4] = {cnt.x, cnt.y, cnt.z, cnt.w};
  float t = 0.f;
#pragma unroll
  for (int b = 0; b < 4; ++b) t += nb[b] * safe_log(mix_eta(m, e, b));
  return t;
}

// The proposal mixture of sample s at one position, never stored:
// mp[a] = sum_g [tau[g] == a] * gamma_prop[s,g], strains in order.
__device__ __forceinline__ float4 proposal_mix(const int* tau_row, const float* gamma_prop,
                                               int s, int G) {
  float4 mp = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int g = 0; g < G; ++g) {
    const float x = gamma_prop[s * G + g];
    const int t = tau_row[g];
    mp.x += (t == 0 ? x : 0.f);
    mp.y += (t == 1 ? x : 0.f);
    mp.z += (t == 2 ? x : 0.f);
    mp.w += (t == 3 ? x : 0.f);
  }
  return mp;
}

// gamma[s, g] where the strain loop finds it: GammaSG reads the [S,G] array
// in device memory (the staged kernels), GammaGS a [G][S] copy in shared
// memory (the row-resident kernels), where the lanes' s = lane, lane + 32,
// ... read neighbouring words of one column. Both give the same value.
struct GammaSG {
  const float* p;
  int G;
  __device__ __forceinline__ float operator()(int s, int g) const { return p[s * G + g]; }
};

struct GammaGS {
  const float* p;
  int S;
  __device__ __forceinline__ float operator()(int s, int g) const { return p[g * S + s]; }
};

// The four candidate terms of cell (v, s) in the tau sweep, from the cell's
// counts, the rest mixture r = mix - gamma[s,g] onehot(tau[v,g]) and
// gs = gamma[s,g]:
//   t[c] = sum_b n[b] * log(max(q[b] + gs * eta[c,b], 1e-12)),  q = r @ eta.
// AllBases takes the four bases of [V,S,4] counts (tau_pallas._kernel).
struct AllBases {
  const float4* n_row;  // n[v, :, :]

  __device__ __forceinline__ void operator()(int s, const float r[4], float gs,
                                             const float e[4][4], float t[4]) const {
    float q[4];
#pragma unroll
    for (int b = 0; b < 4; ++b)
      q[b] = r[0] * e[0][b] + r[1] * e[1][b] + r[2] * e[2][b] + r[3] * e[3][b];
    const float4 cnt = n_row[s];
    const float nb[4] = {cnt.x, cnt.y, cnt.z, cnt.w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float acc = 0.f;
#pragma unroll
      for (int b = 0; b < 4; ++b) acc += nb[b] * safe_log(q[b] + gs * e[c][b]);
      t[c] = acc;
    }
  }
};

// TwoBases takes the cell's at most two observed bases (tau_topk._kernel):
// slot k holds count n_val[s].k of base b_idx[s].k, the two slots in
// ascending base order; an unused slot has count 0 and base 0. Each term is
// the same expression as AllBases' for that base, added in the same (base)
// order, and AllBases' other terms add an exact 0 (n = 0 times a finite
// log): so t[c] is bitwise AllBases' t[c] whenever the cell observes at most
// two bases, with 2 logs per candidate instead of 4. The eta column of each
// slot's base, eta[:, b], comes from a [4] float4 table the kernel stages
// once per block (eta_col[b] = eta[:, b], the same floats as e[:][b]), by
// one shared-memory load indexed by the base: no selects over e, whose
// registers the kernel then does not hold (it passes e = nullptr).
struct TwoBases {
  const float2* n_val;    // [S] slot counts of position v
  const int2* b_idx;      // [S] slot bases of position v
  const float4* eta_col;  // [4]: eta[:, b]

  __device__ __forceinline__ void operator()(int s, const float r[4], float gs,
                                             const float (*)[4], float t[4]) const {
    const float2 nv = n_val[s];
    const int2 bi = b_idx[s];
    const float4 c0 = eta_col[bi.x], c1 = eta_col[bi.y];
    const float e0[4] = {c0.x, c0.y, c0.z, c0.w};  // eta[:, b] at each slot's base
    const float e1[4] = {c1.x, c1.y, c1.z, c1.w};
    const float q0 = r[0] * e0[0] + r[1] * e0[1] + r[2] * e0[2] + r[3] * e0[3];
    const float q1 = r[0] * e1[0] + r[1] * e1[1] + r[2] * e1[2] + r[3] * e1[3];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float acc = 0.f;
      acc += nv.x * safe_log(q0 + gs * e0[c]);
      acc += nv.y * safe_log(q1 + gs * e1[c]);
      t[c] = acc;
    }
  }
};

// Tau Gibbs sweep over all strains of position v (tau_pallas._kernel):
// for each strain g in order,
//   rest = mix - gamma[:,g] (x) onehot(tau[:,g])
//   q    = rest @ eta
//   cand[c] = sum_{s,b} n * log(max(q + gamma[s,g] * eta[c,b], 1e-12))
//   new  = first argmax_c (cand + gz[v,g,:])        (gz already * temperature)
//   mix  = rest + gamma[:,g] (x) onehot(new)
// with the per-sample terms of cand from `terms` (AllBases or TwoBases).
// The row is rewritten after every strain by the lanes that own it and read
// back by the same lanes, so out_row may be the row being read. The rows
// may lie in device or in shared memory; v indexes the tau and gz rows
// (tau_in[v * G + g], gz[v * G + g]) where they lie.
template <class Terms, class Gamma>
__device__ __forceinline__ void tau_position_terms(const Terms& terms, const int* tau_in,
                                                   const float4* mix_row, const Gamma& gamma,
                                                   const float e[4][4], const float4* gz,
                                                   int* tau_out, float4* out_row, long v,
                                                   int S, int G, int lane) {
  const float4* src = mix_row;
  for (int g = 0; g < G; ++g) {
    const int old = tau_in[v * G + g];

    float c0 = 0.f, c1 = 0.f, c2 = 0.f, c3 = 0.f;
    for (int s = lane; s < S; s += kWarp) {
      const float gs = gamma(s, g);
      const float4 m = src[s];
      const float r[4] = {m.x - (old == 0 ? gs : 0.f), m.y - (old == 1 ? gs : 0.f),
                          m.z - (old == 2 ? gs : 0.f), m.w - (old == 3 ? gs : 0.f)};
      float t[4];
      terms(s, r, gs, e, t);
      c0 += t[0];
      c1 += t[1];
      c2 += t[2];
      c3 += t[3];
    }
    c0 = warp_sum(c0);
    c1 = warp_sum(c1);
    c2 = warp_sum(c2);
    c3 = warp_sum(c3);

    const float4 z = gz[v * G + g];
    float best = c0 + z.x;
    int pick = 0;
    const float s1 = c1 + z.y, s2 = c2 + z.z, s3 = c3 + z.w;
    if (s1 > best) { best = s1; pick = 1; }
    if (s2 > best) { best = s2; pick = 2; }
    if (s3 > best) { best = s3; pick = 3; }

    for (int s = lane; s < S; s += kWarp) {
      const float gs = gamma(s, g);
      const float4 m = src[s];
      float4 r;
      r.x = (m.x - (old == 0 ? gs : 0.f)) + (pick == 0 ? gs : 0.f);
      r.y = (m.y - (old == 1 ? gs : 0.f)) + (pick == 1 ? gs : 0.f);
      r.z = (m.z - (old == 2 ? gs : 0.f)) + (pick == 2 ? gs : 0.f);
      r.w = (m.w - (old == 3 ? gs : 0.f)) + (pick == 3 ? gs : 0.f);
      out_row[s] = r;
    }
    if (lane == 0) tau_out[v * G + g] = pick;
    src = out_row;
  }
}

// The full tau sweep of position v on [V,S,4] counts (the tau kernel and
// the fused front-half kernel).
template <class Gamma>
__device__ __forceinline__ void tau_position(const float4* n_row, const int* tau_in,
                                             const float4* mix_row, const Gamma& gamma,
                                             const float e[4][4], const float4* gz,
                                             int* tau_out, float4* out_row, long v, int S,
                                             int G, int lane) {
  tau_position_terms(AllBases{n_row}, tau_in, mix_row, gamma, e, gz, tau_out, out_row, v, S,
                     G, lane);
}

// Swap MH of strains (g, h) at position v (swap_pallas._kernel):
//   dgam = gamma[:,g] - gamma[:,h],  doh = onehot(tau[h]) - onehot(tau[g])
//   p    = mix @ eta,   p' = p + dgam (x) (doh @ eta)
//   dll  = sum_{s,b} n * (log max(p',1e-12) - log max(p,1e-12))
//   accept where logu < dll; g == h never accepts
// and where accepted, swap tau columns g <-> h and set mix += dgam (x) doh.
// tau_out/out_row may be tau_in/mix_row (in place: every lane reads what it
// needs before any lane writes).
//
// kEmit: also the post-swap per-sample loglik of the emit_ll branch,
//   t_fin[s] = sum_b (n*log p + accept * n*(log p' - log p)),
// from the logs already taken for dll, not a fresh log of the new mixture:
// both accept cases are summed in the first pass (slot_a without the swap
// term, slot_c with it) and slot_a keeps the one the decision picks.
template <bool kEmit, class Gamma>
__device__ __forceinline__ void swap_position(const float4* n_row, const int* tau_in,
                                              const float4* mix_row, const Gamma& gamma,
                                              const float e[4][4], int g, int h, float logu_v,
                                              int* tau_out, float4* out_row, long v, int S,
                                              int G, int lane, float* slot_a, float* slot_c) {
  const int tg = tau_in[v * G + g];
  const int th = tau_in[v * G + h];
  float doh[4], w[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) doh[a] = (a == th ? 1.f : 0.f) - (a == tg ? 1.f : 0.f);
#pragma unroll
  for (int b = 0; b < 4; ++b)
    w[b] = doh[0] * e[0][b] + doh[1] * e[1][b] + doh[2] * e[2][b] + doh[3] * e[3][b];

  float part = 0.f;
  for (int s = lane; s < S; s += kWarp) {
    const float dg = gamma(s, g) - gamma(s, h);
    const float4 m = mix_row[s];
    const float4 cnt = n_row[s];
    const float nb[4] = {cnt.x, cnt.y, cnt.z, cnt.w};
    float ta = 0.f, tc = 0.f;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const float p = mix_eta(m, e, b);
      const float lp = safe_log(p);
      const float term = nb[b] * (safe_log(p + dg * w[b]) - lp);
      part += term;
      if (kEmit) {
        const float keep = nb[b] * lp;
        ta += keep;
        tc += keep + term;
      }
    }
    if (kEmit) {
      slot_a[s] = ta;
      slot_c[s] = tc;
    }
  }
  const float dll = warp_sum(part);
  const bool accept = (g != h) && (logu_v < dll);
  if (kEmit && accept)
    for (int s = lane; s < S; s += kWarp) slot_a[s] = slot_c[s];
  __syncwarp();

  for (int s = lane; s < S; s += kWarp) {
    float4 m = mix_row[s];
    if (accept) {
      const float dg = gamma(s, g) - gamma(s, h);
      m.x += dg * doh[0];
      m.y += dg * doh[1];
      m.z += dg * doh[2];
      m.w += dg * doh[3];
    }
    out_row[s] = m;
  }
  for (int k = lane; k < G; k += kWarp) {
    int t = tau_in[v * G + k];
    if (accept && k == g) t = th;
    else if (accept && k == h) t = tg;
    tau_out[v * G + k] = t;
  }
}

// Per-sample loglik of the gamma proposal at position v, into the warp's
// slot: slot[s] = cell_loglik(n, proposal_mix(tau[v,:], gamma_prop, s)).
__device__ __forceinline__ void proposal_loglik(const float4* n_row, const int* tau_row,
                                                const float* gamma_prop, const float e[4][4],
                                                int S, int G, int lane, float* slot) {
  for (int s = lane; s < S; s += kWarp)
    slot[s] = cell_loglik(n_row[s], proposal_mix(tau_row, gamma_prop, s, G), e);
}

}  // namespace desman
