// The unified surface dispatch of adapt_tpu_torch/ops/bxdf_ops.py for
// Hopper (sm_90a): `surface_eval`, `surface_sample` and `surface_pdf`,
// each in one launch.
//
// Replaces no Pallas kernel: the JAX package leaves its BxDF arms to XLA,
// which fuses them. The port's plain version (bxdf_ops.py's eager code,
// `surface_*_plain`) runs every BRDF and BSDF arm present in the scene over
// every lane and merges them with selects: each call is hundreds of
// elementwise launches, issued one by one from the host. Here a thread
// shades one lane: it switches on the lane's material kind and computes
// only that arm, in registers.
//
// Bound: memory. A lane reads its kind and BSDF flag (5 B), its normals
// (24 B), k_d or its albedo texel (12-24 B), k_s, k_g, mean and ior (40 B,
// but for a lambertian BRDF, the most common lane, which skips them), its
// directions (12-24 B) and uniforms (24 B), and writes 4-29 B: ~60-190 B a
// lane. PT's bunny bounce (640,000 lanes) moves ~100 MB in the three
// calls of a shadow ray and the sample, ~30 us at 3.35 TB/s; the arithmetic
// (a few hundred flops a lane, pow, sin and cos on the SFU) is below that.
//
// Rounding: every function follows bxdf_ops.py's operation order line for
// line (math3d.dot is ((x0*y0 + x1*y1) + x2*y2); a product by a Python
// scalar is a product by that double rounded to float; a division by a
// Python scalar is a product by its float reciprocal, as PyTorch's CUDA
// division by a CPU scalar is), and the library builds it with -fmad=false,
// so no product and sum fuse. cosf, sinf, tanf, powf, sqrtf and division
// are CUDA's IEEE-conforming ones, which PyTorch's elementwise kernels call
// too; clamp(min=) and maximum keep a NaN operand, as PyTorch's do. So the
// kernels give the eager code's bits.
//
// Arms: every BRDF (blinn-phong, lambertian, specular, GGX microfacet,
// modified Phong, Fresnel blend, Oren-Nayar, thin coat) and every BSDF
// (det-refraction, lambertian transmission, NULL) of bxdf_ops.py.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define THREADS 128

namespace {

constexpr double kPiD = 3.14159265358979323846;
constexpr float kInvPi = (float)(1.0 / kPiD);
constexpr float kPi2 = (float)(2.0 * kPiD);
constexpr float kHalfPi = (float)(0.5 * kPiD);
constexpr float kFresnelDiffuse = (float)(28.0 / (23.0 * kPiD));
constexpr float kEps = (float)1e-7;

// tags (constants.py)
enum { BLINN_PHONG = 0, LAMBERTIAN = 1, SPECULAR = 2, MICROFACET = 3,
       MOD_PHONG = 4, FRESNEL_BLEND = 5, OREN_NAYAR = 6, THIN_COAT = 7 };
enum { BSDF_NULL = -1, DET_REFRACTION = 0, BSDF_LAMBERTIAN = 1 };
enum { TRANSPORT_RAD = 0 };

struct V {
  float x, y, z;
};

__device__ __forceinline__ V operator+(V a, V b) {
  return {a.x + b.x, a.y + b.y, a.z + b.z};
}
__device__ __forceinline__ V operator-(V a, V b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}
__device__ __forceinline__ V operator*(V a, V b) {
  return {a.x * b.x, a.y * b.y, a.z * b.z};
}
__device__ __forceinline__ V operator*(V a, float s) {
  return {a.x * s, a.y * s, a.z * s};
}
__device__ __forceinline__ V operator*(float s, V a) {
  return {s * a.x, s * a.y, s * a.z};
}
__device__ __forceinline__ V operator/(V a, float s) {
  return {a.x / s, a.y / s, a.z / s};
}
__device__ __forceinline__ V operator+(V a, float s) {
  return {a.x + s, a.y + s, a.z + s};
}
__device__ __forceinline__ V operator-(float s, V a) {
  return {s - a.x, s - a.y, s - a.z};
}
__device__ __forceinline__ V operator-(V a) { return {-a.x, -a.y, -a.z}; }

__device__ __forceinline__ V zero3() { return {0.f, 0.f, 0.f}; }
__device__ __forceinline__ V one3() { return {1.f, 1.f, 1.f}; }
__device__ __forceinline__ V y_axis() { return {0.f, 1.f, 0.f}; }
__device__ __forceinline__ V x_axis() { return {1.f, 0.f, 0.f}; }

// torch.clamp(x, min=lo) and torch.maximum: a NaN operand stays
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}
__device__ __forceinline__ float maximum(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}
__device__ __forceinline__ float amax3(V v) {
  return maximum(maximum(v.x, v.y), v.z);
}
__device__ __forceinline__ V abs3(V v) {
  return {fabsf(v.x), fabsf(v.y), fabsf(v.z)};
}
// torch.sign: 0 for a zero and for NaN
__device__ __forceinline__ float sign(float x) {
  return (float)((0.f < x) - (x < 0.f));
}
__device__ __forceinline__ V pow3(float b, V e) {
  return {powf(b, e.x), powf(b, e.y), powf(b, e.z)};
}

// ------------------------------ math3d.py ------------------------------

__device__ __forceinline__ float dot(V a, V b) {
  return (a.x * b.x + a.y * b.y) + a.z * b.z;
}

__device__ __forceinline__ V cross(V a, V b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
          a.x * b.y - a.y * b.x};
}

__device__ __forceinline__ V normalize(V v) {
  return v / clamp_min(sqrtf(dot(v, v)), (float)1e-12);
}

__device__ __forceinline__ V safe_normalize(V v) {
  float n2 = dot(v, v);
  float n = sqrtf(n2 == 0.f ? 1.f : n2);
  return v / clamp_min(n, (float)1e-12);
}

// rotate_between_apply: the Rodrigues rotation taking `fixed` to `target`,
// applied to v
__device__ V rotate_between_apply(V fixed, V target, V v) {
  V axis = cross(fixed, target);
  float cos_t = dot(fixed, target);
  V k = safe_normalize(axis);
  V out = (v * cos_t + cross(axis, v)) + (k * dot(k, v)) * (1.f - cos_t);
  bool parallel = fabsf(cos_t) >= (float)(1.0 - 1e-5);
  return parallel ? sign(cos_t) * v : out;
}

__device__ __forceinline__ V delocalize_rotate(V anchor, V local) {
  return rotate_between_apply(y_axis(), anchor, local);
}

__device__ __forceinline__ V localize_rotate(V anchor, V global) {
  return rotate_between_apply(anchor, y_axis(), global);
}

struct Raw {
  float cos_theta, sin_theta, cos_phi, sin_phi;
};

__device__ Raw convert_to_raw(V d, V normal) {
  V l = localize_rotate(normal, d);
  Raw r;
  r.cos_theta = l.y;
  r.sin_theta = sqrtf(clamp_min(1.f - r.cos_theta * r.cos_theta, 0.f));
  bool safe = r.sin_theta > (float)1e-5;
  float inv_sin = safe ? 1.f / clamp_min(r.sin_theta, (float)1e-12) : 0.f;
  r.cos_phi = safe ? l.x * inv_sin : 1.f;
  r.sin_phi = safe ? l.z * inv_sin : 0.f;
  return r;
}

// ---------------------------- geo_optics.py ----------------------------

__device__ __forceinline__ V inci_reflect_dir(V ray, V normal, float& d) {
  d = dot(ray, normal);
  return normalize(ray - (2.f * normal) * d);
}

__device__ __forceinline__ V schlick_fresnel(V r_s, float dot_val) {
  float p5 = powf(1.f - dot_val, 5.f);
  return r_s + (1.f - r_s) * p5;
}

__device__ float fresnel_equation(float n_in, float n_out, float cos_inc,
                                  float cos_ref) {
  float n1ci = n_in * cos_inc, n2ci = n_out * cos_inc;
  float n1cr = n_in * cos_ref, n2cr = n_out * cos_ref;
  float rs = (n1ci - n2cr) / clamp_min(fabsf(n1ci + n2cr), (float)1e-12) *
             sign(n1ci + n2cr);
  float rp = (n1cr - n2ci) / clamp_min(fabsf(n1cr + n2ci), (float)1e-12) *
             sign(n1cr + n2ci);
  return 0.5f * (rs * rs + rp * rp);
}

__device__ __forceinline__ float refraction_cos2(float dot_n, float ni,
                                                 float nr) {
  float ratio = ni / nr;
  return 1.f - (ratio * ratio) * (1.f - dot_n * dot_n);
}

__device__ V snell_refraction(V incid, V normal, float dot_n, float ni,
                              float nr, float& cos_r2) {
  float exiting = sign(dot_n);
  float ratio = (ni / nr) * 1.f;
  cos_r2 = refraction_cos2(dot_n, ni, nr);
  float sqrt_c = sqrtf(clamp_min(cos_r2, 0.f));
  V refra = normalize(ratio * incid - (ratio * dot_n - exiting * sqrt_c) *
                                          normal);
  return cos_r2 > 0.f ? refra : zero3();
}

// Fresnel reflectance from one signed cosine
__device__ float fresnel_eval(float cos_v, float n_in, float n_tr) {
  bool neg = cos_v < 0.f;
  float cos_value = fabsf(cos_v);
  float ior_in = neg ? n_tr : n_in;
  float ior_tr = neg ? n_in : n_tr;
  float sin_v = sqrtf(clamp_min(1.f - cos_value * cos_value, 0.f));
  float sin_t = ior_in / ior_tr * sin_v;
  float cos_tr = sqrtf(clamp_min(1.f - sin_t * sin_t, 0.f));
  return fresnel_equation(ior_in, ior_tr, cos_value, cos_tr);
}

// ----------------------------- sampling.py -----------------------------

__device__ __forceinline__ V spherical(float cos_theta, float phi) {
  float sin_theta = sqrtf(clamp_min(1.f - cos_theta * cos_theta, 0.f));
  return {cosf(phi) * sin_theta, cos_theta, sinf(phi) * sin_theta};
}

__device__ __forceinline__ V cosine_hemisphere(float u1, float u2,
                                               float& pdf) {
  float cos_theta = sqrtf(u1);
  float phi = kPi2 * u2;
  pdf = cos_theta * kInvPi;
  return spherical(cos_theta, phi);
}

__device__ V mod_phong_hemisphere(float u1, float u2, float alpha,
                                  float& pdf) {
  float cos_theta = powf(u1, 1.f / (alpha + 1.f));
  float phi = kPi2 * u2;
  pdf = ((0.5f * (1.f + alpha)) * powf(cos_theta, alpha)) * kInvPi;
  return spherical(cos_theta, phi);
}

__device__ V fresnel_hemisphere(float u1, float u2, float nu, float nv,
                                float& power_coeff) {
  float eps1 = u1 * 4.f;
  float inner = eps1 - floorf(eps1);
  float tan_phi = sqrtf((nu + 1.f) / (nv + 1.f)) * tanf(kHalfPi * inner);
  float cos_phi2 = 1.f / (1.f + tan_phi * tan_phi);
  float sin_phi2 = 1.f - cos_phi2;
  float cos_phi = sqrtf(cos_phi2);
  cos_phi = (eps1 > 1.f && eps1 <= 3.f) ? -cos_phi : cos_phi;
  float sin_phi = sqrtf(sin_phi2) * sign(2.f - eps1);
  power_coeff = nu * cos_phi2 + nv * sin_phi2;
  float cos_theta = powf(1.f - u2, 1.f / (power_coeff + 1.f));
  float sin_theta = sqrtf(clamp_min(1.f - cos_theta * cos_theta, 0.f));
  return {cos_phi * sin_theta, cos_theta, sin_phi * sin_theta};
}

// ------------------------------ one lane ------------------------------

// A lane's gathered material and interaction, after the two-sided flip.
struct Lane {
  int kind;
  bool bsdf;
  V ks, kg, mean, dc;  // dc: k_d, or the albedo texel where it has one
  float ior;
  V n_s, n_g;
};

// ============================ BRDF evals ============================

__device__ __forceinline__ V eval_lambertian(const Lane& L, V normal, V out) {
  float cos_t = clamp_min(dot(normal, out), 0.f);
  return (L.dc * kInvPi) * cos_t;
}

__device__ V eval_blinn_phong(const Lane& L, V incid, V out) {
  V half = out - incid;
  bool degenerate = amax3(abs3(half)) <= kEps;
  half = degenerate ? zero3() : normalize(half);
  float dot_clamp = clamp_min(dot(half, L.n_s), 0.f);
  V glossy = pow3(dot_clamp, L.kg);
  float cos_t = clamp_min(dot(L.n_s, out), 0.f);
  return ((L.dc + L.ks * ((0.5f * (L.kg + 2.f)) * glossy)) * kInvPi) * cos_t;
}

__device__ V eval_mod_phong(const Lane& L, V incid, V out) {
  float dot_normal = dot(L.n_s, out);
  V reflect_d = normalize((2.f * L.n_s) * dot_normal - out);
  float dot_view = clamp_min(-dot(incid, reflect_d), 0.f);
  V glossy = pow3(dot_view, L.kg) * L.ks;
  V spec = (((0.5f * (L.kg + 2.f)) * glossy) * kInvPi) * dot_normal;
  spec = spec + eval_lambertian(L, L.n_s, out);
  return dot_normal > 0.f ? spec : zero3();
}

// azimuth (cos^2, sin^2) of the half vector in the tangent frame
__device__ void fresnel_cos2_sin2(V half, V normal, float dot_half,
                                  float& cos_phi2, float& sin_phi2) {
  V transed_x = delocalize_rotate(normal, x_axis());
  V proj = normalize(half - dot_half * normal);
  float c = dot(transed_x, proj);
  cos_phi2 = c * c;
  sin_phi2 = 1.f - cos_phi2;
}

__device__ V eval_fresnel_blend(const Lane& L, V incid, V out) {
  V half = out - incid;
  float dot_out = dot(L.n_s, out);
  bool ok = (dot_out > 0.f) & (amax3(abs3(half)) > (float)1e-4);
  half = normalize(half);
  float dot_in = -dot(L.n_s, incid);
  float dot_half = fabsf(dot(L.n_s, half));
  float dot_hk = fabsf(dot(half, out));
  V fresnel = schlick_fresnel(L.ks, dot_hk);
  float cos_phi2, sin_phi2;
  fresnel_cos2_sin2(half, L.n_s, dot_half, cos_phi2, sin_phi2);
  float denom = clamp_min(dot_hk * maximum(dot_in, dot_out), (float)1e-9);
  V specular = ((L.kg.z * powf(dot_half, L.kg.x * cos_phi2 +
                                             L.kg.y * sin_phi2)) *
                fresnel) /
               denom;
  V diffuse = (kFresnelDiffuse * L.dc) * (1.f - L.ks);
  float pow5_in = powf(1.f - dot_in * 0.5f, 5.f);
  float pow5_out = powf(1.f - dot_out * 0.5f, 5.f);
  diffuse = diffuse * ((1.f - pow5_in) * (1.f - pow5_out));
  V spec = (specular + diffuse) * dot_out;
  return ok ? spec : zero3();
}

__device__ V eval_oren_nayar(const Lane& L, V incid, V out) {
  Raw wi = convert_to_raw(-incid, L.n_s);
  Raw wo = convert_to_raw(out, L.n_s);
  bool both = (wi.sin_theta > (float)1e-5) & (wo.sin_theta > (float)1e-5);
  float d_cos = wi.cos_phi * wo.cos_phi + wi.sin_phi * wo.sin_phi;
  float max_cos = both ? clamp_min(d_cos, 0.f) : 0.f;
  float abs_ci = fabsf(wi.cos_theta), abs_co = fabsf(wo.cos_theta);
  bool i_bigger = abs_ci > abs_co;
  float sin_alpha = i_bigger ? wo.sin_theta : wi.sin_theta;
  float tan_beta = i_bigger ? wi.sin_theta / clamp_min(abs_ci, (float)1e-9)
                            : wo.sin_theta / clamp_min(abs_co, (float)1e-9);
  float factor = L.kg.x + ((L.kg.y * max_cos) * sin_alpha) * tan_beta;
  return (L.dc * kInvPi) * (factor * abs_co);
}

__device__ V eval_thin_coat(const Lane& L, V incid, V out) {
  float ior = L.kg.z;
  float unused;
  V reflect = inci_reflect_dir(incid, L.n_s, unused);
  float dot_in = dot(incid, L.n_s);
  float cos_r2_in;
  V refra_in = snell_refraction(incid, L.n_s, dot_in, 1.f, ior, cos_r2_in);
  float in_F = fresnel_equation(1.f, ior, fabsf(dot_in),
                                sqrtf(clamp_min(cos_r2_in, 0.f)));
  bool is_mirror = fabsf(dot(out, reflect)) > (float)(1.0 - 1e-4);
  V mirror_spec = L.ks * in_F;
  float dot_out = dot(out, L.n_s);
  float cos_r2_out;
  V refra_out = snell_refraction(out, L.n_s, dot_out, 1.f, ior, cos_r2_out);
  float out_F = fresnel_equation(1.f, ior, fabsf(dot_out),
                                 sqrtf(clamp_min(cos_r2_out, 0.f)));
  V on = eval_oren_nayar(L, refra_in, refra_out) *
         (1.f - maximum(in_F, out_F));
  return is_mirror ? mirror_spec : on;
}

__device__ float thin_coat_fresnel(const Lane& L, V incid) {
  float ior = L.kg.z;
  float dot_in = dot(incid, L.n_s);
  float ratio = 1.f / ior;
  float cos_r2 = 1.f - (ratio * ratio) * (1.f - dot_in * dot_in);
  return fresnel_equation(1.f, ior, fabsf(dot_in),
                          sqrtf(clamp_min(cos_r2, 0.f)));
}

// ================= GGX / Trowbridge-Reitz microfacet =================
// in the y-up local frame; k_g.x, k_g.y = alpha_x, alpha_y, k_s.x, k_s.y
// the dielectric Fresnel iors

__device__ float ggx_d(V wh_l, float ax, float ay) {
  float cos2 = wh_l.y * wh_l.y;
  float e = (wh_l.x * wh_l.x) / clamp_min(ax * ax, (float)1e-9) +
            (wh_l.z * wh_l.z) / clamp_min(ay * ay, (float)1e-9);
  float c = cos2 + e;
  float denom = (((float)kPiD * ax) * ay) * (c * c);
  return cos2 > (float)1e-12 ? 1.f / clamp_min(denom, (float)1e-12) : 0.f;
}

__device__ float ggx_lambda(V w_l, float ax, float ay) {
  float cos2 = w_l.y * w_l.y;
  float px = ax * w_l.x, pz = ay * w_l.z;
  float a2 = px * px + pz * pz;
  float tan2 = a2 / clamp_min(cos2, (float)1e-9);
  return 0.5f * (sqrtf(1.f + tan2) + -1.f);
}

__device__ __forceinline__ float ggx_g1(V w_l, float ax, float ay) {
  return 1.f / (1.f + ggx_lambda(w_l, ax, ay));
}

__device__ __forceinline__ float ggx_g(V wo_l, V wi_l, float ax, float ay) {
  return 1.f / ((1.f + ggx_lambda(wo_l, ax, ay)) + ggx_lambda(wi_l, ax, ay));
}

// Heitz 2018 visible-normal sampling in the y-up local frame
__device__ V ggx_sample_wh(V wo_l, float ax, float ay, float u1, float u2) {
  V vh = normalize(V{ax * wo_l.x, wo_l.y, ay * wo_l.z});
  float lensq = vh.x * vh.x + vh.z * vh.z;
  float inv_len = 1.f / sqrtf(clamp_min(lensq, (float)1e-12));
  V T1 = lensq > (float)1e-9 ? V{-vh.z * inv_len, 0.f, vh.x * inv_len}
                             : x_axis();
  V T2 = cross(vh, T1);
  float r = sqrtf(u1);
  float phi = kPi2 * u2;
  float t1 = r * cosf(phi);
  float t2 = r * sinf(phi);
  float s = 0.5f * (1.f + vh.y);
  t2 = (1.f - s) * sqrtf(clamp_min(1.f - t1 * t1, 0.f)) + s * t2;
  V nh = (t1 * T1 + t2 * T2) +
         sqrtf(clamp_min((1.f - t1 * t1) - t2 * t2, 0.f)) * vh;
  return normalize(V{ax * nh.x, clamp_min(nh.y, (float)1e-6), ay * nh.z});
}

__device__ __forceinline__ void ggx_alphas(const Lane& L, float& ax,
                                           float& ay) {
  ax = clamp_min(L.kg.x, (float)1e-4);
  ay = clamp_min(L.kg.y, (float)1e-4);
}

// the half vector of incid -> out, in n_s's upper hemisphere
__device__ __forceinline__ V ggx_half(const Lane& L, V incid, V out) {
  V wh = normalize(out - incid);
  return dot(wh, L.n_s) < 0.f ? -wh : wh;
}

// cosine-weighted Torrance-Sparrow GGX
__device__ V eval_microfacet(const Lane& L, V incid, V out) {
  float ax, ay;
  ggx_alphas(L, ax, ay);
  float cos_o = dot(L.n_s, out);
  float cos_i = dot(L.n_s, incid);
  bool ok = cos_o * cos_i < 0.f;
  V wh = ggx_half(L, incid, out);
  V wh_l = localize_rotate(L.n_s, wh);
  V wo_l = localize_rotate(L.n_s, -incid);
  V wi_l = localize_rotate(L.n_s, out);
  float F = fresnel_eval(dot(wh, out), L.ks.x, L.ks.y);
  V val = (L.dc * ((ggx_d(wh_l, ax, ay) * ggx_g(wo_l, wi_l, ax, ay)) * F)) /
          clamp_min(4.f * fabsf(cos_i), (float)1e-9);
  return ok ? val : zero3();
}

// the VNDF sample's solid-angle density at the local half vector wh_l
__device__ __forceinline__ float ggx_vndf_pdf(V wo_l, V wh_l, float ax,
                                              float ay) {
  float dot_wo_wh = fabsf(dot(wo_l, wh_l));
  float pdf_vndf = ((ggx_g1(wo_l, ax, ay) * ggx_d(wh_l, ax, ay)) *
                    dot_wo_wh) /
                   clamp_min(fabsf(wo_l.y), (float)1e-9);
  return pdf_vndf / clamp_min(4.f * dot_wo_wh, (float)1e-9);
}

__device__ float ggx_pdf(const Lane& L, V incid, V out) {
  float ax, ay;
  ggx_alphas(L, ax, ay);
  V wh_l = localize_rotate(L.n_s, ggx_half(L, incid, out));
  V wo_l = localize_rotate(L.n_s, -incid);
  wo_l = wo_l.y < 0.f ? -wo_l : wo_l;
  return ggx_vndf_pdf(wo_l, wh_l, ax, ay);
}

__device__ __forceinline__ bool covers(unsigned mask, int bit) {
  return bit >= 0 && bit < 32 && ((mask >> bit) & 1u);
}

__device__ V brdf_eval(const Lane& L, unsigned mask, V incid, V out) {
  bool same_hemi = dot(incid, L.n_g) * dot(out, L.n_g) < 0.f;
  V res = zero3();
  if (covers(mask, L.kind)) {
    switch (L.kind) {
      case BLINN_PHONG: res = eval_blinn_phong(L, incid, out); break;
      case LAMBERTIAN: res = eval_lambertian(L, L.n_s, out); break;
      case MOD_PHONG: res = eval_mod_phong(L, incid, out); break;
      case FRESNEL_BLEND: res = eval_fresnel_blend(L, incid, out); break;
      case OREN_NAYAR: res = eval_oren_nayar(L, incid, out); break;
      case THIN_COAT: res = eval_thin_coat(L, incid, out); break;
      case MICROFACET: res = eval_microfacet(L, incid, out); break;
      default: break;  // SPECULAR: a delta lobe evaluates to 0
    }
  }
  return same_hemi ? res : zero3();
}

// =========================== BRDF sampling ===========================

struct Sample {
  V dir, spec;
  float pdf;
  bool delta;
};

__device__ Sample sample_mod_phong(const Lane& L, V incid, const float* u,
                                   const Sample& lam) {
  float eps = u[2];
  float p_diffuse = amax3(L.dc);
  float p_spec = amax3(L.ks);
  float g_pdf;
  V local_dir = mod_phong_hemisphere(u[3], u[4], L.mean.z, g_pdf);
  V normal = delocalize_rotate(L.n_s, local_dir);
  V g_dir = normalize((-2.f * normal) * dot(incid, normal) + incid);
  V g_spec = eval_mod_phong(L, incid, g_dir);
  bool take_diffuse = eps < p_diffuse;
  bool take_glossy = !take_diffuse & (eps < p_diffuse + p_spec);
  Sample s;
  s.dir = take_diffuse ? lam.dir : (take_glossy ? g_dir : y_axis());
  s.spec = take_diffuse ? lam.spec : (take_glossy ? g_spec : zero3());
  s.pdf = take_diffuse ? p_diffuse * lam.pdf
                       : (take_glossy ? g_pdf * p_spec
                                      : (1.f - p_diffuse) - p_spec);
  s.delta = false;
  return s;
}

__device__ Sample sample_fresnel_blend(const Lane& L, V incid,
                                       const float* u, V lam_dir) {
  float power_coeff;
  V local_half = fresnel_hemisphere(u[2], u[3], L.kg.x, L.kg.y,
                                    power_coeff);
  V half = delocalize_rotate(L.n_s, local_half);
  float dot_incid;
  V reflected = inci_reflect_dir(incid, half, dot_incid);
  float half_pdf = L.kg.z * powf(clamp_min(dot(half, L.n_s), 0.f),
                                 power_coeff);
  float spec_pdf = half_pdf / clamp_min(fabsf(dot_incid), kEps);
  bool is_valid = dot(L.n_s, reflected) > 0.f;
  bool take_lambert = u[4] > 0.5f;
  Sample s;
  s.dir = take_lambert ? lam_dir : reflected;
  s.pdf = 0.5f * (spec_pdf + fabsf(dot(s.dir, L.n_s)) * kInvPi);
  s.spec = is_valid ? eval_fresnel_blend(L, incid, s.dir) : zero3();
  s.delta = false;
  return s;
}

__device__ Sample sample_thin_coat(const Lane& L, V incid, const float* u) {
  float ior = L.kg.z;
  float dot_normal = dot(incid, L.n_s);
  float cos_r2;
  V refra_in = snell_refraction(incid, L.n_s, dot_normal, 1.f, ior, cos_r2);
  // the reference's incident Fresnel term reads kg[0] (kept for parity)
  float in_F = fresnel_equation(1.f, L.kg.x, fabsf(dot_normal),
                                sqrtf(clamp_min(cos_r2, 0.f)));
  bool take_reflect = u[2] <= in_F;
  // diffuse branch: cosine-hemisphere + second Fresnel event
  float lam_pdf;
  V local_dir = cosine_hemisphere(u[0], u[1], lam_pdf);
  V d_dir = delocalize_rotate(L.n_s, local_dir);
  float dot_out = dot(d_dir, L.n_s);
  float cos_r2_out = refraction_cos2(dot_out, ior, 1.f);
  bool total_ref = cos_r2_out < 0.f;
  float unused;
  V refra_out = snell_refraction(d_dir, L.n_s, dot_out, ior, 1.f, unused);
  float out_F = fresnel_equation(ior, 1.f, fabsf(dot_out),
                                 sqrtf(clamp_min(cos_r2_out, 0.f)));
  float d_pdf = total_ref ? lam_pdf : lam_pdf * (1.f - in_F);
  V d_spec = eval_oren_nayar(L, refra_in, refra_out) *
             ((1.f - in_F) * (1.f - out_F));
  d_spec = total_ref ? zero3() : d_spec;
  V d_dir_final = total_ref ? d_dir : refra_out;
  // mirror branch
  V m_dir = inci_reflect_dir(incid, L.n_s, unused);
  V m_spec = L.ks * in_F;
  Sample s;
  s.dir = take_reflect ? m_dir : d_dir_final;
  s.spec = take_reflect ? m_spec : d_spec;
  s.pdf = take_reflect ? in_F : d_pdf;
  s.delta = take_reflect;
  return s;
}

// VNDF importance sampling
__device__ Sample sample_microfacet(const Lane& L, V incid, const float* u) {
  float ax, ay;
  ggx_alphas(L, ax, ay);
  V wo_l = localize_rotate(L.n_s, -incid);
  bool flip = wo_l.y < 0.f;
  wo_l = flip ? -wo_l : wo_l;
  V wh_l = ggx_sample_wh(wo_l, ax, ay, u[2], u[3]);
  V wh = delocalize_rotate(L.n_s, wh_l);
  wh = flip ? -wh : wh;
  float unused;
  Sample s;
  s.dir = inci_reflect_dir(incid, wh, unused);
  s.spec = eval_microfacet(L, incid, s.dir);
  s.pdf = ggx_vndf_pdf(wo_l, wh_l, ax, ay);
  bool bad = dot(s.dir, L.n_s) * dot(incid, L.n_s) >= 0.f;
  s.spec = bad ? zero3() : s.spec;
  s.pdf = bad ? 1.f : s.pdf;
  s.delta = false;
  return s;
}

__device__ Sample brdf_sample(const Lane& L, unsigned mask, V incid,
                              const float* u) {
  Sample s = {y_axis(), one3(), 1.f, false};
  if (covers(mask, L.kind)) {
    Sample lam;
    if (L.kind != SPECULAR && L.kind != THIN_COAT && L.kind != MICROFACET) {
      V local_dir = cosine_hemisphere(u[0], u[1], lam.pdf);
      lam.dir = delocalize_rotate(L.n_s, local_dir);
      lam.spec = eval_lambertian(L, L.n_s, lam.dir);
      lam.delta = false;
    }
    float unused;
    switch (L.kind) {
      case LAMBERTIAN: s = lam; break;
      case OREN_NAYAR:
        s = lam;
        s.spec = eval_oren_nayar(L, incid, lam.dir);
        break;
      case BLINN_PHONG:
        s = lam;
        s.spec = eval_blinn_phong(L, incid, lam.dir);
        break;
      case SPECULAR:
        s.dir = inci_reflect_dir(incid, L.n_s, unused);
        s.spec = L.dc;
        s.pdf = 1.f;
        s.delta = true;
        break;
      case MOD_PHONG: s = sample_mod_phong(L, incid, u, lam); break;
      case FRESNEL_BLEND: s = sample_fresnel_blend(L, incid, u, lam.dir); break;
      case THIN_COAT: s = sample_thin_coat(L, incid, u); break;
      case MICROFACET: s = sample_microfacet(L, incid, u); break;
      default: break;
    }
  }
  // shading-normal leak guard
  if (dot(s.dir, L.n_g) <= 0.f) s.spec = zero3();
  return s;
}

// ============================= BRDF pdf =============================

__device__ float brdf_pdf(const Lane& L, unsigned mask, V outdir, V incid) {
  float dot_out = dot(L.n_s, outdir);
  float dot_in = dot(L.n_s, incid);
  bool gate = dot_out * dot_in < 0.f;
  float cos_pdf = dot_out * kInvPi;
  float pdf = 0.f;
  if (covers(mask, L.kind)) {
    float unused;
    switch (L.kind) {
      case BLINN_PHONG:
      case LAMBERTIAN:
      case OREN_NAYAR: pdf = cos_pdf; break;
      case MOD_PHONG: {
        float glossiness = L.mean.z;
        V reflect_view = inci_reflect_dir(incid, L.n_s, unused);
        float dot_ref = clamp_min(dot(reflect_view, outdir), 0.f);
        float spec_pdf = ((0.5f * (glossiness + 1.f)) * kInvPi) *
                         powf(dot_ref, glossiness);
        float p_d = amax3(L.dc);
        pdf = p_d * cos_pdf + amax3(L.ks) * spec_pdf;
        break;
      }
      case THIN_COAT: {
        V reflect = inci_reflect_dir(incid, L.n_s, unused);
        float in_F = thin_coat_fresnel(L, incid);
        bool mirror = fabsf(dot(outdir, reflect)) > (float)(1.0 - 1e-3);
        pdf = mirror ? in_F : (1.f - in_F) * cos_pdf;
        break;
      }
      case FRESNEL_BLEND: {
        V half = normalize(outdir - incid);
        float dot_half = dot(half, L.n_s);
        float cos_phi2, sin_phi2;
        fresnel_cos2_sin2(half, L.n_s, dot_half, cos_phi2, sin_phi2);
        float t = (L.kg.z * powf(clamp_min(dot_half, 0.f),
                                 L.kg.x * cos_phi2 + L.kg.y * sin_phi2)) /
                  clamp_min(fabsf(dot(incid, half)), (float)1e-9);
        pdf = 0.5f * (t + cos_pdf);
        break;
      }
      case MICROFACET: pdf = ggx_pdf(L, incid, outdir); break;
      default: break;  // SPECULAR: delta
    }
  }
  return gate ? pdf : 0.f;
}

// ========================= BSDF (transmissive) =========================

// What the BSDF arms share for direction d: its cosine, the iors, the
// mirror and Snell directions, total internal reflection and the Fresnel
// reflectance (bxdf_ops.py `_refraction_terms`)
struct Refr {
  float dot_n, ni, nr, F;
  V reflect, refra;
  bool total;
};

__device__ Refr refraction_terms(const Lane& L, V d, float world_ior) {
  Refr t;
  t.dot_n = dot(d, L.n_s);
  bool entering = t.dot_n < 0.f;
  t.ni = entering ? world_ior : L.ior;
  t.nr = entering ? L.ior : world_ior;
  t.reflect = normalize(d - (2.f * L.n_s) * t.dot_n);
  float cos_r2 = refraction_cos2(t.dot_n, t.ni, t.nr);
  float unused;
  t.refra = snell_refraction(d, L.n_s, t.dot_n, t.ni, t.nr, unused);
  t.F = fresnel_equation(t.ni, t.nr, fabsf(t.dot_n),
                         sqrtf(clamp_min(cos_r2, 0.f)));
  t.total = cos_r2 < 0.f;
  return t;
}

__device__ __forceinline__ float rad_scale(int mode, float ni, float nr) {
  return mode == TRANSPORT_RAD ? (ni * ni) / (nr * nr) : 1.f;
}

__device__ Sample bsdf_sample(const Lane& L, unsigned mask, V incid,
                              const float* u, float world_ior, int mode) {
  Sample s = {zero3(), zero3(), 0.f, false};
  if (!covers(mask, L.kind + 1)) return s;
  Refr t = refraction_terms(L, incid, world_ior);
  V base = L.dc;
  float scale = rad_scale(mode, t.ni, t.nr);
  if (L.kind == DET_REFRACTION) {
    bool do_refract = !t.total & (u[0] > t.F);
    s.dir = do_refract ? t.refra : t.reflect;
    s.pdf = t.total ? 1.f : (do_refract ? 1.f - t.F : t.F);
    V t_int = base * (do_refract ? scale : 1.f);
    s.spec = t_int * s.pdf;
    s.delta = true;
  } else if (L.kind == BSDF_LAMBERTIAN) {
    bool do_refract = !t.total & (u[0] > t.F);
    float lam_pdf;
    V local_dir = cosine_hemisphere(u[1], u[2], lam_pdf);
    V normal = sign(t.dot_n) * L.n_s;
    V d_dir = delocalize_rotate(normal, local_dir);
    float cos_term = clamp_min(dot(normal, d_dir), 0.f);
    V d_int = (base * ((kInvPi * cos_term) * scale)) * (1.f - t.F);
    s.dir = do_refract ? d_dir : t.reflect;
    s.spec = do_refract ? d_int : base * t.F;
    s.spec = t.total ? base : s.spec;
    s.pdf = do_refract ? lam_pdf * (1.f - t.F) : (t.total ? 1.f : t.F);
    s.delta = !do_refract;
  } else {  // NULL: passthrough
    s.dir = incid;
    s.spec = one3();
    s.pdf = 1.f;
    s.delta = true;
  }
  return s;
}

__device__ V bsdf_eval(const Lane& L, unsigned mask, V incid, V out,
                       float world_ior, int mode) {
  if (!covers(mask, L.kind + 1)) return zero3();
  Refr t = refraction_terms(L, out, world_ior);
  V base = L.dc;
  float scale = rad_scale(mode, t.ni, t.nr);
  bool near_ref = dot(t.reflect, incid) > (float)(1.0 - 1e-4);
  if (L.kind == DET_REFRACTION) {
    bool near_refra = dot(t.refra, incid) > (float)(1.0 - 1e-4);
    if (t.total)
      return dot(t.reflect, incid) > (float)(1.0 - 5e-5) ? base : zero3();
    return near_refra ? base * ((1.f - t.F) * scale)
                      : (near_ref ? base * t.F : zero3());
  }
  if (L.kind == BSDF_LAMBERTIAN) {
    float dot_in = dot(incid, L.n_s);
    bool same_side = dot_in * t.dot_n < 0.f;  // reflection configuration
    V refl_val = (same_side & near_ref) ? base * t.F : zero3();
    V trans_val = base * ((((1.f - t.F) * kInvPi) * fabsf(t.dot_n)) * scale);
    if (t.total) return near_ref ? base : zero3();
    return same_side ? refl_val : trans_val;
  }
  return zero3();  // NULL
}

__device__ float bsdf_pdf(const Lane& L, unsigned mask, V outdir, V incid,
                          float world_ior) {
  if (!covers(mask, L.kind + 1)) return 0.f;
  Refr t = refraction_terms(L, outdir, world_ior);
  bool near_ref = dot(t.reflect, incid) > (float)(1.0 - 1e-4);
  if (L.kind == BSDF_NULL)
    return dot(incid, outdir) > (float)(1.0 - 1e-4) ? 1.f : 0.f;
  if (L.kind == DET_REFRACTION) {
    bool near_refra = dot(t.refra, incid) > (float)(1.0 - 1e-4);
    if (t.total) return near_ref ? 1.f : 0.f;
    return near_ref ? t.F : (near_refra ? 1.f - t.F : 0.f);
  }
  // LAMBERTIAN transmission
  float dot_in = dot(incid, L.n_s);
  bool trans_cfg = dot_in * t.dot_n > 0.f;
  if (t.total) return near_ref ? 1.f : 0.f;
  return near_ref ? t.F
                  : (trans_cfg ? ((1.f - t.F) * fabsf(t.dot_n)) * kInvPi
                               : 0.f);
}

}  // namespace

// The operands of one call: (N,) and (N, 3) float32 rows, contiguous, but
// for `u` (row stride u_stride floats, columns contiguous) and world_ior
// (one value: *wior, a device scalar, or wior_val where wior is null).
// brdf_mask has bit t for each BRDF tag t of the scene, bsdf_mask bit
// t + 1 for each BSDF tag t.
struct ShadeIn {
  const int32_t* kind;
  const uint8_t* is_bsdf;
  const float *kd, *ks, *kg, *mean, *ior;
  const float *n_s, *n_g, *tex;  // tex: null on an untextured scene
  const float* incid;
  const float* dir;  // eval: the scattered direction; pdf: outdir
  const float* u;
  long long u_stride;
  const float* wior;
  float wior_val;
  unsigned brdf_mask, bsdf_mask;
  int two_sides, mode, n;
};

namespace {

__device__ __forceinline__ V load3(const float* p, int i) {
  return {p[3 * i], p[3 * i + 1], p[3 * i + 2]};
}

__device__ __forceinline__ void store3(float* p, int i, V v) {
  p[3 * i] = v.x;
  p[3 * i + 1] = v.y;
  p[3 * i + 2] = v.z;
}

// gather_mat's row, diffuse_color and _apply_two_sides, for lane i
__device__ Lane load_lane(const ShadeIn& in, int i, V incid) {
  Lane L;
  L.kind = in.kind[i];
  L.bsdf = in.is_bsdf[i] != 0;
  L.ks = L.kg = L.mean = zero3();
  L.ior = 0.f;
  if (L.bsdf || L.kind != LAMBERTIAN) {  // a lambertian BRDF reads k_d alone
    L.ks = load3(in.ks, i);
    L.kg = load3(in.kg, i);
    L.mean = load3(in.mean, i);
    L.ior = in.ior[i];
  }
  V tex = in.tex != nullptr ? load3(in.tex, i) : V{-1.f, 0.f, 0.f};
  L.dc = tex.x >= 0.f ? tex : load3(in.kd, i);  // k_d where no texel
  L.n_s = load3(in.n_s, i);
  L.n_g = load3(in.n_g, i);
  if (in.two_sides && (dot(incid, L.n_s) > 0.f) && !L.bsdf) {
    L.n_s = -L.n_s;
    L.n_g = -L.n_g;
  }
  return L;
}

__device__ __forceinline__ float world_ior(const ShadeIn& in) {
  return in.wior != nullptr ? *in.wior : in.wior_val;
}

}  // namespace

extern "C" __global__ void __launch_bounds__(THREADS)
    shade_eval_kernel(ShadeIn in, float* res) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= in.n) return;
  V incid = load3(in.incid, i);
  V out = load3(in.dir, i);
  Lane L = load_lane(in, i, incid);
  V r = zero3();
  if (!L.bsdf) {
    if (in.brdf_mask) r = brdf_eval(L, in.brdf_mask, incid, out);
  } else if (in.bsdf_mask) {
    r = bsdf_eval(L, in.bsdf_mask, incid, out, world_ior(in), in.mode);
  }
  store3(res, i, r);
}

extern "C" __global__ void __launch_bounds__(THREADS)
    shade_sample_kernel(ShadeIn in, float* dir, float* spec, float* pdf,
                        uint8_t* is_specular) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= in.n) return;
  V incid = load3(in.incid, i);
  Lane L = load_lane(in, i, incid);
  const float* u_row = in.u + (long long)i * in.u_stride;
  float u[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) u[k] = u_row[k];
  Sample s = {y_axis(), one3(), 1.f, false};
  if (!L.bsdf) {
    if (in.brdf_mask) s = brdf_sample(L, in.brdf_mask, incid, u);
  } else if (in.bsdf_mask) {
    s = bsdf_sample(L, in.bsdf_mask, incid, u, world_ior(in), in.mode);
  }
  store3(dir, i, s.dir);
  store3(spec, i, s.spec);
  pdf[i] = s.pdf;
  is_specular[i] = s.delta;
}

extern "C" __global__ void __launch_bounds__(THREADS)
    shade_pdf_kernel(ShadeIn in, float* pdf) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= in.n) return;
  V incid = load3(in.incid, i);
  V outdir = load3(in.dir, i);
  Lane L = load_lane(in, i, incid);
  float p = 0.f;
  if (!L.bsdf) {
    if (in.brdf_mask) p = brdf_pdf(L, in.brdf_mask, outdir, incid);
  } else if (in.bsdf_mask) {
    p = bsdf_pdf(L, in.bsdf_mask, outdir, incid, world_ior(in));
  }
  pdf[i] = p;
}

// ------------------------------- launches -------------------------------
// Each returns cudaGetLastError() after its launch (0: launched), or
// UNKNOWN_TAG, launching nothing, where the masks name a tag this file does
// not know.

#define UNKNOWN_TAG (-1)

static inline int blocks(int n) { return (n + THREADS - 1) / THREADS; }

// BRDF tags 0..THIN_COAT; BSDF tags NULL..LAMBERTIAN, shifted by one
static inline bool known_tags(const ShadeIn* in) {
  return !(in->brdf_mask & ~((1u << (THIN_COAT + 1)) - 1u)) &&
         !(in->bsdf_mask & ~((1u << (BSDF_LAMBERTIAN + 2)) - 1u));
}

extern "C" int shade_eval(const ShadeIn* in, float* res, void* stream) {
  if (!known_tags(in)) return UNKNOWN_TAG;
  shade_eval_kernel<<<blocks(in->n), THREADS, 0, (cudaStream_t)stream>>>(
      *in, res);
  return (int)cudaGetLastError();
}

extern "C" int shade_sample(const ShadeIn* in, float* dir, float* spec,
                            float* pdf, uint8_t* is_specular, void* stream) {
  if (!known_tags(in)) return UNKNOWN_TAG;
  shade_sample_kernel<<<blocks(in->n), THREADS, 0, (cudaStream_t)stream>>>(
      *in, dir, spec, pdf, is_specular);
  return (int)cudaGetLastError();
}

extern "C" int shade_pdf(const ShadeIn* in, float* pdf, void* stream) {
  if (!known_tags(in)) return UNKNOWN_TAG;
  shade_pdf_kernel<<<blocks(in->n), THREADS, 0, (cudaStream_t)stream>>>(
      *in, pdf);
  return (int)cudaGetLastError();
}
