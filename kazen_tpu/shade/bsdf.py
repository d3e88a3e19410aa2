"""BSDF library as pure functions over SoA shade batches.

Vectorized, differentiable re-implementations of the reference's BSDF
plugins (bsdf.cpp), dispatched per-lane on the compiled material table.
Conventions follow bsdf.h:58-127: directions are in the *local shading
frame*; ``eval`` returns f*cos(theta_o) (cosine folded in, LOG.md:464-474);
``pdf`` is w.r.t. solid angle and zero for discrete lobes; ``sample``
returns the throughput weight f*cos/pdf.

Per-lane dispatch: only the material types present in the compiled scene
(static.btypes_present) are evaluated, each on the full batch under a mask --
the vectorized form of the reference's virtual dispatch.

The normalmap wrapper (bsdf.cpp:281-417) is resolved here: it perturbs the
shading frame from the tangent-space normal texture and delegates to the
nested material with re-expressed wi/wo.
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from ..core import math as km
from ..core import warp
from ..scene.compiler import (
    BSDF_DIELECTRIC,
    BSDF_DIFFUSE,
    BSDF_GGX,
    BSDF_KISS,
    BSDF_LAMBERTIAN,
    BSDF_MIRROR,
    BSDF_NORMALMAP,
    BSDF_ROUGHCONDUCTOR,
    BSDF_ROUGHDIELECTRIC,
    BSDF_ROUGHPLASTIC,
    MaterialTable,
)
from . import ggx
from .textures import eval_texture

EPS = 1e-4  # reference Epsilon (define.h)


class SampleResult(NamedTuple):
    wo: jnp.ndarray  # (N, 3) local
    weight: jnp.ndarray  # (N, 3) f*cos/pdf
    eta: jnp.ndarray  # (N,)
    is_discrete: jnp.ndarray  # (N,) bool
    pdf: jnp.ndarray  # (N,) solid-angle pdf of wo (0 for discrete lobes),
    # identical to calling pdf() on the sampled direction (the MIS pdf the
    # integrator reads after sampling, integrator.cpp:314)


def gather(materials: MaterialTable, mat_id) -> MaterialTable:
    """Gather per-lane material rows. Material tables are tiny, so each
    field is fetched with an exact where-chain (core.math.select_rows)
    instead of 21 separate gathers."""
    from ..core.math import select_rows

    return MaterialTable(*(select_rows(mat_id, f) for f in materials))


def _cos(v):
    return v[..., 2]


def _mask3(m, x):
    return jnp.where(m[..., None], x, 0.0)


# ---------------------------------------------------------------------------
# Per-type eval / pdf / sample. Each operates on the full batch; the
# dispatcher masks lanes. `mp` is a gathered MaterialTable; `tex` the pool.
# ---------------------------------------------------------------------------


def _diffuse_albedo(static, scene, mp, uv, textured: bool):
    if textured:
        return eval_texture(static, scene.textures, mp.tex_base, uv, mp.base_color)
    return mp.base_color


def _diffuse_eval(albedo, wi, wo):
    m = (_cos(wi) > 0.0) & (_cos(wo) > 0.0)
    return _mask3(m, albedo * (km.INV_PI * _cos(wo))[..., None])


def _diffuse_pdf(wi, wo):
    m = (_cos(wi) > 0.0) & (_cos(wo) > 0.0)
    return jnp.where(m, km.INV_PI * _cos(wo), 0.0)


def _diffuse_sample(albedo, wi, s2):
    wo = warp.square_to_cosine_hemisphere(s2)
    w = _mask3(_cos(wi) > 0.0, albedo)
    return wo, w, jnp.ones(wi.shape[:-1]), jnp.zeros(wi.shape[:-1], bool), \
        _diffuse_pdf(wi, wo)


def _mirror_sample(wi, s2):
    wo = jnp.stack([-wi[..., 0], -wi[..., 1], wi[..., 2]], -1)
    w = _mask3(_cos(wi) > 0.0, jnp.ones_like(wi))
    z = jnp.zeros(wi.shape[:-1])
    return wo, w, jnp.ones(wi.shape[:-1]), jnp.ones(wi.shape[:-1], bool), z


def _dielectric_sample(mp, wi, s1):
    """bsdf.cpp:118-142: fresnel-weighted reflect/refract choice."""
    cos_i = _cos(wi)
    f = km.fresnel(cos_i, mp.ext_ior, mp.int_ior)
    reflectv = jnp.stack([-wi[..., 0], -wi[..., 1], wi[..., 2]], -1)
    outside = cos_i >= 0.0
    n = jnp.stack(
        [
            jnp.zeros_like(cos_i),
            jnp.zeros_like(cos_i),
            jnp.where(outside, 1.0, -1.0),
        ],
        -1,
    )
    factor = jnp.where(outside, mp.int_ior / mp.ext_ior, mp.ext_ior / mp.int_ior)
    refracted = km.refract(-wi, n, factor)
    choose_reflect = s1 < f
    wo = jnp.where(choose_reflect[..., None], reflectv, refracted)
    eta = jnp.where(choose_reflect, 1.0, mp.int_ior / mp.ext_ior)
    w = jnp.ones_like(wi)
    return wo, w, eta, jnp.ones(cos_i.shape, bool), jnp.zeros(cos_i.shape)


def _ggx_eval(static, scene, mp, uv, wi, wo):
    albedo = eval_texture(static, scene.textures, mp.tex_base, uv, mp.base_color)
    f, _ = ggx.eval_ggx_smith_brdf(wi, wo, albedo, mp.roughness, mp.anisotropy)
    m = (_cos(wi) > 0.0) & (_cos(wo) > 0.0)
    return _mask3(m, f * _cos(wo)[..., None])


def _ggx_pdf(mp, wi, wo):
    h = km.normalize(wi + wo)
    alpha = ggx.roughness_to_alpha(mp.roughness, mp.anisotropy)
    denom = 4.0 * km.dot(wi, h)
    pdf = ggx.vndf(wi, h, alpha) / jnp.where(denom == 0.0, 1e-9, denom)
    m = (_cos(wi) > 0.0) & (_cos(wo) > 0.0)
    return jnp.where(m, pdf, 0.0)


def _ggx_sample(static, scene, mp, uv, wi, s2):
    alpha = ggx.roughness_to_alpha(mp.roughness, mp.anisotropy)
    h = ggx.sample_vndf(wi, alpha, s2)
    wo = km.reflect(wi, h)
    val = _ggx_eval(static, scene, mp, uv, wi, wo)
    pdf = _ggx_pdf(mp, wi, wo)
    w = val / jnp.maximum(pdf, 1e-9)[..., None]
    m = (_cos(wi) > 0.0) & (_cos(wo) > 0.0) & (pdf > 0.0)
    return wo, _mask3(m, w), jnp.ones(wi.shape[:-1]), \
        jnp.zeros(wi.shape[:-1], bool), pdf



def _safe_wh(wi, wo):
    """Half-vector with masked-lane hygiene: rough* eval/pdf run on every
    lane (the per-type dispatch masks afterwards), so grazing or
    degenerate (wi ~ -wo) lanes of OTHER material types would feed
    pathological wh into the Beckmann exp/div chain. Forward values are
    masked anyway, but reverse-mode turns inf * 0 into NaN (the classic
    where-branch leak), so the inputs themselves are made safe: invalid
    lanes compute with wh = +z. Returns (wh, ok)."""
    h = wi + wo
    n2 = km.dot(h, h)
    ok = (_cos(wi) > 0.0) & (_cos(wo) > 0.0) & (n2 > 1e-12)
    z = jnp.zeros_like(h).at[..., 2].set(1.0)
    h = jnp.where(ok[..., None], h, z)
    return h / km.norm(h, keepdims=True)[...], ok


def _roughconductor_eval(mp, wi, wo):
    wh, m = _safe_wh(wi, wo)
    f = ggx.fresnel_conductor(km.dot(wh, wo), mp.eta_c, mp.k_c)
    d = ggx.beckmann_ndf(wh, mp.alpha)
    g = ggx.smith_beckmann_g1(wi, wh, mp.alpha) * ggx.smith_beckmann_g1(
        wo, wh, mp.alpha
    )
    val = (d * g / jnp.maximum(4.0 * _cos(wi), 1e-9))[..., None] * f
    return _mask3(m, val)


def _roughconductor_pdf(mp, wi, wo):
    wh, m = _safe_wh(wi, wo)
    d = ggx.beckmann_ndf(wh, mp.alpha)
    denom = 4.0 * km.dot(wh, wo)
    safe = jnp.where(jnp.abs(denom) < 1e-9, 1e-9, denom)
    pdf = d * _cos(wh) / safe
    return jnp.where(m, pdf, 0.0)


def _roughconductor_sample(mp, wi, s2):
    wh = warp.square_to_beckmann(s2, mp.alpha)
    wo = km.normalize(km.reflect(wi, wh))
    val = _roughconductor_eval(mp, wi, wo)
    pdf = _roughconductor_pdf(mp, wi, wo)
    w = val / jnp.maximum(pdf, 1e-9)[..., None]
    m = (_cos(wi) > 0.0) & (_cos(wo) > 0.0) & (pdf > 0.0)
    return wo, _mask3(m, w), jnp.ones(wi.shape[:-1]), \
        jnp.zeros(wi.shape[:-1], bool), pdf


def _roughplastic_ks(mp):
    return 1.0 - jnp.max(mp.base_color, axis=-1)


def _roughplastic_eval(mp, wi, wo):
    wh, m = _safe_wh(wi, wo)
    d = ggx.beckmann_ndf(wh, mp.alpha)
    f = km.fresnel(km.dot(wh, wo), mp.ext_ior, mp.int_ior)
    g = ggx.smith_beckmann_g1(wo, wh, mp.alpha) * ggx.smith_beckmann_g1(
        wi, wh, mp.alpha
    )
    ks = _roughplastic_ks(mp)
    spec = ks * d * f * g / jnp.maximum(4.0 * _cos(wi), 1e-9)
    val = mp.base_color * (km.INV_PI * _cos(wo))[..., None] + spec[..., None]
    return _mask3(m, val)


def _roughplastic_pdf(mp, wi, wo):
    wh, m = _safe_wh(wi, wo)
    d = ggx.beckmann_ndf(wh, mp.alpha)
    jh = 1.0 / jnp.maximum(4.0 * jnp.abs(km.dot(wh, wo)), 1e-9)
    ks = _roughplastic_ks(mp)
    pdf = ks * d * _cos(wh) * jh + (1.0 - ks) * _cos(wo) * km.INV_PI
    return jnp.where(m, pdf, 0.0)


def _roughplastic_sample(mp, wi, s1, s2):
    ks = _roughplastic_ks(mp)
    wh = warp.square_to_beckmann(s2, mp.alpha)
    wo_spec = km.normalize(2.0 * km.dot(wh, wi, keepdims=True) * wh - wi)
    wo_diff = warp.square_to_cosine_hemisphere(s2)
    wo = jnp.where((s1 < ks)[..., None], wo_spec, wo_diff)
    val = _roughplastic_eval(mp, wi, wo)
    pdf = _roughplastic_pdf(mp, wi, wo)
    w = val / jnp.maximum(pdf, 1e-9)[..., None]
    m = (_cos(wi) > 0.0) & (_cos(wo) > 0.0) & (pdf > 0.0)
    return wo, _mask3(m, w), jnp.ones(wi.shape[:-1]), \
        jnp.zeros(wi.shape[:-1], bool), pdf


def _rd_refract(wi, n, eta, cos_theta_t):
    """RoughDielectric::refract (bsdf.cpp:1129-1134)."""
    eta_eff = jnp.where(cos_theta_t < 0.0, 1.0 / eta, eta)
    return (
        n * (km.dot(wi, n) * eta_eff + cos_theta_t)[..., None] - wi * eta_eff[..., None]
    )


def _roughdielectric_eval(mp, wi, wo):
    """bsdf.cpp:966-1010."""
    cos_i = _cos(wi)
    cos_o = _cos(wo)
    eta0 = mp.int_ior / mp.ext_ior
    inv_eta0 = mp.ext_ior / mp.int_ior
    is_reflect = cos_i * cos_o > 0.0
    eta = jnp.where(cos_i > 0.0, eta0, inv_eta0)
    wm_r = wi + wo
    wm_t = wi + wo * eta[..., None]
    wm = km.normalize(jnp.where(is_reflect[..., None], wm_r, wm_t))
    wm = wm * jnp.sign(_cos(wm))[..., None]
    f, _ = km.fresnel_dielectric(km.dot(wi, wm), eta0)
    d = ggx.beckmann_ndf(wm, mp.alpha)
    g = ggx.smith_beckmann_g1(wo, wm, mp.alpha) * ggx.smith_beckmann_g1(
        wi, wm, mp.alpha
    )
    fr = f * g * d / jnp.maximum(4.0 * jnp.abs(cos_i), 1e-9)
    denom = km.dot(wi, wm) + eta * km.dot(wo, wm)
    ft = jnp.abs(
        (1.0 - f)
        * d
        * g
        * eta
        * eta
        * km.dot(wi, wm)
        * km.dot(wo, wm)
        / jnp.where(cos_i * km.sqr(denom) == 0.0, 1e-9, cos_i * km.sqr(denom))
    )
    val = jnp.where(is_reflect, fr, ft)
    val = jnp.where(cos_i == 0.0, 0.0, val)
    return val[..., None] * jnp.ones_like(wi)


def _roughdielectric_pdf(mp, wi, wo):
    """bsdf.cpp:1012-1047."""
    cos_i = _cos(wi)
    cos_o = _cos(wo)
    eta0 = mp.int_ior / mp.ext_ior
    inv_eta0 = mp.ext_ior / mp.int_ior
    is_reflect = cos_i * cos_o > 0.0
    eta = jnp.where(cos_i > 0.0, eta0, inv_eta0)
    wm_r = wi + wo
    wm_t = wi + wo * eta[..., None]
    wm = km.normalize(jnp.where(is_reflect[..., None], wm_r, wm_t))
    dwm_r = 1.0 / jnp.where(
        km.dot(wo, wm) == 0.0, 1e-9, 4.0 * km.dot(wo, wm)
    )
    sqrt_denom = km.dot(wi, wm) + eta * km.dot(wo, wm)
    dwm_t = (eta * eta * km.dot(wo, wm)) / jnp.maximum(km.sqr(sqrt_denom), 1e-9)
    dwm_dwo = jnp.where(is_reflect, dwm_r, dwm_t)
    wm = wm * jnp.sign(_cos(wm))[..., None]
    f, _ = km.fresnel_dielectric(km.dot(wi, wm), eta0)
    d = ggx.beckmann_ndf(wm, mp.alpha)
    prob = d * _cos(wm) * jnp.where(is_reflect, f, 1.0 - f)
    return jnp.abs(prob * dwm_dwo)


def _roughdielectric_sample(mp, wi, s1, s2):
    """bsdf.cpp:1051-1095 with the Walter alpha-scaling trick."""
    cos_i = _cos(wi)
    eta0 = mp.int_ior / mp.ext_ior
    inv_eta0 = mp.ext_ior / mp.int_ior
    alpha = mp.alpha * (1.2 - 0.2 * jnp.sqrt(jnp.abs(cos_i)))
    wm = warp.square_to_beckmann(s2, alpha)
    pdf_m = warp.square_to_beckmann_pdf(wm, alpha)
    f, cos_theta_t = km.fresnel_dielectric(km.dot(wi, wm), eta0)
    sample_reflection = s1 <= f
    wo_r = km.reflect(wi, wm)
    wo_t = _rd_refract(wi, wm, eta0, cos_theta_t)
    wo = jnp.where(sample_reflection[..., None], wo_r, wo_t)
    eta = jnp.where(
        sample_reflection, 1.0, jnp.where(cos_theta_t < 0.0, eta0, inv_eta0)
    )
    cos_o = _cos(wo)
    ok = jnp.where(
        sample_reflection,
        cos_i * cos_o > 0.0,
        (cos_i * cos_o < 0.0) & (cos_theta_t != 0.0),
    ) & (pdf_m > 0.0)
    d = ggx.beckmann_ndf(wm, alpha)
    g = ggx.smith_beckmann_g1(wo, wm, alpha) * ggx.smith_beckmann_g1(wi, wm, alpha)
    w = jnp.abs(
        d
        * g
        * km.dot(wi, wm)
        / jnp.where(pdf_m * cos_i == 0.0, 1e-9, pdf_m * cos_i)
    )
    w3 = _mask3(ok, w[..., None] * jnp.ones_like(wi))
    # post-sample MIS pdf uses the class (un-Walter-scaled) alpha
    # (integrator reads pdf(bRec) after sampling)
    pdf_out = _roughdielectric_pdf(mp, wi, wo)
    return wo, w3, eta, jnp.zeros(cos_i.shape, bool), pdf_out


# ---------------------------------------------------------------------------
# kiss / KazenStandardSurface (bsdf.cpp:1157-1418)
# ---------------------------------------------------------------------------


def _kiss_textures(static, scene, mp, uv):
    base = eval_texture(static, scene.textures, mp.tex_base, uv, mp.base_color)
    metallic = eval_texture(
        static,
        scene.textures,
        mp.tex_metallic,
        uv,
        jnp.stack([mp.metallic] * 3, -1),
    )[..., 0]
    roughness = eval_texture(
        static,
        scene.textures,
        mp.tex_roughness,
        uv,
        jnp.stack([mp.roughness] * 3, -1),
    )[..., 0]
    return base, metallic, roughness


def _schlick_weight(x):
    x = jnp.clip(1.0 - x, 0.0, 1.0)
    return km.sqr(km.sqr(x)) * x


def _kiss_eval(static, scene, mp, uv, wi, wo, accum_rough):
    v, l = wi, wo
    h = km.normalize(v + l)
    cdlin, metallic, rough_tex = _kiss_textures(static, scene, mp, uv)
    roughness = jnp.minimum(1.0, rough_tex + accum_rough)
    cdlum = km.luminance(cdlin)
    ctint = jnp.where(
        (cdlum > 0.0)[..., None], cdlin / jnp.maximum(cdlum, 1e-9)[..., None], 1.0
    )
    ctintmix = (0.08 * mp.specular)[..., None] * (
        km.lerp(mp.specular_tint[..., None], jnp.ones_like(ctint), ctint)
    )
    cspec0 = km.lerp(metallic[..., None], ctintmix, cdlin)

    fl = _schlick_weight(_cos(l))
    fv = _schlick_weight(_cos(v))
    fh = _schlick_weight(km.dot(l, h))
    cos_d = km.dot(v, h)

    lambert = (1.0 - 0.5 * fl) * (1.0 - 0.5 * fv)
    rr = 2.0 * roughness * cos_d * cos_d
    retro = rr * (fl + fv + fl * fv * (rr - 1.0))

    csheen = km.lerp(mp.sheen_tint[..., None], jnp.ones_like(ctint), ctint)
    fsheen = fh[..., None] * mp.sheen[..., None] * csheen

    spec, _ = ggx.eval_ggx_smith_brdf(v, l, cspec0, roughness, mp.anisotropy)
    cc_rough = km.lerp(mp.clearcoat_roughness, 0.01, 0.3)
    cc, _ = ggx.eval_ggx_smith_brdf(
        v, l, jnp.full_like(cspec0, 0.04), cc_rough, mp.anisotropy
    )
    clearcoat = 0.25 * mp.clearcoat[..., None] * cc

    val = (
        (1.0 - metallic)[..., None]
        * (cdlin * (km.INV_PI * (lambert + retro))[..., None] + fsheen)
        + spec
        + clearcoat
    ) * _cos(wo)[..., None]
    m = (_cos(wi) > 0.0) & (_cos(wo) > 0.0)
    return _mask3(m, val)


def _kiss_pdf(static, scene, mp, uv, wi, wo, accum_rough):
    _, metallic, rough_tex = _kiss_textures(static, scene, mp, uv)
    diffuse = (1.0 - metallic) * 0.5
    gtr2 = 1.0 / (1.0 + mp.clearcoat)
    h = km.normalize(wi + wo)
    jacobian = 4.0 * km.dot(wi, h)
    jacobian = jnp.where(jacobian == 0.0, 1e-9, jacobian)
    roughness = jnp.minimum(1.0, rough_tex + accum_rough)
    alpha = ggx.roughness_to_alpha(roughness, mp.anisotropy)
    spec_pdf = ggx.vndf(wi, h, alpha) / jacobian
    coat_alpha = ggx.roughness_to_alpha(
        km.lerp(mp.clearcoat_roughness, 0.01, 0.3), jnp.zeros_like(mp.anisotropy)
    )
    coat_pdf = ggx.vndf(wi, h, coat_alpha) / jacobian
    pdf = diffuse * km.INV_PI * _cos(wo) + (1.0 - diffuse) * (
        gtr2 * spec_pdf + (1.0 - gtr2) * coat_pdf
    )
    m = (_cos(wi) > 0.0) & (_cos(wo) > 0.0)
    return jnp.where(m, pdf, 0.0)


def _kiss_eval_pdf(static, scene, mp, uv, wi, wo, accum_rough):
    """eval+pdf in one pass sharing textures, H, and alphas (the NEE hot
    path evaluates both per bounce; separate dispatches defeat XLA CSE)."""
    v, l = wi, wo
    h = km.normalize(v + l)
    cdlin, metallic, rough_tex = _kiss_textures(static, scene, mp, uv)
    roughness = jnp.minimum(1.0, rough_tex + accum_rough)
    alpha = ggx.roughness_to_alpha(roughness, mp.anisotropy)
    cc_rough = km.lerp(mp.clearcoat_roughness, 0.01, 0.3)
    coat_alpha_e = ggx.roughness_to_alpha(cc_rough, mp.anisotropy)
    coat_alpha_p = ggx.roughness_to_alpha(cc_rough, jnp.zeros_like(mp.anisotropy))

    # ---- eval
    cdlum = km.luminance(cdlin)
    ctint = jnp.where(
        (cdlum > 0.0)[..., None], cdlin / jnp.maximum(cdlum, 1e-9)[..., None], 1.0
    )
    ctintmix = (0.08 * mp.specular)[..., None] * (
        km.lerp(mp.specular_tint[..., None], jnp.ones_like(ctint), ctint)
    )
    cspec0 = km.lerp(metallic[..., None], ctintmix, cdlin)
    fl = _schlick_weight(_cos(l))
    fv = _schlick_weight(_cos(v))
    fh = _schlick_weight(km.dot(l, h))
    cos_d = km.dot(v, h)
    lambert = (1.0 - 0.5 * fl) * (1.0 - 0.5 * fv)
    rr = 2.0 * roughness * cos_d * cos_d
    retro = rr * (fl + fv + fl * fv * (rr - 1.0))
    csheen = km.lerp(mp.sheen_tint[..., None], jnp.ones_like(ctint), ctint)
    fsheen = fh[..., None] * mp.sheen[..., None] * csheen

    d_spec = ggx.ggx_ndf(h, alpha)
    g_spec = ggx.smith_g2(v, l, h, alpha)
    f_spec = ggx.schlick_fresnel(cspec0, cos_d)
    denom = jnp.maximum(4.0 * jnp.abs(_cos(v)) * jnp.abs(_cos(l)), 1e-9)
    opp = (_cos(v) * _cos(l) < 0.0)[..., None]
    spec = jnp.where(opp, 0.0, (d_spec * g_spec / denom)[..., None] * f_spec)
    d_cc = ggx.ggx_ndf(h, coat_alpha_e)
    g_cc = ggx.smith_g2(v, l, h, coat_alpha_e)
    f_cc = ggx.schlick_fresnel(jnp.full_like(cspec0, 0.04), cos_d)
    cc = jnp.where(opp, 0.0, (d_cc * g_cc / denom)[..., None] * f_cc)
    clearcoat = 0.25 * mp.clearcoat[..., None] * cc
    val = (
        (1.0 - metallic)[..., None]
        * (cdlin * (km.INV_PI * (lambert + retro))[..., None] + fsheen)
        + spec
        + clearcoat
    ) * _cos(wo)[..., None]

    # ---- pdf (shares H/alpha; clearcoat pdf uses isotropic alpha like the
    # reference's roughnessToAlpha(..., 0))
    diffuse_p = (1.0 - metallic) * 0.5
    gtr2 = 1.0 / (1.0 + mp.clearcoat)
    jacobian = 4.0 * km.dot(wi, h)
    jacobian = jnp.where(jacobian == 0.0, 1e-9, jacobian)
    spec_pdf = ggx.vndf(wi, h, alpha) / jacobian
    coat_pdf = ggx.vndf(wi, h, coat_alpha_p) / jacobian
    pdf = diffuse_p * km.INV_PI * _cos(wo) + (1.0 - diffuse_p) * (
        gtr2 * spec_pdf + (1.0 - gtr2) * coat_pdf
    )

    m = (_cos(wi) > 0.0) & (_cos(wo) > 0.0)
    return _mask3(m, val), jnp.where(m, pdf, 0.0)


def _kiss_sample(static, scene, mp, uv, wi, s1, s2, accum_rough):
    _, metallic, rough_tex = _kiss_textures(static, scene, mp, uv)
    diffuse = (1.0 - metallic) * 0.5
    gtr2 = 1.0 / (1.0 + mp.clearcoat)

    wo_diff = warp.square_to_cosine_hemisphere(s2)

    # Specular/clearcoat H: lobe select by rescaled sample1 (bsdf.cpp:1317-1336)
    # NOTE (reference parity): sample's H uses the *unregularized* roughness.
    s_rescaled = (s1 - diffuse) / jnp.maximum(1.0 - diffuse, 1e-9)
    flip = _cos(wi) <= 0.0
    wi_f = jnp.where(flip[..., None], -wi, wi)
    alpha_spec = ggx.roughness_to_alpha(rough_tex, mp.anisotropy)
    alpha_coat = ggx.roughness_to_alpha(
        km.lerp(mp.clearcoat_roughness, 0.01, 0.3), jnp.zeros_like(mp.anisotropy)
    )
    use_spec = s_rescaled < gtr2
    alpha = jnp.where(use_spec[..., None], alpha_spec, alpha_coat)
    h = ggx.sample_vndf(wi_f, alpha, s2)
    h = jnp.where(flip[..., None], -h, h)
    wo_spec = km.normalize(km.reflect(wi, h))

    wo = jnp.where((s1 < diffuse)[..., None], wo_diff, wo_spec)
    val = _kiss_eval(static, scene, mp, uv, wi, wo, accum_rough)
    pdf = _kiss_pdf(static, scene, mp, uv, wi, wo, accum_rough)
    w = val / jnp.maximum(pdf, 1e-9)[..., None]
    ok = (
        (_cos(wi) > 0.0)
        & (_cos(wo) > 0.0)
        & (pdf > EPS)
        & jnp.all(jnp.isfinite(wo), axis=-1)
    )
    w = jnp.where(jnp.isfinite(w), w, 0.0)
    return wo, _mask3(ok, w), jnp.ones(s1.shape), jnp.zeros(s1.shape, bool), pdf


# ---------------------------------------------------------------------------
# Dispatcher
# ---------------------------------------------------------------------------


def _base_types(static):
    return tuple(t for t in static.btypes_present if t != BSDF_NORMALMAP)



def _safe_dirs(m, *vs):
    """Masked-dispatch input hygiene: every per-type branch runs on ALL
    lanes and is masked afterwards, so lanes of other types can feed
    degenerate directions into sqrt/div/exp chains whose reverse-mode
    turns inf*0 into NaN. Substitute +z on non-this-type lanes."""
    z = jnp.zeros_like(vs[0]).at[..., 2].set(1.0)
    return tuple(jnp.where(m[..., None], v, z) for v in vs)


def eval_base(static, scene, mp, uv, wi, wo, accum_rough):
    out = jnp.zeros_like(wi)
    wi0, wo0 = wi, wo
    for t in _base_types(static):
        m = mp.btype == t
        wi, wo = _safe_dirs(m, wi0, wo0)
        if t in (BSDF_DIFFUSE, BSDF_LAMBERTIAN):
            albedo = _diffuse_albedo(static, scene, mp, uv, t == BSDF_LAMBERTIAN)
            v = _diffuse_eval(albedo, wi, wo)
        elif t in (BSDF_MIRROR, BSDF_DIELECTRIC):
            v = jnp.zeros_like(wi)
        elif t == BSDF_GGX:
            v = _ggx_eval(static, scene, mp, uv, wi, wo)
        elif t == BSDF_ROUGHCONDUCTOR:
            v = _roughconductor_eval(mp, wi, wo)
        elif t == BSDF_ROUGHPLASTIC:
            v = _roughplastic_eval(mp, wi, wo)
        elif t == BSDF_ROUGHDIELECTRIC:
            v = _roughdielectric_eval(mp, wi, wo)
        elif t == BSDF_KISS:
            v = _kiss_eval(static, scene, mp, uv, wi, wo, accum_rough)
        else:
            raise ValueError(f"unhandled btype {t}")
        out = jnp.where(m[..., None], v, out)
    return out


def pdf_base(static, scene, mp, uv, wi, wo, accum_rough):
    out = jnp.zeros(wi.shape[:-1])
    wi0, wo0 = wi, wo
    for t in _base_types(static):
        m = mp.btype == t
        wi, wo = _safe_dirs(m, wi0, wo0)
        if t in (BSDF_DIFFUSE, BSDF_LAMBERTIAN):
            v = _diffuse_pdf(wi, wo)
        elif t in (BSDF_MIRROR, BSDF_DIELECTRIC):
            v = jnp.zeros(wi.shape[:-1])
        elif t == BSDF_GGX:
            v = _ggx_pdf(mp, wi, wo)
        elif t == BSDF_ROUGHCONDUCTOR:
            v = _roughconductor_pdf(mp, wi, wo)
        elif t == BSDF_ROUGHPLASTIC:
            v = _roughplastic_pdf(mp, wi, wo)
        elif t == BSDF_ROUGHDIELECTRIC:
            v = _roughdielectric_pdf(mp, wi, wo)
        elif t == BSDF_KISS:
            v = _kiss_pdf(static, scene, mp, uv, wi, wo, accum_rough)
        else:
            raise ValueError(f"unhandled btype {t}")
        out = jnp.where(m, v, out)
    return out


def eval_pdf_base(static, scene, mp, uv, wi, wo, accum_rough):
    """(eval, pdf) in one masked dispatch (NEE hot path)."""
    out_f = jnp.zeros_like(wi)
    out_p = jnp.zeros(wi.shape[:-1])
    wi0, wo0 = wi, wo
    for t in _base_types(static):
        m = mp.btype == t
        wi, wo = _safe_dirs(m, wi0, wo0)
        if t in (BSDF_DIFFUSE, BSDF_LAMBERTIAN):
            albedo = _diffuse_albedo(static, scene, mp, uv, t == BSDF_LAMBERTIAN)
            f = _diffuse_eval(albedo, wi, wo)
            p = _diffuse_pdf(wi, wo)
        elif t in (BSDF_MIRROR, BSDF_DIELECTRIC):
            f = jnp.zeros_like(wi)
            p = jnp.zeros(wi.shape[:-1])
        elif t == BSDF_GGX:
            f = _ggx_eval(static, scene, mp, uv, wi, wo)
            p = _ggx_pdf(mp, wi, wo)
        elif t == BSDF_ROUGHCONDUCTOR:
            f = _roughconductor_eval(mp, wi, wo)
            p = _roughconductor_pdf(mp, wi, wo)
        elif t == BSDF_ROUGHPLASTIC:
            f = _roughplastic_eval(mp, wi, wo)
            p = _roughplastic_pdf(mp, wi, wo)
        elif t == BSDF_ROUGHDIELECTRIC:
            f = _roughdielectric_eval(mp, wi, wo)
            p = _roughdielectric_pdf(mp, wi, wo)
        elif t == BSDF_KISS:
            f, p = _kiss_eval_pdf(static, scene, mp, uv, wi, wo, accum_rough)
        else:
            raise ValueError(f"unhandled btype {t}")
        out_f = jnp.where(m[..., None], f, out_f)
        out_p = jnp.where(m, p, out_p)
    return out_f, out_p


def sample_base(static, scene, mp, uv, wi, s1, s2, accum_rough) -> SampleResult:
    n = wi.shape[:-1]
    out = SampleResult(
        wo=jnp.zeros_like(wi),
        weight=jnp.zeros_like(wi),
        eta=jnp.ones(n),
        is_discrete=jnp.zeros(n, bool),
        pdf=jnp.zeros(n),
    )
    wi0 = wi
    for t in _base_types(static):
        m = mp.btype == t
        (wi,) = _safe_dirs(m, wi0)
        if t in (BSDF_DIFFUSE, BSDF_LAMBERTIAN):
            albedo = _diffuse_albedo(static, scene, mp, uv, t == BSDF_LAMBERTIAN)
            wo, w, eta, disc, pdf = _diffuse_sample(albedo, wi, s2)
        elif t == BSDF_MIRROR:
            wo, w, eta, disc, pdf = _mirror_sample(wi, s2)
        elif t == BSDF_DIELECTRIC:
            wo, w, eta, disc, pdf = _dielectric_sample(mp, wi, s1)
        elif t == BSDF_GGX:
            wo, w, eta, disc, pdf = _ggx_sample(static, scene, mp, uv, wi, s2)
        elif t == BSDF_ROUGHCONDUCTOR:
            wo, w, eta, disc, pdf = _roughconductor_sample(mp, wi, s2)
        elif t == BSDF_ROUGHPLASTIC:
            wo, w, eta, disc, pdf = _roughplastic_sample(mp, wi, s1, s2)
        elif t == BSDF_ROUGHDIELECTRIC:
            wo, w, eta, disc, pdf = _roughdielectric_sample(mp, wi, s1, s2)
        elif t == BSDF_KISS:
            wo, w, eta, disc, pdf = _kiss_sample(
                static, scene, mp, uv, wi, s1, s2, accum_rough
            )
        else:
            raise ValueError(f"unhandled btype {t}")
        out = SampleResult(
            wo=jnp.where(m[..., None], wo, out.wo),
            weight=jnp.where(m[..., None], w, out.weight),
            eta=jnp.where(m, eta, out.eta),
            is_discrete=jnp.where(m, disc, out.is_discrete),
            pdf=jnp.where(m, pdf, out.pdf),
        )
    return out


# ---------------------------------------------------------------------------
# normalmap resolution (bsdf.cpp:281-417) + public entry points
# ---------------------------------------------------------------------------


def _resolve_normalmap(static, scene, materials, mat_id, uv, sh_frame, dpdu, wi):
    mp = gather(materials, mat_id)
    if BSDF_NORMALMAP not in static.btypes_present:
        return mp, mp, jnp.zeros(wi.shape[:-1], bool), sh_frame, wi, None
    is_nm = mp.btype == BSDF_NORMALMAP
    eff_id = jnp.where(is_nm, mp.nested, mat_id)
    mp_eff = gather(materials, eff_id)
    rgb = eval_texture(
        static,
        scene.textures,
        mp.tex_normal,
        uv,
        jnp.broadcast_to(jnp.asarray([0.5, 0.5, 1.0], wi.dtype), wi.shape),
    )
    n_t = 2.0 * rgb - 1.0
    # Hemisphere-consistency shortcut (bsdf.cpp:295-297): when the mapped
    # normal faces away from wi, fall back to the unperturbed nested BSDF.
    shortcut = (_cos(wi) > 0.0) & (km.dot(n_t, wi) <= 0.0)
    # getFrame (bsdf.cpp:366-378): naive frame construction
    n_w = km.normalize(sh_frame.to_world(km.normalize(n_t)))
    s_p = km.normalize(dpdu - n_w * km.dot(n_w, dpdu, keepdims=True))
    t_p = km.normalize(km.cross(n_w, s_p))
    pframe = km.Frame(s=s_p, t=t_p, n=n_w)
    perturbed = is_nm & ~shortcut
    wi_p = pframe.to_local(sh_frame.to_world(wi))
    wi_eff = jnp.where(perturbed[..., None], wi_p, wi)
    return mp, mp_eff, perturbed, pframe, wi_eff, sh_frame


class ShadeCtx(NamedTuple):
    """Per-hit shading context: material rows gathered once, normalmap frame
    resolved once; eval/pdf/sample share it (5x fewer table gathers per
    bounce)."""

    mp: MaterialTable  # raw rows
    mp_eff: MaterialTable  # nested-resolved rows
    uv: jnp.ndarray
    sh_frame: km.Frame
    wi: jnp.ndarray  # local wi (unperturbed)
    wi_eff: jnp.ndarray
    perturbed: jnp.ndarray
    pframe: km.Frame


def make_ctx(
    static, scene, mat_id, uv, sh_frame, dpdu, wi, lod=None, aniso=None
) -> ShadeCtx:
    if lod is not None and getattr(static, "mip_textures", False):
        # thread the mip footprint through every texture fetch as extra
        # uv columns: [u, v, lod, maj_du, maj_dv] (see
        # textures.eval_texture; the last two are the anisotropic major
        # uv half-axis, zero = isotropic)
        cols = [uv, lod[..., None]]
        if aniso is not None:
            cols += [aniso[0][..., None], aniso[1][..., None]]
        uv = jnp.concatenate(cols, axis=-1)
    mp, mp_eff, perturbed, pframe, wi_eff, _ = _resolve_normalmap(
        static, scene, scene.materials, mat_id, uv, sh_frame, dpdu, wi
    )
    if pframe is None:
        pframe = sh_frame
    return ShadeCtx(
        mp=mp,
        mp_eff=mp_eff,
        uv=uv,
        sh_frame=sh_frame,
        wi=wi,
        wi_eff=wi_eff,
        perturbed=perturbed,
        pframe=pframe,
    )


def eval_ctx(static, scene, ctx: ShadeCtx, wo, accum_rough):
    if BSDF_NORMALMAP not in static.btypes_present:
        return eval_base(static, scene, ctx.mp, ctx.uv, ctx.wi, wo, accum_rough)
    wo_p = ctx.pframe.to_local(ctx.sh_frame.to_world(wo))
    wo_eff = jnp.where(ctx.perturbed[..., None], wo_p, wo)
    val = eval_base(
        static, scene, ctx.mp_eff, ctx.uv, ctx.wi_eff, wo_eff, accum_rough
    )
    bad = ctx.perturbed & (_cos(wo) * _cos(wo_p) <= 0.0)
    return _mask3(~bad, val)


def pdf_ctx(static, scene, ctx: ShadeCtx, wo, accum_rough):
    if BSDF_NORMALMAP not in static.btypes_present:
        return pdf_base(static, scene, ctx.mp, ctx.uv, ctx.wi, wo, accum_rough)
    wo_p = ctx.pframe.to_local(ctx.sh_frame.to_world(wo))
    wo_eff = jnp.where(ctx.perturbed[..., None], wo_p, wo)
    val = pdf_base(
        static, scene, ctx.mp_eff, ctx.uv, ctx.wi_eff, wo_eff, accum_rough
    )
    bad = ctx.perturbed & (_cos(wo) * _cos(wo_p) <= 0.0)
    return jnp.where(bad, 0.0, val)


def eval_pdf_ctx(static, scene, ctx: ShadeCtx, wo, accum_rough):
    if BSDF_NORMALMAP not in static.btypes_present:
        return eval_pdf_base(
            static, scene, ctx.mp, ctx.uv, ctx.wi, wo, accum_rough
        )
    wo_p = ctx.pframe.to_local(ctx.sh_frame.to_world(wo))
    wo_eff = jnp.where(ctx.perturbed[..., None], wo_p, wo)
    f, p = eval_pdf_base(
        static, scene, ctx.mp_eff, ctx.uv, ctx.wi_eff, wo_eff, accum_rough
    )
    bad = ctx.perturbed & (_cos(wo) * _cos(wo_p) <= 0.0)
    return _mask3(~bad, f), jnp.where(bad, 0.0, p)


def sample_ctx(static, scene, ctx: ShadeCtx, s1, s2, accum_rough) -> SampleResult:
    res = sample_base(
        static, scene, ctx.mp_eff, ctx.uv, ctx.wi_eff, s1, s2, accum_rough
    )
    if BSDF_NORMALMAP not in static.btypes_present:
        return res
    # Map the sampled direction back through the perturbed frame
    # (bsdf.cpp:357-362) and reject hemisphere flips.
    wo_world = ctx.pframe.to_world(res.wo)
    wo_back = ctx.sh_frame.to_local(wo_world)
    wo = jnp.where(ctx.perturbed[..., None], wo_back, res.wo)
    bad = ctx.perturbed & (_cos(wo) * _cos(res.wo) <= 0.0)
    return SampleResult(
        wo=wo,
        weight=_mask3(~bad, res.weight),
        eta=res.eta,
        is_discrete=res.is_discrete,
        pdf=jnp.where(bad, 0.0, res.pdf),
    )


def regularize_ctx(static, scene, ctx: ShadeCtx):
    """regularize() with normalmap forwarding (bsdf.cpp:412)."""
    return regularize(static, scene, ctx.mp_eff, ctx.uv)


# thin mat_id wrappers (tests / simple integrators)
def eval(static, scene, mat_id, uv, sh_frame, dpdu, wi, wo, accum_rough):
    """BSDF::eval with per-lane material dispatch + normalmap handling.

    wi/wo are in the interaction's shading frame; returns f*cos(theta_o).
    """
    ctx = make_ctx(static, scene, mat_id, uv, sh_frame, dpdu, wi)
    return eval_ctx(static, scene, ctx, wo, accum_rough)


def pdf(static, scene, mat_id, uv, sh_frame, dpdu, wi, wo, accum_rough):
    ctx = make_ctx(static, scene, mat_id, uv, sh_frame, dpdu, wi)
    return pdf_ctx(static, scene, ctx, wo, accum_rough)


def sample(
    static, scene, mat_id, uv, sh_frame, dpdu, wi, s1, s2, accum_rough
) -> SampleResult:
    ctx = make_ctx(static, scene, mat_id, uv, sh_frame, dpdu, wi)
    return sample_ctx(static, scene, ctx, s1, s2, accum_rough)


def regularize_resolved(static, scene, mat_id, uv):
    """regularize() with normalmap forwarding (bsdf.cpp:412)."""
    mp = gather(scene.materials, mat_id)
    if BSDF_NORMALMAP in static.btypes_present:
        eff_id = jnp.where(mp.btype == BSDF_NORMALMAP, mp.nested, mat_id)
        mp = gather(scene.materials, eff_id)
    return regularize(static, scene, mp, uv)


def regularize(static, scene, mp, uv):
    """BSDF::regularize: kiss returns its roughness texture (bsdf.cpp:1397-
    1399); all others 0 (bsdf.h:125). normalmap forwards to nested, which the
    caller resolves before calling."""
    if BSDF_KISS not in static.btypes_present:
        return jnp.zeros(uv.shape[:-1])
    rough = eval_texture(
        static, scene.textures, mp.tex_roughness, uv,
        jnp.stack([mp.roughness] * 3, -1),
    )[..., 0]
    return jnp.where(mp.btype == BSDF_KISS, rough, 0.0)
