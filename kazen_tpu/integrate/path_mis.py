"""Wavefront NEE+MIS path tracer.

Faithful re-expression of the reference's iterative megaloop
(PathMisIntegrator::Li, integrator.cpp:195-338) as a masked SoA wavefront:
every lane carries (ray, throughput, eta, bsdfWeight, accumulatedRoughness,
alive) and all lanes advance through the same per-bounce stages, so the
per-lane random-stream consumption matches the reference exactly and images
agree at equal (sampler, spp, seed).

Bounce structure (per iteration):
  1. emitter-hit termination with MIS weight       (integrator.cpp:226-231)
  2. Russian roulette from depth>=3, `<=` compare  (:237-244)
  3. NEE: uniform light pick, area-light sample, biased shadow ray with
     step-through of primary-invisible lights      (:247-294)
  4. roughness-bias accumulation (opt-in)          (:297-301)
  5. BSDF sample; throughput/eta update            (:303-309)
  6. trace; miss -> background; emitter-hit MIS
     weight for next iteration                     (:312-331)

All max_depth bounces run as a single lax.scan over per-bounce static
draw_rr flags (true from depth 3), so the RR draw is only consumed from
depth 3 (parity with the reference's conditional draw) while the whole
depth loop compiles once. The ordered-wavefront lane permutation is
described at _bounce_ordered / li_wavefront.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..accel import backend
from ..accel.intersect import Rays, intersect_brute
from ..core import math as km
from ..samplers import streams
from ..shade import bsdf as bsdf_mod
from ..shade import lights as lights_mod
from ..shade.interaction import ROWS, Interaction, prepare_from_rows

EPSILON = 1e-4  # Ray3f default mint (define.h)
INF = jnp.float32(3.0e38)
_MAX_OCCLUSION_STEPS = 8


def _spread10(x):
    """Spread the low 10 bits of x two apart (Morton interleave)."""
    x = jnp.bitwise_and(x, jnp.uint32(0x3FF))
    x = jnp.bitwise_and(x | (x << 16), jnp.uint32(0x030000FF))
    x = jnp.bitwise_and(x | (x << 8), jnp.uint32(0x0300F00F))
    x = jnp.bitwise_and(x | (x << 4), jnp.uint32(0x030C30C3))
    x = jnp.bitwise_and(x | (x << 2), jnp.uint32(0x09249249))
    return x


def _morton3(cell):
    return (
        (_spread10(cell[:, 0]) << 2)
        | (_spread10(cell[:, 1]) << 1)
        | _spread10(cell[:, 2])
    )


def _dmorton(d):
    """12-bit direction Morton code (16^3 cells)."""
    dcell = jnp.clip((d * 0.5 + 0.5) * 16.0, 0.0, 15.0).astype(jnp.uint32)
    return _morton3(dcell)


def intersect(scene, rays: Rays):
    """Scene::rayIntersect: nearest hit only. The BVH walk is the one
    ``accel.backend`` picks for the platform; scenes without a BVH use
    the brute-force oracle."""
    if getattr(scene, "bvh", None) is not None:
        return backend.bvh_walk()(scene, rays)
    return intersect_brute(scene, rays)


def power_heuristic(pdf_a, pdf_b):
    """powerHeuristic (integrator.cpp:340-344). The untaken branch of the
    where must not compute 0/0 (reverse-mode turns its NaN into NaN
    cotangents), so the denominator is substituted where a2 == 0."""
    a2 = pdf_a * pdf_a
    b2 = pdf_b * pdf_b
    ok = a2 > 0.0
    return jnp.where(ok, a2 / jnp.where(ok, a2 + b2, 1.0), 0.0)


def _occluded_with_stepthrough(scene, static, o, d, mint, maxt, active):
    """Shadow-ray occlusion with the reference's step-through of
    primary-invisible lights (integrator.cpp:259-278): the nearest hit is
    examined; invisible lights are skipped by re-casting past them. The
    re-cast loop is capped at _MAX_OCCLUSION_STEPS=8 (the reference's loop
    is unbounded; >8 stacked invisible lights along one shadow ray differ).
    """
    def cond(state):
        _, _, _, done, steps = state
        return (~jnp.all(done)) & (steps < _MAX_OCCLUSION_STEPS)

    def body(state):
        o, mt, occluded, done, steps = state
        rays = Rays(o=o, d=d, mint=jnp.full_like(mt, mint), maxt=mt)
        hit = intersect(scene, rays)
        its_mesh = scene.face_mesh[jnp.clip(hit.face, 0, scene.F.shape[0] - 1)]
        its_light = scene.mesh_light[its_mesh]
        is_light = hit.valid & (its_light >= 0)
        light_visible = scene.light_primary_vis[jnp.maximum(its_light, 0)]
        blocked = hit.valid & (~is_light | (is_light & light_visible))
        newly_done = ~hit.valid | blocked
        # step past the invisible light (integrator.cpp:273)
        o_next = o + d * (hit.t + static.trace_bias)[:, None]
        mt_next = mt - hit.t
        upd = ~done & ~newly_done
        return (
            jnp.where(upd[:, None], o_next, o),
            jnp.where(upd, mt_next, mt),
            jnp.where(~done & blocked, True, occluded),
            done | newly_done,
            steps + 1,
        )

    n = o.shape[0]
    init = (
        o,
        maxt,
        jnp.zeros(n, bool),
        ~active,  # inactive lanes are pre-done
        jnp.int32(0),
    )
    _, _, occluded, _, _ = jax.lax.while_loop(cond, body, init)
    return occluded


def _rows_from_hit(scene, hit):
    """Pack a hit and its face's shading attributes into the trace-row
    matrix (``shade.interaction`` row layout) that the wavefront carries
    and permutes as one array."""
    n = hit.t.shape[0]
    f = jnp.clip(hit.face, 0, scene.F.shape[0] - 1)
    shade = scene.face_shade[f]  # (N, 24)
    mesh = scene.face_mesh[f]
    light = scene.mesh_light[mesh]
    valid = hit.valid
    rows = jnp.zeros((ROWS.count, n), jnp.float32)
    rows = rows.at[ROWS.t].set(jnp.where(valid, hit.t, ROWS.big))
    rows = rows.at[ROWS.u].set(hit.u)
    rows = rows.at[ROWS.v].set(hit.v)
    rows = rows.at[ROWS.face].set(
        jnp.where(valid, f.astype(jnp.float32), -1.0)
    )
    rows = rows.at[ROWS.shade].set(shade.T)
    rows = rows.at[ROWS.light].set(
        jnp.where(valid, light.astype(jnp.float32), -1.0)
    )
    rows = rows.at[ROWS.lpv].set(
        scene.light_primary_vis[jnp.maximum(light, 0)].astype(jnp.float32)
    )
    rows = rows.at[ROWS.mat].set(scene.mesh_material[mesh].astype(jnp.float32))
    rows = rows.at[ROWS.has_n].set(
        scene.mesh_has_normals[mesh].astype(jnp.float32)
    )
    rows = rows.at[ROWS.has_uv].set(
        scene.mesh_has_uvs[mesh].astype(jnp.float32)
    )
    return rows


def _trace_rows(scene, rays: Rays):
    """Nearest-hit trace returning the packed trace rows."""
    return _rows_from_hit(scene, intersect(scene, rays))


def _ordering_useful(scene):
    """Static: is the per-bounce coherence permute worth anything? Only
    for BVH scenes; the brute-force backend tests every triangle for
    every lane, so lane order does not matter to it."""
    return getattr(scene, "bvh", None) is not None


class _OState(NamedTuple):
    """Ordered-wavefront scan carry: everything lives in the order of the
    LAST path trace (sigma_k); one per-bounce permute moves the whole
    state into the next trace's order instead of a sort and unsort
    around every trace."""

    stream: streams.StreamState
    ray_o: jnp.ndarray  # (N, 3) rays that produced `rows`
    ray_d: jnp.ndarray  # (N, 3)
    rows: jnp.ndarray  # (ROWS.count, N) trace rows in current order
    li: jnp.ndarray  # (N, 3)
    throughput: jnp.ndarray  # (N, 3)
    eta: jnp.ndarray  # (N,)
    bsdf_pdf: jnp.ndarray  # (N,) pdf of the BSDF sample that made ray_d
    discrete: jnp.ndarray  # (N,) bool: that sample was a delta lobe
    accum_rough: jnp.ndarray  # (N,)
    alive: jnp.ndarray  # (N,) bool (not yet masked by rows validity)
    lane: jnp.ndarray  # (N,) int32 original lane id (for final unscatter)
    rays: jnp.ndarray  # () f32: useful rays traced


_MAX_ANISO = 16.0  # footprint elongation cap (OIIO default aniso limit)


def _texture_footprint(static, its: Interaction, ray_d):
    """EWA-style two-axis texture footprint (VERDICT r4 #6; the reference
    gets this from OIIO's default anisotropic filtering,
    texture.cpp:46-64).

    The pixel cone hits the surface as an ellipse: minor (cross-view)
    diameter = |t| * pixel_cone, major axis elongated by 1/cos(theta)
    along the view direction's tangential projection (capped at
    _MAX_ANISO). Both axes are pulled back to uv space through the
    [dpdu dpdv] Jacobian (2x2 Gram solve); the mip level comes from the
    MINOR uv extent while the texture lookup averages probes along the
    major uv half-axis (textures._eval_leaf). Degenerate footprints
    (normal-parallel view, singular Jacobian) fall back to the round-4
    conservative isotropic extent (min |dpdu|,|dpdv| denominator).

    Returns (lod_minor, (maj_du, maj_dv)) or (None, None) when mip
    filtering is off."""
    if not getattr(static, "mip_textures", False):
        return None, None
    # miss lanes carry t = BIG (3e38): unclamped, the major-axis products
    # overflow to inf and the masked lanes' NaN texture probes poison the
    # texel-gradient cotangents (0 * NaN). 1e8 is far beyond any real
    # footprint and keeps every downstream product finite.
    foot = jnp.minimum(jnp.abs(its.t), 1e8) * static.pixel_cone
    if not getattr(static, "aniso_textures", True):
        dp_len = jnp.maximum(
            jnp.minimum(km.norm(its.dpdu), km.norm(its.dpdv)), 1e-6
        )
        return jnp.log2(jnp.maximum(foot / dp_len, 1e-9)), None
    nrm = its.sh_frame.n
    dn = jnp.sum(ray_d * nrm, axis=-1)
    cosv = jnp.clip(jnp.abs(dn), 1.0 / _MAX_ANISO, 1.0)
    tang = ray_d - dn[..., None] * nrm
    tl = km.norm(tang)
    m_dir = tang / jnp.maximum(tl, 1e-9)[..., None]
    mi_dir = jnp.cross(nrm, m_dir)
    E = jnp.sum(its.dpdu * its.dpdu, axis=-1)
    Fg = jnp.sum(its.dpdu * its.dpdv, axis=-1)
    G = jnp.sum(its.dpdv * its.dpdv, axis=-1)
    det = E * G - Fg * Fg
    ok = (det > 1e-16) & (tl > 1e-5)
    det_s = jnp.where(ok, det, 1.0)

    def uv_vec(wvec):
        b1 = jnp.sum(wvec * its.dpdu, axis=-1)
        b2 = jnp.sum(wvec * its.dpdv, axis=-1)
        return (G * b1 - Fg * b2) / det_s, (E * b2 - Fg * b1) / det_s

    half = 0.5 * foot
    mdu, mdv = uv_vec(m_dir * (half / cosv)[..., None])
    idu, idv = uv_vec(mi_dir * half[..., None])
    # guarded sqrt: at an exactly-degenerate footprint the 0-cotangent
    # meets d(sqrt)/dx = inf and NaNs the whole batch's texel gradients
    # (same reverse-mode class as core.math.norm's clamp)
    minor_len = 2.0 * jnp.sqrt(jnp.maximum(idu * idu + idv * idv, 1e-30))
    iso_len = foot / jnp.maximum(
        jnp.minimum(km.norm(its.dpdu), km.norm(its.dpdv)), 1e-6
    )
    lod = jnp.log2(
        jnp.maximum(jnp.where(ok, minor_len, iso_len), 1e-9)
    )
    aniso = (jnp.where(ok, mdu, 0.0), jnp.where(ok, mdv, 0.0))
    return lod, aniso


def _light_eval_at_hit(scene, its: Interaction, ray_o):
    """Light::eval with lRec(ref=ray.o, p=its.p, n=its.shFrame.n)."""
    wi = km.normalize(its.p - ray_o)
    lidx = jnp.maximum(its.light, 0)
    return lights_mod.eval_area_light(scene, lidx, its.sh_frame.n, wi)


def _light_pdf_at_hit(scene, its: Interaction, ray_o):
    to_p = its.p - ray_o
    dist = km.norm(to_p)
    wi = to_p / jnp.maximum(dist, 1e-9)[:, None]
    lidx = jnp.maximum(its.light, 0)
    return lights_mod.pdf_area_light(scene, lidx, its.sh_frame.n, wi, dist)


def _shade_prologue(scene, static, st: _OState):
    """Bookkeeping for the trace that produced ``st.rows``
    (integrator.cpp:312-331 re-phased to the top of the next iteration):
    miss -> background, alive &= valid, and the MIS bsdfWeight for an
    emitter hit by the BSDF ray (1 for delta lobes / camera rays)."""
    li = st.li
    valid = st.rows[ROWS.face] >= 0.0
    missed = st.alive & ~valid
    bg = lights_mod.background_radiance(scene, static, st.ray_d)
    if static.env_importance and static.has_background:
        w_bg = power_heuristic(
            st.bsdf_pdf,
            lights_mod.pdf_env_dir(scene, static, st.ray_d),
        )
        w_bg = jnp.where(st.discrete, 1.0, w_bg)
        li = li + jnp.where(
            missed[:, None], st.throughput * bg * w_bg[:, None], 0.0
        )
    else:
        li = li + jnp.where(missed[:, None], st.throughput * bg, 0.0)
    alive = st.alive & valid
    return li, alive


def _bounce_ordered(scene, static, spec, st: _OState, draw_rr) -> _OState:
    """One bounce of the ordered wavefront. The whole lane state lives in
    the order of the trace that produced ``st.rows``; the shade stage runs
    in that order, then ONE permute moves rays + state into the next
    bounce's shared order (light | direction octant | direction Morton)
    and both the shadow and the path trace run with no internal sort. ``draw_rr`` as before: the RR draw is
    consumed only when true (reference depth>=3 parity)."""
    n = st.ray_o.shape[0]
    stream = st.stream

    # ---- epilogue of the previous trace (integrator.cpp:312-331) ----
    li, alive = _shade_prologue(scene, static, st)
    its = prepare_from_rows(
        Rays(o=st.ray_o, d=st.ray_d,
             mint=jnp.zeros(n, jnp.float32), maxt=jnp.full(n, INF)),
        st.rows,
    )[1]
    throughput = st.throughput
    eta = st.eta
    accum = st.accum_rough

    wi_local = its.sh_frame.to_local(-st.ray_d)
    lod, aniso = _texture_footprint(static, its, st.ray_d)
    ctx = bsdf_mod.make_ctx(
        scene=scene, static=static, mat_id=its.material, uv=its.uv,
        sh_frame=its.sh_frame, dpdu=its.dpdu, wi=wi_local, lod=lod,
        aniso=aniso,
    )

    # (1) emitter hit terminates the lane (integrator.cpp:226-231); the
    # MIS weight is recomputed here from the carried (bsdf_pdf, discrete)
    hit_light = alive & (its.light >= 0)
    bw = jnp.where(
        st.discrete,
        1.0,
        power_heuristic(st.bsdf_pdf, _light_pdf_at_hit(scene, its, st.ray_o)),
    )
    le = _light_eval_at_hit(scene, its, st.ray_o)
    li = li + jnp.where(
        hit_light[:, None], bw[:, None] * throughput * le, 0.0
    )
    alive = alive & ~hit_light

    # (2) Russian roulette (integrator.cpp:237-244)
    stream_rr, u_rr = streams.next_1d(spec, stream)
    stream = jax.tree_util.tree_map(
        lambda a, b: jnp.where(draw_rr, a, b), stream_rr, stream
    )
    prob = jnp.minimum(jnp.max(throughput, axis=-1) * eta * eta, 0.95)
    dead = draw_rr & (prob <= u_rr)
    alive = alive & ~dead
    rr_scale = jnp.where(
        draw_rr & alive, 1.0 / jnp.maximum(prob, 1e-9), 1.0
    )
    throughput = throughput * rr_scale[:, None]

    # (3) NEE sampling (integrator.cpp:247-294); occlusion runs after the
    # permute, so the masked contribution rides the state
    do_env = static.env_importance and static.has_background
    n_strat = static.num_lights + (1 if do_env else 0)
    if n_strat > 0:
        stream, u_pick = streams.next_1d(spec, stream)
        stream, u_tri = streams.next_1d(spec, stream)
        stream, u_a = streams.next_1d(spec, stream)
        stream, u_b = streams.next_1d(spec, stream)
        pick = lights_mod.select_uniform(n_strat, u_pick)
        if static.num_lights > 0:
            lidx = jnp.clip(pick, 0, static.num_lights - 1)
            ls = lights_mod.sample_area_light(
                scene, lidx, its.p, u_tri, u_a, u_b
            )
            nee_wi = ls.wi
            nee_maxt = ls.dist - static.trace_bias
            nee_ls = ls.ls
            nee_pdf = ls.pdf
        if do_env:
            env = lights_mod.sample_env_light(scene, static, u_a, u_b)
            if static.num_lights > 0:
                is_env = pick == static.num_lights
                nee_wi = jnp.where(is_env[:, None], env.wi, nee_wi)
                nee_maxt = jnp.where(is_env, INF, nee_maxt)
                nee_ls = jnp.where(is_env[:, None], env.ls, nee_ls)
                nee_pdf = jnp.where(is_env, env.pdf, nee_pdf)
            else:
                nee_wi = env.wi
                nee_maxt = jnp.full(env.pdf.shape, INF)
                nee_ls = env.ls
                nee_pdf = env.pdf
        ls_val = nee_ls * n_strat
        wo_local = its.sh_frame.to_local(nee_wi)
        f, pdf_b = bsdf_mod.eval_pdf_ctx(static, scene, ctx, wo_local, accum)
        w_light = power_heuristic(nee_pdf, pdf_b)
        contrib = jnp.where(
            alive[:, None],
            throughput * ls_val * f * w_light[:, None],
            0.0,
        )
        # a lane whose NEE contribution is already zero (light behind the
        # surface, zero BSDF toward the light, zero MIS weight) does not
        # need its occlusion answered: mark the shadow ray dead so its
        # blocks exit the any-hit walk on the first test. Exact-output
        # preserving; stream consumption unchanged.
        has_contrib = jnp.any(contrib != 0.0, axis=-1)
        smaxt = jnp.where(alive & has_contrib, nee_maxt, -1.0)
        n_shadow_rays = jnp.sum((alive & has_contrib).astype(jnp.float32))
    else:
        pick = jnp.zeros(n, jnp.int32)
        nee_wi = st.ray_d
        contrib = jnp.zeros((n, 3), jnp.float32)
        smaxt = jnp.full(n, -1.0, jnp.float32)
        n_shadow_rays = jnp.float32(0.0)

    # (4) roughness-bias firefly control (integrator.cpp:297-301)
    if static.regularization:
        reg = bsdf_mod.regularize_ctx(static, scene, ctx)
        accum = jnp.where(
            alive, accum + reg * static.accumulated_roughness, accum
        )

    # (5) BSDF sampling (integrator.cpp:303-309)
    stream, s1 = streams.next_1d(spec, stream)
    stream, s2 = streams.next_2d(spec, stream)
    res = bsdf_mod.sample_ctx(static, scene, ctx, s1, s2, accum)
    throughput = jnp.where(alive[:, None], throughput * res.weight, throughput)
    eta = jnp.where(alive, eta * res.eta, eta)
    alive = alive & jnp.any(res.weight > 0.0, axis=-1)
    pd = its.sh_frame.to_world(res.wo)
    n_path_rays = jnp.sum(alive.astype(jnp.float32))

    if not _ordering_useful(scene):
        # The brute-force backend is order-independent: skip the permute.
        # Identical output: the permute only reorders lanes.
        if n_strat > 0:
            occluded = _occluded_with_stepthrough(
                scene, static, its.p, nee_wi, static.trace_bias, smaxt,
                smaxt >= 0.0,
            )
            li = li + jnp.where(occluded[:, None], 0.0, contrib)
        rays = Rays(
            o=its.p,
            d=pd,
            mint=jnp.full(n, static.trace_bias, jnp.float32),
            maxt=jnp.where(alive, INF, -1.0),
        )
        rows = _trace_rows(scene, rays)
        return _OState(
            stream=stream,
            ray_o=its.p,
            ray_d=pd,
            rows=rows,
            li=li,
            throughput=throughput,
            eta=eta,
            bsdf_pdf=res.pdf,
            discrete=res.is_discrete,
            accum_rough=accum,
            alive=alive,
            lane=st.lane,
            rays=st.rays + n_shadow_rays + n_path_rays,
        )

    # ---- ONE permute into the next shared order ----
    # picked light (major: shadow rays toward one light share a direction
    # octant) | path-direction octant | direction Morton (minor).
    md = _dmorton(pd)
    key = (
        (jnp.minimum(jnp.asarray(pick, jnp.uint32), 15) << 26)
        | ((md >> 9) << 23)
        | (md & jnp.uint32(0x1FF))
    )
    # Alive-first tier bit: lanes whose path ray continues sort
    # before shadow-only lanes, so after this permute the still-alive lanes
    # occupy a contiguous prefix of length sum(alive). The staged driver
    # (integrate/staged.py) exploits this to run later bounces on a
    # narrowed static slice; results are exact either way (the permute
    # only reorders lanes).
    key = jnp.where(alive, key, key | jnp.uint32(1 << 30))
    key = jnp.where(alive | (smaxt >= 0.0), key, jnp.uint32(0xFFFFFFFF))
    order = jnp.argsort(key)

    frows = jnp.stack(
        [
            its.p[:, 0], its.p[:, 1], its.p[:, 2],
            nee_wi[:, 0], nee_wi[:, 1], nee_wi[:, 2],
            smaxt,
            pd[:, 0], pd[:, 1], pd[:, 2],
            li[:, 0], li[:, 1], li[:, 2],
            throughput[:, 0], throughput[:, 1], throughput[:, 2],
            eta,
            accum,
            contrib[:, 0], contrib[:, 1], contrib[:, 2],
            res.pdf,
            jnp.where(res.is_discrete, 1.0, 0.0),
            jnp.where(alive, 1.0, 0.0),
        ],
        0,
    )[:, order]
    (
        px_, py_, pz_, swx, swy, swz, smaxt, pdx, pdy, pdz,
        li0, li1, li2, tp0, tp1, tp2, eta, accum,
        c0, c1, c2, bsdf_pdf, disc_f, alive_f,
    ) = frows
    p = jnp.stack([px_, py_, pz_], -1)
    swi = jnp.stack([swx, swy, swz], -1)
    pd = jnp.stack([pdx, pdy, pdz], -1)
    li = jnp.stack([li0, li1, li2], -1)
    throughput = jnp.stack([tp0, tp1, tp2], -1)
    contrib = jnp.stack([c0, c1, c2], -1)
    alive = alive_f > 0.5
    discrete = disc_f > 0.5

    urows = jnp.stack(
        [
            stream.pcg[0][0], stream.pcg[0][1],
            stream.pcg[1][0], stream.pcg[1][1],
            stream.dim, stream.px, stream.py, stream.sample_index,
            st.lane.astype(jnp.uint32),
        ],
        0,
    )[:, order]
    stream = streams.StreamState(
        pcg=((urows[0], urows[1]), (urows[2], urows[3])),
        dim=urows[4], px=urows[5], py=urows[6], sample_index=urows[7],
    )
    lane = urows[8].astype(jnp.int32)

    # ---- shadow trace in the shared order, no internal sort ----
    if n_strat > 0:
        occluded = _occluded_with_stepthrough(
            scene, static, p, swi, static.trace_bias, smaxt,
            smaxt >= 0.0,
        )
        li = li + jnp.where(occluded[:, None], 0.0, contrib)

    # ---- path trace in the shared order, no internal sort ----
    rays = Rays(
        o=p,
        d=pd,
        mint=jnp.full(n, static.trace_bias, jnp.float32),
        maxt=jnp.where(alive, INF, -1.0),
    )
    rows = _trace_rows(scene, rays)

    return _OState(
        stream=stream,
        ray_o=p,
        ray_d=pd,
        rows=rows,
        li=li,
        throughput=throughput,
        eta=eta,
        bsdf_pdf=bsdf_pdf,
        discrete=discrete,
        accum_rough=accum,
        alive=alive,
        lane=lane,
        rays=st.rays + n_shadow_rays + n_path_rays,
    )


def li_wavefront(scene, static, spec, stream, rays: Rays):
    """Integrator::Li over a whole lane batch. Returns (stream, li, rays).

    Ordered-wavefront design: after the primary trace (run in caller/pixel
    order, coherent by construction), the whole lane state is permuted
    ONCE per bounce into a shared order that serves both the shadow and
    the path trace (key: picked light | direction octant | direction
    Morton); results are scattered back to caller order at the end. Stream
    consumption per lane is identical to the reference megaloop
    (integrator.cpp:195-338), so images match at equal (sampler, spp,
    seed) regardless of the internal order."""
    return _li_wavefront_core(scene, static, spec, stream, rays)


def wavefront_init(scene, static, spec, stream, rays: Rays) -> "_OState":
    """Primary trace + punch-through recast + initial wavefront state.

    Shared by the scan driver below and the host-staged driver
    (integrate/staged.py); the state is in caller/pixel lane order."""
    n = rays.o.shape[0]
    rows = _trace_rows(scene, rays)

    # Camera-ray punch-through for primary-invisible lights
    # (integrator.cpp:213-220): a single re-cast past the light; if the
    # re-cast misses, the stale light hit is kept (reference behavior).
    valid0 = rows[ROWS.face] >= 0.0
    punch = valid0 & (rows[ROWS.light] >= 0.0) & (rows[ROWS.lpv] < 0.5)
    if static.num_lights > 0:
        _, its0 = prepare_from_rows(rays, rows)
        o2 = its0.p + static.trace_bias * rays.d
        rays2 = Rays(
            o=o2,
            d=rays.d,
            mint=jnp.full(n, EPSILON),
            maxt=jnp.where(punch, INF, -1.0),
        )
        rows2 = _trace_rows(scene, rays2)
        take = punch & (rows2[ROWS.face] >= 0.0)
        rows = jnp.where(take[None, :], rows2, rows)
        ray_o = jnp.where(take[:, None], o2, rays.o)
    else:
        ray_o = rays.o

    st = _OState(
        stream=stream,
        ray_o=ray_o,
        ray_d=rays.d,
        rows=rows,
        li=jnp.zeros((n, 3), jnp.float32),
        throughput=jnp.ones((n, 3), jnp.float32),
        eta=jnp.ones(n, jnp.float32),
        bsdf_pdf=jnp.zeros(n, jnp.float32),
        discrete=jnp.ones(n, bool),  # camera "lobe": bsdfWeight = 1
        accum_rough=jnp.zeros(n, jnp.float32),
        alive=rows[ROWS.face] >= 0.0,
        lane=jnp.arange(n, dtype=jnp.int32),
        rays=jnp.sum(jnp.ones(n, jnp.float32)),
    )
    return st


def wavefront_finish(scene, static, st: "_OState"):
    """Final miss->background + un-permute to caller lane order.
    Returns (stream, li, nrays) exactly like li_wavefront."""
    # final trace's miss -> background (integrator.cpp:315-318); its
    # emitter hit is beyond maxDepth and contributes nothing (reference
    # loop-exit truncation)
    li, _ = _shade_prologue(scene, static, st)

    # back to caller lane order. st.lane is a permutation of [0, n), so
    # the scatter .at[lane].set(x) equals the gather x[argsort(lane)].
    inv = jnp.argsort(st.lane)
    li_out = li[inv]
    stream_out = jax.tree_util.tree_map(lambda r: r[inv], st.stream)
    return stream_out, li_out, st.rays


def _li_wavefront_core(scene, static, spec, stream, rays: Rays):
    st = wavefront_init(scene, static, spec, stream, rays)

    draw_rr_flags = jnp.arange(static.max_depth) >= 3

    def body(carry, flag):
        return _bounce_ordered(scene, static, spec, carry, draw_rr=flag), None

    st, _ = jax.lax.scan(body, st, draw_rr_flags)
    return wavefront_finish(scene, static, st)
