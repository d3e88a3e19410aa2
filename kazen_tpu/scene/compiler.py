"""Scene compiler: lowers the Python scene description to flat device arrays.

This is the analog of the reference's ``activate()`` cascade
(parser.cpp:169-199, scene.cpp:29-52): it packs all meshes into one global
triangle soup, builds per-light area CDFs (mesh.cpp:31-44), flattens the
material graph into an SoA parameter table, packs textures into a flat texel
pool, and precomputes the camera's sample-to-camera matrix
(camera.cpp:35-68). The result is a ``(SceneArrays, SceneStatic)`` pair:
arrays are a jit-able pytree; statics are hashable config closed over by jit.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..accel import backend
from . import description as D

# Material type ids (shade/bsdf.py dispatches on these)
BSDF_DIFFUSE = 0
BSDF_DIELECTRIC = 1
BSDF_MIRROR = 2
BSDF_LAMBERTIAN = 3
BSDF_GGX = 4
BSDF_ROUGHCONDUCTOR = 5
BSDF_ROUGHPLASTIC = 6
BSDF_ROUGHDIELECTRIC = 7
BSDF_KISS = 8
BSDF_NORMALMAP = 9

# Conductor fresnel presets (eta, k) per channel (bsdf.cpp:703-713)
CONDUCTORS = {
    "Au": ((0.1431889, 0.3749570, 1.4424879), (3.9831604, 2.3857207, 1.6032152)),
    "Cu": ((0.2004376, 0.9240334, 1.1022119), (3.9129485, 2.4528477, 2.1421879)),
    "Cr": ((4.3696842, 2.9167024, 1.6547005), (5.2064351, 4.2313262, 3.7549467)),
}


class MaterialTable(NamedTuple):
    btype: jnp.ndarray  # (M,) int32
    base_color: jnp.ndarray  # (M, 3)
    tex_base: jnp.ndarray  # (M,) int32, -1 = constant
    metallic: jnp.ndarray  # (M,)
    tex_metallic: jnp.ndarray  # (M,) int32
    roughness: jnp.ndarray  # (M,)
    tex_roughness: jnp.ndarray  # (M,) int32
    anisotropy: jnp.ndarray
    specular: jnp.ndarray
    specular_tint: jnp.ndarray
    clearcoat: jnp.ndarray
    clearcoat_roughness: jnp.ndarray
    sheen: jnp.ndarray
    sheen_tint: jnp.ndarray
    int_ior: jnp.ndarray
    ext_ior: jnp.ndarray
    alpha: jnp.ndarray  # Beckmann alpha for rough* models
    eta_c: jnp.ndarray  # (M, 3) conductor eta
    k_c: jnp.ndarray  # (M, 3) conductor k
    nested: jnp.ndarray  # (M,) int32: wrapped material for normalmap
    tex_normal: jnp.ndarray  # (M,) int32


TEX_IMAGE = 0
TEX_CONSTANT = 1
TEX_COLORRAMP = 2
TEX_BLEND_MIX = 3
TEX_BLEND_MULTIPLY = 4


MAX_MIP_LEVELS = 14  # up to 8192^2 level-0 images


class TexturePool(NamedTuple):
    """Flat texture graph: image nodes index the texel pool; composite nodes
    (colorramp texture.cpp:149-191, blend :195-270) reference child node ids.
    Graph depth is limited to 2 composite levels at compile time. When the
    scene opts into mip_textures, every image node carries a box-filtered
    mip chain appended to the same flat pool (level l at mip_offset[:, l],
    size max(1, w>>l) x max(1, h>>l))."""

    texels: jnp.ndarray  # (P, 3) float32 flat pool
    offset: jnp.ndarray  # (T,) int32 start index into texels (level 0)
    width: jnp.ndarray  # (T,) int32 (level 0)
    height: jnp.ndarray  # (T,) int32
    uv_scale: jnp.ndarray  # (T,) float32
    ttype: jnp.ndarray  # (T,) int32 TEX_*
    const_color: jnp.ndarray  # (T, 3)
    input1: jnp.ndarray  # (T,) int32 nested/input1 node id, -1 absent
    input2: jnp.ndarray  # (T,) int32
    mask_id: jnp.ndarray  # (T,) int32
    ramp_min: jnp.ndarray  # (T,)
    ramp_max: jnp.ndarray  # (T,)
    mip_offset: jnp.ndarray  # (T, MAX_MIP_LEVELS) int32
    n_levels: jnp.ndarray  # (T,) int32 (1 = no chain)


class SceneArrays(NamedTuple):
    # geometry
    V: jnp.ndarray  # (Nv, 3)
    F: jnp.ndarray  # (Nf, 3) int32
    N: jnp.ndarray  # (Nv, 3) (zeros where absent)
    UV: jnp.ndarray  # (Nv, 2)
    # packed per-face shading row [p0 p1 p2 n0 n1 n2 uv0 uv1 uv2] -- one
    # contiguous gather per hit instead of 9 two-level vertex gathers
    face_shade: jnp.ndarray  # (Nf, 24) f32
    face_mesh: jnp.ndarray  # (Nf,) int32
    mesh_material: jnp.ndarray  # (Nm,) int32
    mesh_light: jnp.ndarray  # (Nm,) int32, -1 = not a light
    mesh_has_normals: jnp.ndarray  # (Nm,) bool
    mesh_has_uvs: jnp.ndarray  # (Nm,) bool
    # materials / textures
    materials: MaterialTable
    textures: TexturePool
    # lights
    light_mesh: jnp.ndarray  # (L,) int32
    light_radiance: jnp.ndarray  # (L, 3)
    light_primary_vis: jnp.ndarray  # (L,) bool
    light_cdf: jnp.ndarray  # (L, maxLF + 1) normalized area CDF
    light_faces: jnp.ndarray  # (L, maxLF) int32 global face ids
    light_inv_area: jnp.ndarray  # (L,) 1/total area (DiscretePDF normalization)
    # background
    bg_color: jnp.ndarray  # (3,)
    bg_tex: jnp.ndarray  # () int32, -1 = constant color
    bg_intensity: jnp.ndarray  # ()
    # camera
    cam_to_world: jnp.ndarray  # (4, 4)
    sample_to_camera: jnp.ndarray  # (4, 4)
    cam_near: jnp.ndarray  # ()
    cam_far: jnp.ndarray  # ()
    aperture_radius: jnp.ndarray  # ()
    focus_distance: jnp.ndarray  # ()
    # acceleration structure (accel/bvh.py); None = brute-force intersection
    bvh: Optional[object] = None
    # environment importance tables (built when Background.importance; see
    # _build_env_tables). Zeros-placeholders otherwise so the pytree shape
    # is stable.
    env_row_cdf: jnp.ndarray = None  # (Eh+1,) marginal CDF over rows
    env_col_cdf: jnp.ndarray = None  # (Eh, Ew+1) conditional CDF per row
    env_pdf: jnp.ndarray = None  # (Eh, Ew) solid-angle pdf per texel


@dataclass(frozen=True)
class SceneStatic:
    width: int
    height: int
    camera_kind: str  # "perspective" | "thinlens"
    num_meshes: int
    num_materials: int
    num_lights: int
    btypes_present: Tuple[int, ...]  # material types in this scene (dispatch)
    has_composite_textures: bool  # any colorramp/blend nodes in the graph
    has_image_textures: bool  # any image nodes (else texel gathers elide)
    has_background: bool
    sampler_kind: str
    sample_count: int
    seed: int
    integrator_kind: str  # path_mis | normals | ao | whitted | path_mats
    # path_mis params (integrator.cpp:189-192)
    max_depth: int
    trace_bias: float
    regularization: bool
    accumulated_roughness: float
    rfilter_kind: str
    rfilter_radius: float
    rfilter_stddev: float
    rfilter_b: float
    rfilter_c: float
    # env importance sampling (opt-in via Background.importance)
    env_importance: bool = False
    env_res: Tuple[int, int] = (0, 0)  # (Eh, Ew) of the importance tables
    # filtered (trilinear mip) image-texture minification (opt-in via
    # Scene.mip_textures); pixel_cone = screen-space footprint angle used
    # to pick the mip level from hit distance + dpdu
    mip_textures: bool = False
    aniso_textures: bool = True
    pixel_cone: float = 0.0


def _load_mesh_arrays(m: D.Mesh):
    if m.filename is not None:
        from .obj import load_obj

        return load_obj(m.filename, m.to_world)
    V = np.asarray(m.vertices, np.float32)
    F = np.asarray(m.faces, np.int32)
    N = None if m.normals is None else np.asarray(m.normals, np.float32)
    UV = None if m.uvs is None else np.asarray(m.uvs, np.float32)
    if m.to_world is not None:
        t = np.asarray(m.to_world, np.float32)
        V = V @ t[:3, :3].T + t[:3, 3]
        if N is not None:
            nmat = np.linalg.inv(t[:3, :3]).T
            N = N @ nmat.T
            N /= np.maximum(np.linalg.norm(N, axis=-1, keepdims=True), 1e-9)
    return V, F, N, UV


class _TexturePacker:
    def __init__(self, build_mips: bool = False):
        self.texels = []
        self.offsets = []
        self.widths = []
        self.heights = []
        self.scales = []
        self.total = 0
        self.ttypes = []
        self.const_colors = []
        self.input1 = []
        self.input2 = []
        self.mask_id = []
        self.ramp_min = []
        self.ramp_max = []
        self.build_mips = build_mips
        self.mip_offsets = []
        self.n_levels = []

    def _new_node(self, ttype, const=(0.0, 0.0, 0.0)):
        tid = len(self.ttypes)
        self.ttypes.append(ttype)
        self.const_colors.append(np.asarray(const, np.float32))
        self.input1.append(-1)
        self.input2.append(-1)
        self.mask_id.append(-1)
        self.ramp_min.append(0.0)
        self.ramp_max.append(1.0)
        self.offsets.append(0)
        self.widths.append(1)
        self.heights.append(1)
        self.scales.append(1.0)
        self.mip_offsets.append([0] * MAX_MIP_LEVELS)
        self.n_levels.append(1)
        return tid

    def add_node(self, tex, depth=0) -> int:
        """Register any texture-graph node; returns its node id."""
        tex = D.as_texture(tex)
        if isinstance(tex, D.ImageTexture):
            return self.add(tex)
        if isinstance(tex, D.ConstantTexture):
            return self._new_node(TEX_CONSTANT, tex.color)
        if depth >= 2:
            raise ValueError("texture graphs deeper than 2 composite levels")
        if isinstance(tex, D.ColorRamp):
            tid = self._new_node(TEX_COLORRAMP)
            if tex.input is not None:
                self.input1[tid] = self.add_node(tex.input, depth + 1)
            self.ramp_min[tid] = float(tex.min)
            self.ramp_max[tid] = float(tex.max)
            return tid
        if isinstance(tex, D.Blend):
            ttype = TEX_BLEND_MIX if tex.mode == "mix" else TEX_BLEND_MULTIPLY
            tid = self._new_node(ttype)
            if tex.mask is not None:
                self.mask_id[tid] = self.add_node(tex.mask, depth + 1)
            if tex.input1 is not None:
                self.input1[tid] = self.add_node(tex.input1, depth + 1)
            if tex.input2 is not None:
                self.input2[tid] = self.add_node(tex.input2, depth + 1)
            return tid
        raise TypeError(f"unknown texture node {type(tex).__name__}")

    def add(self, tex: D.ImageTexture) -> int:
        if tex.data is not None:
            img = np.asarray(tex.data, np.float32)
        elif tex.filename.lower().endswith(".exr"):
            from ..film.io import load_exr

            img = load_exr(tex.filename)
        else:
            import imageio.v3 as iio  # optional dependency; gated

            img = np.asarray(iio.imread(tex.filename), np.float32)
            if img.dtype == np.uint8 or img.max() > 1.5:
                img = img / 255.0
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, axis=-1)
        img = img[..., :3]
        if tex.colorspace == "srgb":
            img = np.where(
                img <= 0.04045, img / 12.92, ((img + 0.055) / 1.055) ** 2.4
            ).astype(np.float32)
        h, w = img.shape[:2]
        tid = self._new_node(TEX_IMAGE)
        self.offsets[tid] = self.total
        self.widths[tid] = w
        self.heights[tid] = h
        self.scales[tid] = float(tex.scale)
        self.texels.append(img.reshape(-1, 3).astype(np.float32))
        self.mip_offsets[tid][0] = self.total
        self.total += h * w
        if self.build_mips:
            # 2x2 box-filtered chain down to 1x1 (texture.cpp:46-64's OIIO
            # filtered minification, precomputed). Odd dims wrap the last
            # row/col (periodic textures).
            level = img.astype(np.float32)
            li = 1
            while (
                (level.shape[0] > 1 or level.shape[1] > 1)
                and li < MAX_MIP_LEVELS
            ):
                hh, ww = level.shape[:2]
                if hh % 2:
                    level = np.concatenate([level, level[:1]], axis=0)
                if ww % 2:
                    level = np.concatenate([level, level[:, :1]], axis=1)
                level = 0.25 * (
                    level[0::2, 0::2]
                    + level[1::2, 0::2]
                    + level[0::2, 1::2]
                    + level[1::2, 1::2]
                )
                self.mip_offsets[tid][li] = self.total
                self.texels.append(level.reshape(-1, 3).astype(np.float32))
                self.total += level.shape[0] * level.shape[1]
                li += 1
            self.n_levels[tid] = li
            for rest in range(li, MAX_MIP_LEVELS):
                self.mip_offsets[tid][rest] = self.mip_offsets[tid][li - 1]
        return tid

    def finish(self) -> TexturePool:
        if not self.ttypes:
            self._new_node(TEX_CONSTANT)
        texels = (
            np.concatenate(self.texels, axis=0)
            if self.texels
            else np.zeros((1, 3), np.float32)
        )
        return TexturePool(
            texels=jnp.asarray(texels),
            offset=jnp.asarray(np.asarray(self.offsets, np.int32)),
            width=jnp.asarray(np.asarray(self.widths, np.int32)),
            height=jnp.asarray(np.asarray(self.heights, np.int32)),
            uv_scale=jnp.asarray(np.asarray(self.scales, np.float32)),
            ttype=jnp.asarray(np.asarray(self.ttypes, np.int32)),
            const_color=jnp.asarray(np.stack(self.const_colors)),
            input1=jnp.asarray(np.asarray(self.input1, np.int32)),
            input2=jnp.asarray(np.asarray(self.input2, np.int32)),
            mask_id=jnp.asarray(np.asarray(self.mask_id, np.int32)),
            ramp_min=jnp.asarray(np.asarray(self.ramp_min, np.float32)),
            ramp_max=jnp.asarray(np.asarray(self.ramp_max, np.float32)),
            mip_offset=jnp.asarray(np.asarray(self.mip_offsets, np.int32)),
            n_levels=jnp.asarray(np.asarray(self.n_levels, np.int32)),
        )


class _MaterialBuilder:
    FIELDS = dict(
        btype=np.int32,
        base_color=None,
        tex_base=np.int32,
        metallic=np.float32,
        tex_metallic=np.int32,
        roughness=np.float32,
        tex_roughness=np.int32,
        anisotropy=np.float32,
        specular=np.float32,
        specular_tint=np.float32,
        clearcoat=np.float32,
        clearcoat_roughness=np.float32,
        sheen=np.float32,
        sheen_tint=np.float32,
        int_ior=np.float32,
        ext_ior=np.float32,
        alpha=np.float32,
        eta_c=None,
        k_c=None,
        nested=np.int32,
        tex_normal=np.int32,
    )

    def __init__(self, packer: _TexturePacker):
        self.rows = []
        self.packer = packer

    def _tex_or_const(self, tex):
        """Returns (constant_rgb, tex_id); plain constants avoid a node."""
        tex = D.as_texture(tex)
        if isinstance(tex, D.ConstantTexture):
            return np.asarray(tex.color, np.float32), -1
        return np.ones(3, np.float32), self.packer.add_node(tex)

    def _blank(self):
        return dict(
            btype=BSDF_DIFFUSE,
            base_color=np.asarray([0.5, 0.5, 0.5], np.float32),
            tex_base=-1,
            metallic=0.0,
            tex_metallic=-1,
            roughness=0.5,
            tex_roughness=-1,
            anisotropy=0.0,
            specular=0.5,
            specular_tint=0.5,
            clearcoat=0.0,
            clearcoat_roughness=0.5,
            sheen=0.0,
            sheen_tint=0.5,
            int_ior=1.5046,
            ext_ior=1.000277,
            alpha=0.1,
            eta_c=np.zeros(3, np.float32),
            k_c=np.zeros(3, np.float32),
            nested=-1,
            tex_normal=-1,
        )

    def add(self, b: Optional[D.BSDF]) -> int:
        if b is None:
            b = D.Diffuse()  # default material (mesh.cpp:25-28)
        row = self._blank()
        if isinstance(b, D.Diffuse):
            row["btype"] = BSDF_DIFFUSE
            row["base_color"] = np.asarray(b.albedo, np.float32)
        elif isinstance(b, D.Dielectric):
            row["btype"] = BSDF_DIELECTRIC
            row["int_ior"] = b.int_ior
            row["ext_ior"] = b.ext_ior
        elif isinstance(b, D.Mirror):
            row["btype"] = BSDF_MIRROR
        elif isinstance(b, D.Lambertian):
            row["btype"] = BSDF_LAMBERTIAN
            row["base_color"], row["tex_base"] = self._tex_or_const(b.albedo)
        elif isinstance(b, D.GGX):
            row["btype"] = BSDF_GGX
            row["base_color"], row["tex_base"] = self._tex_or_const(b.albedo)
            row["roughness"] = b.roughness
            row["anisotropy"] = b.anisotropy
        elif isinstance(b, D.RoughConductor):
            row["btype"] = BSDF_ROUGHCONDUCTOR
            eta, k = CONDUCTORS[b.material]
            row["eta_c"] = np.asarray(eta, np.float32)
            row["k_c"] = np.asarray(k, np.float32)
            row["alpha"] = max(1e-3, b.alpha**2)  # bsdf.cpp:695-700
        elif isinstance(b, D.RoughPlastic):
            row["btype"] = BSDF_ROUGHPLASTIC
            row["alpha"] = max(1e-3, b.alpha**2)
            row["int_ior"] = b.int_ior
            row["ext_ior"] = b.ext_ior
            row["base_color"] = np.asarray(b.kd, np.float32)
        elif isinstance(b, D.RoughDielectric):
            row["btype"] = BSDF_ROUGHDIELECTRIC
            row["alpha"] = max(1e-3, b.roughness**2)
            row["int_ior"] = b.int_ior
            row["ext_ior"] = b.ext_ior
        elif isinstance(b, D.KazenStandard):
            row["btype"] = BSDF_KISS
            row["base_color"], row["tex_base"] = self._tex_or_const(b.base_color)
            mc, mt = self._tex_or_const(b.metallic)
            row["metallic"], row["tex_metallic"] = float(mc[0]), mt
            rc, rt = self._tex_or_const(b.roughness)
            row["roughness"], row["tex_roughness"] = float(rc[0]), rt
            row["anisotropy"] = b.anisotropy
            row["specular"] = b.specular
            row["specular_tint"] = b.specular_tint
            row["clearcoat"] = b.clearcoat
            row["clearcoat_roughness"] = b.clearcoat_roughness
            row["sheen"] = b.sheen
            row["sheen_tint"] = b.sheen_tint
        elif isinstance(b, D.NormalMap):
            nested_id = self.add(b.nested)
            row = self._blank()
            row["btype"] = BSDF_NORMALMAP
            row["nested"] = nested_id
            _, row["tex_normal"] = self._tex_or_const(b.normals)
        else:
            raise TypeError(f"unknown BSDF {type(b).__name__}")
        self.rows.append(row)
        return len(self.rows) - 1

    def finish(self) -> MaterialTable:
        if not self.rows:
            self.add(D.Diffuse())
        cols = {}
        for name in self.FIELDS:
            vals = [r[name] for r in self.rows]
            if name in ("base_color", "eta_c", "k_c"):
                cols[name] = jnp.asarray(np.stack(vals).astype(np.float32))
            else:
                cols[name] = jnp.asarray(np.asarray(vals, self.FIELDS[name]))
        return MaterialTable(**cols)


ENV_TABLE_RES = (256, 512)  # (Eh, Ew) lat-long importance-table resolution


def _build_env_tables(pool, bg_tex, bg_color, bg_intensity, has_comp, has_img):
    """Rasterize the background graph onto a lat-long luminance grid and
    build row-marginal / per-row-conditional CDFs plus the solid-angle pdf
    per texel (pbrt-style 2D distribution). The pdf gets a 1% uniform-
    luminance floor so any texel the rasterization underestimates still has
    nonzero sampling probability (keeps the estimator unbiased)."""
    from ..shade.textures import eval_texture_dir

    Eh, Ew = ENV_TABLE_RES
    v = (np.arange(Eh) + 0.5) / Eh
    u = (np.arange(Ew) + 0.5) / Ew
    lat = ((v - 0.5) * np.pi).astype(np.float32)  # [-pi/2, pi/2]
    phi = (u * 2.0 * np.pi - np.pi).astype(np.float32)
    cos_lat = np.cos(lat)
    y = np.broadcast_to(np.sin(lat)[:, None], (Eh, Ew))
    x = cos_lat[:, None] * np.sin(phi)[None, :]
    z = cos_lat[:, None] * np.cos(phi)[None, :]
    dirs = np.stack([x, y, z], -1).reshape(-1, 3).astype(np.float32)

    class _Shim:  # eval_texture_dir only reads these two statics
        has_composite_textures = has_comp
        has_image_textures = has_img

    tid = jnp.full((dirs.shape[0],), int(bg_tex), jnp.int32)
    cc = jnp.broadcast_to(
        jnp.asarray(bg_color, jnp.float32), (dirs.shape[0], 3)
    )
    rad = np.asarray(
        eval_texture_dir(_Shim, pool, tid, jnp.asarray(dirs), cc)
    ) * float(bg_intensity)
    lum = (
        0.212671 * rad[:, 0] + 0.715160 * rad[:, 1] + 0.072169 * rad[:, 2]
    ).reshape(Eh, Ew)
    lum = np.maximum(lum, 0.0)
    mean_lum = float(lum.mean())
    if mean_lum <= 0.0:
        lum = np.ones_like(lum)
        mean_lum = 1.0
    w = (lum + 0.01 * mean_lum) * cos_lat[:, None]  # dOmega ~ cos(lat) du dv
    total = float(w.sum())
    row_w = w.sum(axis=1)
    row_cdf = np.zeros(Eh + 1, np.float64)
    row_cdf[1:] = np.cumsum(row_w) / total
    row_cdf[-1] = 1.0
    col_cdf = np.zeros((Eh, Ew + 1), np.float64)
    safe_row = np.where(row_w > 0.0, row_w, 1.0)
    col_cdf[:, 1:] = np.cumsum(w, axis=1) / safe_row[:, None]
    col_cdf[:, -1] = 1.0
    # p(u,v) = w/total * Eh*Ew; dOmega = 2 pi^2 cos(lat) du dv
    pdf = (w / total * (Eh * Ew)) / (
        2.0 * np.pi * np.pi * np.maximum(cos_lat[:, None], 1e-6)
    )
    return (
        jnp.asarray(row_cdf.astype(np.float32)),
        jnp.asarray(col_cdf.astype(np.float32)),
        jnp.asarray(pdf.astype(np.float32)),
    )


def compile_scene(
    scene: D.Scene, use_bvh: Optional[bool] = None
) -> Tuple[SceneArrays, SceneStatic]:
    """use_bvh: None = auto (BVH when the scene has >64 faces)."""
    packer = _TexturePacker(build_mips=bool(scene.mip_textures))
    mats = _MaterialBuilder(packer)

    Vs, Fs, Ns, UVs = [], [], [], []
    face_mesh = []
    mesh_material = []
    mesh_light = []
    mesh_has_normals = []
    mesh_has_uvs = []
    lights = []  # (mesh_id, AreaLight, face_start, face_count, areas)

    vert_off = 0
    face_off = 0
    for mi, mesh in enumerate(scene.meshes):
        V, F, N, UV = _load_mesh_arrays(mesh)
        nv, nf = len(V), len(F)
        Vs.append(V)
        Fs.append(F + vert_off)
        Ns.append(N if N is not None else np.zeros((nv, 3), np.float32))
        UVs.append(UV if UV is not None else np.zeros((nv, 2), np.float32))
        face_mesh.append(np.full(nf, mi, np.int32))
        mesh_material.append(mats.add(mesh.bsdf))
        mesh_has_normals.append(N is not None)
        mesh_has_uvs.append(UV is not None)
        if mesh.light is not None:
            p0 = V[F[:, 0]]
            e1 = V[F[:, 1]] - p0
            e2 = V[F[:, 2]] - p0
            areas = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)
            mesh_light.append(len(lights))
            lights.append((mi, mesh.light, face_off, nf, areas))
        else:
            mesh_light.append(-1)
        vert_off += nv
        face_off += nf

    V = np.concatenate(Vs) if Vs else np.zeros((0, 3), np.float32)
    F = np.concatenate(Fs) if Fs else np.zeros((0, 3), np.int32)
    N = np.concatenate(Ns) if Ns else np.zeros((0, 3), np.float32)
    UV = np.concatenate(UVs) if UVs else np.zeros((0, 2), np.float32)
    face_mesh = (
        np.concatenate(face_mesh) if face_mesh else np.zeros((0,), np.int32)
    )

    # lights: per-light triangle CDF over global face ids (mesh.cpp:31-44)
    L = len(lights)
    max_lf = max((lf for (_, _, _, lf, _) in lights), default=1)
    light_mesh = np.zeros((max(L, 1),), np.int32)
    light_radiance = np.zeros((max(L, 1), 3), np.float32)
    light_primary = np.zeros((max(L, 1),), bool)
    light_cdf = np.zeros((max(L, 1), max_lf + 1), np.float32)
    light_faces = np.zeros((max(L, 1), max_lf), np.int32)
    light_inv_area = np.ones((max(L, 1),), np.float32)
    for li, (mi, al, fstart, fcount, areas) in enumerate(lights):
        light_mesh[li] = mi
        light_radiance[li] = np.asarray(al.color, np.float32) * al.intensity
        light_primary[li] = al.primary_visibility
        total = float(areas.sum())
        cdf = np.concatenate([[0.0], np.cumsum(areas / total, dtype=np.float64)])
        cdf[-1] = 1.0
        light_cdf[li, : fcount + 1] = cdf.astype(np.float32)
        light_cdf[li, fcount + 1 :] = 1.0
        light_faces[li, :fcount] = np.arange(fstart, fstart + fcount, dtype=np.int32)
        light_faces[li, fcount:] = fstart + fcount - 1
        light_inv_area[li] = 1.0 / total

    # background
    if scene.background is not None:
        bg = scene.background
        tex = D.as_texture(bg.texture) if bg.texture is not None else D.ConstantTexture((0, 0, 0))
        if isinstance(tex, D.ConstantTexture):
            bg_color = np.asarray(tex.color, np.float32)
            bg_tex = -1
        else:
            bg_color = np.ones(3, np.float32)
            bg_tex = packer.add_node(tex)
        bg_intensity = float(bg.intensity)
        has_bg = True
        env_importance = bool(getattr(bg, "importance", False))
    else:
        bg_color = np.zeros(3, np.float32)
        bg_tex = -1
        bg_intensity = 1.0
        has_bg = False
        env_importance = False

    cam = scene.camera
    sample_to_camera = _sample_to_camera_matrix(cam)
    cam_to_world = (
        np.asarray(cam.to_world, np.float32)
        if cam.to_world is not None
        else np.eye(4, dtype=np.float32)
    )
    camera_kind = (
        "thinlens" if isinstance(cam, D.ThinlensCamera) else "perspective"
    )
    aperture = getattr(cam, "aperture_radius", 0.0)
    focus = getattr(cam, "focus_distance", 0.0)

    integ = scene.integrator
    if isinstance(integ, D.PathMis):
        integrator_kind = "path_mis"
        max_depth = min(512, integ.max_depth)
        trace_bias = integ.trace_bias
        regularization = integ.regularization
        accumulated_roughness = integ.accumulated_roughness
    else:
        integrator_kind = integ.kind
        max_depth = integ.max_depth
        trace_bias = 1e-3
        regularization = False
        accumulated_roughness = 0.5

    face_shade = np.concatenate(
        [
            V[F[:, 0]], V[F[:, 1]], V[F[:, 2]],
            N[F[:, 0]], N[F[:, 1]], N[F[:, 2]],
            UV[F[:, 0]], UV[F[:, 1]], UV[F[:, 2]],
        ],
        axis=1,
    ).astype(np.float32) if len(F) else np.zeros((0, 24), np.float32)

    if use_bvh is None:
        use_bvh = len(F) > 64
    bvh = None
    if use_bvh:
        from ..accel.bvh import build_bvh
        from ..utils.metrics import LOG

        bvh = build_bvh(V, F)
        LOG(f"BVH walk for {len(F)} faces: {backend.trace_backend()}")

    tex_pool = packer.finish()
    has_comp = any(t >= 2 for t in packer.ttypes)
    has_img = any(t == TEX_IMAGE for t in packer.ttypes)
    if env_importance:
        env_row_cdf, env_col_cdf, env_pdf = _build_env_tables(
            tex_pool, bg_tex, bg_color, bg_intensity, has_comp, has_img
        )
        env_res = ENV_TABLE_RES
    else:
        env_row_cdf = jnp.zeros(2, jnp.float32)
        env_col_cdf = jnp.zeros((1, 2), jnp.float32)
        env_pdf = jnp.zeros((1, 1), jnp.float32)
        env_res = (0, 0)

    arrays = SceneArrays(
        V=jnp.asarray(V),
        F=jnp.asarray(F),
        N=jnp.asarray(N),
        UV=jnp.asarray(UV),
        face_shade=jnp.asarray(face_shade),
        face_mesh=jnp.asarray(face_mesh),
        mesh_material=jnp.asarray(np.asarray(mesh_material, np.int32)),
        mesh_light=jnp.asarray(np.asarray(mesh_light, np.int32)),
        mesh_has_normals=jnp.asarray(np.asarray(mesh_has_normals, bool)),
        mesh_has_uvs=jnp.asarray(np.asarray(mesh_has_uvs, bool)),
        materials=mats.finish(),
        textures=tex_pool,
        light_mesh=jnp.asarray(light_mesh),
        light_radiance=jnp.asarray(light_radiance),
        light_primary_vis=jnp.asarray(light_primary),
        light_cdf=jnp.asarray(light_cdf),
        light_faces=jnp.asarray(light_faces),
        light_inv_area=jnp.asarray(light_inv_area),
        bg_color=jnp.asarray(bg_color),
        bg_tex=jnp.asarray(bg_tex, jnp.int32),
        bg_intensity=jnp.asarray(bg_intensity, jnp.float32),
        cam_to_world=jnp.asarray(cam_to_world),
        sample_to_camera=jnp.asarray(sample_to_camera),
        cam_near=jnp.asarray(cam.near_clip, jnp.float32),
        cam_far=jnp.asarray(cam.far_clip, jnp.float32),
        aperture_radius=jnp.asarray(aperture, jnp.float32),
        focus_distance=jnp.asarray(focus, jnp.float32),
        bvh=bvh,
        env_row_cdf=env_row_cdf,
        env_col_cdf=env_col_cdf,
        env_pdf=env_pdf,
    )
    static = SceneStatic(
        width=cam.width,
        height=cam.height,
        camera_kind=camera_kind,
        num_meshes=len(scene.meshes),
        num_materials=len(mats.rows),
        num_lights=L,
        btypes_present=tuple(sorted({int(r["btype"]) for r in mats.rows})),
        has_composite_textures=has_comp,
        has_image_textures=has_img,
        has_background=has_bg,
        sampler_kind=scene.sampler.kind,
        sample_count=scene.sampler.sample_count,
        seed=scene.sampler.seed,
        integrator_kind=integrator_kind,
        max_depth=max_depth,
        trace_bias=trace_bias,
        regularization=regularization,
        accumulated_roughness=accumulated_roughness,
        rfilter_kind=scene.rfilter.kind,
        rfilter_radius=scene.rfilter.radius,
        rfilter_stddev=scene.rfilter.stddev,
        rfilter_b=scene.rfilter.b,
        rfilter_c=scene.rfilter.c,
        env_importance=env_importance,
        env_res=env_res,
        mip_textures=bool(scene.mip_textures),
        aniso_textures=bool(getattr(scene, "aniso_textures", True)),
        pixel_cone=float(
            2.0 * np.tan(np.deg2rad(cam.fov) / 2.0) / cam.height
        ),
    )

    return arrays, static


def _sample_to_camera_matrix(cam: D.PerspectiveCamera) -> np.ndarray:
    """Perspective projection + screen mapping inverse (camera.cpp:35-63)."""
    aspect = cam.width / cam.height
    recip = 1.0 / (cam.far_clip - cam.near_clip)
    cot = 1.0 / np.tan(np.deg2rad(cam.fov / 2.0))
    perspective = np.array(
        [
            [cot, 0, 0, 0],
            [0, cot, 0, 0],
            [0, 0, cam.far_clip * recip, -cam.near_clip * cam.far_clip * recip],
            [0, 0, 1, 0],
        ],
        np.float64,
    )
    scale = np.diag([-0.5, -0.5 * aspect, 1.0, 1.0])
    translate = np.eye(4)
    translate[:3, 3] = [-1.0, -1.0 / aspect, 0.0]
    m = scale @ translate @ perspective
    return np.linalg.inv(m).astype(np.float32)
