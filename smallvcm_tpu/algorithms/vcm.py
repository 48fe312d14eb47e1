"""Wavefront Vertex Connection and Merging (lt / ppm / bpm / bpt / vcm).

Re-architecture of the reference's ``VertexCM`` (vertexcm.hxx:61-1031) — the
five-algorithm family switched by (use_vc, use_vm, light_trace_only, ppm)
static flags — as a four-stage wavefront pipeline over
component-planar (SoA) vectors:

  1. *Light stage*: all N light sub-paths advance one bounce per
     ``lax.fori_loop`` step; non-delta vertices land in fixed per-path slots
     ``[maxL, N]`` (replacing the ragged ``mPathEnds`` CSR pairing,
     vertexcm.hxx:311-312) and splat onto the framebuffer via differentiable
     scatter-add (ConnectToCamera).
  2. *Grid stage* (merging only): photons cell-sorted + compacted by ONE
     stable multi-operand lax.sort (see ops/hashgrid.py).
  3. *Camera stage*: camera sub-paths advance bounce-by-bounce doing
     hit-light radiance, NEE, and same-index light-path connections, with
     the dVCM/dVC/dVM MIS recursion carried per lane. Merge *queries*
     (the camera vertex + its MIS state) are recorded per bounce instead of
     merging inline.
  4. *Merge stage* (merging only): all recorded queries are processed in
     one pass — photons/queries are compacted, exact (query, photon)
     candidate pairs are expanded from the grid's CSR ranges (work scales
     with actual candidates, not padded cell capacity), distance-filtered,
     evaluated, and scatter-added back to the owning pixel; every per-pair
     data movement is a single wide-row gather (see merge_stage). Merging
     is additive and independent of the walk, so deferring it is exactly
     equivalent to the reference's inline loop.

The per-lane MIS recursion implements the tech-report equations exactly as
the reference does; [tech. rep. (NN)] refs use vertexcm.hxx's numbering.

Because camera path i connects only to light path i (vertexcm.hxx:498-526),
sharding both stages by path index makes vertex connection shard-local; only
the photon map needs cross-shard exchange (all-gather).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core import rng
from ..core.vec3 import V3, dot, len_sqr, max_gt_zero, v3_where
from ..core.vecmath import EPS_RAY, PI_F, pdf_w_to_a, sqr
from ..ops import bsdf as bsdf_ops
from ..ops import hashgrid as grid_ops
from ..ops import lights as light_ops
from ..ops.intersect import intersect, occluded
from ..scene.camera import check_raster, generate_ray, world_to_raster
from ..scene.scene import SceneData
from ..io.framebuffer import (add_color, add_color_at_pix, new_fb_planes,
                              splat_colors)


def _pad_mult(x: int, m: int) -> int:
    """Round x up to a multiple of m (query caps must split into chunks)."""
    return -(-x // m) * m


def _safe_div(a, b):
    return a / jnp.where(b == 0.0, 1.0, b)


def _mis(pdf):
    """Balance heuristic power (vertexcm.hxx:552-557)."""
    return pdf


class SubPathState(NamedTuple):
    """vertexcm.hxx:64-76 as SoA."""

    origin: V3
    direction: V3
    throughput: V3
    is_finite_light: jnp.ndarray  # [N] bool
    specular_path: jnp.ndarray    # [N] bool
    d_vcm: jnp.ndarray            # [N]
    d_vc: jnp.ndarray             # [N]
    d_vm: jnp.ndarray             # [N]
    alive: jnp.ndarray            # [N] bool


class StoredVertices(NamedTuple):
    """Fixed-slot vertex storage [L, N] (PathVertex, vertexcm.hxx:79-98).

    The vertex BSDF is reconstructed from (in_dir, normal, mat_id) at use
    time — Setup is deterministic, so this is exact and cheaper than
    storing frames/probabilities.
    """

    position: V3             # V3 of [L,N]
    throughput: V3
    in_dir: V3               # ray direction arriving at the vertex
    normal: V3
    mat_id: jnp.ndarray      # [L,N]
    d_vcm: jnp.ndarray
    d_vc: jnp.ndarray        # light: dVC; camera queries: unused
    d_vm: jnp.ndarray
    valid: jnp.ndarray       # [L,N] bool; slot i holds pathLength == i+1


class VcmMisc(NamedTuple):
    """Per-iteration constants (vertexcm.hxx:294-308)."""

    radius: jnp.ndarray
    radius_sqr: jnp.ndarray
    vm_normalization: jnp.ndarray
    mis_vm_weight: jnp.ndarray
    mis_vc_weight: jnp.ndarray
    light_sub_path_count: jnp.ndarray


def _empty_vertices(max_l: int, n: int) -> StoredVertices:
    zf = jnp.zeros((max_l, n), jnp.float32)
    zv = V3(zf, zf, zf)
    return StoredVertices(
        position=zv, throughput=zv, in_dir=zv, normal=zv,
        mat_id=jnp.zeros((max_l, n), jnp.int32),
        d_vcm=zf, d_vc=zf, d_vm=zf,
        valid=jnp.zeros((max_l, n), bool),
    )


def _store_slot(verts: StoredVertices, i, **fields) -> StoredVertices:
    upd = lambda arr, val: jax.lax.dynamic_update_index_in_dim(
        arr, val, i, axis=0
    )
    updv = lambda arr, val: V3(
        upd(arr.x, val.x), upd(arr.y, val.y), upd(arr.z, val.z)
    )
    return StoredVertices(
        position=updv(verts.position, fields["position"]),
        throughput=updv(verts.throughput, fields["throughput"]),
        in_dir=updv(verts.in_dir, fields["in_dir"]),
        normal=updv(verts.normal, fields["normal"]),
        mat_id=upd(verts.mat_id, fields["mat_id"]),
        d_vcm=upd(verts.d_vcm, fields["d_vcm"]),
        d_vc=upd(verts.d_vc, fields["d_vc"]),
        d_vm=upd(verts.d_vm, fields["d_vm"]),
        valid=upd(verts.valid, fields["valid"]),
    )


def compute_misc(
    scene: SceneData, iteration, n_light_paths, radius_factor, radius_alpha,
    use_vc: bool, use_vm: bool,
) -> VcmMisc:
    base_radius = radius_factor * scene.scene_sphere.radius
    radius = base_radius / jnp.power(
        jnp.asarray(iteration, jnp.float32) + 1.0,
        0.5 * (1.0 - radius_alpha),
    )
    radius = jnp.maximum(radius, 1e-7)
    radius_sqr = sqr(radius)
    count = jnp.asarray(n_light_paths, jnp.float32)
    eta_vcm = PI_F * radius_sqr * count
    return VcmMisc(
        radius=radius,
        radius_sqr=radius_sqr,
        vm_normalization=1.0 / (radius_sqr * PI_F * count),
        mis_vm_weight=_mis(eta_vcm) if use_vm else jnp.float32(0.0),
        mis_vc_weight=_mis(1.0 / eta_vcm) if use_vc else jnp.float32(0.0),
        light_sub_path_count=count,
    )


# ---------------------------------------------------------------------------
# Light stage
# ---------------------------------------------------------------------------


def generate_light_sample(
    scene: SceneData, misc: VcmMisc, pix, iteration, base_seed: int,
    rng_kind: str = "threefry",
) -> SubPathState:
    """GenerateLightSample (vertexcm.hxx:816-858)."""
    n = pix.shape[0]
    light_count = scene.lights.kind.shape[0]
    pick_prob = 1.0 / light_count

    u = rng.uniform_slots(
        base_seed, rng.make_stream(iteration, rng.STAGE_LIGHT_EMIT), pix, 5,
        rng_kind,
    )
    light_id = jnp.minimum(
        (u[:, 0] * light_count).astype(jnp.int32), light_count - 1
    )
    em = light_ops.emit(
        scene.lights, light_id, scene.scene_sphere,
        u[:, 1], u[:, 2], u[:, 3], u[:, 4],
    )
    emission_pdf = em.emission_pdf_w * pick_prob
    direct_pdf = em.direct_pdf_a * pick_prob

    throughput = em.energy * _safe_div(1.0, emission_pdf)

    d_vcm = _mis(_safe_div(direct_pdf, emission_pdf))
    used_cos = jnp.where(em.is_finite, em.cos_theta_light, 1.0)
    d_vc = jnp.where(em.is_delta, 0.0, _mis(_safe_div(used_cos, emission_pdf)))
    d_vm = d_vc * misc.mis_vc_weight

    return SubPathState(
        origin=em.position,
        direction=em.direction,
        throughput=throughput,
        is_finite_light=em.is_finite,
        specular_path=jnp.ones((n,), bool),
        d_vcm=d_vcm, d_vc=d_vc, d_vm=d_vm,
        alive=emission_pdf > 0.0,
    )


def connect_to_camera(
    scene: SceneData, misc: VcmMisc, state: SubPathState, hit_point: V3,
    b: bsdf_ops.BsdfState, enabled_mask, light_trace_only: bool,
):
    """ConnectToCamera (vertexcm.hxx:862-933) -> (raster_x, raster_y,
    contrib V3)."""
    cam = scene.camera
    dir_to_cam_raw = cam.position - hit_point
    in_front = dot(cam.forward, -dir_to_cam_raw) > 0.0

    rx, ry = world_to_raster(cam, hit_point)
    on_screen = check_raster(cam, rx, ry)

    dist_eye2 = jnp.maximum(len_sqr(dir_to_cam_raw), 1e-30)
    distance = jnp.sqrt(dist_eye2)
    dir_to_cam = dir_to_cam_raw * (1.0 / distance)

    factor, cos_to_cam, _, rev_pdf_w = bsdf_ops.evaluate(
        scene.materials, b, dir_to_cam
    )
    nonzero = max_gt_zero(factor)
    rev_pdf_w = rev_pdf_w * b.cont_prob

    cos_at_cam = dot(cam.forward, -dir_to_cam)
    img_to_cam_dist = _safe_div(cam.image_plane_dist, cos_at_cam)
    img_to_solid_angle = _safe_div(sqr(img_to_cam_dist), cos_at_cam)
    img_to_surface = img_to_solid_angle * jnp.abs(cos_to_cam) / dist_eye2
    camera_pdf_a = img_to_surface

    # [tech. rep. (46)]
    w_light = _mis(camera_pdf_a / misc.light_sub_path_count) * (
        misc.mis_vm_weight + state.d_vcm + state.d_vc * _mis(rev_pdf_w)
    )
    mis_weight = (
        jnp.ones_like(w_light) if light_trace_only else 1.0 / (w_light + 1.0)
    )

    surface_to_img = _safe_div(1.0, img_to_surface)
    scale = mis_weight * _safe_div(
        1.0, misc.light_sub_path_count * surface_to_img
    )
    contrib = state.throughput * factor * scale

    ok = enabled_mask & in_front & on_screen & nonzero & max_gt_zero(contrib)
    shadowed = occluded(scene, hit_point, dir_to_cam, distance)
    ok = ok & ~shadowed
    return rx, ry, v3_where(ok, contrib, 0.0), ok


def sample_scattering(
    scene: SceneData, misc: VcmMisc, state: SubPathState, hit_point: V3,
    b: bsdf_ops.BsdfState, u, fix_is_light: bool,
) -> SubPathState:
    """SampleScattering (vertexcm.hxx:937-1006) — masked wavefront version."""
    factor, new_dir, dir_pdf_w, cos_out, event, keep = bsdf_ops.sample(
        scene.materials, b, u[:, 0], u[:, 1], u[:, 2],
        fix_is_light=fix_is_light,
    )
    alive = state.alive & keep

    specular = (event & bsdf_ops.EV_SPECULAR) != 0
    _, rev_reverse = bsdf_ops.pdf(scene.materials, b, new_dir)
    rev_pdf_w = jnp.where(specular, dir_pdf_w, rev_reverse)

    cont = b.cont_prob
    alive = alive & (u[:, 3] <= cont)
    dir_pdf_w = dir_pdf_w * cont
    rev_pdf_w = rev_pdf_w * cont

    inv_dir_pdf = _safe_div(1.0, dir_pdf_w)
    cos_over_pdf = cos_out * inv_dir_pdf

    # Specular [tech. rep. (53)-(55)] / non-specular [(34)-(36)].
    d_vcm = jnp.where(specular, 0.0, _mis(inv_dir_pdf))
    d_vc = jnp.where(
        specular,
        state.d_vc * _mis(cos_out),
        _mis(cos_over_pdf)
        * (state.d_vc * _mis(rev_pdf_w) + state.d_vcm + misc.mis_vm_weight),
    )
    d_vm = jnp.where(
        specular,
        state.d_vm * _mis(cos_out),
        _mis(cos_over_pdf)
        * (state.d_vm * _mis(rev_pdf_w) + state.d_vcm * misc.mis_vc_weight + 1.0),
    )
    specular_path = state.specular_path & specular

    throughput = state.throughput * factor * cos_over_pdf

    sel = lambda new, old: jnp.where(alive, new, old)
    selv = lambda new, old: v3_where(alive, new, old)
    return SubPathState(
        origin=selv(hit_point, state.origin),
        direction=selv(new_dir, state.direction),
        throughput=selv(throughput, state.throughput),
        is_finite_light=state.is_finite_light,
        specular_path=sel(specular_path, state.specular_path),
        d_vcm=sel(d_vcm, state.d_vcm),
        d_vc=sel(d_vc, state.d_vc),
        d_vm=sel(d_vm, state.d_vm),
        alive=alive,
    )


def trace_light_paths(
    scene: SceneData, misc: VcmMisc, pix, iteration, fb,
    base_seed: int, max_path_length: int, min_path_length: int,
    use_vc: bool, use_vm: bool, light_trace_only: bool,
    rng_kind: str = "threefry",
):
    """Light stage (vertexcm.hxx:321-396) -> (vertices, fb, ray_count)."""
    n = pix.shape[0]
    max_l = max(1, max_path_length - 1)
    store_vertices = use_vc or use_vm
    connect_cam = use_vc or light_trace_only

    state = generate_light_sample(scene, misc, pix, iteration, base_seed,
                                  rng_kind)
    verts = _empty_vertices(max_l, n)
    # Deferred camera-connection splats: per-bounce scatter-adds were 88%
    # of lt's iteration time (scripts/profile_lt.py); bounces record
    # (pixel, rgb) rows here and ONE sorted 3-wide scatter flushes them
    # after the walk (io/framebuffer.py::splat_colors).
    res_y_fb, res_x_fb = fb.x.shape
    pix_sentinel = jnp.int32(res_x_fb * res_y_fb)
    if connect_cam:
        splat_pix0 = jnp.full((max_l, n), pix_sentinel, jnp.int32)
        splat_rgb0 = V3(*(jnp.zeros((max_l, n), jnp.float32)
                          for _ in range(3)))
    else:  # keep the carry free of dead [max_l, n] buffers
        splat_pix0 = jnp.zeros((0,), jnp.int32)
        splat_rgb0 = V3(*(jnp.zeros((0,), jnp.float32) for _ in range(3)))

    def bounce(i, carry):
        state, verts, splat_pix, splat_rgb, fb, rays = carry
        path_length = i + 1

        rays = rays + jnp.sum(state.alive.astype(jnp.int32))
        org = state.origin + state.direction * EPS_RAY
        hit = intersect(scene, org, state.direction)
        alive = state.alive & hit.hit
        dist_safe = jnp.where(hit.hit, hit.dist, 1.0)
        hit_point = org + state.direction * dist_safe
        isect_dist = dist_safe + EPS_RAY

        b = bsdf_ops.setup(
            scene.materials, state.direction, hit.normal, hit.mat_id, hit.hit
        )
        alive = alive & b.valid

        # MIS completion after tracing (vertexcm.hxx:351-360), masked by
        # alive so dead lanes can't overflow/NaN.
        infinite_first = (path_length == 1) & ~state.is_finite_light
        d_vcm = jnp.where(
            infinite_first, state.d_vcm, state.d_vcm * _mis(sqr(isect_dist))
        )
        abs_cos = jnp.abs(b.cos_theta_fix())
        inv_cos = _safe_div(1.0, _mis(abs_cos))
        state = state._replace(
            d_vcm=jnp.where(alive, d_vcm * inv_cos, state.d_vcm),
            d_vc=jnp.where(alive, state.d_vc * inv_cos, state.d_vc),
            d_vm=jnp.where(alive, state.d_vm * inv_cos, state.d_vm),
            alive=alive,
        )

        # Store vertex (vertexcm.hxx:364-377).
        if store_vertices:
            can_store = alive & ~b.is_delta
            verts = _store_slot(
                verts, i,
                position=hit_point, throughput=state.throughput,
                in_dir=state.direction, normal=hit.normal,
                mat_id=hit.mat_id, d_vcm=state.d_vcm, d_vc=state.d_vc,
                d_vm=state.d_vm, valid=can_store,
            )

        # Connect to camera (vertexcm.hxx:380-384).
        if connect_cam:
            enabled = (
                alive & ~b.is_delta & (path_length + 1 >= min_path_length)
            )
            rx, ry, contrib, cast = connect_to_camera(
                scene, misc, state, hit_point, b, enabled, light_trace_only
            )
            # Record the splat; AddColor's floor/drop semantics
            # (framebuffer.hxx:43-57) via the sentinel for any dead/OOB row.
            px_i = jnp.floor(rx).astype(jnp.int32)
            py_i = jnp.floor(ry).astype(jnp.int32)
            pix1d = jnp.where(
                cast & (rx >= 0) & (ry >= 0) & (px_i < res_x_fb)
                & (py_i < res_y_fb),
                py_i * res_x_fb + px_i, pix_sentinel,
            )
            upd1 = lambda a, v: jax.lax.dynamic_update_index_in_dim(
                a, v, i, axis=0
            )
            splat_pix = upd1(splat_pix, pix1d)
            splat_rgb = V3(upd1(splat_rgb.x, contrib.x),
                           upd1(splat_rgb.y, contrib.y),
                           upd1(splat_rgb.z, contrib.z))
            rays = rays + jnp.sum(enabled.astype(jnp.int32))  # shadow rays

        # Path-too-long termination (vertexcm.hxx:387).
        state = state._replace(
            alive=alive & (path_length + 2 <= max_path_length)
        )

        u = rng.uniform_slots(
            base_seed,
            rng.make_stream(iteration, rng.STAGE_LIGHT_WALK, i),
            pix, 4, rng_kind,
        )
        state = sample_scattering(
            scene, misc, state, hit_point, b, u, fix_is_light=True
        )
        return state, verts, splat_pix, splat_rgb, fb, rays

    state, verts, splat_pix, splat_rgb, fb, rays = jax.lax.fori_loop(
        0, max_l, bounce,
        (state, verts, splat_pix0, splat_rgb0, fb,
         jnp.zeros((), jnp.int32)),
    )
    if connect_cam:
        fb = splat_colors(fb, splat_pix, splat_rgb)
    return verts, fb, rays


# ---------------------------------------------------------------------------
# Camera stage helpers
# ---------------------------------------------------------------------------


def generate_camera_sample(
    scene: SceneData, misc: VcmMisc, pix, res_x: int, iteration,
    base_seed: int, rng_kind: str = "threefry",
):
    """GenerateCameraSample (vertexcm.hxx:564-606)."""
    n = pix.shape[0]
    cam = scene.camera
    x = (pix % res_x).astype(jnp.float32)
    y = (pix // res_x).astype(jnp.float32)
    jitter = rng.uniform_slots(
        base_seed, rng.make_stream(iteration, rng.STAGE_CAMERA_JITTER), pix, 2,
        rng_kind,
    )
    sx = x + jitter[:, 0]
    sy = y + jitter[:, 1]

    org, direction = generate_ray(cam, sx, sy)
    cos_at_cam = dot(cam.forward, direction)
    img_to_cam_dist = cam.image_plane_dist / cos_at_cam
    camera_pdf_w = sqr(img_to_cam_dist) / cos_at_cam

    ones = jnp.ones((n,), jnp.float32)
    zeros = jnp.zeros((n,), jnp.float32)
    state = SubPathState(
        origin=org,
        direction=direction,
        throughput=V3(ones, ones, ones),
        is_finite_light=jnp.zeros((n,), bool),
        specular_path=jnp.ones((n,), bool),
        d_vcm=_mis(misc.light_sub_path_count / camera_pdf_w),
        d_vc=zeros,
        d_vm=zeros,
        alive=jnp.ones((n,), bool),
    )
    return sx, sy, state


def get_light_radiance_weighted(
    scene: SceneData, state: SubPathState, light_id, ray_dir: V3, path_length,
    use_vc: bool, use_vm: bool,
) -> V3:
    """GetLightRadiance (vertexcm.hxx:617-658): radiance * MIS weight."""
    light_count = scene.lights.kind.shape[0]
    pick_prob = 1.0 / light_count

    lr = light_ops.get_radiance(
        scene.lights, light_id, scene.scene_sphere, ray_dir
    )
    nonzero = max_gt_zero(lr.radiance)

    direct_pdf = lr.direct_pdf_a * pick_prob
    emission_pdf = lr.emission_pdf_w * pick_prob

    # [tech. rep. (42)-(43)]
    w_camera = _mis(direct_pdf) * state.d_vcm + _mis(emission_pdf) * state.d_vc
    mis_weight = 1.0 / (1.0 + w_camera)

    if use_vm and not use_vc:  # merging-only: purely specular paths only
        weighted = v3_where(state.specular_path, lr.radiance, 0.0)
    else:
        weighted = lr.radiance * mis_weight
    weighted = v3_where(path_length == 1, lr.radiance, weighted)
    return v3_where(nonzero, weighted, 0.0)


def direct_illumination(
    scene: SceneData, misc: VcmMisc, state: SubPathState, hit_point: V3,
    b: bsdf_ops.BsdfState, u3,
) -> V3:
    """DirectIllumination (vertexcm.hxx:663-738): NEE contribution."""
    light_count = scene.lights.kind.shape[0]
    pick_prob = 1.0 / light_count

    light_id = jnp.minimum(
        (u3[:, 0] * light_count).astype(jnp.int32), light_count - 1
    )
    ill = light_ops.illuminate(
        scene.lights, light_id, scene.scene_sphere, hit_point,
        u3[:, 1], u3[:, 2],
    )
    ok = max_gt_zero(ill.radiance)

    factor, cos_to_light, dir_pdf_w, rev_pdf_w = bsdf_ops.evaluate(
        scene.materials, b, ill.dir_to_light
    )
    ok = ok & max_gt_zero(factor)

    cont = b.cont_prob
    light_is_delta = scene.lights.is_delta[
        jnp.clip(light_id, 0, light_count - 1)
    ]
    dir_pdf_w = jnp.where(light_is_delta, 0.0, dir_pdf_w * cont)
    rev_pdf_w = rev_pdf_w * cont

    # [tech. rep. (44)]
    w_light = _mis(_safe_div(dir_pdf_w, pick_prob * ill.direct_pdf_w))
    # [tech. rep. (45)]
    ratio = _safe_div(
        ill.emission_pdf_w * cos_to_light,
        ill.direct_pdf_w * ill.cos_at_light,
    )
    w_camera = _mis(ratio) * (
        misc.mis_vm_weight + state.d_vcm + state.d_vc * _mis(rev_pdf_w)
    )
    mis_weight = 1.0 / (w_light + 1.0 + w_camera)

    contrib = (ill.radiance * factor) * (
        mis_weight * cos_to_light * _safe_div(
            1.0, pick_prob * ill.direct_pdf_w
        )
    )

    ok = ok & max_gt_zero(contrib)
    shadowed = occluded(scene, hit_point, ill.dir_to_light, ill.distance)
    return v3_where(ok & ~shadowed, contrib, 0.0)


def connect_vertices(
    scene: SceneData, misc: VcmMisc, cam_d_vcm, cam_d_vc, cam_hit: V3,
    cam_b: bsdf_ops.BsdfState, lv_pos: V3, lv_in_dir: V3, lv_normal: V3,
    lv_mat, lv_d_vcm, lv_d_vc, lv_valid,
) -> V3:
    """ConnectVertices (vertexcm.hxx:743-809): contribution (without the
    camera/light throughputs, which the caller multiplies).

    All operands may be [maxL*N]-flat: the camera stage batches every
    (camera vertex, stored light vertex) pair of a bounce into ONE call so
    the occlusion sweep and BSDF evaluations run at full width instead of
    maxL sequential N-lane launches."""
    direction_raw = lv_pos - cam_hit
    dist2 = jnp.maximum(len_sqr(direction_raw), 1e-30)
    distance = jnp.sqrt(dist2)
    direction = direction_raw * (1.0 / distance)

    cam_factor, cos_camera, cam_dir_pdf_w, cam_rev_pdf_w = bsdf_ops.evaluate(
        scene.materials, cam_b, direction
    )
    ok = max_gt_zero(cam_factor)

    cam_cont = cam_b.cont_prob
    cam_dir_pdf_w = cam_dir_pdf_w * cam_cont
    cam_rev_pdf_w = cam_rev_pdf_w * cam_cont

    # Reconstruct the light vertex BSDF (deterministic Setup re-run).
    lb = bsdf_ops.setup(scene.materials, lv_in_dir, lv_normal, lv_mat, lv_valid)
    light_factor, cos_light, light_dir_pdf_w, light_rev_pdf_w = (
        bsdf_ops.evaluate(scene.materials, lb, -direction)
    )
    ok = ok & max_gt_zero(light_factor)

    light_cont = lb.cont_prob
    light_dir_pdf_w = light_dir_pdf_w * light_cont
    light_rev_pdf_w = light_rev_pdf_w * light_cont

    geometry_term = cos_light * cos_camera / dist2
    ok = ok & (geometry_term >= 0.0)

    cam_dir_pdf_a = pdf_w_to_a(cam_dir_pdf_w, distance, cos_light)
    light_dir_pdf_a = pdf_w_to_a(light_dir_pdf_w, distance, cos_camera)

    # [tech. rep. (40)-(41)]
    w_light = _mis(cam_dir_pdf_a) * (
        misc.mis_vm_weight + lv_d_vcm + lv_d_vc * _mis(light_rev_pdf_w)
    )
    w_camera = _mis(light_dir_pdf_a) * (
        misc.mis_vm_weight + cam_d_vcm
        + cam_d_vc * _mis(cam_rev_pdf_w)
    )
    mis_weight = 1.0 / (w_light + 1.0 + w_camera)

    contrib = cam_factor * light_factor * (mis_weight * geometry_term)
    ok = ok & max_gt_zero(contrib) & lv_valid
    shadowed = occluded(scene, cam_hit, direction, distance)
    return v3_where(ok & ~shadowed, contrib, 0.0)


# ---------------------------------------------------------------------------
# Deferred merge stage
# ---------------------------------------------------------------------------


def merge_stage(
    scene: SceneData, misc: VcmMisc, queries: StoredVertices,
    light_verts: StoredVertices, num_cells: int, pair_cap: int, ppm: bool,
    max_path_length: int, min_path_length: int,
    photon_cap: int, query_cap: int, n_paths: int, merge_chunks: int = 1,
):
    """Vertex merging over all recorded camera queries in one pass.

    Implements RangeQuery::Process (vertexcm.hxx:130-169): for every camera
    vertex, every light vertex within the merge radius contributes
    mis * f_s(camera, photon_dir) * photon_throughput, summed and scaled by
    vm_normalization * camera_throughput.

    Every data movement here is (a) compacted first — only ~15% of the
    fixed [maxLen, N] vertex/query slots are live — and (b) moved as ONE
    wide-row gather per pair/survivor instead of one gather per field:

      1. compact photons -> [photon_cap] (narrow index scatter + wide
         payload gather), cell-hash and radix-sort them, and pre-permute the
         payload into cell order so pairs index photons by sorted position
         with no indirection;
      2. compact queries -> [query_cap], probe the 8-cell neighborhood
         (hashgrid.hxx:124-138) with per-cell (start,count) ROW gathers, and
         bake everything a pair will need into one int32 row per query
         (CSR offset, position bits, path length, per-cell boundaries);
      3. expand pairs by segment-carry (scatter segment heads + cummax),
         then ONE row gather each of the query row and the photon
         position row gives the exact r^2 test (no quantization) and the
         path-length window (vertexcm.hxx:132-135);
      4. compact survivors with a single keys-only sort (flag|pair_id keys),
         gather full f32 payload rows for survivors only, run the BSDF +
         MIS [tech. rep. (38)-(39)] math, and scatter-add per query.

    Returns (color_add V3 [n_paths] — per-path merge radiance already scaled
    by camera throughput and vm normalization, overflow scalar (any dropped
    photon/query/pair/survivor; caller must retry with bigger caps for an
    exact image), total_pairs scalar (for right-sizing pair_cap)).
    """
    lq, n = queries.valid.shape
    ll, n_ph = light_verts.valid.shape  # n_ph may exceed n (all-gathered)
    mq = lq * n
    m = ll * n_ph
    assert n == n_paths

    flat = lambda a: a.reshape((-1,))
    sg = jax.lax.stop_gradient
    f2i = lambda a: jax.lax.bitcast_convert_type(sg(a), jnp.int32)
    i2f = lambda a: jax.lax.bitcast_convert_type(a, jnp.float32)

    # Payload planes [14, M]: pos3 | in_dir3 | normal3 | throughput3 |
    # d_vcm | d_vm, stacked planar (axis=0).
    def payload_planes(v: StoredVertices):
        cols = [
            flat(v.position.x), flat(v.position.y), flat(v.position.z),
            flat(v.in_dir.x), flat(v.in_dir.y), flat(v.in_dir.z),
            flat(v.normal.x), flat(v.normal.y), flat(v.normal.z),
            flat(v.throughput.x), flat(v.throughput.y), flat(v.throughput.z),
            flat(v.d_vcm), flat(v.d_vm),
        ]
        return jnp.stack(cols, axis=0)  # [14, M]

    # ---- 1. Photons: hash at full width, ONE sort-compact. ---------------
    # The cell key is computed at source width; a single stable (key,
    # iota) lax.sort + one [14, cap] payload gather compacts and
    # cell-orders the photons.
    pvalid_f = flat(light_verts.valid)
    n_p = jnp.sum(pvalid_f.astype(jnp.int32))
    ovf_p = jnp.maximum(n_p - photon_cap, 0)
    pvalid_c = jnp.arange(photon_cap, dtype=jnp.int32) < n_p

    px_f, py_f, pz_f = (
        sg(flat(light_verts.position.x)),
        sg(flat(light_verts.position.y)),
        sg(flat(light_verts.position.z)),
    )
    big = jnp.float32(1e36)
    vmin = lambda a: jnp.min(jnp.where(pvalid_f, a, big))
    vmax = lambda a: jnp.max(jnp.where(pvalid_f, a, -big))
    mnx, mny, mnz = vmin(px_f), vmin(py_f), vmin(pz_f)
    mxx, mxy, mxz = vmax(px_f), vmax(py_f), vmax(pz_f)
    inv_cell = sg(1.0 / (misc.radius * 2.0))           # hashgrid.hxx:64

    def cell_of(x, y, z):
        return (
            jnp.floor((x - mnx) * inv_cell).astype(jnp.int32),
            jnp.floor((y - mny) * inv_cell).astype(jnp.int32),
            jnp.floor((z - mnz) * inv_cell).astype(jnp.int32),
        )

    h_f = grid_ops._hash_cell(*cell_of(px_f, py_f, pz_f), num_cells)
    h_f = jnp.where(pvalid_f, h_f, jnp.int32(num_cells))  # sentinel cell
    pplanes = jnp.concatenate(
        [payload_planes(light_verts),
         sg(i2f(flat(light_verts.mat_id)))[None, :]], axis=0
    )  # [15, M]
    pf_s, src_p = grid_ops.sort_compact_planes(
        h_f.astype(jnp.uint32), pplanes, photon_cap
    )  # cell-sorted compacted payload [15, photon_cap]
    p_mat_s = f2i(pf_s[14])
    p_len_s = src_p // n_ph + 1                        # slot i = length i+1

    # Histogram/CSR from the sentinel-keyed full-width hashes.
    cell_count = jnp.zeros((num_cells,), jnp.int32).at[h_f].add(
        1, mode="drop"
    )
    cell_start = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32),
         jnp.cumsum(cell_count)[:-1].astype(jnp.int32)]
    )
    cell_tbl = jnp.stack([cell_start, cell_count], axis=1)  # [C, 2]
    # Phase-1 photon row: position bits + path length, one gather per pair.
    p1 = jnp.stack(
        [f2i(pf_s[0]), f2i(pf_s[1]), f2i(pf_s[2]), p_len_s], axis=1
    )

    # ---- 2. Queries: compact + per-query pair-expansion row. --------------
    # Order-preserving compaction as a stable sort on the validity bit
    # (iota tiebreak keeps live relative order — same result as the old
    # cumsum-scatter compact_indices, minus its full-width scatter and
    # separate payload gather).
    qvalid_f = flat(queries.valid)
    n_q = jnp.sum(qvalid_f.astype(jnp.int32))
    ovf_q = jnp.maximum(n_q - query_cap, 0)
    qvalid_c = jnp.arange(query_cap, dtype=jnp.int32) < n_q
    qplanes = jnp.concatenate(
        [payload_planes(queries),
         sg(i2f(flat(queries.mat_id)))[None, :]], axis=0
    )  # [15, M]
    qf_c, idx_q = grid_ops.sort_compact_planes(
        (~qvalid_f).astype(jnp.uint32), qplanes, query_cap
    )
    q_mat_c = f2i(qf_c[14])
    q_len_c = idx_q // n + 1
    q_path_c = (idx_q % n).astype(jnp.int32)            # owning path/pixel

    qx, qy, qz = sg(qf_c[0]), sg(qf_c[1]), sg(qf_c[2])
    # Query-side bbox rejection (hashgrid.hxx:116-122) PADDED by the merge
    # radius: camera hit points on a photon-bearing plane can land a few
    # f32 ULPs outside the tight photon bbox (the floor plane loses ~2% of
    # in-radius pairs at 256^2, measured), and the 2x2x2 probe is
    # geometrically valid for any query within r of a photon. The reference
    # only survives this because its identically-computed camera/photon hit
    # points happen to overlap in f32.
    pad = sg(misc.radius)
    in_bbox = (
        (qx >= mnx - pad) & (qx <= mxx + pad)
        & (qy >= mny - pad) & (qy <= mxy + pad)
        & (qz >= mnz - pad) & (qz <= mxz + pad)
    )
    bx, by, bz = cell_of(qx, qy, qz)
    # Nearest 2x2x2 neighborhood by fractional part (hashgrid.hxx:124-138).
    frac = lambda a, mn: (a - mn) * inv_cell
    pick = lambda r: jnp.where(r - jnp.floor(r) < 0.5, -1, 1).astype(
        jnp.int32
    )
    sx = pick(frac(qx, mnx))
    sy = pick(frac(qy, mny))
    sz = pick(frac(qz, mnz))

    starts8 = []
    counts8 = []
    live = qvalid_c & in_bbox
    for bit in range(8):
        hc = grid_ops._hash_cell(
            bx + (sx if bit & 1 else 0),
            by + (sy if bit & 2 else 0),
            bz + (sz if bit & 4 else 0),
            num_cells,
        )
        rc = cell_tbl[hc]                               # [query_cap, 2] row
        starts8.append(rc[:, 0])
        counts8.append(jnp.where(live, rc[:, 1], 0))
    starts8 = jnp.stack(starts8, axis=1)                # [query_cap, 8]
    counts8 = jnp.stack(counts8, axis=1)

    per_q = jnp.sum(counts8, axis=1)

    # Inclusive per-cell boundaries b1..b8 and start-minus-prefix adjust so a
    # pair recovers its photon slot as adj_j + rank with pure arithmetic.
    incl = jnp.cumsum(counts8, axis=1)                  # [query_cap, 8]
    excl = incl - counts8
    adj = starts8 - excl
    # Query row: [xbits ybits zbits | len | b1..b8 | adj0..adj7]; the pair-
    # expansion offset column is prepended per chunk below.
    qrow20 = jnp.concatenate(
        [
            f2i(qx)[:, None], f2i(qy)[:, None], f2i(qz)[:, None],
            q_len_c[:, None], incl, adj,
        ],
        axis=1,
    )  # [query_cap, 20]

    # ---- 3+4. Pair expansion, prefilter, and evaluation — per query chunk.
    # Pair-level arrays dominate merge memory (candidate pairs grow with
    # photon DENSITY, i.e. quadratically with resolution at fixed radius);
    # chunking the compacted query axis bounds them: per-chunk caps are
    # pair_cap / merge_chunks while total work and results are unchanged.
    assert query_cap % merge_chunks == 0, "query_cap % merge_chunks != 0"
    qc_n = query_cap // merge_chunks
    # Per-chunk cap with 1.5x slack: pairs are NOT evenly distributed
    # across query chunks (measured: a 2-chunk split overflowed at 512^2
    # even though the total cap covered total pairs with 30% margin).
    pair_cap_c = max(
        pair_cap // merge_chunks
        + (pair_cap // (2 * merge_chunks) if merge_chunks > 1 else 0),
        1024,
    )
    surv_cap = min(pair_cap_c, max(pair_cap_c // 4, 1024))
    rv3 = lambda r, i: V3(r[i], r[i + 1], r[i + 2])  # planar [14, K] reads

    def chunk_body(c, carry):
        acc_x, acc_y, acc_z, ovf, pairs_total = carry
        base = c * qc_n
        sl = lambda a: jax.lax.dynamic_slice_in_dim(a, base, qc_n)

        per_q_ch = sl(per_q)
        offs = jnp.concatenate(
            [jnp.zeros((1,), jnp.int32),
             jnp.cumsum(per_q_ch)[:-1].astype(jnp.int32)]
        )
        total_ch = offs[-1] + per_q_ch[-1]
        ovf = ovf + jnp.maximum(total_ch - pair_cap_c, 0)
        pairs_total = pairs_total + total_ch

        qrow = jnp.concatenate(
            [offs[:, None],
             jax.lax.dynamic_slice_in_dim(qrow20, base, qc_n, axis=0)],
            axis=1,
        )  # [qc_n, 21]

        seg_head = jnp.zeros((pair_cap_c,), jnp.int32).at[offs].max(
            jnp.where(per_q_ch > 0, jnp.arange(qc_n, dtype=jnp.int32), 0),
            mode="drop",
        )
        qseg = jax.lax.cummax(seg_head)
        qr = qrow[qseg]                                 # [pair_cap_c, 21]

        p_iota = jnp.arange(pair_cap_c, dtype=jnp.int32)
        rank = p_iota - qr[:, 0]
        pair_ok = (p_iota < total_ch) & (rank >= 0) & (rank < qr[:, 12])
        # Cell pick: smallest j with rank < b_{j+1}.
        php = qr[:, 20]
        for j in range(6, -1, -1):
            php = jnp.where(rank < qr[:, 5 + j], qr[:, 13 + j], php)
        php = php + rank
        php_safe = jnp.clip(php, 0, photon_cap - 1)

        pr = p1[php_safe]                               # [pair_cap_c, 4]
        dx = i2f(pr[:, 0]) - i2f(qr[:, 1])
        dy = i2f(pr[:, 1]) - i2f(qr[:, 2])
        dz = i2f(pr[:, 2]) - i2f(qr[:, 3])
        pair_ok = pair_ok & (
            dx * dx + dy * dy + dz * dz <= misc.radius_sqr
        )
        # Path length window (vertexcm.hxx:132-135).
        total_len = pr[:, 3] + qr[:, 4]
        pair_ok = pair_ok & (total_len <= max_path_length) & (
            total_len >= min_path_length
        )

        # Survivor compaction via one keys-only sort (flag | pair id).
        key = jnp.where(pair_ok, p_iota, p_iota | (1 << 30)).astype(
            jnp.uint32
        )
        p_c = (jnp.sort(key)[:surv_cap] & jnp.uint32((1 << 30) - 1)).astype(
            jnp.int32
        )
        n_surv = jnp.sum(pair_ok.astype(jnp.int32))
        ovf = ovf + jnp.maximum(n_surv - surv_cap, 0)
        ok2 = jnp.arange(surv_cap, dtype=jnp.int32) < n_surv

        meta = jnp.stack([qseg, php_safe], axis=1)      # [pair_cap_c, 2]
        meta_c = meta[p_c]
        qs_g = meta_c[:, 0] + base                      # global query index
        pp_c = meta_c[:, 1]

        prow = pf_s[:, pp_c]                            # [14, surv_cap]
        qrow_f = qf_c[:, qs_g]

        cam_b = bsdf_ops.setup(
            scene.materials, rv3(qrow_f, 3), rv3(qrow_f, 6), q_mat_c[qs_g],
            ok2,
        )
        ph_in = rv3(prow, 3)
        # Light-vertex continuation probability: reconstruct its BSDF setup.
        ph_b = bsdf_ops.setup(
            scene.materials, ph_in, rv3(prow, 6), p_mat_s[pp_c], ok2
        )

        light_dir = -ph_in  # the photon's WorldDirFix
        factor, _, dir_pdf_w, rev_pdf_w = bsdf_ops.evaluate(
            scene.materials, cam_b, light_dir
        )
        ok2 = ok2 & max_gt_zero(factor)

        dir_pdf_w = dir_pdf_w * cam_b.cont_prob
        rev_pdf_w = rev_pdf_w * ph_b.cont_prob

        # [tech. rep. (38)-(39)]
        w_light = prow[12] * misc.mis_vc_weight + \
            prow[13] * _mis(dir_pdf_w)
        w_camera = qrow_f[12] * misc.mis_vc_weight + \
            qrow_f[13] * _mis(rev_pdf_w)
        if ppm:
            mis_weight = jnp.ones_like(w_light)
        else:
            mis_weight = 1.0 / (w_light + 1.0 + w_camera)

        contrib = factor * rv3(prow, 9) * mis_weight
        contrib = v3_where(ok2, contrib, 0.0)

        qdst = jnp.where(ok2, qs_g, query_cap)
        return (
            acc_x.at[qdst].add(contrib.x, mode="drop"),
            acc_y.at[qdst].add(contrib.y, mode="drop"),
            acc_z.at[qdst].add(contrib.z, mode="drop"),
            ovf, pairs_total,
        )

    qz_acc = jnp.zeros((query_cap,), jnp.float32)
    zi = jnp.zeros((), jnp.int32)
    if merge_chunks == 1:
        acc_x, acc_y, acc_z, ovf_pe, total_pairs = chunk_body(
            0, (qz_acc, qz_acc, qz_acc, zi, zi)
        )
    else:
        acc_x, acc_y, acc_z, ovf_pe, total_pairs = jax.lax.fori_loop(
            0, merge_chunks, chunk_body, (qz_acc, qz_acc, qz_acc, zi, zi)
        )
    # Scale by the camera throughput + the vm normalization and route to
    # the owning path.
    acc = V3(acc_x, acc_y, acc_z)
    acc = acc * V3(qf_c[9], qf_c[10], qf_c[11]) * misc.vm_normalization

    pz_out = jnp.zeros((n,), jnp.float32)
    pdst = jnp.where(qvalid_c, q_path_c, n)
    color_add = V3(
        pz_out.at[pdst].add(acc.x, mode="drop"),
        pz_out.at[pdst].add(acc.y, mode="drop"),
        pz_out.at[pdst].add(acc.z, mode="drop"),
    )
    overflow = ovf_p + ovf_q + ovf_pe
    # stats = [candidate pairs, live photons, live queries]. n_p/n_q (from
    # compact_indices) are exact unconditionally; the candidate-pair count
    # is exact only when the photon and query caps did NOT overflow (a
    # truncated photon set builds a smaller cell table, hiding pairs) —
    # drivers must re-probe after growing those caps (see render.py's
    # ladder and bench.py's probe loop).
    stats = jnp.stack([total_pairs, n_p, n_q])
    return color_add, overflow, stats


# ---------------------------------------------------------------------------
# Full iteration
# ---------------------------------------------------------------------------


def render_iteration_core(
    scene: SceneData,
    iteration,
    pix,
    res_x: int,
    res_y: int,
    n_paths_global: int,
    base_seed: int = 1234,
    max_path_length: int = 10,
    min_path_length: int = 0,
    radius_factor: float = 0.003,
    radius_alpha: float = 0.75,
    use_vc: bool = True,
    use_vm: bool = True,
    light_trace_only: bool = False,
    ppm: bool = False,
    pair_factor: float = 24.0,
    photon_factor: float = 3.0,
    query_factor: float = 3.0,
    vm_exchange: str = "allgather",
    rng_kind: str = "threefry",
    merge_chunks: int = 1,
    axis_name: str | None = None,
    camera_unroll: str = "auto",
):
    """One VCM-family iteration over the given (possibly sharded) path ids.

    ``pix`` holds *global* path/pixel indices — RNG streams and the camera
    pixel mapping depend only on them, so any partition of
    ``arange(n_paths_global)`` over devices reproduces the single-device
    image exactly. With ``axis_name`` set (inside shard_map), light vertices
    are all-gathered for merging (the only cross-shard data dependency).
    MIS constants always use the *global* light path count
    (vertexcm.hxx:303-308). Returns (fb V3 planes -> array, ray_count).
    """
    n = pix.shape[0]
    misc = compute_misc(
        scene, iteration, n_paths_global, radius_factor, radius_alpha,
        use_vc, use_vm,
    )

    fb = new_fb_planes(res_x, res_y)

    # ---- Stage 1: light sub-paths.
    verts, fb, ray_count = trace_light_paths(
        scene, misc, pix, iteration, fb, base_seed, max_path_length,
        min_path_length, use_vc, use_vm, light_trace_only, rng_kind,
    )

    if light_trace_only:
        out = fb.to_array()
        if axis_name is not None:
            out = jax.lax.psum(out, axis_name)
            ray_count = jax.lax.psum(ray_count, axis_name)
        return (out, ray_count, jnp.zeros((), jnp.int32),
                jnp.zeros((3,), jnp.int32))

    color, queries, light_verts_global, sx, sy, cam_rays = _camera_stage(
        scene, misc, verts, pix, iteration, res_x, base_seed,
        max_path_length, min_path_length, use_vc, use_vm, ppm, rng_kind,
        vm_exchange, axis_name, _resolve_unroll(camera_unroll),
    )
    ray_count = ray_count + cam_rays
    return _merge_finish(
        scene, misc, n, n_paths_global, verts, fb, color, queries,
        light_verts_global, pix, sx, sy, ray_count,
        max_path_length, min_path_length, use_vm, ppm,
        pair_factor, photon_factor, query_factor, vm_exchange,
        merge_chunks, axis_name,
    )


def _resolve_unroll(camera_unroll: str) -> bool:
    """Resolve the camera-bounce loop form: "on" unrolls it, "off" and
    "auto" keep the rolled fori_loop.

    The unroll buys the per-bounce *static* connection window (~60% fewer
    connection lanes at maxPath 10) at ~4.7x the compile time; measured on
    an H100 for vcm at 512^2 it saves ~22% per iteration but breaks even
    only after tens of thousands of iterations in a cold process (PERF.md),
    so "auto" stays rolled. The two forms agree to float round-off (~1 ulp:
    the loop form masks always-dead window lanes to exact zeros, but XLA's
    reduce/fusion order differs between the loop bodies); any ONE form is
    deterministic."""
    return camera_unroll == "on"


def _camera_stage(
    scene, misc, verts, pix, iteration, res_x, base_seed,
    max_path_length, min_path_length, use_vc, use_vm, ppm, rng_kind,
    vm_exchange, axis_name, unroll: bool = True,
):
    """Stage 2 (+ the cross-shard photon all-gather): camera sub-paths.

    Its shapes are independent of the merge caps, so a driver can jit it
    separately from the merge stage (see trace_iteration below). Returns
    (color, queries, light_verts_global, sx, sy, camera_ray_count).
    """
    n = pix.shape[0]
    if use_vm and axis_name is not None and vm_exchange == "allgather":
        # Cross-shard photon exchange: gather every shard's vertices so local
        # camera vertices merge against the global photon map (the reference
        # reads them from shared memory, vertexcm.hxx:530-538).
        ag = lambda a: jax.lax.all_gather(a, axis_name, axis=1, tiled=True)
        agv = lambda v: V3(ag(v.x), ag(v.y), ag(v.z))
        light_verts_global = StoredVertices(
            position=agv(verts.position), throughput=agv(verts.throughput),
            in_dir=agv(verts.in_dir), normal=agv(verts.normal),
            mat_id=ag(verts.mat_id), d_vcm=ag(verts.d_vcm),
            d_vc=ag(verts.d_vc), d_vm=ag(verts.d_vm), valid=ag(verts.valid),
        )
    else:
        # Single device, or ring exchange (photons stay sharded; see below).
        light_verts_global = verts

    # ---- Stage 2: camera sub-paths (+ query recording for merging).
    sx, sy, state = generate_camera_sample(
        scene, misc, pix, res_x, iteration, base_seed, rng_kind
    )
    zerov = V3(*(jnp.zeros((n,), jnp.float32),) * 3)
    color = zerov
    has_background = scene.background_idx >= 0
    max_l = verts.valid.shape[0]
    queries = _empty_vertices(max_path_length, n) if use_vm else None

    def bounce(i, carry, w_conn):
        state, color, queries, rays = carry
        path_length = i + 1

        rays = rays + jnp.sum(state.alive.astype(jnp.int32))
        org = state.origin + state.direction * EPS_RAY
        hit = intersect(scene, org, state.direction)
        dist_safe = jnp.where(hit.hit, hit.dist, 1.0)
        hit_point = org + state.direction * dist_safe
        isect_dist = dist_safe + EPS_RAY

        # Miss -> background radiance, PRE-update MIS (vertexcm.hxx:434-447).
        if has_background:
            bg_contrib = get_light_radiance_weighted(
                scene, state,
                jnp.full((n,), scene.background_idx, jnp.int32),
                state.direction,
                jnp.full((n,), path_length, jnp.int32),
                use_vc, use_vm,
            )
            take_bg = state.alive & ~hit.hit & (path_length >= min_path_length)
            color = color + v3_where(take_bg, state.throughput * bg_contrib, 0.0)

        alive = state.alive & hit.hit
        b = bsdf_ops.setup(
            scene.materials, state.direction, hit.normal, hit.mat_id, hit.hit
        )
        alive = alive & b.valid

        # MIS update (vertexcm.hxx:459-464), masked by alive.
        abs_cos = jnp.abs(b.cos_theta_fix())
        inv_cos = _safe_div(1.0, _mis(abs_cos))
        state = state._replace(
            d_vcm=jnp.where(
                alive, state.d_vcm * _mis(sqr(isect_dist)) * inv_cos,
                state.d_vcm,
            ),
            d_vc=jnp.where(alive, state.d_vc * inv_cos, state.d_vc),
            d_vm=jnp.where(alive, state.d_vm * inv_cos, state.d_vm),
        )

        # Hit a light source (vertexcm.hxx:468-479).
        hit_light = alive & (hit.light_id >= 0)
        light_contrib = get_light_radiance_weighted(
            scene, state, hit.light_id, state.direction,
            jnp.full((n,), path_length, jnp.int32), use_vc, use_vm,
        )
        take_light = hit_light & (path_length >= min_path_length)
        color = color + v3_where(
            take_light, state.throughput * light_contrib, 0.0
        )
        alive = alive & ~hit_light

        # Too long for connections/merging (vertexcm.hxx:482-483).
        alive = alive & (path_length < max_path_length)
        state = state._replace(alive=alive)

        # VC: connect to a light source — NEE (vertexcm.hxx:487-494).
        if use_vc:
            u3 = rng.uniform_slots(
                base_seed,
                rng.make_stream(iteration, rng.STAGE_CAMERA_NEE, i),
                pix, 3, rng_kind,
            )
            nee = direct_illumination(scene, misc, state, hit_point, b, u3)
            nee_on = alive & ~b.is_delta & (path_length + 1 >= min_path_length)
            color = color + v3_where(nee_on, state.throughput * nee, 0.0)
            rays = rays + jnp.sum(nee_on.astype(jnp.int32))

        # VC: connect to this path's light vertices (vertexcm.hxx:498-526).
        # All in-window slots batch into one [w*N] call: one occlusion
        # sweep and one pair of BSDF evaluations per bounce instead of
        # maxL sequential N-lane launches. In unrolled form ``w_conn``
        # shrinks with camera depth — full_len = (j+1) + 1 + path_length
        # <= max_path_length bounds the reachable light slot j, so later
        # bounces slice the vertex table statically instead of masking
        # always-dead lanes (connections are HBM-traffic-bound at ~9 ns
        # per lane, and the window cuts total lanes by ~60% at maxPath
        # 10). In loop form the window is the fixed worst case and
        # ``in_range`` masks dead lanes to exact zeros (forms agree to
        # float round-off; see _resolve_unroll).
        if use_vc and w_conn > 0:
            m_conn = w_conn * n
            bro = lambda a: jnp.broadcast_to(a, (w_conn,) + a.shape) \
                .reshape((m_conn,) + a.shape[1:])
            brov = lambda v: V3(bro(v.x), bro(v.y), bro(v.z))
            fl = lambda a: a[:w_conn].reshape((m_conn,))
            flv = lambda v: V3(fl(v.x), fl(v.y), fl(v.z))

            lv_len = jnp.repeat(
                jnp.arange(w_conn, dtype=jnp.int32) + 1, n
            )
            full_len = lv_len + 1 + path_length
            in_range = (full_len >= min_path_length) & (
                full_len <= max_path_length
            )
            lv_valid = fl(verts.valid) & bro(alive & ~b.is_delta) & in_range

            cam_b_t = bsdf_ops.BsdfState(
                valid=bro(b.valid), mat_id=bro(b.mat_id),
                frame_x=brov(b.frame_x), frame_y=brov(b.frame_y),
                frame_z=brov(b.frame_z),
                local_dir_fix=brov(b.local_dir_fix),
                is_delta=bro(b.is_delta),
                prob_diff=bro(b.prob_diff), prob_phong=bro(b.prob_phong),
                prob_refl=bro(b.prob_refl), prob_refr=bro(b.prob_refr),
                cont_prob=bro(b.cont_prob),
                reflect_coeff=bro(b.reflect_coeff),
            )
            c = connect_vertices(
                scene, misc, bro(state.d_vcm), bro(state.d_vc),
                brov(hit_point), cam_b_t,
                flv(verts.position), flv(verts.in_dir), flv(verts.normal),
                fl(verts.mat_id), fl(verts.d_vcm), fl(verts.d_vc), lv_valid,
            )
            contrib = v3_where(
                lv_valid, brov(state.throughput) * flv(verts.throughput) * c,
                0.0,
            )
            c2 = contrib.reshape((w_conn, n))
            color = color + V3(
                jnp.sum(c2.x, axis=0), jnp.sum(c2.y, axis=0),
                jnp.sum(c2.z, axis=0),
            )
            rays = rays + jnp.sum(lv_valid.astype(jnp.int32))

        # VM: record a merge query at this vertex (processed in the deferred
        # merge stage — merging is additive and walk-independent).
        if use_vm:
            merge_on = alive & ~b.is_delta
            queries = _store_slot(
                queries, i,
                position=hit_point, throughput=state.throughput,
                in_dir=state.direction, normal=hit.normal,
                mat_id=hit.mat_id, d_vcm=state.d_vcm, d_vc=state.d_vc,
                d_vm=state.d_vm, valid=merge_on,
            )
            if ppm:  # PPM ends the camera path at the first non-delta hit
                state = state._replace(alive=alive & b.is_delta)

        u = rng.uniform_slots(
            base_seed,
            rng.make_stream(iteration, rng.STAGE_CAMERA_WALK, i),
            pix, 4, rng_kind,
        )
        state = sample_scattering(
            scene, misc, state, hit_point, b, u, fix_is_light=False
        )
        return state, color, queries, rays

    carry = (state, color, queries, jnp.zeros((), jnp.int32))
    if unroll:
        # Python-unrolled bounce loop: each bounce slices the light-vertex
        # table to its static connection window w_conn — shapes differ per
        # bounce, which a traced loop cannot express. Unrolling also lets
        # XLA fuse stores/walk across bounces. The HLO growth costs
        # several times the compile time (see _resolve_unroll).
        for i in range(max_path_length):
            w_i = min(max_l, max(0, max_path_length - 1 - (i + 1)))
            carry = bounce(i, carry, w_i)
    else:
        # fori_loop form: ONE traced bounce body with the worst-case
        # (bounce-0) connection window; per-bounce dead lanes are masked
        # by ``in_range`` to exact zeros (matches the unroll to ~1 ulp).
        w_fix = min(max_l, max(0, max_path_length - 2)) if use_vc else 0
        carry = jax.lax.fori_loop(
            0, max_path_length, lambda i, c: bounce(i, c, w_fix), carry
        )
    state, color, queries, cam_rays = carry
    return color, queries, light_verts_global, sx, sy, cam_rays


def _merge_finish(
    scene, misc, n, n_paths_global, verts, fb, color, queries,
    light_verts_global, pix, sx, sy, ray_count,
    max_path_length, min_path_length, use_vm, ppm,
    pair_factor, photon_factor, query_factor, vm_exchange,
    merge_chunks, axis_name,
):
    """Stage 3 (deferred merging) + framebuffer splat + cross-shard sums."""
    merge_overflow = jnp.zeros((), jnp.int32)
    merge_stats = jnp.zeros((3,), jnp.int32)
    if use_vm:
        # 8x pixels: purely a perf knob (results stay exact — candidates
        # are always r^2-filtered). At 2x, hash collisions contributed
        # ~40% of all candidate pairs at 512^2 (317K photons over 524K
        # cells, 8 probes/query); gathers scale with the pair cap, so
        # fewer spurious pairs is a direct merge-time win.
        num_cells = 8 * n_paths_global
        def merge_fn(qs, lv, ph_cap):
            return merge_stage(
                scene, misc, qs, lv, num_cells,
                int(pair_factor * n), ppm, max_path_length,
                min_path_length, _pad_mult(ph_cap, 8),
                _pad_mult(int(query_factor * n), 8 * merge_chunks), n,
                merge_chunks,
            )

        if axis_name is not None and vm_exchange == "ring":
            # Ring exchange (the ring-attention communication pattern from
            # SURVEY.md §2): each shard's photons visit every shard in
            # n_dev ppermute hops, merged against the resident camera
            # queries. Merging is additive over photons, so the sum over
            # hops equals the all-gather result exactly — but peak photon
            # memory is per-shard (photon_factor * n instead of
            # * n_paths_global), the regime where the full photon map
            # doesn't fit one chip.
            n_dev = jax.lax.axis_size(axis_name)
            perm = [(i, (i + 1) % n_dev) for i in range(n_dev)]
            shift = lambda a: jax.lax.ppermute(a, axis_name, perm)

            def ring_step(_, carry):
                visiting, color, ovf, st = carry
                mc, o, s2 = merge_fn(
                    queries, visiting, int(photon_factor * n)
                )
                visiting = jax.tree.map(shift, visiting)
                # pairs accumulate over hops; photon/query counts are
                # per-hop peaks (they size the per-shard caps).
                st = jnp.stack([
                    st[0] + s2[0], jnp.maximum(st[1], s2[1]),
                    jnp.maximum(st[2], s2[2]),
                ])
                return visiting, color + mc, ovf + o, st

            _, color, merge_overflow, merge_stats = jax.lax.fori_loop(
                0, n_dev, ring_step,
                (verts, color, merge_overflow, merge_stats),
            )
        else:
            mc, merge_overflow, merge_stats = merge_fn(
                queries, light_verts_global,
                int(photon_factor * n_paths_global),
            )
            color = color + mc

    # Camera contributions always land on the path's own pixel
    # (floor(sx) == pix % res_x); the contiguous-pix fast path replaces
    # the 262k-row scatter (io/framebuffer.py::add_color_at_pix).
    fb = add_color_at_pix(fb, pix, color)
    out = fb.to_array()
    if axis_name is not None:
        out = jax.lax.psum(out, axis_name)
        ray_count = jax.lax.psum(ray_count, axis_name)
        merge_overflow = jax.lax.psum(merge_overflow, axis_name)
        merge_stats = jax.lax.psum(merge_stats, axis_name)
    return out, ray_count, merge_overflow, merge_stats


_STATIC = (
    "res_x", "res_y", "base_seed", "max_path_length", "min_path_length",
    "use_vc", "use_vm", "light_trace_only", "ppm", "pair_factor",
    "photon_factor", "query_factor", "vm_exchange", "rng_kind",
    "merge_chunks", "camera_unroll",
)


@partial(jax.jit, static_argnames=_STATIC)
def render_iteration(
    scene: SceneData,
    iteration,
    res_x: int,
    res_y: int,
    base_seed: int = 1234,
    max_path_length: int = 10,
    min_path_length: int = 0,
    radius_factor: float = 0.003,
    radius_alpha: float = 0.75,
    use_vc: bool = True,
    use_vm: bool = True,
    light_trace_only: bool = False,
    ppm: bool = False,
    pair_factor: float = 24.0,
    photon_factor: float = 3.0,
    query_factor: float = 3.0,
    vm_exchange: str = "allgather",
    rng_kind: str = "threefry",
    merge_chunks: int = 1,
    camera_unroll: str = "auto",
) -> jnp.ndarray:
    """Single-device iteration -> accumulation image [resY,resX,3]."""
    n = res_x * res_y
    pix = jnp.arange(n, dtype=jnp.uint32)
    fb, _, _, _ = render_iteration_core(
        scene, iteration, pix, res_x, res_y, n, base_seed,
        max_path_length, min_path_length, radius_factor, radius_alpha,
        use_vc, use_vm, light_trace_only, ppm, pair_factor,
        photon_factor, query_factor, vm_exchange, rng_kind, merge_chunks,
        axis_name=None, camera_unroll=camera_unroll,
    )
    return fb


# ---------------------------------------------------------------------------
# Cap sizing: stages 1-2 as one program, then cheap measurement programs
# over its result (render.py::_ensure_merge_caps).
# ---------------------------------------------------------------------------

_STATIC_TRACE = (
    "res_x", "res_y", "base_seed", "max_path_length", "min_path_length",
    "use_vc", "ppm", "rng_kind", "camera_unroll",
)


@partial(jax.jit, static_argnames=_STATIC_TRACE)
def trace_iteration(
    scene: SceneData,
    iteration,
    res_x: int,
    res_y: int,
    base_seed: int = 1234,
    max_path_length: int = 10,
    min_path_length: int = 0,
    radius_factor: float = 0.003,
    radius_alpha: float = 0.75,
    use_vc: bool = True,
    ppm: bool = False,
    rng_kind: str = "threefry",
    camera_unroll: str = "auto",
):
    """Stages 1-2 of a single-device merging iteration (use_vm algorithms
    only), for cap sizing.

    Returns (fb_planes, color, queries, light_verts, sx, sy, ray_count) —
    feed verbatim to merge_demand_iteration.
    Shapes depend only on the resolution and path length, never on the
    merge caps.
    """
    n = res_x * res_y
    pix = jnp.arange(n, dtype=jnp.uint32)
    misc = compute_misc(
        scene, iteration, n, radius_factor, radius_alpha, use_vc, True
    )
    fb = new_fb_planes(res_x, res_y)
    verts, fb, ray_count = trace_light_paths(
        scene, misc, pix, iteration, fb, base_seed, max_path_length,
        min_path_length, use_vc, True, False, rng_kind,
    )
    color, queries, _lv, sx, sy, cam_rays = _camera_stage(
        scene, misc, verts, pix, iteration, res_x, base_seed,
        max_path_length, min_path_length, use_vc, True, ppm, rng_kind,
        "allgather", None, _resolve_unroll(camera_unroll),
    )
    return fb, color, queries, verts, sx, sy, ray_count + cam_rays


# ---------------------------------------------------------------------------
# Iteration-batched rendering.
#
# Batching `block` iterations into one executable amortizes the dispatch
# and the driver's one host sync per block. The fori_loop body is traced
# once, so compile time is independent of the block size, and the
# counter-based RNG keeps any (start, block) partition bit-identical to
# the per-iteration loop.
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=_STATIC)
def render_block_with_stats(
    scene: SceneData,
    start_iteration,
    res_x: int,
    res_y: int,
    block: int = 1,
    base_seed: int = 1234,
    max_path_length: int = 10,
    min_path_length: int = 0,
    radius_factor: float = 0.003,
    radius_alpha: float = 0.75,
    use_vc: bool = True,
    use_vm: bool = True,
    light_trace_only: bool = False,
    ppm: bool = False,
    pair_factor: float = 24.0,
    photon_factor: float = 3.0,
    query_factor: float = 3.0,
    vm_exchange: str = "allgather",
    rng_kind: str = "threefry",
    merge_chunks: int = 1,
    camera_unroll: str = "auto",
):
    """``block`` consecutive iterations in ONE executable.

    ``block`` is a TRACED argument (the fori_loop bound; shapes don't
    depend on it), so every block size shares ONE compiled program.
    fori_loop lowers to while_loop even with a static bound, so the
    dynamic bound costs nothing.

    Returns (image_sum [resY,resX,3], ray_count, overflow_sum, stats_max,
    luminance) — overflow summed so ANY overflowing iteration triggers the
    driver's grow-and-rerender (exactness), stats maxed so cap sizing sees
    the worst iteration, and the luminance scalar doubles as the block's
    host sync point.
    """
    n = res_x * res_y
    pix = jnp.arange(n, dtype=jnp.uint32)

    def body(j, carry):
        acc, rays, ovf, stats = carry
        img, r, o, st = render_iteration_core(
            scene, start_iteration + j, pix, res_x, res_y, n, base_seed,
            max_path_length, min_path_length, radius_factor, radius_alpha,
            use_vc, use_vm, light_trace_only, ppm, pair_factor,
            photon_factor, query_factor, vm_exchange, rng_kind,
            merge_chunks, axis_name=None, camera_unroll=camera_unroll,
        )
        return acc + img, rays + r, ovf + o, jnp.maximum(stats, st)

    init = (
        jnp.zeros((res_y, res_x, 3), jnp.float32),
        jnp.zeros((), jnp.int32),
        jnp.zeros((), jnp.int32),
        jnp.zeros((3,), jnp.int32),
    )
    acc, rays, ovf, stats = jax.lax.fori_loop(
        0, jnp.asarray(block, jnp.int32), body, init
    )
    return acc, rays, ovf, stats, jnp.sum(acc)


@partial(jax.jit, static_argnames=("res_x", "res_y"))
def merge_demand_iteration(
    scene: SceneData,
    iteration,
    traced,
    res_x: int,
    res_y: int,
    radius_factor: float = 0.003,
    radius_alpha: float = 0.75,
):
    """EXACT candidate-pair demand of the XLA merge over a traced
    iteration — no caps, no sort, so one cheap program sizes the XLA
    pair/photon/query caps without the render-retry ladder.

    Counts with the same spatial hash + 2x2x2 probe the XLA merge_stage
    uses (hash collisions included), so pair_cap >= pairs is exact.
    Returns (pairs, n_photons, n_queries) as one int32[3] array.
    """
    fb, color, queries, verts, sx, sy, ray_count = traced
    n = res_x * res_y
    num_cells = 8 * n  # must match _merge_finish's hash-cell count
    misc = compute_misc(
        scene, iteration, n, radius_factor, radius_alpha, True, True
    )

    flat = lambda a: a.reshape((-1,))
    pv = flat(verts.valid)
    px, py, pz = flat(verts.position.x), flat(verts.position.y), \
        flat(verts.position.z)
    big = jnp.float32(1e36)
    mn = lambda a: jnp.min(jnp.where(pv, a, big))
    mx = lambda a: jnp.max(jnp.where(pv, a, -big))
    mnx, mny, mnz = mn(px), mn(py), mn(pz)
    mxx, mxy, mxz = mx(px), mx(py), mx(pz)
    inv_cell = 1.0 / (misc.radius * 2.0)

    def cell(x, y, z):
        return (
            jnp.floor((x - mnx) * inv_cell).astype(jnp.int32),
            jnp.floor((y - mny) * inv_cell).astype(jnp.int32),
            jnp.floor((z - mnz) * inv_cell).astype(jnp.int32),
        )

    h = grid_ops._hash_cell(*cell(px, py, pz), num_cells)
    counts = jnp.zeros((num_cells,), jnp.int32).at[
        jnp.where(pv, h, num_cells)
    ].add(1, mode="drop")

    qv = flat(queries.valid)
    qx, qy, qz = flat(queries.position.x), flat(queries.position.y), \
        flat(queries.position.z)
    pad = misc.radius
    in_bbox = (
        (qx >= mnx - pad) & (qx <= mxx + pad)
        & (qy >= mny - pad) & (qy <= mxy + pad)
        & (qz >= mnz - pad) & (qz <= mxz + pad)
    )
    live = qv & in_bbox
    bx, by, bz = cell(qx, qy, qz)
    rel = lambda a, mnv: (a - mnv) * inv_cell
    pick = lambda r: jnp.where(r - jnp.floor(r) < 0.5, -1, 1).astype(
        jnp.int32
    )
    sx_, sy_, sz_ = pick(rel(qx, mnx)), pick(rel(qy, mny)), pick(rel(qz, mnz))
    per_q = jnp.zeros_like(bx)
    for bit in range(8):
        hc = grid_ops._hash_cell(
            bx + (sx_ if bit & 1 else 0),
            by + (sy_ if bit & 2 else 0),
            bz + (sz_ if bit & 4 else 0),
            num_cells,
        )
        per_q = per_q + jnp.where(live, counts[hc], 0)

    return jnp.stack([
        jnp.sum(per_q),
        jnp.sum(pv.astype(jnp.int32)),
        jnp.sum(qv.astype(jnp.int32)),
    ])
