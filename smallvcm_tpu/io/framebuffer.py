"""Accumulation framebuffer + PPM/PFM/BMP/HDR writers.

Device side, the framebuffer is just a ``[resY, resX, 3]`` f32 array;
accumulation is a differentiable scatter-add (``.at[y, x].add`` with
``mode='drop'``, which reproduces the reference's silent bounds check,
framebuffer.hxx:43-57). The file writers replicate the reference's byte
formats exactly (framebuffer.hxx:106-251): PPM, binary PFM, bottom-up 24bpp
BMP with gamma, and Radiance RGBE HDR.

Like the reference, the encode path is native: each save_* first tries the
C++ codec (native/codec.cpp via io/native_codec.py, built on demand with
the in-image g++) and falls back to the numpy implementations below, which
double as the byte-format oracle in tests/test_io.py.
"""

from __future__ import annotations

import struct

import numpy as np
import jax
import jax.numpy as jnp


def new_framebuffer(res_x: int, res_y: int) -> jnp.ndarray:
    return jnp.zeros((res_y, res_x, 3), jnp.float32)


def add_color(fb, sx, sy, color):
    """Batched AddColor: floor the raster position, drop out-of-bounds.

    fb is a V3 of [resY, resX] color planes (full-lane scatter-adds);
    sx/sy are float raster coords [N], color a V3 of [N]. Negative coords
    must drop (not round toward zero onto pixel 0), so they are pre-masked
    before the int cast.
    """
    from ..core.vec3 import V3

    x = jnp.floor(sx).astype(jnp.int32)
    y = jnp.floor(sy).astype(jnp.int32)
    oob = (sx < 0) | (sy < 0)
    x = jnp.where(oob, jnp.int32(-1), x)
    y = jnp.where(oob, jnp.int32(-1), y)
    return V3(
        fb.x.at[y, x].add(color.x, mode="drop"),
        fb.y.at[y, x].add(color.y, mode="drop"),
        fb.z.at[y, x].add(color.z, mode="drop"),
    )


def add_color_at_pix(fb, pix, color):
    """Own-pixel accumulate for camera sub-paths.

    Camera-path contributions always land on the path's own pixel
    (floor(x + jitter) == x for jitter in [0, 1)), and every driver hands
    paths a CONTIGUOUS ascending pixel-id range (full-frame arange, or a
    shard_map block of it — parallel/sharding.py::_global_pix), so the
    per-path add reduces to a dynamic-slice add at pix[0] instead of a
    scatter-add over every path.
    """
    from ..core.vec3 import V3

    ns = pix.shape[0]
    start = pix[0].astype(jnp.int32)

    def upd(p, c):
        flat = p.reshape(-1)
        cur = jax.lax.dynamic_slice(flat, (start,), (ns,))
        return jax.lax.dynamic_update_slice(
            flat, cur + c, (start,)
        ).reshape(p.shape)

    return V3(upd(fb.x, color.x), upd(fb.y, color.y), upd(fb.z, color.z))


def splat_colors(fb, pix1d, color):
    """Scattered splat of [L, N] contributions -> fb planes, one sorted
    3-wide scatter.

    ``pix1d``: int32 [L, N] flat pixel index per splat; dead splats carry
    the sentinel ``res_x * res_y`` (dropped by the OOB scatter mode).
    Light-tracer camera connections land on arbitrary pixels, and
    per-bounce scatter-adds were the single largest cost of the light
    stage (27 scatters x 262k rows ~= 47 ms/iter at 512^2 — 88% of lt).
    One deferred (key, iota, r, g, b) sort (~7 ms at 2.4M) + one 3-wide
    ascending-index scatter (~21 ms) replaces them; the iota tiebreak
    keeps the permutation deterministic, and sorting ALL slots (no
    compaction cap) keeps the splat exact with static shapes.
    """
    from ..core.vec3 import V3

    res_y, res_x = fb.x.shape
    p = res_x * res_y
    m = pix1d.size
    key = pix1d.reshape(-1).astype(jnp.uint32)
    iota = jnp.arange(m, dtype=jnp.int32)
    sk, _si, sr, sg, sb = jax.lax.sort(
        (key, iota, color.x.reshape(-1), color.y.reshape(-1),
         color.z.reshape(-1)),
        num_keys=2,
    )
    v3 = jnp.stack([sr, sg, sb], axis=1)           # [M, 3]; minor-3 is cheap
    sk_i = sk.astype(jnp.int32)
    # Dead (sentinel-key) rows sort LAST, and scatter time is per row even
    # for dropped rows — so the steady-state scatter covers only the first
    # half (live splats are ~27% of slots at 512^2), and a cond-guarded
    # tail scatter keeps the result exact if live rows ever exceed it.
    cap = max(m // 2, 1)
    buf = jnp.zeros((p, 3), jnp.float32).at[sk_i[:cap]].add(
        v3[:cap], mode="drop", indices_are_sorted=True
    )
    buf = jax.lax.cond(
        sk_i[cap] < p if cap < m else False,
        lambda b: b.at[sk_i[cap:]].add(
            v3[cap:], mode="drop", indices_are_sorted=True
        ),
        lambda b: b,
        buf,
    )
    return V3(
        fb.x + buf[:, 0].reshape(res_y, res_x),
        fb.y + buf[:, 1].reshape(res_y, res_x),
        fb.z + buf[:, 2].reshape(res_y, res_x),
    )


def new_fb_planes(res_x: int, res_y: int):
    """Device-side accumulation planes (V3 of [resY, resX])."""
    from ..core.vec3 import V3

    z = jnp.zeros((res_y, res_x), jnp.float32)
    return V3(z, z, z)


def total_luminance(fb: jnp.ndarray) -> jnp.ndarray:
    """framebuffer.hxx:89-102 (fb = [resY, resX, 3] array)."""
    return jnp.sum(
        0.212671 * fb[..., 0] + 0.715160 * fb[..., 1] + 0.072169 * fb[..., 2]
    )


def _np(fb) -> np.ndarray:
    return np.asarray(fb, np.float32)


def save_ppm(fb, filename: str, gamma: float = 1.0) -> None:
    img = _np(fb)
    from . import native_codec
    if native_codec.save_ppm(img, filename, gamma):
        return
    # Pure-Python fallback (native codec unavailable): writes pixel rows
    # one .join at a time -- fine for tests, SLOW at 512^2+ (seconds);
    # the native codec shadows it everywhere it can build.
    res_y, res_x, _ = img.shape
    inv_g = 1.0 / gamma
    quant = np.clip((img ** inv_g * 255.0).astype(np.int32), 0, 255)
    with open(filename, "w") as f:
        f.write(f"P3\n{res_x} {res_y}\n255\n")
        for y in range(res_y):
            row = " ".join(
                f"{quant[y, x, 0]} {quant[y, x, 1]} {quant[y, x, 2]}"
                for x in range(res_x)
            )
            f.write(row + " \n")


def save_pfm(fb, filename: str) -> None:
    img = _np(fb)
    from . import native_codec
    if native_codec.save_pfm(img, filename):
        return
    res_y, res_x, _ = img.shape
    with open(filename, "wb") as f:
        f.write(f"PF\n{res_x} {res_y}\n-1\n".encode())
        f.write(img.tobytes())


def save_bmp(fb, filename: str, gamma: float = 1.0) -> None:
    """24bpp bottom-up BMP, byte-identical layout to framebuffer.hxx:170-215."""
    img = _np(fb)
    from . import native_codec
    if native_codec.save_bmp(img, filename, gamma):
        return
    res_y, res_x, _ = img.shape
    inv_g = 1.0 / gamma
    header = struct.pack(
        "<IIIIii hh IIIIII".replace(" ", ""),
        54 + res_x * res_y * 3,  # file size
        0,                       # reserved
        54,                      # data offset
        40,                      # header size
        res_x,
        res_y,
        1,                       # color planes
        24,                      # bpp
        0,                       # compression
        res_x * res_y * 3,       # image size
        2953, 2953, 0, 0,
    )
    # bottom-up rows, BGR order
    g = np.power(np.maximum(img, 0.0), inv_g) * 255.0
    bgr = np.clip(g[::-1, :, ::-1], 0.0, 255.0).astype(np.uint8)
    with open(filename, "wb") as f:
        f.write(b"BM")
        f.write(header)
        f.write(bgr.tobytes())


def save_hdr(fb, filename: str) -> None:
    """Radiance RGBE (framebuffer.hxx:219-251, non-RLE scanlines)."""
    img = _np(fb)
    from . import native_codec
    if native_codec.save_hdr(img, filename):
        return
    res_y, res_x, _ = img.shape
    v = img.max(axis=2)
    mant, exp = np.frexp(v)
    scale = np.where(v >= 1e-32, mant * 256.0 / np.where(v == 0, 1.0, v), 0.0)
    rgbe = np.zeros((res_y, res_x, 4), np.uint8)
    rgbe[..., 0] = (img[..., 0] * scale).astype(np.uint8)
    rgbe[..., 1] = (img[..., 1] * scale).astype(np.uint8)
    rgbe[..., 2] = (img[..., 2] * scale).astype(np.uint8)
    rgbe[..., 3] = np.where(v >= 1e-32, exp + 128, 0).astype(np.uint8)
    with open(filename, "wb") as f:
        f.write(b"#?RADIANCE\n# SmallVCM\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {res_y} +X {res_x}\n".encode())
        f.write(rgbe.tobytes())


def save_image(fb, filename: str) -> None:
    """Dispatch by extension like smallvcm.cxx:313-320 (gamma 2.2 for bmp)."""
    if filename.endswith(".bmp"):
        save_bmp(fb, filename, gamma=2.2)
    elif filename.endswith(".hdr"):
        save_hdr(fb, filename)
    elif filename.endswith(".pfm"):
        save_pfm(fb, filename)
    elif filename.endswith(".ppm"):
        save_ppm(fb, filename, gamma=2.2)
    else:
        save_bmp(fb, filename + ".bmp", gamma=2.2)


def load_hdr(filename: str) -> np.ndarray:
    """Read a flat (non-RLE) Radiance RGBE file as written by save_hdr or the
    reference -> float [resY,resX,3]."""
    with open(filename, "rb") as f:
        data = f.read()
    # header ends at the blank line, then the resolution line
    pos = data.find(b"\n\n") + 2
    eol = data.find(b"\n", pos)
    res_line = data[pos:eol].decode()
    parts = res_line.split()
    assert parts[0] == "-Y" and parts[2] == "+X", res_line
    res_y, res_x = int(parts[1]), int(parts[3])
    rgbe = np.frombuffer(
        data, np.uint8, count=res_y * res_x * 4, offset=eol + 1
    ).reshape(res_y, res_x, 4).astype(np.float32)
    exp = np.ldexp(1.0, rgbe[..., 3].astype(np.int32) - 136)  # 2^(e-128)/256
    # Canonical Radiance reconstruction (r + 0.5) * 2^(e-136): the encoder
    # truncates mantissas (framebuffer.hxx:219-251), so the half-quantum
    # offset makes decode the unbiased inverse. Without it every decoded
    # image reads ~0.2-0.5% darker than the renderer produced — enough to
    # fake a systematic cross-renderer energy difference in parity runs.
    img = (rgbe[..., :3] + 0.5) * exp[..., None]
    img[rgbe[..., 3] == 0] = 0.0
    return img


def load_bmp(filename: str) -> np.ndarray:
    """Read a 24bpp BMP written by either renderer -> float [resY,resX,3] in [0,1]."""
    with open(filename, "rb") as f:
        data = f.read()
    assert data[:2] == b"BM"
    data_offset = struct.unpack_from("<I", data, 10)[0]
    width = struct.unpack_from("<i", data, 18)[0]
    height = struct.unpack_from("<i", data, 22)[0]
    bpp = struct.unpack_from("<H", data, 28)[0]
    assert bpp == 24
    row_bytes = width * 3  # SmallVCM writes unpadded rows (width multiple of 4)
    arr = np.frombuffer(
        data, np.uint8, count=height * row_bytes, offset=data_offset
    ).reshape(height, width, 3)
    return arr[::-1, :, ::-1].astype(np.float32) / 255.0
