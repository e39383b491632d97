"""Crop-window rendering for the masked-object stages.

Port of `egogaussian_tpu/render/crop.py`. The coarse pose stage renders
the object Gaussians only, on black, against `gt * obj_mask`: every pixel
outside (object-splat reach | object mask) is exactly zero in prediction
and target. Compositing only a window that covers that support, with
losses normalized by the full frame's pixel count, gives the full-frame
loss and gradients (up to float32 summation order) at the window's cost.

Coverage is counted, never assumed: `crop_window` returns how many splats
reach outside the window (with the same opacity-aware reach the binning
cull uses), and trainers grow the window when the running max is nonzero.
The window origin is computed on the device from the current projection
every call, so the window follows the object without host syncs; only its
size is fixed.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from egogaussian_tpu_torch.render.oracle import ALPHA_EPS
from egogaussian_tpu_torch.render.tiled import opacity_aabb_radius

_BIG = 1e9


def mask_rect(mask: torch.Tensor) -> torch.Tensor:
    """Bounding rect (x0, y0, x1, y1) float32 of the nonzero pixels of a
    [1, H, W] or [H, W] mask, exclusive end. An empty mask gives
    (+big, +big, -big, -big), a no-op under union."""
    return mask_rects(mask.reshape((1,) + mask.shape[-2:]))[0]


def mask_rects(masks: torch.Tensor) -> torch.Tensor:
    """mask_rect of each mask of an [S, 1, H, W] or [S, H, W] stack in one
    device pass: [S, 4] float32, an empty mask's row (+big, +big, -big,
    -big)."""
    m = (masks[:, 0] if masks.dim() == 4 else masks) > 0
    _, h, w = m.shape
    rows = torch.any(m, dim=2).to(torch.int32)  # [S, H]
    cols = torch.any(m, dim=1).to(torch.int32)  # [S, W]
    y0 = torch.argmax(rows, dim=1)
    y1 = h - torch.argmax(torch.flip(rows, (1,)), dim=1)
    x0 = torch.argmax(cols, dim=1)
    x1 = w - torch.argmax(torch.flip(cols, (1,)), dim=1)
    rect = torch.stack([x0, y0, x1, y1], dim=1).to(torch.float32)
    empty = torch.tensor([_BIG, _BIG, -_BIG, -_BIG], dtype=torch.float32, device=masks.device)
    return torch.where(torch.any(m.flatten(1), dim=1)[:, None], rect, empty)


def mask_rect_table(masks: torch.Tensor) -> torch.Tensor:
    """[F, 1, H, W] (or [F, H, W]) mask stack -> [F, 4] int32 (x0, y0, x1,
    y1) exclusive-end boxes in one device pass; empty masks give
    (0, 0, 0, 0)."""
    m = (masks[:, 0] if masks.dim() == 4 else masks) > 0
    _, h, w = m.shape
    rows = torch.any(m, dim=2).to(torch.int32)  # [F, H]
    cols = torch.any(m, dim=1).to(torch.int32)  # [F, W]
    y0 = torch.argmax(rows, dim=1)
    y1 = h - torch.argmax(torch.flip(rows, (1,)), dim=1)
    x0 = torch.argmax(cols, dim=1)
    x1 = w - torch.argmax(torch.flip(cols, (1,)), dim=1)
    rect = torch.stack([x0, y0, x1, y1], dim=1).to(torch.int32)
    any_ = torch.any(m.flatten(1), dim=1)
    return torch.where(any_[:, None], rect, torch.zeros_like(rect))


def crop_window(
    proj,
    opacities: torch.Tensor,
    valid_mask: Optional[torch.Tensor],
    rect: Optional[torch.Tensor],
    crop_w: int,
    crop_h: int,
    width: int,
    height: int,
    align: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Place a (crop_w x crop_h) window over the support of the scene and a
    must-cover rect, and count coverage escapes.

    `align` is the compositing tile size for the binned backend (pair
    inclusion is tile-granular, so a tile-aligned window composites the
    same pixels as the full frame) and 1 for the oracle.

    Args:
      proj: ProjectedGaussians of the full frame (not shifted)
      opacities: [N]; valid_mask: [N] bool or None
      rect: optional (x0, y0, x1, y1) float32 must-cover rect (mask_rect)
      crop_w, crop_h: window size in pixels (<= width, height)

    Returns:
      ox, oy: int32 0-d tensors, the window origin, clipped into the frame
      outside: int32 [3] = [escape_count, need_w, need_h]: splats whose
        in-frame reach escapes the window (+1 if the rect escapes), and the
        per-axis window size that covers the current support.

    With a leading scene axis (proj fields [S, N, ...], opacities and
    valid_mask [S, N], rect [S, 4]) crop_w and crop_h are [S] float32
    tensors, one window size per scene, and ox, oy come back [S], outside
    [S, 3].
    """
    if isinstance(crop_w, int) and (crop_w > width or crop_h > height):
        raise ValueError(f"crop {crop_w}x{crop_h} larger than frame {width}x{height}")
    mu = proj.means2d.detach()
    radii = proj.radii.detach().to(torch.float32)
    op = opacities.detach()
    r_aabb, _ = opacity_aabb_radius(radii, op)
    ok = (radii > 0) & (op >= ALPHA_EPS)
    if valid_mask is not None:
        ok = ok & valid_mask
    # in-frame reach per splat, in pixel-center coordinates
    lo_x = torch.clamp(mu[..., 0] - r_aabb, min=0.5)
    hi_x = torch.clamp(mu[..., 0] + r_aabb, max=width - 0.5)
    lo_y = torch.clamp(mu[..., 1] - r_aabb, min=0.5)
    hi_y = torch.clamp(mu[..., 1] + r_aabb, max=height - 0.5)
    reach = ok & (lo_x <= hi_x) & (lo_y <= hi_y)

    def masked_min(x):
        return torch.amin(torch.where(reach, x, torch.full_like(x, _BIG)), dim=-1)

    def masked_max(x):
        return torch.amax(torch.where(reach, x, torch.full_like(x, -_BIG)), dim=-1)

    sx0, sx1 = masked_min(lo_x), masked_max(hi_x)
    sy0, sy1 = masked_min(lo_y), masked_max(hi_y)
    if rect is not None:
        # mask pixel k has center k + 0.5: [x0, x1) covers [x0+0.5, x1-0.5]
        sx0 = torch.minimum(sx0, rect[..., 0] + 0.5)
        sy0 = torch.minimum(sy0, rect[..., 1] + 0.5)
        sx1 = torch.maximum(sx1, rect[..., 2] - 0.5)
        sy1 = torch.maximum(sy1, rect[..., 3] - 0.5)

    def place(lo, hi, size, full):
        # center on the union's midpoint (empty union -> 0), then snap the
        # origin down to the alignment grid
        if isinstance(size, int):
            half = torch.full_like(lo, 0.5 * size)
            o_max = float((full - size) // align * align)
        else:  # one size per scene
            half = 0.5 * size
            o_max = torch.floor((full - size) / align) * align
        c = torch.where(hi >= lo, 0.5 * (lo + hi), half)
        o = torch.floor((c - 0.5 * size) / align) * align
        if isinstance(size, int):
            return torch.clamp(o, 0.0, o_max).to(torch.int32)
        return torch.minimum(torch.clamp(o, min=0.0), o_max).to(torch.int32)

    ox = place(sx0, sx1, crop_w, width)
    oy = place(sy0, sy1, crop_h, height)
    oxf, oyf = ox.to(torch.float32), oy.to(torch.float32)
    cw = crop_w if isinstance(crop_w, int) else crop_w[..., None]
    chh = crop_h if isinstance(crop_h, int) else crop_h[..., None]
    # escape: some reachable in-frame pixel center lies outside the window
    # (conservative: the AABB contains the elliptical reach)
    esc = reach & (
        (lo_x < oxf[..., None] + 0.5) | (hi_x > oxf[..., None] + cw - 0.5)
        | (lo_y < oyf[..., None] + 0.5) | (hi_y > oyf[..., None] + chh - 0.5)
    )
    outside = torch.sum(esc.to(torch.int32), dim=-1).to(torch.int32)
    if rect is not None:
        rect_esc = (
            (rect[..., 0] < oxf) | (rect[..., 1] < oyf)
            | (rect[..., 2] > oxf + crop_w) | (rect[..., 3] > oyf + crop_h)
        ) & (rect[..., 2] > rect[..., 0])  # an empty rect never escapes
        outside = outside + rect_esc.to(torch.int32)
    # least per-axis size covering the current support under centering,
    # snap-down by < align and the frame-edge clip: extent + 2*align
    zero = torch.zeros((), dtype=torch.float32, device=mu.device)
    need_w = torch.where(sx1 >= sx0, torch.ceil(sx1 - sx0 + 1.0) + 2 * align, zero)
    need_h = torch.where(sy1 >= sy0, torch.ceil(sy1 - sy0 + 1.0) + 2 * align, zero)
    return ox, oy, torch.stack([outside, need_w, need_h], dim=-1).to(torch.int32)


def crop_plane(plane: torch.Tensor, ox, oy, crop_w: int, crop_h: int) -> torch.Tensor:
    """[C, H, W] plane -> [C, crop_h, crop_w] window at (oy, ox), for
    origins held on the device (an index gather, so no host sync). Origins
    are clamped to keep the window in the plane, like a dynamic slice."""
    _, h, w = plane.shape
    ox = torch.clamp(torch.as_tensor(ox, device=plane.device).to(torch.int64), 0, w - crop_w)
    oy = torch.clamp(torch.as_tensor(oy, device=plane.device).to(torch.int64), 0, h - crop_h)
    rows = oy + torch.arange(crop_h, device=plane.device)
    cols = ox + torch.arange(crop_w, device=plane.device)
    return plane.index_select(1, rows).index_select(2, cols)


def crop_planes(planes: torch.Tensor, ox, oy, sizes, out_w: int, out_h: int) -> torch.Tensor:
    """crop_plane for S scenes at once: planes [S, C, H, W], origins ox, oy
    [S], sizes ((crop_w, crop_h), ...) per scene -> [S, C, out_h, out_w]
    (out_w, out_h the largest window), each scene's pixels past its own
    window 0. Equal windows take crop_plane's index gather."""
    s_n, c, h, w = planes.shape
    dev = planes.device
    cws = torch.tensor([cw for cw, _ in sizes], device=dev)
    chs = torch.tensor([ch for _, ch in sizes], device=dev)
    ox = torch.minimum(torch.clamp(ox.to(torch.int64), min=0), w - cws)
    oy = torch.minimum(torch.clamp(oy.to(torch.int64), min=0), h - chs)
    xs = torch.arange(out_w, device=dev)
    ys = torch.arange(out_h, device=dev)
    cols = torch.clamp(ox[:, None] + xs, max=w - 1)  # [S, out_w]
    rows = torch.clamp(oy[:, None] + ys, max=h - 1)  # [S, out_h]
    idx = rows[:, :, None] * w + cols[:, None, :]  # [S, out_h, out_w]
    flat = planes.reshape(s_n, c, h * w)
    out = torch.gather(flat, 2, idx.reshape(s_n, 1, -1).expand(-1, c, -1))
    out = out.reshape(s_n, c, out_h, out_w)
    if all(tuple(sz) == (out_w, out_h) for sz in sizes):
        return out
    own = (xs[None, :] < cws[:, None])[:, None, None, :] & (
        ys[None, :] < chs[:, None])[:, None, :, None]
    return torch.where(own, out, torch.zeros_like(out))
