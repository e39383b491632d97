"""Visualization helpers: captioned montages and training panels.

Port of `egogaussian_tpu/utils/visualize.py` (which imports no JAX; this
is the port's own copy, taking tensors on any device as well as arrays).
Twin of reference `utils/dynamic_utils.py:49-120` (get_eval_img /
get_eval_img_new with Serif.ttf captions) and `utils/visualize_utils.py`
(vis_input_and_render 8-panel montage). Captions use a scalable TTF when
one is available on the system (matplotlib bundles DejaVu; the reference
bundles Serif.ttf), falling back to PIL's bitmap font.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _caption_font(size: int):
    """Best available scalable font (reference dynamic_utils.py:65-120 uses
    ImageFont.truetype('utils/Serif.ttf', ...)); None -> PIL default."""
    from PIL import ImageFont

    candidates = []
    try:
        import matplotlib

        candidates.append(
            os.path.join(
                os.path.dirname(matplotlib.__file__),
                "mpl-data", "fonts", "ttf", "DejaVuSans.ttf",
            )
        )
    except ImportError:
        pass
    candidates += [
        "/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf",
        "/usr/share/fonts/dejavu/DejaVuSans.ttf",
    ]
    for path in candidates:
        try:
            return ImageFont.truetype(path, size)
        except OSError:
            continue
    return None


def to_uint8_image(arr) -> np.ndarray:
    """[C, H, W] float in [0,1] (C in {1,3}) -> [H, W, 3] uint8."""
    a = _host(arr)
    if a.ndim == 2:
        a = a[None]
    if a.shape[0] == 1:
        a = np.repeat(a, 3, axis=0)
    return (np.clip(a.transpose(1, 2, 0), 0, 1) * 255).astype(np.uint8)


def make_montage(
    images: Sequence,
    captions: Optional[Sequence[str]] = None,
    rows: int = 1,
    cols: Optional[int] = None,
    caption_height: int = 14,
):
    """Grid montage with captions (get_eval_img / get_eval_img_new twin).
    Returns a PIL Image."""
    from PIL import Image, ImageDraw

    tiles = [to_uint8_image(im) for im in images]
    n = len(tiles)
    if cols is None:
        cols = -(-n // rows)
    h, w = tiles[0].shape[:2]
    ch = caption_height if captions else 0
    canvas = Image.new("RGB", (cols * w, rows * (h + ch)), (0, 0, 0))
    draw = ImageDraw.Draw(canvas)
    font = _caption_font(max(caption_height - 3, 8)) if captions else None
    for i, tile in enumerate(tiles):
        r, c = divmod(i, cols)
        y = r * (h + ch)
        canvas.paste(Image.fromarray(tile), (c * w, y + ch))
        if captions and i < len(captions):
            draw.text(
                (c * w + 2, y + 1), captions[i], fill=(255, 255, 255),
                font=font,
            )
    return canvas


def vis_input_and_render(
    gt_image,
    int_mask,
    obj_mask,
    est_depth,
    render_image,
    render_depth,
    render_alpha,
    render_label,
    frame_name: str = "",
):
    """8-panel training panel (reference utils/visualize_utils.py:4-54)."""
    def norm01(x):
        a = _host(x)
        lo, hi = float(a.min()), float(a.max())
        return (a - lo) / (hi - lo) if hi > lo else a * 0

    return make_montage(
        [
            gt_image, int_mask, obj_mask, norm01(est_depth),
            render_image, norm01(render_depth), render_alpha, render_label,
        ],
        [
            f"GT {frame_name}", "int mask", "obj mask", "est depth",
            "render", "depth", "alpha", "label",
        ],
        rows=2, cols=4,
    )
