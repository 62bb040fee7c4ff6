"""Synthetic occlusion masks for inpainting (port of
``ocflow_tpu/data/occlusion.py``): host-side numpy, masks ``[H, W, 1]``
float32 with 1 = occluded, from the same ``rng`` draws in the same order.

The JAX package draws its brush strokes with ``cv2.line(mask, p0, p1, 1.0,
width)`` (8-connected, ``LINE_8``). The port imports no OpenCV, so
:func:`thick_line` rasterizes that thick line itself, pixel for pixel as
OpenCV's ``line`` does: the segment first clipped to the image grown
by ``width`` on every side (``clipLine``), then a quadrilateral of
half-width ``width / 2`` around it in 16-bit fixed point, its four edges
drawn as 8-connected lines (clipped to the image) and its inside filled
row by row (``FillConvexPoly``), plus a filled disc of radius ``(width +
1) // 2`` at each end (``Circle``, the midpoint walk). Those rules were
worked out against OpenCV 5.0's ``cv2.line`` and are held to it pixel for
pixel by ``tests/test_torch_inpaint_masks.py``. Exactness matters: the stroke
loop stops once the coverage reaches ``0.9 * ratio``, so one pixel more or
less can move the stop and every draw after it.
"""

from __future__ import annotations

import math

import numpy as np

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT
_HALF = XY_ONE >> 1


def _cdiv(a: int, b: int) -> int:
    """C's integer division: the quotient truncated toward zero."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _hline(mask: np.ndarray, y: int, x1: int, x2: int) -> None:
    h, w = mask.shape
    if 0 <= y < h:
        x1, x2 = max(x1, 0), min(x2, w - 1)
        if x1 <= x2:
            mask[y, x1:x2 + 1] = 1.0


def _clip_line(width: int, height: int, x1: int, y1: int, x2: int, y2: int):
    """OpenCV's ``clipLine`` on ``[0, width - 1] x [0, height - 1]``:
    ``None`` when the segment misses the rectangle, else its clipped ends
    (the intersections computed in double and truncated, as there)."""
    right, bottom = width - 1, height - 1

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * float(x2 - x1) / float(y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * float(x2 - x1) / float(y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * float(y2 - y1) / float(x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * float(y2 - y1) / float(x2 - x1))
                x2 = a
                c2 = 0
    if c1 | c2:
        return None
    return x1, y1, x2, y2


def _line_fixed(mask: np.ndarray, p1: tuple[int, int], p2: tuple[int, int]) -> None:
    """OpenCV's ``Line2``: the 8-connected line between two points in 16-bit
    fixed point, clipped to the image; one pixel per step of the major
    axis, the minor coordinate accumulated in fixed point, plus the far
    end rounded."""
    h, w = mask.shape
    clipped = _clip_line(w << XY_SHIFT, h << XY_SHIFT, *p1, *p2)
    if clipped is None:
        return
    x1, y1, x2, y2 = clipped
    dx, dy = x2 - x1, y2 - y1
    ax, ay = abs(dx), abs(dy)
    if ax > ay:
        if dx < 0:
            x1, y1, x2, y2, dy = x2, y2, x1, y1, -dy
        step = _cdiv(dy * XY_ONE, ax | 1)
        ecount = (x2 - x1) >> XY_SHIFT
    else:
        if dy < 0:
            x1, y1, x2, y2, dx = x2, y2, x1, y1, -dx
        step = _cdiv(dx * XY_ONE, ay | 1)
        ecount = (y2 - y1) >> XY_SHIFT
    k = np.arange(ecount + 1, dtype=np.int64)
    if ax > ay:
        xs = ((x1 + _HALF) >> XY_SHIFT) + k
        ys = (y1 + _HALF + k * step) >> XY_SHIFT
    else:
        ys = ((y1 + _HALF) >> XY_SHIFT) + k
        xs = (x1 + _HALF + k * step) >> XY_SHIFT
    xs = np.append(xs, (x2 + _HALF) >> XY_SHIFT)
    ys = np.append(ys, (y2 + _HALF) >> XY_SHIFT)
    keep = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    mask[ys[keep], xs[keep]] = 1.0


def _fill_convex(mask: np.ndarray, v: list[tuple[int, int]]) -> None:
    """OpenCV's ``FillConvexPoly`` of a polygon in 16-bit fixed point
    (``LINE_8``): the edges as :func:`_line_fixed`, then each row from the
    top vertex down filled between two edge walkers, each stepping its x by
    a rounded slope per row."""
    h, w = mask.shape
    npts = len(v)
    p0 = v[-1]
    imin = 0
    xmin = xmax = v[0][0]
    ymin = ymax = v[0][1]
    for i, p in enumerate(v):
        if p[1] < ymin:
            ymin, imin = p[1], i
        ymax, xmax, xmin = max(ymax, p[1]), max(xmax, p[0]), min(xmin, p[0])
        _line_fixed(mask, p0, p)
        p0 = p
    xmin, xmax = (xmin + _HALF) >> XY_SHIFT, (xmax + _HALF) >> XY_SHIFT
    ymin, ymax = (ymin + _HALF) >> XY_SHIFT, (ymax + _HALF) >> XY_SHIFT
    if npts < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    idx_, di_ = [imin, imin], [1, npts - 1]
    ye, ex, edx = [ymin, ymin], [-XY_ONE, -XY_ONE], [0, 0]
    edges = npts
    y = ymin
    while True:
        for i in (0, 1):
            if y >= ye[i]:
                idx0, di = idx_[i], di_[i]
                idx = idx0 + di
                if idx >= npts:
                    idx -= npts
                while True:
                    more = edges > 0
                    edges -= 1
                    if not more:
                        break
                    ty = (v[idx][1] + _HALF) >> XY_SHIFT
                    if ty > y:
                        xs, xe = v[idx0][0], v[idx][0]
                        ye[i] = ty
                        edx[i] = _cdiv((xe - xs) * 2 + (ty - y), 2 * (ty - y))
                        ex[i] = xs
                        idx_[i] = idx
                        break
                    idx0 = idx
                    idx += di
                    if idx >= npts:
                        idx -= npts
        if edges < 0:
            break
        if y >= 0:
            left, right = (1, 0) if ex[0] > ex[1] else (0, 1)
            xx1 = (ex[left] + _HALF) >> XY_SHIFT
            xx2 = (ex[right] + _HALF) >> XY_SHIFT
            if xx2 >= 0 and xx1 < w:
                mask[y, max(xx1, 0):min(xx2, w - 1) + 1] = 1.0
        ex[0] += edx[0]
        ex[1] += edx[1]
        y += 1
        if y > ymax:
            break


def _disc(mask: np.ndarray, cx: int, cy: int, radius: int) -> None:
    """OpenCV's filled ``Circle``: the midpoint walk, each step filling the
    rows ``cy +- dy`` over ``cx +- dx`` and ``cy +- dx`` over ``cx +- dy``."""
    h, w = mask.shape
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    while dx >= dy:
        x11, x12, x21, x22 = cx - dx, cx + dx, cx - dy, cx + dy
        if x11 < w and x12 >= 0 and cy - dx < h and cy + dx >= 0:
            _hline(mask, cy - dy, x11, x12)
            _hline(mask, cy + dy, x11, x12)
            if x21 < w and x22 >= 0:
                _hline(mask, cy - dx, x21, x22)
                _hline(mask, cy + dx, x21, x22)
        dy += 1
        err += plus
        plus += 2
        step = -1 if err > 0 else 0
        err -= minus & step
        dx += step
        minus -= step & 2


def thick_line(mask: np.ndarray, p0: tuple[int, int], p1: tuple[int, int],
               thickness: int) -> None:
    """``cv2.line(mask, p0, p1, 1.0, thickness)`` (``LINE_8``) in place on a
    2-D float mask: points are ``(x, y)`` = (column, row), any integers,
    ``thickness`` >= 2."""
    if thickness < 2:
        raise ValueError(f"thick_line: thickness {thickness} (the strokes are 5 and wider)")
    h, w = mask.shape
    # the segment clipped to the image grown by the thickness on each side
    t = thickness
    clipped = _clip_line(w + 2 * t, h + 2 * t, int(p0[0]) + t, int(p0[1]) + t,
                         int(p1[0]) + t, int(p1[1]) + t)
    if clipped is None:
        return
    x0, y0, x1, y1 = ((c - t) << XY_SHIFT for c in clipped)
    dx = (x0 - x1) / XY_ONE
    dy = (y1 - y0) / XY_ONE
    r = dx * dx + dy * dy
    odd = thickness & 1
    half = thickness << (XY_SHIFT - 1)
    if math.fabs(r) > np.finfo(np.float64).eps:
        r = (half + odd * XY_ONE * 0.5) / math.sqrt(r)
        # cvRound: to nearest, ties to even
        ox, oy = int(np.rint(dy * r)), int(np.rint(dx * r))
        _fill_convex(mask, [(x0 + ox, y0 + oy), (x0 - ox, y0 - oy),
                            (x1 - ox, y1 - oy), (x1 + ox, y1 + oy)])
    radius = (half + _HALF) >> XY_SHIFT
    for x, y in ((x0, y0), (x1, y1)):
        _disc(mask, x >> XY_SHIFT, y >> XY_SHIFT, radius)


def static_random_occlusion(rng: np.random.Generator, height: int, width: int,
                            ratio: float = 0.5) -> np.ndarray:
    """One random rectangle of ``(ratio H, ratio W)`` pixels."""
    th, tw = int(ratio * height), int(ratio * width)
    h1 = int(rng.integers(0, max(height - th, 1)))
    w1 = int(rng.integers(0, max(width - tw, 1)))
    mask = np.zeros((height, width, 1), np.float32)
    mask[h1:h1 + th, w1:w1 + tw] = 1.0
    return mask


def free_form_occlusion(rng: np.random.Generator, height: int, width: int,
                        ratio: float = 0.2, max_brush_width: int | None = None,
                        max_len: int | None = None, max_angle: float = np.pi,
                        max_rounds: int = 100) -> np.ndarray:
    """Random brush strokes until the coverage reaches ``0.9 * ratio`` (or
    ``max_rounds`` rounds): each round starts at a normal draw around the
    image centre and chains 1-4 strokes of random angle, length ``10 ..
    9 + max_len`` and width ``5 .. 4 + max_brush_width`` (defaults
    ``0.02 H`` and ``0.3 H``, at least 1)."""
    if max_brush_width is None:
        max_brush_width = max(int(0.02 * height), 1)
    if max_len is None:
        max_len = max(int(0.3 * height), 1)
    mask = np.zeros((height, width), np.float64)
    i = 0
    for _ in range(max_rounds):
        start_x = int((rng.standard_normal() + 1) * height / 2)
        start_y = int((rng.standard_normal() + 1) * width / 2)
        for _ in range(1 + int(rng.integers(4))):
            angle = float(rng.uniform(0, max_angle))
            if i % 2 == 0:
                angle = 2 * np.pi - angle
            length = 10 + int(rng.integers(max_len))
            brush_w = 5 + int(rng.integers(max_brush_width))
            end_x = int(start_x + length * np.sin(angle))
            end_y = int(start_y + length * np.cos(angle))
            # (column, row): the start_y draw is the point's x
            thick_line(mask, (start_y, start_x), (end_y, end_x), brush_w)
            start_x, start_y = end_x, end_y
            i += 1
        if mask.sum() / mask.size >= 0.9 * ratio:
            break
    return mask.astype(np.float32)[..., None]


def apply_occlusion(img: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """``img`` ``[H, W, C]`` with the occluded region (``mask`` ``[H, W,
    1]`` > 0) set to 0, in ``img``'s dtype."""
    return np.where(mask > 0, 0.0, img).astype(img.dtype)
