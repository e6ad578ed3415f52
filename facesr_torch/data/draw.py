"""OpenCV's 8-connected drawing on float32 images, in numpy and integers,
so the port needs no cv2: the calls `cli.make_synthetic_faces` makes.

- `ellipse`: ``cv2.ellipse(img, center, axes, angle, start, end, color,
  thickness)``: filled (thickness < 0), full or a partial arc (closed
  through the centre), and arcs of any thickness;
- `circle`: ``cv2.circle(img, center, radius, color, -1)``, filled (OpenCV's
  midpoint circle);
- `line`: ``cv2.line(img, pt1, pt2, color, thickness)``.

On a float image cv2 turns ``LINE_AA`` into ``LINE_8`` (anti-aliasing
blends only 8-bit images), so these follow OpenCV's integer rasteriser
(drawing.cpp): `_ellipse2poly` with its 7-decimal sine table and its angle
rounded to whole degrees, points in 16-bit fixed point (``XY_SHIFT``),
the convex fill (`_fill_convex`, its outline drawn with the fixed-point
`_line2`), the general polygon fill (`_fill_edges`, its outline drawn with
the Bresenham `_line_points`, each row's span from the pixel at or right
of the left edge to the one at or left of the right edge) for a partial
filled arc, thick lines as a quad plus round joins (`_thick_line`; a
1-pixel stroke in fixed point is the Bresenham line of its rounded end
points, as in the OpenCV these follow) and the midpoint `_circle`. They
match cv2 (5.0) bitwise on every shape the synthetic faces draw, at any
position, and on full fills and circles cut by any edge of the image; a
partial fill or a thick line cut by a side edge (left or right) can
differ from cv2 in a few border pixels, and no face draws one. Colours
are stored as float32, as cv2 stores a Scalar on a float image. Each
call draws in place and returns the image.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np

__all__ = ["ellipse", "circle", "line", "SIN_TABLE"]

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT
_HALF = XY_ONE >> 1


def _sin_table() -> np.ndarray:
    """OpenCV's ``SinTable``: sin of 0..450 degrees as 7-decimal float
    literals (built from 0..90 by symmetry)."""
    quarter = [round(math.sin(math.radians(d)), 7) for d in range(91)]
    out = []
    for d in range(451):
        k, r = divmod(d, 90)
        v = quarter[r] if k % 2 == 0 else quarter[90 - r]
        out.append(-v if (d // 180) % 2 else v)
    table = np.array(out, np.float32)
    table.setflags(write=False)
    return table


SIN_TABLE = _sin_table()


def _round(v: float) -> int:
    """``cvRound``: to the nearest integer, halves to even."""
    return int(round(v))


def _cdiv(a: int, b: int) -> int:
    """C's integer division (truncates towards zero)."""
    q = abs(a) // abs(b)
    return q if (a < 0) == (b < 0) else -q


class _Painter:
    """Stores ``color`` (float32, one value a channel) into ``img``."""

    def __init__(self, img: np.ndarray, color):
        if img.dtype != np.float32 or img.ndim != 3:
            raise ValueError(f"draw takes an [H, W, C] float32 image, got {img.shape} "
                             f"{img.dtype}")
        self.img = img
        self.h, self.w, c = img.shape
        vals = list(color) if np.ndim(color) else [color]
        vals = (vals + [0.0] * c)[:c]
        self.color = np.array(vals, np.float64).astype(np.float32)

    def hline(self, y: int, x1: int, x2: int) -> None:
        self.img[y, x1:x2 + 1] = self.color

    def points(self, pts) -> None:
        if not len(pts):
            return
        p = np.asarray(pts, np.int64).reshape(-1, 2)
        keep = (p[:, 0] >= 0) & (p[:, 0] < self.w) & (p[:, 1] >= 0) & (p[:, 1] < self.h)
        p = p[keep]
        self.img[p[:, 1], p[:, 0]] = self.color


def _clip_line(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """OpenCV's ``clipLine`` on a w x h rectangle: (inside, x1, y1, x2, y2)."""
    right, bottom = w - 1, h - 1
    if w <= 0 or h <= 0:
        return False, x1, y1, x2, y2

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
    return (c1 | c2) == 0, x1, y1, x2, y2


def _line_points(w: int, h: int, x1: int, y1: int, x2: int, y2: int) -> List[Tuple[int, int]]:
    """The pixels of OpenCV's 8-connected ``LineIterator`` (left to
    right) from (x1, y1) to (x2, y2), clipped to the image."""
    if not (0 <= x1 < w and 0 <= x2 < w and 0 <= y1 < h and 0 <= y2 < h):
        ok, x1, y1, x2, y2 = _clip_line(w, h, x1, y1, x2, y2)
        if not ok:
            return []
    dx, dy = x2 - x1, y2 - y1
    if dx < 0:
        dx, dy = -dx, -dy
        x1, y1 = x2, y2
    sy = 1
    if dy < 0:
        dy, sy = -dy, -1
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    err, plus, minus = dx - 2 * dy, 2 * dx, -2 * dy
    x, y, pts = x1, y1, []
    for _ in range(dx + 1):
        pts.append((x, y))
        if err < 0:  # both axes move
            err += minus + plus
            x, y = x + 1, y + sy
        else:  # the main axis only
            err += minus
            if vert:
                y += sy
            else:
                x += 1
    return pts


def _line2(p: _Painter, x1: int, y1: int, x2: int, y2: int) -> None:
    """OpenCV's ``Line2``: an 8-connected line between two points in
    ``XY_SHIFT`` fixed point, stepping one pixel along the longer axis and
    a fixed-point slope along the other (the convex fill's outline)."""
    ok, x1, y1, x2, y2 = _clip_line(p.w << XY_SHIFT, p.h << XY_SHIFT, x1, y1, x2, y2)
    if not ok:
        return
    dx, dy = x2 - x1, y2 - y1
    ax, ay = abs(dx), abs(dy)
    if ax > ay:
        if dx < 0:
            dy = -dy
            x1, x2, y1, y2 = x2, x1, y2, y1
        step = _cdiv(dy << XY_SHIFT, ax | 1)
        ecount = (x2 - x1) >> XY_SHIFT
    else:
        if dy < 0:
            dx = -dx
            x1, x2, y1, y2 = x2, x1, y2, y1
        step = _cdiv(dx << XY_SHIFT, ay | 1)
        ecount = (y2 - y1) >> XY_SHIFT
    x1 += _HALF
    y1 += _HALF
    k = np.arange(max(ecount + 1, 0), dtype=np.int64)
    if ax > ay:
        xs, ys = (x1 >> XY_SHIFT) + k, (y1 + k * step) >> XY_SHIFT
    else:
        xs, ys = (x1 + k * step) >> XY_SHIFT, (y1 >> XY_SHIFT) + k
    p.points([((x2 + _HALF) >> XY_SHIFT, (y2 + _HALF) >> XY_SHIFT)])
    p.points(np.stack([xs, ys], axis=1))


def _fill_convex(p: _Painter, v: Sequence[Tuple[int, int]]) -> None:
    """OpenCV's ``FillConvexPoly`` (8-connected) of the points ``v`` in
    ``XY_SHIFT`` fixed point: the outline, then the scanlines."""
    npts = len(v)
    p0 = v[-1]
    xmin = xmax = v[0][0]
    ymin = ymax = v[0][1]
    imin = 0
    for i, q in enumerate(v):
        if q[1] < ymin:
            ymin, imin = q[1], i
        ymax, xmax, xmin = max(ymax, q[1]), max(xmax, q[0]), min(xmin, q[0])
        _line2(p, p0[0], p0[1], q[0], q[1])
        p0 = q
    xmin, xmax = (xmin + _HALF) >> XY_SHIFT, (xmax + _HALF) >> XY_SHIFT
    ymin, ymax = (ymin + _HALF) >> XY_SHIFT, (ymax + _HALF) >> XY_SHIFT
    if npts < 3 or xmax < 0 or ymax < 0 or xmin >= p.w or ymin >= p.h:
        return
    ymax = min(ymax, p.h - 1)
    # the two edges: [idx, di, x, dx, ye]
    edge = [[imin, 1, -XY_ONE, 0, ymin], [imin, npts - 1, -XY_ONE, 0, ymin]]
    edges = npts
    y = ymin
    while True:
        for e in edge:
            if y >= e[4]:
                idx0, di = e[0], e[1]
                idx = idx0 + di
                if idx >= npts:
                    idx -= npts
                while edges > 0:
                    edges -= 1
                    ty = (v[idx][1] + _HALF) >> XY_SHIFT
                    if ty > y:
                        xs, xe = v[idx0][0], v[idx][0]
                        e[4] = ty
                        e[3] = _cdiv((xe - xs) * 2 + (ty - y), 2 * (ty - y))
                        e[2] = xs
                        e[0] = idx
                        break
                    idx0 = idx
                    idx += di
                    if idx >= npts:
                        idx -= npts
                else:
                    edges -= 1  # the loop's last post-decrement
        if edges < 0:
            break
        if y >= 0:
            left, right = (1, 0) if edge[0][2] > edge[1][2] else (0, 1)
            xx1 = (edge[left][2] + _HALF) >> XY_SHIFT
            xx2 = (edge[right][2] + _HALF) >> XY_SHIFT
            if xx2 >= 0 and xx1 < p.w:
                p.hline(y, max(xx1, 0), min(xx2, p.w - 1))
        edge[0][2] += edge[0][3]
        edge[1][2] += edge[1][3]
        y += 1
        if y > ymax:
            break


class _Edge:
    __slots__ = ("y0", "y1", "x", "dx", "next")

    def __init__(self, y0, y1, x, dx):
        self.y0, self.y1, self.x, self.dx, self.next = y0, y1, x, dx, None


def _collect_edges(p: _Painter, v: Sequence[Tuple[int, int]]) -> List[_Edge]:
    """OpenCV's ``CollectPolyEdges`` (8-connected, no offset) of points in
    ``XY_SHIFT`` fixed point: draws each edge with the Bresenham line and
    returns the scan edges (x fixed point, y whole rows)."""
    edges = []
    pt0 = (v[-1][0], (v[-1][1] + _HALF) >> XY_SHIFT)
    for q in v:
        pt1 = (q[0], (q[1] + _HALF) >> XY_SHIFT)
        t0 = ((pt0[0] + _HALF) >> XY_SHIFT, pt0[1])
        t1 = ((pt1[0] + _HALF) >> XY_SHIFT, pt1[1])
        p.points(_line_points(p.w, p.h, t0[0], t0[1], t1[0], t1[1]))
        c0, c1 = list(pt0), list(pt1)
        if not (0 <= t0[0] < p.w and 0 <= t1[0] < p.w and 0 <= t0[1] < p.h
                and 0 <= t1[1] < p.h):
            # the clipped end points make the edge (its x at its own rows)
            _, a0, b0, a1, b1 = _clip_line(p.w, p.h, t0[0], t0[1], t1[0], t1[1])
            if b0 != b1:
                c0, c1 = [a0 << XY_SHIFT, b0], [a1 << XY_SHIFT, b1]
        if pt0[1] != pt1[1]:
            dx = _cdiv(c1[0] - c0[0], c1[1] - c0[1])
            if pt0[1] < pt1[1]:
                edges.append(_Edge(pt0[1], pt1[1], c0[0] + (pt0[1] - c0[1]) * dx, dx))
            else:
                edges.append(_Edge(pt1[1], pt0[1], c1[0] + (pt1[1] - c1[1]) * dx, dx))
        pt0 = pt1
    return edges


def _fill_edges(p: _Painter, edges: List[_Edge]) -> None:
    """OpenCV's ``FillEdgeCollection`` (8-connected): an active edge list
    kept sorted by x, spans between consecutive pairs."""
    total = len(edges)
    if total < 2:
        return
    y_max, y_min = -(1 << 31), (1 << 31) - 1
    x_max, x_min = -(1 << 63), (1 << 63) - 1
    for e in edges:
        x1 = e.x + (e.y1 - e.y0) * e.dx
        y_min, y_max = min(y_min, e.y0), max(y_max, e.y1)
        x_min, x_max = min(x_min, e.x, x1), max(x_max, e.x, x1)
    if y_max < 0 or y_min >= p.h or x_max < 0 or x_min >= (p.w << XY_SHIFT):
        return
    edges = sorted(edges, key=lambda e: (e.y0, e.x, e.dx))
    edges.append(_Edge((1 << 31) - 1, 0, 0, 0))
    tmp = _Edge(0, 0, 0, 0)
    i = 0
    e = edges[0]
    y_max = min(y_max, p.h)
    for y in range(e.y0, y_max):
        draw = False
        prelast, last = tmp, tmp.next
        while last is not None or e.y0 == y:
            if last is not None and last.y1 == y:  # the edge ends here
                prelast.next = last.next
                last = last.next
                continue
            keep_prelast = prelast
            if last is not None and (e.y0 > y or last.x < e.x):
                prelast, last = last, last.next
            elif i < total:  # the next edge starts here
                prelast.next = e
                e.next = last
                prelast = e
                i += 1
                e = edges[i]
            else:
                break
            if draw:
                if y >= 0:
                    # the pixels whose left edge lies within [left x, right x]
                    a, b = sorted((keep_prelast.x, prelast.x))
                    x1, x2 = (a + XY_ONE - 1) >> XY_SHIFT, b >> XY_SHIFT
                    if x1 < p.w and x2 >= 0:
                        p.hline(y, max(x1, 0), min(x2, p.w - 1))
                keep_prelast.x += keep_prelast.dx
                prelast.x += prelast.dx
            draw = not draw
        # bubble sort of the active list by x
        keep_prelast = None
        while True:
            prelast, last = tmp, tmp.next
            last_exchange = None
            while last is not keep_prelast and last.next is not None:
                te = last.next
                if last.x > te.x:
                    prelast.next = te
                    last.next = te.next
                    te.next = last
                    prelast = te
                    last_exchange = prelast
                else:
                    prelast, last = last, te
            if last_exchange is None:
                break
            keep_prelast = last_exchange
            if keep_prelast is tmp.next or keep_prelast is tmp:
                break


def _circle(p: _Painter, cx: int, cy: int, radius: int) -> None:
    """OpenCV's filled midpoint ``Circle``."""
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    while dx >= dy:
        for y, half in ((cy - dy, dx), (cy + dy, dx), (cy - dx, dy), (cy + dx, dy)):
            x1, x2 = max(cx - half, 0), min(cx + half, p.w - 1)
            if 0 <= y < p.h and x1 <= x2:
                p.hline(y, x1, x2)
        dy += 1
        err += plus
        plus += 2
        mask = 0 if err <= 0 else -1
        err -= minus & mask
        dx += mask
        minus -= mask & 2


def _ellipse2poly(center, axes, angle: int, arc_start: int, arc_end: int,
                 delta: int) -> List[Tuple[float, float]]:
    """OpenCV's double ``ellipse2Poly``: the arc's points every ``delta``
    degrees (and the end), from the sine table, with float32 rotation."""
    if not 0 < delta <= 180:
        raise ValueError(f"delta must be in (0, 180], got {delta}")
    while angle < 0:
        angle += 360
    while angle > 360:
        angle -= 360
    if arc_start > arc_end:
        arc_start, arc_end = arc_end, arc_start
    while arc_start < 0:
        arc_start, arc_end = arc_start + 360, arc_end + 360
    while arc_end > 360:
        arc_start, arc_end = arc_start - 360, arc_end - 360
    if arc_end - arc_start > 360:
        arc_start, arc_end = 0, 360
    beta = float(SIN_TABLE[angle])
    alpha = float(SIN_TABLE[450 - angle])
    cx, cy = float(center[0]), float(center[1])
    aw, ah = float(axes[0]), float(axes[1])
    pts = []
    for i in range(arc_start, arc_end + delta, delta):
        a = min(i, arc_end)
        if a < 0:
            a += 360
        x = aw * float(SIN_TABLE[450 - a])
        y = ah * float(SIN_TABLE[a])
        pts.append((cx + x * alpha - y * beta, cy + x * beta + y * alpha))
    if len(pts) == 1:
        pts = [(cx, cy), (cx, cy)]
    return pts


def _thick_line(p: _Painter, p0, p1, thickness: int, flags: int, shift: int) -> None:
    """OpenCV's ``ThickLine`` (8-connected) between points in ``shift``-bit
    fixed point; ``flags`` bit 0 / 1: a round cap at the start / the end."""
    up = XY_SHIFT - shift
    p0 = (p0[0] << up, p0[1] << up)
    p1 = (p1[0] << up, p1[1] << up)
    if thickness <= 1:
        # the rounded end points' 8-connected line, with or without a shift
        # (the OpenCV these follow draws a thin fixed-point line so)
        p.points(_line_points(p.w, p.h, (p0[0] + _HALF) >> XY_SHIFT,
                              (p0[1] + _HALF) >> XY_SHIFT, (p1[0] + _HALF) >> XY_SHIFT,
                              (p1[1] + _HALF) >> XY_SHIFT))
        return
    dx = (p0[0] - p1[0]) / XY_ONE
    dy = (p1[1] - p0[1]) / XY_ONE
    r = dx * dx + dy * dy
    odd = thickness & 1
    thickness <<= XY_SHIFT - 1
    if abs(r) > np.finfo(np.float64).eps:
        r = (thickness + odd * XY_ONE * 0.5) / math.sqrt(r)
        ddx, ddy = _round(dy * r), _round(dx * r)
        quad = [(p0[0] + ddx, p0[1] + ddy), (p0[0] - ddx, p0[1] - ddy),
                (p1[0] - ddx, p1[1] - ddy), (p1[0] + ddx, p1[1] + ddy)]
        _fill_convex(p, quad)
    for i in range(2):
        if flags & (i + 1):
            _circle(p, (p0[0] + _HALF) >> XY_SHIFT, (p0[1] + _HALF) >> XY_SHIFT,
                    (thickness + _HALF) >> XY_SHIFT)
        p0 = p1


def _ellipse_ex(p: _Painter, center, axes, angle: int, arc_start: int, arc_end: int,
                thickness: int) -> None:
    """OpenCV's ``EllipseEx`` on a centre and axes in ``XY_SHIFT`` fixed
    point."""
    aw, ah = abs(axes[0]), abs(axes[1])
    delta = (max(aw, ah) + _HALF) >> XY_SHIFT
    delta = 90 if delta < 3 else 30 if delta < 10 else 18 if delta < 15 else 5
    v: List[Tuple[int, int]] = []
    for x, y in _ellipse2poly(center, (aw, ah), angle, arc_start, arc_end, delta):
        px = _round(x / XY_ONE) << XY_SHIFT
        py = _round(y / XY_ONE) << XY_SHIFT
        pt = (px + _round(x - px), py + _round(y - py))
        if not v or pt != v[-1]:
            v.append(pt)
    if len(v) == 1:
        v = [tuple(center), tuple(center)]
    if thickness >= 0:
        for i in range(1, len(v)):  # PolyLine, open
            _thick_line(p, v[i - 1], v[i], thickness, 3 if i == 1 else 2, XY_SHIFT)
    elif arc_end - arc_start >= 360:
        _fill_convex(p, v)
    else:
        v.append(tuple(center))
        _fill_edges(p, _collect_edges(p, v))


def ellipse(img: np.ndarray, center, axes, angle: float, start_angle: float,
            end_angle: float, color, thickness: int = 1) -> np.ndarray:
    """``cv2.ellipse(img, center, axes, angle, start_angle, end_angle,
    color, thickness)`` on a float32 image (8-connected; the angles are
    rounded to whole degrees, as OpenCV does); thickness < 0 fills."""
    p = _Painter(img, color)
    c = (int(center[0]) << XY_SHIFT, int(center[1]) << XY_SHIFT)
    a = (int(axes[0]) << XY_SHIFT, int(axes[1]) << XY_SHIFT)
    if a[0] < 0 or a[1] < 0:
        raise ValueError(f"axes must be non-negative, got {axes}")
    _ellipse_ex(p, c, a, _round(angle), _round(start_angle), _round(end_angle),
                int(thickness))
    return img


def circle(img: np.ndarray, center, radius: int, color, thickness: int = -1) -> np.ndarray:
    """``cv2.circle(img, center, radius, color, -1)`` on a float32 image:
    OpenCV's filled 8-connected midpoint circle (the only circle the faces
    draw; an outline raises)."""
    if thickness >= 0:
        raise NotImplementedError("circle: only filled circles (thickness < 0) are drawn")
    if radius < 0:
        raise ValueError(f"radius must be non-negative, got {radius}")
    _circle(_Painter(img, color), int(center[0]), int(center[1]), int(radius))
    return img


def line(img: np.ndarray, pt1, pt2, color, thickness: int = 1) -> np.ndarray:
    """``cv2.line(img, pt1, pt2, color, thickness)`` on a float32 image
    (8-connected, round caps)."""
    if not 0 < thickness:
        raise ValueError(f"thickness must be positive, got {thickness}")
    p = _Painter(img, color)
    _thick_line(p, (int(pt1[0]), int(pt1[1])), (int(pt2[0]), int(pt2[1])), int(thickness),
                3, 0)
    return img
