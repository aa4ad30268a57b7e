"""Dependency-free software rasterizer for headless rendering.

The port's own copy of the JAX package's numpy rasterizer
(``vectorizedmultiagentsimulator_tpu/render/rasterizer.py``), which
replaces the reference's pyglet/OpenGL viewer (``vmas/simulator/
rendering.py``): circles, convex polygons and segments are drawn into an
RGB uint8 canvas on the host, so ``mode="rgb_array"`` needs numpy only;
``mode="human"`` displays frames through matplotlib where it is installed.

Each circle, polygon and segment is masked over the window of the canvas
its pixels can lie in (``Viewer._window``), not over the whole canvas as
the JAX package masks it: the same pixels, in a time that grows with the
geom's size instead of the canvas's (a road_traffic frame draws
thousands of lanelet segments).

The geometry builders (``entity_geoms``, ``lidar_geoms``, ``joint_geoms``)
read the port's objects.  ``Environment.render`` calls them while the world
is bound to a one-env copy of the state on the host, so every tensor they
read lies on the CPU.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np


class Transform:
    """Reference-compatible transform attribute (rendering.py:280-311):
    geoms accept ``add_attr(Transform())`` and the viewer resolves the
    translation/rotation/scale chain at draw time."""

    def __init__(self, translation=(0.0, 0.0), rotation: float = 0.0,
                 scale=(1.0, 1.0)):
        self.translation = (float(translation[0]), float(translation[1]))
        self.rotation = float(rotation)
        self.scale = (float(scale[0]), float(scale[1]))

    def set_translation(self, newx, newy):
        self.translation = (float(newx), float(newy))
        return self

    def set_rotation(self, new):
        self.rotation = float(new)
        return self

    def set_scale(self, newx, newy):
        self.scale = (float(newx), float(newy))
        return self

    def apply(self, pts: np.ndarray) -> np.ndarray:
        pts = pts * np.asarray(self.scale, dtype=np.float64)
        pts = _rot(pts, self.rotation)
        return pts + np.asarray(self.translation, dtype=np.float64)


@dataclass
class Geom:
    color: Tuple[float, float, float] = (0.25, 0.25, 0.25)
    alpha: float = 1.0
    attrs: list = field(default_factory=list)

    def set_color(self, r, g, b, alpha: float = 1.0):
        self.color = (float(r), float(g), float(b))
        self.alpha = float(alpha)
        return self

    def add_attr(self, attr):
        self.attrs.append(attr)
        return self

    def _transform_pts(self, pts: np.ndarray) -> np.ndarray:
        for attr in reversed(self.attrs):
            if isinstance(attr, Transform):
                pts = attr.apply(pts)
        return pts


@dataclass
class Circle(Geom):
    center: Tuple[float, float] = (0.0, 0.0)
    radius: float = 0.05
    filled: bool = True


@dataclass
class Polygon(Geom):
    points: Sequence[Tuple[float, float]] = field(default_factory=list)
    filled: bool = True


@dataclass
class Segment(Geom):
    start: Tuple[float, float] = (0.0, 0.0)
    end: Tuple[float, float] = (0.0, 0.0)
    width: float = 0.01  # world units


@dataclass
class Image(Geom):
    """Pre-rasterized RGBA field plot covering plot_range."""

    data: Optional[np.ndarray] = None  # [H, W, 4] float 0..1
    x_range: Tuple[float, float] = (-1, 1)
    y_range: Tuple[float, float] = (-1, 1)


# Classic 5x7 column-major bitmap font (bit 0 = top row); enough glyphs
# for the comm-message / interactive-play overlays.  Unknown characters
# render as blanks; lowercase maps to uppercase.
_FONT_5X7 = {
    " ": (0x00, 0x00, 0x00, 0x00, 0x00),
    "0": (0x3E, 0x51, 0x49, 0x45, 0x3E),
    "1": (0x00, 0x42, 0x7F, 0x40, 0x00),
    "2": (0x42, 0x61, 0x51, 0x49, 0x46),
    "3": (0x21, 0x41, 0x45, 0x4B, 0x31),
    "4": (0x18, 0x14, 0x12, 0x7F, 0x10),
    "5": (0x27, 0x45, 0x45, 0x45, 0x39),
    "6": (0x3C, 0x4A, 0x49, 0x49, 0x30),
    "7": (0x01, 0x71, 0x09, 0x05, 0x03),
    "8": (0x36, 0x49, 0x49, 0x49, 0x36),
    "9": (0x06, 0x49, 0x49, 0x29, 0x1E),
    "A": (0x7E, 0x11, 0x11, 0x11, 0x7E),
    "B": (0x7F, 0x49, 0x49, 0x49, 0x36),
    "C": (0x3E, 0x41, 0x41, 0x41, 0x22),
    "D": (0x7F, 0x41, 0x41, 0x22, 0x1C),
    "E": (0x7F, 0x49, 0x49, 0x49, 0x41),
    "F": (0x7F, 0x09, 0x09, 0x09, 0x01),
    "G": (0x3E, 0x41, 0x49, 0x49, 0x7A),
    "H": (0x7F, 0x08, 0x08, 0x08, 0x7F),
    "I": (0x00, 0x41, 0x7F, 0x41, 0x00),
    "J": (0x20, 0x40, 0x41, 0x3F, 0x01),
    "K": (0x7F, 0x08, 0x14, 0x22, 0x41),
    "L": (0x7F, 0x40, 0x40, 0x40, 0x40),
    "M": (0x7F, 0x02, 0x0C, 0x02, 0x7F),
    "N": (0x7F, 0x04, 0x08, 0x10, 0x7F),
    "O": (0x3E, 0x41, 0x41, 0x41, 0x3E),
    "P": (0x7F, 0x09, 0x09, 0x09, 0x06),
    "Q": (0x3E, 0x41, 0x51, 0x21, 0x5E),
    "R": (0x7F, 0x09, 0x19, 0x29, 0x46),
    "S": (0x46, 0x49, 0x49, 0x49, 0x31),
    "T": (0x01, 0x01, 0x7F, 0x01, 0x01),
    "U": (0x3F, 0x40, 0x40, 0x40, 0x3F),
    "V": (0x1F, 0x20, 0x40, 0x20, 0x1F),
    "W": (0x3F, 0x40, 0x38, 0x40, 0x3F),
    "X": (0x63, 0x14, 0x08, 0x14, 0x63),
    "Y": (0x07, 0x08, 0x70, 0x08, 0x07),
    "Z": (0x61, 0x51, 0x49, 0x45, 0x43),
    "[": (0x00, 0x7F, 0x41, 0x41, 0x00),
    "]": (0x00, 0x41, 0x41, 0x7F, 0x00),
    "(": (0x00, 0x1C, 0x22, 0x41, 0x00),
    ")": (0x00, 0x41, 0x22, 0x1C, 0x00),
    ",": (0x00, 0x50, 0x30, 0x00, 0x00),
    ".": (0x00, 0x60, 0x60, 0x00, 0x00),
    "-": (0x08, 0x08, 0x08, 0x08, 0x08),
    "_": (0x40, 0x40, 0x40, 0x40, 0x40),
    ":": (0x00, 0x36, 0x36, 0x00, 0x00),
    ";": (0x00, 0x56, 0x36, 0x00, 0x00),
    "=": (0x14, 0x14, 0x14, 0x14, 0x14),
    "+": (0x08, 0x08, 0x3E, 0x08, 0x08),
    "/": (0x20, 0x10, 0x08, 0x04, 0x02),
    "'": (0x00, 0x05, 0x03, 0x00, 0x00),
    "<": (0x08, 0x14, 0x22, 0x41, 0x00),
    ">": (0x00, 0x41, 0x22, 0x14, 0x08),
}


class TextLine(Geom):
    """Screen-space text overlay (reference ``rendering.TextLine``,
    rendering.py:277-313, pyglet Label → dependency-free bitmap font).

    ``x``/``y`` are pixel coordinates from the bottom-left corner, like
    the reference's pyglet label placement.
    """

    def __init__(self, text: str = "", font_size: int = 15,
                 x: float = 0.0, y: float = 0.0):
        super().__init__()
        self.text = str(text)
        self.font_size = int(font_size)
        self.x = float(x)
        self.y = float(y)
        self.set_color(0.0, 0.0, 0.0)

    def set_text(self, text: str, font_size: Optional[int] = None):
        self.text = str(text)
        if font_size is not None:
            self.font_size = int(font_size)
        return self

    def render(self):  # reference API no-op (drawing happens in Viewer)
        return self


def _rot(points: np.ndarray, angle: float) -> np.ndarray:
    c, s = math.cos(angle), math.sin(angle)
    return points @ np.array([[c, s], [-s, c]], dtype=np.float64).T


class Viewer:
    """Minimal camera + canvas."""

    def __init__(self, width: int = 700, height: int = 700, visible: bool = False):
        self.width = width
        self.height = height
        self.bounds = None  # (xmin, xmax, ymin, ymax)
        self.geoms: List[Geom] = []
        self._onetime: List[Geom] = []
        self._mpl = None

    def set_bounds(self, xmin, xmax, ymin, ymax):
        self.bounds = (float(xmin), float(xmax), float(ymin), float(ymax))

    def add_onetime(self, geom: Geom):
        if geom is not None:
            self._onetime.append(geom)

    def add_onetime_list(self, geoms):
        for g in geoms or []:
            self.add_onetime(g)

    # -------------------------------------------------------------- #
    def _world_to_px(self, xy: np.ndarray) -> np.ndarray:
        xmin, xmax, ymin, ymax = self.bounds
        u = (xy[..., 0] - xmin) / (xmax - xmin) * self.width
        v = (1 - (xy[..., 1] - ymin) / (ymax - ymin)) * self.height
        return np.stack([u, v], axis=-1)

    def _px_per_unit(self) -> float:
        xmin, xmax, _, _ = self.bounds
        return self.width / (xmax - xmin)

    def render(self, return_rgb_array: bool = False):
        if self.bounds is None:
            self.set_bounds(-1.2, 1.2, -1.2, 1.2)
        canvas = np.ones((self.height, self.width, 3), dtype=np.float32)
        for geom in list(self.geoms) + self._onetime:
            self._draw(canvas, geom)
        self._onetime = []
        frame = (np.clip(canvas, 0, 1) * 255).astype(np.uint8)
        if return_rgb_array:
            return frame
        self._show(frame)
        return True

    def _show(self, frame: np.ndarray):
        try:
            import matplotlib.pyplot as plt

            if self._mpl is None:
                plt.ion()
                fig, ax = plt.subplots()
                im = ax.imshow(frame)
                ax.axis("off")
                self._mpl = (fig, ax, im)
            else:
                fig, ax, im = self._mpl
                im.set_data(frame)
            self._mpl[0].canvas.draw_idle()
            import matplotlib.pyplot as plt  # noqa: F811

            plt.pause(0.001)
        except Exception:
            pass

    def close(self):
        if self._mpl is not None:
            import matplotlib.pyplot as plt

            plt.close(self._mpl[0])
            self._mpl = None

    # -------------------------------------------------------------- #
    def _blend(self, canvas, mask, color, alpha):
        if not mask.any():
            return
        c = np.asarray(color, dtype=np.float32)
        canvas[mask] = canvas[mask] * (1 - alpha) + c[None, :] * alpha

    def _window(self, xs, ys, reach):
        """``(rows, cols)`` slices of the canvas that hold every pixel within
        ``reach`` of the box of ``xs``, ``ys`` (pixel coordinates): a geom's
        mask is made there only, which gives the pixels the whole canvas
        would.  The whole canvas where a coordinate is not finite."""
        lo_x, hi_x = float(np.min(xs)) - reach, float(np.max(xs)) + reach
        lo_y, hi_y = float(np.min(ys)) - reach, float(np.max(ys)) + reach
        if not np.isfinite([lo_x, hi_x, lo_y, hi_y]).all():
            return slice(0, self.height), slice(0, self.width)
        x0 = min(max(math.floor(lo_x) - 1, 0), self.width)
        x1 = min(max(math.ceil(hi_x) + 2, 0), self.width)
        y0 = min(max(math.floor(lo_y) - 1, 0), self.height)
        y1 = min(max(math.ceil(hi_y) + 2, 0), self.height)
        return slice(y0, y1), slice(x0, x1)

    def _draw(self, canvas, geom: Geom):
        if isinstance(geom, Circle):
            world = geom._transform_pts(
                np.asarray(
                    [geom.center, (geom.center[0] + geom.radius, geom.center[1])],
                    dtype=np.float64,
                )
            )
            center = self._world_to_px(world[0])
            r = float(np.linalg.norm(world[1] - world[0])) * self._px_per_unit()
            rows, cols = self._window(center[0], center[1], r + 1.0)
            yy, xx = np.mgrid[rows, cols]
            d2 = (xx - center[0]) ** 2 + (yy - center[1]) ** 2
            mask = d2 <= r * r if geom.filled else np.abs(np.sqrt(d2) - r) <= 1.0
            self._blend(canvas[rows, cols], mask, geom.color, geom.alpha)
        elif isinstance(geom, Polygon):
            world = geom._transform_pts(np.asarray(geom.points, dtype=np.float64))
            pts = self._world_to_px(world)
            if len(pts) < 2:
                return
            rows, cols = self._window(pts[:, 0], pts[:, 1], 0.0)
            yy, xx = np.mgrid[rows, cols]
            mask = _polygon_mask(pts, yy, xx)
            self._blend(canvas[rows, cols], mask, geom.color, geom.alpha)
        elif isinstance(geom, Segment):
            world = geom._transform_pts(
                np.asarray([geom.start, geom.end], dtype=np.float64)
            )
            p0 = self._world_to_px(world[0])
            p1 = self._world_to_px(world[1])
            half_w = max(geom.width * self._px_per_unit() / 2, 0.5)
            rows, cols = self._window([p0[0], p1[0]], [p0[1], p1[1]], half_w)
            yy, xx = np.mgrid[rows, cols]
            mask = _segment_mask(p0, p1, half_w, yy, xx)
            self._blend(canvas[rows, cols], mask, geom.color, geom.alpha)
        elif isinstance(geom, Image) and geom.data is not None:
            self._draw_image(canvas, geom)
        elif isinstance(geom, TextLine):
            self._draw_text(canvas, geom)

    def _draw_text(self, canvas, geom: "TextLine"):
        if not geom.text:
            return
        scale = max(1, round(geom.font_size / 8))
        glyph_w, glyph_h = 6 * scale, 7 * scale
        # pyglet anchors at bottom-left with y up; canvas rows go top-down
        x0 = int(round(geom.x))
        y0 = self.height - int(round(geom.y)) - glyph_h
        for ci, ch in enumerate(geom.text):
            cols = _FONT_5X7.get(ch.upper() if ch.islower() else ch)
            if cols is None:
                continue
            cx = x0 + ci * glyph_w
            if cx >= self.width or cx + 5 * scale < 0:
                continue
            glyph = np.zeros((7, 5), dtype=bool)
            for col, bits in enumerate(cols):
                for row in range(7):
                    if bits >> row & 1:
                        glyph[row, col] = True
            glyph = np.kron(glyph, np.ones((scale, scale), dtype=bool))
            gy0 = max(y0, 0)
            gx0 = max(cx, 0)
            gy1 = min(y0 + glyph_h, self.height)
            gx1 = min(cx + 5 * scale, self.width)
            if gy1 <= gy0 or gx1 <= gx0:
                continue
            sub = glyph[gy0 - y0 : gy1 - y0, gx0 - cx : gx1 - cx]
            region = canvas[gy0:gy1, gx0:gx1]
            c = np.asarray(geom.color, dtype=np.float32)
            region[sub] = (
                region[sub] * (1 - geom.alpha) + c[None, :] * geom.alpha
            )

    def _draw_image(self, canvas, geom: "Image"):
        xmin, xmax, ymin, ymax = self.bounds
        h, w = canvas.shape[:2]
        yy, xx = np.mgrid[0:h, 0:w]
        wx = xmin + (xx + 0.5) / w * (xmax - xmin)
        wy = ymax - (yy + 0.5) / h * (ymax - ymin)
        gx0, gx1 = geom.x_range
        gy0, gy1 = geom.y_range
        H, W = geom.data.shape[:2]
        ix = ((wx - gx0) / max(gx1 - gx0, 1e-9) * (W - 1)).round().astype(int)
        iy = ((wy - gy0) / max(gy1 - gy0, 1e-9) * (H - 1)).round().astype(int)
        valid = (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)
        rgba = np.zeros((h, w, 4), dtype=np.float32)
        rgba[valid] = geom.data[iy[valid], ix[valid]]
        a = rgba[..., 3:4]
        canvas[...] = canvas * (1 - a) + rgba[..., :3] * a


def _polygon_mask(pts: np.ndarray, yy: np.ndarray, xx: np.ndarray) -> np.ndarray:
    inside = np.ones(yy.shape, dtype=bool)
    n = len(pts)
    sign = 0.0
    for i in range(n):
        x0, y0 = pts[i]
        x1, y1 = pts[(i + 1) % n]
        cross = (x1 - x0) * (yy - y0) - (y1 - y0) * (xx - x0)
        if sign == 0.0:
            area2 = sum(
                pts[j][0] * pts[(j + 1) % n][1] - pts[(j + 1) % n][0] * pts[j][1]
                for j in range(n)
            )
            sign = 1.0 if area2 >= 0 else -1.0
        inside &= cross * sign >= 0
    return inside


def _segment_mask(p0, p1, half_w, yy, xx) -> np.ndarray:
    d = p1 - p0
    L2 = float(d @ d)
    if L2 < 1e-9:
        dist2 = (xx - p0[0]) ** 2 + (yy - p0[1]) ** 2
        return dist2 <= half_w**2
    t = ((xx - p0[0]) * d[0] + (yy - p0[1]) * d[1]) / L2
    t = np.clip(t, 0.0, 1.0)
    px = p0[0] + t * d[0]
    py = p0[1] + t * d[1]
    dist2 = (xx - px) ** 2 + (yy - py) ** 2
    return dist2 <= half_w**2


# ------------------------------------------------------------------ #
# Geometry builders used by entities / sensors / joints
# ------------------------------------------------------------------ #
def entity_geoms(entity, env_index: int = 0) -> List[Geom]:
    from vectorizedmultiagentsimulator_tpu_torch.core import shapes as shp

    world = entity._world
    key = entity._extras_key("is_rendering")
    if world.has_extra(key) and not bool(world.get_extra(key)[env_index]):
        return []
    pos = np.asarray(entity.state.pos)[env_index]
    rot = float(np.asarray(entity.state.rot)[env_index, 0])
    color = entity.color
    alpha = getattr(entity, "_alpha", 1.0)
    shape = entity.shape
    if isinstance(shape, shp.Sphere):
        g: Geom = Circle(center=tuple(pos), radius=shape.radius)
    elif isinstance(shape, shp.Box):
        l, w = shape.length / 2, shape.width / 2
        corners = np.array([[-l, -w], [-l, w], [l, w], [l, -w]])
        corners = _rot(corners, rot) + pos
        g = Polygon(points=[tuple(p) for p in corners])
    elif isinstance(shape, shp.Line):
        half = np.array([shape.length / 2, 0.0])
        p0 = _rot(-half[None], rot)[0] + pos
        p1 = _rot(half[None], rot)[0] + pos
        g = Segment(start=tuple(p0), end=tuple(p1), width=0.01)
    else:
        return []
    g.set_color(*color[:3], alpha=alpha)
    return [g]


def lidar_geoms(lidar, meas: np.ndarray, env_index: int = 0) -> List[Geom]:
    """The rays of ``lidar`` for the distances ``meas`` ``[n_rays]`` of env
    ``env_index``."""
    geoms: List[Geom] = []
    pos = np.asarray(lidar.agent.state.pos)[env_index]
    rot = float(np.asarray(lidar.agent.state.rot)[env_index, 0])
    angles = np.asarray(lidar.angles_key, dtype=np.float32) + rot
    for angle, dist in zip(angles, meas):
        end = pos + np.array([math.cos(angle), math.sin(angle)]) * float(dist)
        ray = Segment(start=tuple(pos), end=tuple(end), width=0.002)
        ray.set_color(0, 0, 0, alpha=lidar.alpha)
        hit = Circle(center=tuple(end), radius=0.01)
        hit.set_color(*lidar.render_color[:3], alpha=lidar.alpha)
        geoms += [ray, hit]
    return geoms


def joint_geoms(constraint, env_index: int = 0) -> List[Geom]:
    import torch

    from vectorizedmultiagentsimulator_tpu_torch.utils import TorchUtils

    if constraint.dist == 0:
        return []

    def anchor_pos(entity, anchor):
        pos = entity.state.pos
        delta = torch.tensor(entity.shape.get_delta_from_anchor(anchor),
                             dtype=torch.float32)
        return pos + TorchUtils.rotate_vector(delta.expand(pos.shape),
                                              entity.state.rot)

    pa = np.asarray(anchor_pos(constraint.entity_a,
                               constraint.anchor_a))[env_index]
    pb = np.asarray(anchor_pos(constraint.entity_b,
                               constraint.anchor_b))[env_index]
    seg = Segment(start=tuple(pa), end=tuple(pb), width=0.004)
    seg.set_color(0.15, 0.15, 0.15)
    return [seg]


# ------------------------------------------------------------------ #
# Reference-compatible geometry factories (rendering.py:524-560).
# Scenario ``extra_render`` code uses these with Transform attrs.
# ------------------------------------------------------------------ #
def make_circle(radius: float = 10, res: int = 30, filled: bool = True,
                angle: float = 2 * math.pi) -> Geom:
    if angle % (2 * math.pi) != 0:  # sector (e.g. football shooting cone)
        return make_ellipse(radius, radius, res=res, filled=filled,
                            angle=angle)
    del res
    return Circle(center=(0.0, 0.0), radius=radius, filled=filled)


def make_ellipse(radius_x: float = 10, radius_y: float = 5, res: int = 30,
                 filled: bool = True, angle: float = 2 * math.pi) -> Geom:
    """Ellipse/sector polygon (reference rendering.py make_ellipse): arc
    points spanning [-angle/2, angle/2], closed through the centre when the
    angle is partial."""
    points = []
    for i in range(res):
        a = -angle / 2 + angle * i / res
        points.append((math.cos(a) * radius_x, math.sin(a) * radius_y))
    if angle % (2 * math.pi) != 0:
        points.append((0.0, 0.0))
    return Polygon(points=points, filled=filled)


def make_polygon(v, filled: bool = True) -> Polygon:
    return Polygon(points=[tuple(p) for p in v], filled=filled)


def make_line(length: float = 1.0, width: float = 0.01) -> Segment:
    """A horizontal segment of ``length`` centred at the origin (matches the
    reference's ``Line.get_geometry()`` convention, core.py:177-203)."""
    return Segment(start=(-length / 2, 0.0), end=(length / 2, 0.0), width=width)


class Line(Segment):
    """Reference-style two-point line geom (rendering.py:415-430)."""

    def __init__(self, start=(0.0, 0.0), end=(0.0, 0.0), width: float = 0.01):
        super().__init__(start=tuple(start), end=tuple(end), width=width)


class Grid(Geom):
    """Reference-style background grid (rendering.py:433-452) — rendered as
    segments at draw time by expanding in the viewer."""

    def __init__(self, spacing: float = 0.1, length: float = 25.0,
                 width: float = 0.5):
        super().__init__()
        self.spacing = spacing
        self.length = length
        self.width = width


def render_function_util(
    f,
    precision: float,
    plot_range,
    cmap_range=None,
    cmap_alpha: float = 1.0,
    cmap_name: str = "viridis",
) -> Image:
    """Field-plot helper (reference rendering.py:453-521): evaluates ``f``
    on a grid and returns an Image geom."""
    (x0, x1), (y0, y1) = plot_range
    xs = np.arange(x0, x1, precision)
    ys = np.arange(y0, y1, precision)
    gx, gy = np.meshgrid(xs, ys)
    pts = np.stack([gx.ravel(), gy.ravel()], axis=-1)
    vals = np.asarray(f(pts))
    if vals.ndim == 1:
        vals = vals[:, None]
    if vals.shape[-1] == 1:
        v = vals[:, 0].astype(np.float64)
        lo = np.nanmin(v) if cmap_range is None else cmap_range[0]
        hi = np.nanmax(v) if cmap_range is None else cmap_range[1]
        vnorm = np.clip((v - lo) / max(hi - lo, 1e-9), 0, 1)
        try:
            import matplotlib.cm as cm

            rgba = cm.get_cmap(cmap_name)(vnorm)
        except Exception:
            rgba = np.stack(
                [vnorm, 0.5 * np.ones_like(vnorm), 1 - vnorm, np.ones_like(vnorm)],
                axis=-1,
            )
        rgba[..., 3] = cmap_alpha
    else:
        rgba = vals
    img = rgba.reshape(len(ys), len(xs), 4).astype(np.float32)
    return Image(data=img, x_range=(x0, x1), y_range=(y0, y1))
