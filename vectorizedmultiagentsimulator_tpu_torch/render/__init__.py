"""Rendering package: the port's copy of the JAX package's numpy software
rasterizer (``rgb_array`` frames with numpy only, ``human`` mode through
matplotlib), in place of the reference's pyglet/OpenGL viewer
(``vmas/simulator/rendering.py``).  The geometry of entities, sensors and
joints is built in ``rasterizer.py``.
"""
from vectorizedmultiagentsimulator_tpu_torch.render.rasterizer import (
    Geom,
    Circle,
    Grid,
    Image,
    Line,
    Polygon,
    Segment,
    TextLine,
    Transform,
    Viewer,
    entity_geoms,
    joint_geoms,
    lidar_geoms,
    make_circle,
    make_ellipse,
    make_line,
    make_polygon,
    render_function_util,
)

__all__ = [
    "Geom",
    "Circle",
    "Grid",
    "Image",
    "Line",
    "Polygon",
    "Segment",
    "TextLine",
    "Transform",
    "Viewer",
    "entity_geoms",
    "joint_geoms",
    "lidar_geoms",
    "make_circle",
    "make_ellipse",
    "make_line",
    "make_polygon",
    "render_function_util",
]
