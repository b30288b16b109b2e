"""Large lat/lon sphere meshes: the scene-size axis of the benchmark.

One matte sphere of radius 4 at z = 10 seen head-on, tessellated with
`make_sphere` (raytrace.rs:464-529) at `segments` latitude and longitude
rows: 224 gives 99,904 triangles, 708 gives 1,001,112.  The geometry is
trivial to shade, so the render time is the traversal's; at 1M triangles the
page tables (~70 MB) are far larger than the card's L2 cache.
"""

from .. import math3d as m3
from ..camera import create_viewport
from ..geometry import make_sphere
from ..materials import matte
from ..scene import assemble

RESOLUTIONS = {"dev": (64, 36), "2k": (2560, 1440)}


def build(resolution="2k", maxdepth: int = 5, samples: int = 1,
          segments: int = 224):
    if isinstance(resolution, str):
        width, height = RESOLUTIONS[resolution]
    else:
        width, height = resolution
    sphere = make_sphere((0.0, 0.0, 10.0), 4.0, (segments, segments),
                         matte(m3.make_color((252, 119, 0)), 0.2), 0.0)
    viewport = create_viewport(
        px=(width, height), size=(1.6, 0.9), pos=(0.0, 0.0, 0.0),
        dir=m3.unit(m3.vec(0.0, 0.0, 1.0)), fov_deg=90.0, c_roll=0.0,
        maxdepth=maxdepth, samples=samples)
    return assemble([sphere]), viewport
