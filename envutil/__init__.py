"""envutil: an environment-image conversion framework on NVIDIA GPUs.

A from-scratch JAX/XLA re-design with the capabilities of the
reference C++/SIMD tool `envutil` (kfjahnke/envutil): reprojection
between spherical / cylindrical / rectilinear / stereographic / fisheye
/ cubemap / biatan6 environment images, multi-facet panorama stitching
(spherical voronoi), HDR exposure merging, PTO lens correction, and
"twining" anti-aliasing - all rendered as jitted XLA programs over
output-raster grids, with b-spline interpolation of any degree.

Package layout:
  core/      conventions, projection geometry, rotations, metrics
  ops/       compute primitives: b-spline prefilter/eval, gathers
  models/    rendering pipeline: steppers, environments, synopsis, twining
  io/        image I/O (native EXR shim), PTO parser, colour management
  parallel/  device-mesh sharding of the render grid
  runtime/   CLI, args, asset cache, orchestration, serve mode
"""

__version__ = "0.1.0"

from .core.conventions import Projection, Face  # noqa: F401
