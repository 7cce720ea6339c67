"""raytpu — a differentiable Whitted ray tracer for the GPU.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the reference
CPU ray tracer (JonathanMenschaert/GP1_Raytracer_2223): camera ray generation,
sphere/plane/triangle intersection, Lambert / Lambert-Phong / Cook-Torrance
shading, point-light hard shadows, OBJ meshes, per-frame mesh animation —
expressed as pure-functional batched array programs instead of per-pixel
object-oriented loops.

Layer map (mirrors SURVEY.md §7):
  raytpu.core     — math conventions, scene schema (SoA pytrees), camera, OBJ, scenes
  raytpu.oracle   — scalar NumPy golden renderer (the test fixture)
  raytpu.ops      — batched intersection + shading formulas
  raytpu.render   — jitted forward pass and Pallas megakernel
  raytpu.grad     — differentiable (soft-visibility) rendering
  raytpu.parallel — device-mesh sharding (pixel DP, primitive sharding)
  raytpu.app      — CLI, timer/benchmark, image IO
  raytpu.native   — C++ host runtime (OBJ parse, BVH/Morton sort, BMP, timer)
"""

from raytpu.core.types import (  # noqa: F401
    Camera,
    CullMode,
    LightingMode,
    LightKind,
    MaterialKind,
    RenderConfig,
    Scene,
    SceneBuilder,
)

__version__ = "0.1.0"
