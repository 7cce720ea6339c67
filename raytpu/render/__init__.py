from raytpu.render.renderer import generate_rays, render_image_ssaa  # noqa: F401
from raytpu.render.route import render_image, render_image_f32  # noqa: F401
