"""Rendering: camera rays, the regenerating integrator, the render driver,
the first-hit AOV pass (``aov``) and the AOV-guided denoiser
(``denoise``)."""

from .camera import CameraParams, camera_consts, camera_params, generate_rays
from .integrator import render_fused_reference, trace_paths_regen
from .renderer import Renderer
