"""Rendering: camera rays, the regenerating integrator and the render
driver."""

from .camera import CameraParams, camera_consts, camera_params, generate_rays
from .integrator import render_fused_reference, trace_paths_regen
from .renderer import Renderer
