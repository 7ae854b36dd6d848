"""zig_weekend_raytracer_tpu_torch — the path tracer ported to PyTorch and
CUDA for one NVIDIA H100.

The JAX package ``zig_weekend_raytracer_tpu`` is the reference; this
package mirrors its layout (math/, sampling/, geometry/, render/, ops/,
io/, utils/, models/) and never imports it or JAX.  Renders go through
hand-written CUDA kernels: ``csrc/fused_render.cu`` (the whole render of
a scene without images, or of an image scene with a texture LUT),
``csrc/bounce.cu`` (the bounce of image-texture scenes) and
``csrc/closest_hit.cu`` (the first-hit probe of tree scenes); the render
and bounce kernels take the tree walk that ``ZWRT_TRAV`` (queue, rowqueue,
spec) or a scene compiled with ``ZWRT_UNI_TREE=1`` asks for.  Scenes live
on the card unless built with ``device="cpu"``, where the same entry
points run the kernels' plain PyTorch versions.  The command line is
``python -m zig_weekend_raytracer_tpu_torch.cli`` (``cli.py``);
``python -m zig_weekend_raytracer_tpu_torch.tools.fp32_peak`` measures the
card's FP32 peak (``csrc/fp32_peak.cu``), the roofline's rate.

Typical usage:

    import zig_weekend_raytracer_tpu_torch as zwrt_torch
    scene = zwrt_torch.models.load_scene("rtw_final")
    img = zwrt_torch.render.Renderer(samples_per_pixel=64, max_ray_bounce_depth=8).render(scene, 400, 400)
    zwrt_torch.io.write_ppm("out.ppm", img)
"""

from . import dtypes
from . import math
from . import sampling
from . import geometry
from . import textures
from . import materials
from . import scene
from . import models
from . import render
from . import ops
from . import io
from . import utils

__version__ = "0.1.0"
