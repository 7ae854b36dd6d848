"""zig_weekend_raytracer_tpu_torch — the path tracer ported to PyTorch and
CUDA for one NVIDIA H100.

The JAX package ``zig_weekend_raytracer_tpu`` is the reference; this
package mirrors its layout (math/, sampling/, geometry/, render/, ops/,
io/, utils/, models/) and never imports it or JAX.  Renders go through
hand-written CUDA kernels: ``csrc/fused_render.cu`` (the whole render) and
``csrc/closest_hit.cu`` (the first-hit probe of tree scenes); on CPU
tensors the same entry points run their plain PyTorch versions.

Typical usage:

    import zig_weekend_raytracer_tpu_torch as zwrt_torch
    scene = zwrt_torch.models.load_scene("balls", device="cuda")
    img = zwrt_torch.render.Renderer(samples_per_pixel=128).render(scene, 400, 400)
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
