"""CLI entry point of the port (counterpart of ``cli.py``; reference:
src/main.zig).

The same flags, defaults and usage text as the JAX package's ``UserArgs``,
and the same three stage log lines (src/main.zig:94,97,105) and ``--stats``
line.  The command line renders on the card through the hand-written
kernels; ``main(argv, device="cpu")`` runs the same path on the kernels'
plain versions (the tests' way in).  ``--adaptive``, ``--checkpoint``,
``--supersample``, ``--scene_file``, ``--russian_roulette`` and
``--clamp_indirect`` render as the JAX CLI's do, with its combination
rules and messages.  ``--shard=samples|rows`` renders across every device
of the CLI's kind (``parallel/``: all cards; on the CPU ``ZWRT_CPU_DEVICES``
entries), alone, with ``--adaptive`` and with ``--checkpoint``.

Run:  python -m zig_weekend_raytracer_tpu_torch.cli --image_width=400 --image_height=400
"""

from __future__ import annotations

import dataclasses
import logging
import sys
import time

import torch

from .io.ppm import write_image
from .models import DEFAULT_ASSET_DIR, SceneType, load_scene
from .parallel import SHARD_MODES, make_mesh, render_adaptive_sharded, render_sharded
from .render.renderer import Renderer
from .sampling.sampler import SamplerKind
from .utils.argparser import ArgParser, HelpPassedInArgs, ParseArgsError
from .utils.timer import Timer


@dataclasses.dataclass
class UserArgs:
    image_width: int
    image_height: int
    image_out_path: str = "image.ppm"
    # the native PPM writer's thread count
    thread_pool_size: int = 8
    scene: SceneType = SceneType.EMISSIVE
    samples_per_pixel: int = 10
    ray_bounce_max_depth: int = 20
    # --- extensions beyond the reference flag set ---
    sampler: SamplerKind = SamplerKind.SOBOL
    seed: int = 0
    asset_dir: str = DEFAULT_ASSET_DIR
    # declarative JSON scene (models/scenefile.py); overrides --scene
    scene_file: str = ""
    # none | samples | rows: sharding over every device (parallel/)
    shard: str = "none"
    # Russian roulette's first bounce, 0 = off: unbiased path-tail
    # termination, ignored on image scenes without a texture LUT
    russian_roulette: int = 0
    # indirect luminance clamp, 0 = off: contributions landed at bounce >= 1
    # scaled to at most this luminance; the same gate
    clamp_indirect: float = 0.0
    # variance-guided adaptive sampling (render/adaptive.py): 1 with an
    # automatic pilot, N >= 2 a pilot of N spp; the uniform render's budget;
    # sobol and independent samplers only
    adaptive: int = 0
    # progressive rendering (render/progressive.py) checkpointed to this
    # .npz after every batch; an interrupted render resumes from it bitwise;
    # not with --adaptive
    checkpoint: str = ""
    # samples per progressive batch (with --checkpoint)
    checkpoint_batch_spp: int = 16
    # a-trous denoise iterations, 0 = off: guided by the first-hit AOV pass
    # (render/denoise.py)
    denoise: int = 0
    # supersampling factor, 1 = off: K times the resolution at spp / K^2
    # per subpixel, box-filtered (Renderer.render_supersampled); spp must
    # divide by K^2; only with the plain render
    supersample: int = 1
    # texture LUT texel budget, 0 = off: every image box-downsampled to at
    # most this many texels and read by the whole-render kernel
    # (scene.py:_build_tex_lut); a budget >= an image's size keeps it exact
    texture_lut: int = 0
    # print paths traced, wall-clock and Mpaths/s after the render
    stats: bool = False
    # first-hit AOV buffers (render/aov.py), written as
    # <image_out_path>.{albedo,normal,depth}.png
    aov: bool = False
    # tables after the render: host (wall-clock per span, then the
    # counters) or device (per-kernel device ms from a torch.profiler
    # capture, then the device's idle ms by span)
    profile: str = "off"


def normalize_profile_mode(text: str) -> str | None:
    """--profile value -> 'off' | 'host' | 'device', or None if invalid
    (the legacy bool spellings included)."""
    mode = text.lower()
    if mode in ("true", "1", "yes", "on"):
        return "host"
    if mode in ("false", "0", "no"):
        return "off"
    return mode if mode in ("off", "host", "device") else None


def parse_user_args(argv) -> UserArgs:
    parser = ArgParser(UserArgs)
    try:
        return parser.parse(argv)
    except ParseArgsError:  # --help included
        print(parser.usage(), file=sys.stderr)
        raise


def combination_error(args: UserArgs) -> str | None:
    """The JAX CLI's error for flags that do not combine, or None; and an
    unknown ``--shard`` mode, which the JAX CLI reports only at the render."""
    if args.shard != "none" and args.shard not in SHARD_MODES:
        return f"unknown --shard mode {args.shard!r} (none | samples | rows)"
    if args.checkpoint and args.adaptive:
        # the adaptive plan depends on the pilot's noise map, which the
        # checkpoint cannot reproduce
        return "--checkpoint is a uniform render (drop --adaptive)"
    if args.checkpoint and args.checkpoint_batch_spp < 1:
        return "--checkpoint_batch_spp must be >= 1"
    if args.supersample < 1:
        return "--supersample must be >= 1"
    if args.supersample > 1:
        k2 = args.supersample * args.supersample
        if args.adaptive or args.checkpoint or args.shard != "none":
            return ("--supersample combines only with the plain render "
                    "(drop --adaptive/--checkpoint/--shard)")
        if args.samples_per_pixel % k2:
            return (f"--samples_per_pixel={args.samples_per_pixel} "
                    f"must be divisible by supersample^2={k2}")
    return None


def main(argv=None, device="cuda") -> int:
    """Run the CLI on ``argv`` (default: the command line); renders on
    ``device``, the card unless a caller asks for the CPU."""
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    timer = Timer()
    try:
        args = parse_user_args(argv if argv is not None else sys.argv[1:])
    except HelpPassedInArgs:
        return 0
    except ParseArgsError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1

    profile_mode = normalize_profile_mode(args.profile)
    if profile_mode is None:
        print(f"error: unknown --profile mode {args.profile!r} "
              "(off | host | device)", file=sys.stderr)
        return 1
    why = combination_error(args)
    if why is not None:
        print(f"error: {why}", file=sys.stderr)
        return 1
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        print("error: CUDA is not available: the port's CLI renders on the card",
              file=sys.stderr)
        return 1

    from .utils import profiler

    was_profiling = profiler.profiling_enabled()
    if profile_mode == "host":
        profiler.set_profiling(True)
    try:
        return _run(args, device, profile_mode, timer)
    finally:
        profiler.set_profiling(was_profiling)


def _run(args: UserArgs, device, profile_mode: str, timer: Timer) -> int:
    """Load, render, write and report, after the flags were checked."""
    from .utils import profiler

    if args.scene_file:
        from .models import load_scene_file

        try:
            scene = load_scene_file(args.scene_file, device=device,
                                    texture_lut=args.texture_lut)
        except (OSError, ValueError, KeyError, TypeError, AttributeError,
                NotImplementedError) as e:
            print(f"error: --scene_file {args.scene_file}: {e}", file=sys.stderr)
            return 1
    else:
        scene = load_scene(args.scene, seed=args.seed, asset_dir=args.asset_dir,
                           device=device, texture_lut=args.texture_lut)
    timer.log_info_elapsed("scene initialized")

    renderer = Renderer(
        samples_per_pixel=args.samples_per_pixel,
        max_ray_bounce_depth=args.ray_bounce_max_depth,
        sampler=args.sampler,
        seed=args.seed,
        russian_roulette=args.russian_roulette,
        clamp_indirect=args.clamp_indirect,
    )
    w, h = args.image_width, args.image_height
    pilot = args.adaptive if args.adaptive >= 2 else 0
    mesh = None
    if args.shard != "none":
        mesh = make_mesh(device=torch.device(device).type)
        sharded = dict(sampler=args.sampler, mesh=mesh, shard=args.shard, seed=args.seed,
                       rr=args.russian_roulette, clamp=args.clamp_indirect)

    def do_render():
        if args.adaptive:
            if mesh is not None:
                return render_adaptive_sharded(
                    scene, w, h, args.samples_per_pixel, args.ray_bounce_max_depth,
                    pilot_spp=pilot, **sharded).cpu().numpy()
            return renderer.render_adaptive(scene, w, h, pilot_spp=pilot).cpu().numpy()
        if args.checkpoint:
            from .render.progressive import ProgressiveRenderer

            return ProgressiveRenderer(renderer, checkpoint_path=args.checkpoint,
                                       shard=args.shard, mesh=mesh).render(
                scene, w, h, batch_spp=args.checkpoint_batch_spp)
        if args.supersample > 1:
            return renderer.render_supersampled(scene, w, h, k=args.supersample).cpu().numpy()
        if mesh is not None:
            return render_sharded(scene, w, h, args.samples_per_pixel,
                                  args.ray_bounce_max_depth, **sharded).cpu().numpy()
        return renderer.render(scene, w, h)

    device_table = None
    t_render0 = time.perf_counter()
    if profile_mode == "device":
        fb, agg, idle = profiler.run_with_device_trace(do_render)
        device_table = (profiler.format_device_summary(agg) + "\n"
                        + profiler.format_idle_summary(idle))
    else:
        fb = do_render()
    render_s = time.perf_counter() - t_render0
    timer.log_info_elapsed("scene rendered")

    aovs = None
    aov_s = 0.0
    aov_spp = 0
    if args.aov or args.denoise:
        from .render.aov import render_aovs

        # a separate first-hit pass at 4 spp (the regenerating kernels keep
        # no per-pixel first bounce to reuse); its time and paths count in
        # --stats
        aov_spp = 4
        t_aov0 = time.perf_counter()
        aovs = render_aovs(scene, args.image_width, args.image_height, spp=aov_spp,
                           seed=args.seed, sampler=args.sampler)
        if scene.compiled.device.type == "cuda":
            torch.cuda.synchronize()
        aov_s = time.perf_counter() - t_aov0
        timer.log_info_elapsed(f"aovs rendered ({aov_spp} spp)")
    if args.denoise:
        from .render.denoise import denoise

        fb = denoise(torch.as_tensor(fb, device=scene.compiled.device), aovs,
                     iterations=args.denoise).cpu().numpy()
        timer.log_info_elapsed("denoised")

    write_image(args.image_out_path, fb, n_threads=args.thread_pool_size)
    timer.log_info_elapsed("scene written to file")

    if args.aov:
        from .render.aov import write_aovs

        for p in write_aovs(args.image_out_path, aovs):
            logging.info("aov written: %s", p)
        timer.log_info_elapsed("aovs written")

    if args.stats:
        px = args.image_width * args.image_height
        paths = px * args.samples_per_pixel
        total_paths = paths + px * aov_spp
        total_s = render_s + aov_s
        line = (
            f"stats: {total_paths:,} paths in {total_s:.3f} s "
            f"(incl. compile on first run) = "
            f"{total_paths / total_s / 1e6:.2f} Mpaths/s"
        )
        if aov_spp:
            line += (f" [beauty {paths:,} paths / {render_s:.3f} s"
                     f" + aov pass {px * aov_spp:,} paths / {aov_s:.3f} s]")
        print(line)

    if profiler.profiling_enabled():
        print(profiler.format_zone_summary())
    if device_table is not None:
        print(device_table)
    return 0


if __name__ == "__main__":
    sys.exit(main())
