"""raymarching_tpu: a differentiable sphere-tracing renderer on JAX/Pallas.

Brand-new JAX/XLA/Pallas framework with the capabilities of the reference
CPU/OpenGL renderer (RevelcoS/Raymarching): CSG scenes (sphere/box/cross +
union/complement/intersection/difference lists, Menger sponge and Death Star
generators), Lambertian multi-light shading with hard shadow rays, SSAA
supersampling, and the exact ``scene/objects.txt`` grammar — plus what the
reference never had: gradients to every scene parameter through the march
(implicit-function differentiation), fused Pallas kernels compiled for
NVIDIA GPUs through Triton, and ray-sharded multi-device execution over a
JAX mesh.
"""

from .config import REFERENCE_CONFIG, RenderConfig
from .scene.compile import ScenePlan, SceneTables, compile_scene, compile_tree
from .scene.csg import Box, Cross, ListNode, Mode, Sphere, bounds
from .scene.generators import death_star, menger_sponge
from .scene.objects import Camera, Light
from .scene.parser import Scene, load_scene, parse_scene

__version__ = "0.1.0"

__all__ = [
    "RenderConfig", "REFERENCE_CONFIG",
    "Scene", "parse_scene", "load_scene",
    "ScenePlan", "SceneTables", "compile_scene", "compile_tree",
    "Sphere", "Box", "Cross", "ListNode", "Mode", "bounds",
    "menger_sponge", "death_star", "Camera", "Light",
    "render", "render_ref",
]


def render(scene, cfg=None, **kw):
    """High-level render: parsed Scene -> [H, W, 3] image (auto backend)."""
    from .api import render as _render

    return _render(scene, cfg, **kw)


def render_ref(scene, cfg=None):
    """Pure-jnp reference render (the oracle)."""
    from .core.render import render_image
    cfg = cfg or RenderConfig()
    plan, tables = compile_scene(scene)
    return render_image(plan, tables, cfg)
