"""Multi-chip execution: rays sharded over a device mesh.

The reference is a single-process, single-node program (SURVEY §2: OpenMP
threads + one GL dispatch are its only parallelism).  This module is the new
capability the north star mandates: data parallelism over RAYS across a
`jax.sharding.Mesh`, the direct analogue of the reference's
pixel-parallelism, scaled over the cards of a host (NVLink, all to all)
instead of OpenMP threads.

Design (SURVEY §5, "How to Scale Your Model" recipe):
  * 1-D mesh over the ``rays`` axis (every card reaches every other at
    the same rate, so the mesh follows the algorithm alone; rays are
    independent, so no halo exchange, no KV rotation).
  * Image rows are the sharded dimension: each device owns H/n contiguous
    rows of the SSAA ray grid.  Scene parameter tables are REPLICATED
    (a few KB — the analogue of the reference broadcasting its SSBOs to
    every GL workgroup).
  * Forward pass: ZERO collectives — each device marches and shades its
    block under ``shard_map``, with a per-device early-exit march (no
    global convergence sync).
  * Backward pass: gradients w.r.t. the replicated tables are partial sums
    over local rays; ``shard_map``'s transpose inserts per-field ``psum``s
    which XLA's all-reduce combiner fuses into ONE tail-of-program tuple
    all-reduce over the mesh (verified from compiled HLO — see
    docs/collectives.md; the ~15 KB gradient payload makes overlap
    machinery irrelevant).

Camera-pose gradients flow too: ray generation happens inside the loss,
replicated on every device (it is a few thousand FLOPs), so its backward
contributions join the same psum.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from jax import shard_map

from ..config import RenderConfig
from ..scene.compile import ScenePlan, SceneTables
from ..core import camera as cam
from ..core.render import _shade_rays

RAYS = "rays"


def make_mesh(num_devices: Optional[int] = None, axis: str = RAYS) -> Mesh:
    """1-D mesh over the ray axis.  In a multi-process run
    ``jax.devices()`` enumerates every process's devices, so the same 1-D
    mesh spans hosts; the gradient psum is the only collective."""
    devices = jax.devices()
    if num_devices is not None:
        devices = devices[:num_devices]
    return Mesh(np.asarray(devices), (axis,))


def make_mesh_2d(hosts: int, chips: int) -> Mesh:
    """(hosts, chips) mesh with BOTH axes sharding rays.

    A renderer has exactly one data axis worth scaling (rays — pixels are
    independent; there is no tensor/pipeline/expert dimension in a 428-
    float-parameter scene, SURVEY §2 parallelism table), so a multi-host
    topology maps both mesh axes onto the ray axis: the outer axis keeps
    each host's rows local (the network between hosts never carries ray
    data) while the inner axis spreads rows over each host's cards.  Use
    ``PartitionSpec(("hosts", "chips"))`` — parallel.render_sharded does
    this automatically when handed a 2-D mesh."""
    devices = jax.devices()[:hosts * chips]
    if len(devices) < hosts * chips:
        raise ValueError(f"need {hosts * chips} devices, "
                         f"have {len(jax.devices())}")
    return Mesh(np.asarray(devices).reshape(hosts, chips),
                ("hosts", "chips"))


def _ray_spec(mesh: Mesh) -> P:
    """PartitionSpec sharding image rows over EVERY mesh axis (1-D rays
    mesh or 2-D hosts x chips mesh)."""
    names = tuple(mesh.axis_names)
    return P(names if len(names) > 1 else names[0])


def _check_rows(cfg: RenderConfig, mesh: Mesh) -> int:
    n = mesh.devices.size
    if cfg.height % n:
        raise ValueError(
            f"image height {cfg.height} must be divisible by the mesh size "
            f"{n} (rows are the sharded axis)")
    return n


def render_sharded(plan: ScenePlan, tables: SceneTables, cfg: RenderConfig,
                   mesh: Mesh, *, differentiable: bool = False,
                   backend: str = "ref",
                   interpret: Optional[bool] = None) -> jnp.ndarray:
    """Render with image rows sharded over the mesh -> [H, W, 3] (sharded).

    ``backend`` selects the per-device march implementation (api backends);
    the Pallas kernels compose with shard_map — each device runs the same
    fused kernels on its own row block."""
    _check_rows(cfg, mesh)

    def shade_block(tables, dirs_block):
        # dirs_block: [H/n, W, S, 3] — this device's rows.
        from ..api import make_render_hooks, resolve_backend
        shape = dirs_block.shape
        resolved = resolve_backend(backend)
        if resolved == "mega":
            from ..ops.pallas_render import fused_render_op
            colors = fused_render_op(plan, cfg, interpret, tables,
                                     tables.cam_position,
                                     dirs_block.reshape(-1, 3))
        else:
            hooks = make_render_hooks(plan, tables, cfg, resolved,
                                      interpret=interpret)
            colors = _shade_rays(plan, tables, cfg, tables.cam_position,
                                 dirs_block.reshape(-1, 3),
                                 differentiable=differentiable,
                                 **hooks)
        samples = colors.reshape(shape[0], shape[1], shape[2], 3)
        return jnp.mean(samples, axis=2)

    # check_vma=False: the march while_loop initializes carries from
    # unvarying constants, which trips the varying-manual-axes typecheck
    # even though the computation is per-device pure.
    spec = _ray_spec(mesh)
    sharded = shard_map(shade_block, mesh=mesh,
                        in_specs=(P(), spec), out_specs=spec,
                        check_vma=False)

    _, dirs = cam.generate_rays(tables, cfg)     # [H, W, S, 3], replicated calc
    return sharded(tables, dirs)


def render_rays_sharded(plan: ScenePlan, tables: SceneTables,
                        origins: jnp.ndarray, dirs: jnp.ndarray,
                        cfg: RenderConfig, mesh: Mesh, *,
                        interpret: Optional[bool] = None) -> jnp.ndarray:
    """Arbitrary ray bundles sharded over the mesh -> [R, 3] colors.

    The multi-chip twin of ``api.render_rays`` (the camera-grid-free entry
    point): F posed views' rays concatenated into one bundle and spread
    over devices — multiview fitting / camera localization at scale.
    ``origins`` [R, 3] shards with its rays; a shared [3] origin is
    replicated.  The bundle is padded to a multiple of the mesh size (the
    pad repeats the last ray and is sliced off the result).

    Runs the production mega kernel per device; differentiating through
    it transposes the shard_map — tables cotangents psum over the mesh,
    per-ray origin/direction cotangents stay with their shard."""
    dirs = jnp.asarray(dirs, jnp.float32)
    origins = jnp.asarray(origins, jnp.float32)
    n = mesh.devices.size
    R = dirs.shape[0]
    pad = (-R) % n
    if pad:
        dirs = jnp.concatenate(
            [dirs, jnp.broadcast_to(dirs[-1:], (pad, 3))])
    per_ray = origins.ndim == 2
    if per_ray and pad:
        origins = jnp.concatenate(
            [origins, jnp.broadcast_to(origins[-1:], (pad, 3))])
    spec = _ray_spec(mesh)

    def block(tables, o, d):
        # api.render_rays does the per-device work: mega kernel launches
        # honoring cfg.ray_chunk (chunked lax.map + remat keeps the
        # backward's scatter-adds and peak memory bounded exactly like
        # the single-device path).
        from ..api import render_rays
        return render_rays(plan, tables, o, d, cfg, interpret=interpret)

    sharded = shard_map(block, mesh=mesh,
                        in_specs=(P(), spec if per_ray else P(), spec),
                        out_specs=spec, check_vma=False)
    out = sharded(tables, origins, dirs)
    return out[:R]


def render_sharded_gspmd(plan: ScenePlan, tables: SceneTables,
                         cfg: RenderConfig, mesh: Mesh,
                         backend: str = "ref") -> jnp.ndarray:
    """GSPMD alternative to the shard_map path: annotate shardings and let
    XLA partition the whole renderer (jit + with_sharding_constraint).

    Same layout (rows sharded, tables replicated).  The shard_map path is
    preferred for the Pallas backend (explicit per-device kernels, no
    global convergence sync); this variant demonstrates the
    compiler-partitioned idiom and serves as a differential check.
    """
    _check_rows(cfg, mesh)
    from ..api import make_render_hooks
    from ..core.render import render_image

    row_sharding = jax.sharding.NamedSharding(mesh, _ray_spec(mesh))
    repl = jax.sharding.NamedSharding(mesh, P())

    @partial(jax.jit, out_shardings=row_sharding)
    def run(tables):
        hooks = make_render_hooks(plan, tables, cfg, backend)
        img = render_image(plan, tables, cfg, **hooks)
        return jax.lax.with_sharding_constraint(img, row_sharding)

    tables = jax.device_put(tables, repl)
    return run(tables)


def mse_loss(plan: ScenePlan, tables: SceneTables, target: jnp.ndarray,
             cfg: RenderConfig, mesh: Mesh,
             backend: str = "ref", interpret: Optional[bool] = None) -> jnp.ndarray:
    img = render_sharded(plan, tables, cfg, mesh, differentiable=True,
                         backend=backend, interpret=interpret)
    return jnp.mean((img - target) ** 2)


def train_step(plan: ScenePlan, tables: SceneTables, target: jnp.ndarray,
               cfg: RenderConfig, mesh: Mesh, lr: float = 1e-2,
               backend: str = "ref", interpret: Optional[bool] = None):
    """One SGD step on the scene parameters against a target image.

    Returns (loss, updated tables).  Differentiating through
    ``render_sharded`` transposes the shard_map: per-device partial
    gradients of the replicated tables are psum-reduced over the mesh.
    ``interpret=None`` runs the kernels in the Pallas interpreter exactly
    on CPU meshes.
    """
    loss, grads = jax.value_and_grad(
        lambda t: mse_loss(plan, t, target, cfg, mesh, backend,
                           interpret))(tables)
    new_tables = jax.tree_util.tree_map(lambda t, g: t - lr * g,
                                        tables, grads)
    return loss, new_tables


def train_step_jit(plan: ScenePlan, cfg: RenderConfig, mesh: Mesh,
                   lr: float = 1e-2):
    """Jitted training step closure (plan/cfg/mesh static)."""
    return jax.jit(partial(train_step, plan, cfg=cfg, mesh=mesh, lr=lr))
