"""Multi-process (multi-host model) validation: two real OS processes form
a jax.distributed cluster on CPU, render a row-sharded frame across the
process boundary, and gather it — exercising the exact code paths a
multi-host run uses (distributed.initialize, cross-process mesh,
process_allgather at save time)."""

import socket
import subprocess
import sys
import textwrap

import pytest


def _free_port() -> str:
    """An OS-assigned ephemeral port, so concurrent suites (or a second
    checkout on the same box) never collide on a pinned coordinator port.
    The bind-then-close handoff has a theoretical reuse race, but the
    kernel cycles ephemeral ports, and jax.distributed's coordinator
    raises loudly on bind failure rather than hanging."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return str(s.getsockname()[1])

_WORKER = textwrap.dedent('''
import os, sys
pid = int(sys.argv[1])
port = sys.argv[2]
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax
jax.config.update("jax_platforms", "cpu")
jax.distributed.initialize(coordinator_address="127.0.0.1:" + port,
                           num_processes=2, process_id=pid)
sys.path.insert(0, {repo!r})
import numpy as np
from raymarching_tpu import RenderConfig, compile_scene, load_scene
from raymarching_tpu.parallel.sharded import make_mesh, render_sharded
from raymarching_tpu.parallel import distributed

scene = load_scene({scene!r})
plan, tables = compile_scene(scene)
cfg = RenderConfig(width=32, height=16, ssaa=1, iterations=60,
                   shadows=False, normal_mode="analytic")
mesh = make_mesh()      # spans both processes (4 devices)
img = jax.jit(lambda t: render_sharded(plan, t, cfg, mesh))(tables)
full = distributed.gather_image(img)
assert full.shape == (16, 32, 3)
assert np.isfinite(full).all()
assert distributed.is_primary() == (pid == 0)
print("OK", pid, jax.process_count(), len(jax.devices()), flush=True)
''')


_TILED_WORKER = textwrap.dedent('''
import os, sys
pid = int(sys.argv[1])
port = sys.argv[2]
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax
jax.config.update("jax_platforms", "cpu")
jax.distributed.initialize(coordinator_address="127.0.0.1:" + port,
                           num_processes=2, process_id=pid)
sys.path.insert(0, {repo!r})
import numpy as np
from raymarching_tpu import RenderConfig, compile_scene, load_scene
from raymarching_tpu.api import render_tables, render_tiled_multihost

scene = load_scene({scene!r})
plan, tables = compile_scene(scene)
# odd height -> uneven 9/8 split, exercises the pad-row + trim path
cfg = RenderConfig(width=32, height=17, ssaa=1, iterations=60,
                   shadows=False, normal_mode="analytic")
full = render_tiled_multihost(plan, tables, cfg, row_block=5,
                              backend="jnp")
assert full.shape == (17, 32, 3), full.shape
ref = np.asarray(render_tables(plan, tables, cfg, backend="jnp"))
np.testing.assert_allclose(full, ref, atol=1e-3, rtol=0)
print("OK-TILED", pid, flush=True)
''')


@pytest.mark.slow
def test_two_process_tiled_multihost(scenes_dir):
    """Each host streams its own row band, one allgather assembles the
    frame — the big-frame multi-host path (api.render_tiled_multihost)."""
    import pathlib
    repo = str(pathlib.Path(__file__).resolve().parent.parent)
    prog = _TILED_WORKER.format(repo=repo,
                                scene=str(scenes_dir / "config1.txt"))
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, "-c", prog, str(i), port],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=240)
            outs.append(out.decode())
            assert p.returncode == 0, out.decode()[-2000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for i, out in enumerate(outs):
        assert f"OK-TILED {i}" in out, out[-2000:]


@pytest.mark.slow
def test_two_process_cluster(scenes_dir, tmp_path):
    import pathlib
    repo = str(pathlib.Path(__file__).resolve().parent.parent)
    prog = _WORKER.format(repo=repo,
                          scene=str(scenes_dir / "config1.txt"))
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, "-c", prog, str(i), port],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=240)
            outs.append(out.decode())
            assert p.returncode == 0, out.decode()[-2000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for i, out in enumerate(outs):
        assert f"OK {i} 2 4" in out, out[-2000:]
