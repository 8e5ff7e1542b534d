"""Minimal render server: HTTP endpoint over the fast render path.

Serving story for production deployment (no reference equivalent — the
reference is a one-shot binary).  Stdlib-only (http.server), one worker
per process; the jit cache makes repeated renders of the same
(resolution, scene-structure) combination hot after the first request.

    python -m raymarching_tpu.serve [--port 8000] [--backend auto]

API:
  GET  /healthz                  -> {"status": "ok", "backend": ...}
  POST /render                   -> PNG bytes
       body: the scene text (objects.txt grammar)
       query params: width, height, ssaa, iterations, gamma,
                     shadows=0|1, format=png|ppm,
                     soft_shadow_k (penumbra sharpness, 0 = hard),
                     ao (ambient-occlusion strength, 0 = off),
                     reflect (mirror strength in [0, 1), 0 = off),
                     bounces (mirror bounce count, default 1, max 3),
                     aperture (thin-lens radius, 0 = pinhole),
                     focus (focus-plane distance, with aperture),
                     serve_raygen=0|1 (default 1: in-kernel raygen fast
                     path on the mega backend — bit-exact, ~3% faster)
  POST /aovs                     -> ZIP of AOV planes from ONE render:
       color.png (beauty), normal.png ([-1,1] mapped to [0,255]),
       hit.png (coverage), depth.npy (float32, +inf = miss),
       objid.npy (int32, -1 = miss), shadow.npy (float32 [H,W,L],
       per-light shadowed fraction over converged samples)
       body + query params: the /render set (format ignored)
  POST /animate                  -> ZIP of frame_NNN.png (format=zip,
       default) or a looping animated GIF (format=gif)
       body: the scene text; camera orbits the scene (turntable path:
       fixed height, circle in the xz-plane about ``center``).
       query params: the /render set plus frames (default 24),
                     orbit (degrees swept, default 360),
                     center=x,y,z (default: primitive centroid),
                     delay_cs (GIF frame delay, centiseconds)
       The scene compiles ONCE and only the camera pytree changes per
       frame, so every frame after the first reuses the jit executable —
       this is the batch/throughput serving path.
"""

from __future__ import annotations

import argparse
import io
import json
import math
import sys
import urllib.parse
import zipfile
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

# Resource guards: one request may not demand an arbitrarily large compile
# or working set (each novel resolution tuple triggers a fresh jit compile,
# and the frame buffer is rays x state).  Out-of-range asks get a 422;
# oversized scene bodies a 413.
MAX_WIDTH = 4096
MAX_HEIGHT = 4096
MAX_SSAA = 4
MAX_ITERATIONS = 10_000
MAX_FRAMES = 600
MAX_ANIMATE_SAMPLES = 1 << 28     # total rays across all frames
MAX_GIF_PIXELS = 1 << 24          # total PIXELS a gif response may encode
MAX_BODY_BYTES = 1 << 20          # 1 MiB of scene text (~25k lines)
DEFAULT_RAY_CHUNK = 65536
FRAME_BATCH = 8                   # poses per batched /animate device stream


def _make_handler(backend: str):
    from .api import render_aovs, render_tables_jit, resolve_backend
    from .config import RenderConfig
    from .io.image import to_uint8
    from .io.png import encode_png
    from .scene.compile import compile_scene
    from .scene.parser import parse_scene

    resolved = resolve_backend(backend)

    class Handler(BaseHTTPRequestHandler):
        server_version = "raymarching_tpu"

        def log_message(self, fmt, *args):
            print("[serve]", fmt % args, file=sys.stderr)

        def _json(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if urllib.parse.urlparse(self.path).path == "/healthz":
                self._json(200, {"status": "ok", "backend": resolved})
            else:
                self._json(404, {"error": "unknown path"})

        def _read_request(self, q):
            """Validate query params + body -> (cfg, plan, tables, frames)
            or None (a 4xx has already been sent)."""
            length = int(self.headers.get("Content-Length", 0))
            if length > MAX_BODY_BYTES:
                self._json(413, {"error": "scene body too large "
                                          f"(max {MAX_BODY_BYTES} B)"})
                return None
            text = self.rfile.read(length).decode()
            limits = [("width", int(q.get("width", 512)), 1, MAX_WIDTH),
                      ("height", int(q.get("height", 384)), 1, MAX_HEIGHT),
                      ("ssaa", int(q.get("ssaa", 1)), 1, MAX_SSAA),
                      ("iterations", int(q.get("iterations", 1000)), 1,
                       MAX_ITERATIONS),
                      ("frames", int(q.get("frames", 24)), 1, MAX_FRAMES)]
            for name, val, lo, hi in limits:
                if not lo <= val <= hi:
                    self._json(422, {"error": f"{name}={val} out of "
                                              f"range [{lo}, {hi}]"})
                    return None
            scene = parse_scene(text)
            plan, tables = compile_scene(scene)
            cfg = RenderConfig(
                width=limits[0][1], height=limits[1][1],
                ssaa=limits[2][1], iterations=limits[3][1],
                gamma=float(q.get("gamma", 1.0)),
                shadows=q.get("shadows", "1") != "0",
                # extensions, both clamped non-negative (0 = parity default)
                soft_shadow_k=max(0.0, float(q.get("soft_shadow_k", 0.0))),
                ao_strength=max(0.0, float(q.get("ao", 0.0))),
                reflect_strength=min(max(0.0, float(q.get("reflect", 0.0))),
                                     0.99),
                reflect_bounces=min(max(int(q.get("bounces", 1)), 1), 3),
                aperture=min(max(0.0, float(q.get("aperture", 0.0))), 10.0),
                focus_dist=min(max(float(q.get("focus", 6.0)), 1e-3), 1e4),
                # serving renders are forward-only: the in-kernel raygen
                # fast path is bit-exact vs the standard path (bench's
                # serve gate) and worth ~3% per frame; opt out with
                # serve_raygen=0
                serve_raygen=q.get("serve_raygen", "1") != "0",
                normal_mode="fd", ray_chunk=DEFAULT_RAY_CHUNK)
            return cfg, plan, tables, limits[4][1]

        def _send_bytes(self, body: bytes, ctype: str):
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _do_render(self, q):
            parsed = self._read_request(q)
            if parsed is None:
                return
            cfg, plan, tables, _ = parsed
            img = np.asarray(render_tables_jit(plan, tables, cfg, resolved))
            data = to_uint8(img, cfg.gamma)
            if q.get("format", "png") == "ppm":
                h, w, _ = data.shape
                body = b"P6\n%d %d\n255\n" % (w, h) + data[..., :3].tobytes()
                self._send_bytes(body, "image/x-portable-pixmap")
            else:
                self._send_bytes(encode_png(data), "image/png")

        def _do_aovs(self, q):
            parsed = self._read_request(q)
            if parsed is None:
                return
            cfg, plan, tables, _ = parsed
            aovs = render_aovs(plan, tables, cfg)
            n = np.asarray(aovs["normal"], np.float32)
            normal8 = np.clip((n * 0.5 + 0.5) * 255.0 + 0.5,
                              0, 255).astype(np.uint8)
            hit = np.asarray(aovs["hit"], np.float32)
            hit8 = np.repeat(
                np.clip(hit * 255.0 + 0.5, 0, 255)
                .astype(np.uint8)[..., None], 3, axis=-1)
            buf = io.BytesIO()
            with zipfile.ZipFile(buf, "w", zipfile.ZIP_STORED) as zf:
                zf.writestr("color.png", encode_png(
                    to_uint8(np.asarray(aovs["color"]), cfg.gamma)))
                zf.writestr("normal.png", encode_png(normal8))
                zf.writestr("hit.png", encode_png(hit8))
                for name, dtype in (("depth", np.float32),
                                    ("objid", np.int32),
                                    ("shadow", np.float32)):
                    b = io.BytesIO()
                    np.save(b, np.asarray(aovs[name], dtype))
                    zf.writestr(name + ".npy", b.getvalue())
            self._send_bytes(buf.getvalue(), "application/zip")

        def _do_animate(self, q):
            parsed = self._read_request(q)
            if parsed is None:
                return
            cfg, plan, tables, frames = parsed
            total = frames * cfg.rays_per_image
            if total > MAX_ANIMATE_SAMPLES:
                self._json(422, {"error": f"frames x rays = {total} over "
                                          f"cap {MAX_ANIMATE_SAMPLES}"})
                return
            # GIF encoding is pure-Python LZW (~1e6 px/s single-threaded):
            # the ray cap bounds only the cheap device half, so bound the
            # ENCODE-side pixel count separately or one request pins the
            # handler thread for minutes.
            if q.get("format", "zip").lower() == "gif":
                px = frames * cfg.width * cfg.height
                if px > MAX_GIF_PIXELS:
                    self._json(422, {"error": f"frames x pixels = {px} "
                                              f"over GIF encode cap "
                                              f"{MAX_GIF_PIXELS}; use "
                                              f"format=zip"})
                    return
            orbit = math.radians(float(q.get("orbit", 360.0)))
            center = None
            if "center" in q:
                center = np.array([float(v) for v in
                                   q["center"].split(",")], np.float32)
                if center.shape != (3,):
                    raise ValueError("center must be x,y,z")

            # Shared turntable path (api.turntable_frames): batched device
            # streams on mega (FRAME_BATCH poses per render_frames call),
            # one reused jitted executable per frame elsewhere.
            from .api import turntable_frames

            def frames_iter():
                for img in turntable_frames(plan, tables, cfg, frames,
                                            orbit=orbit, center=center,
                                            backend=resolved,
                                            batch=FRAME_BATCH):
                    yield to_uint8(img, cfg.gamma)

            if q.get("format", "zip") == "gif":
                from .io.gif import encode_gif
                delay = max(1, min(int(q.get("delay_cs", 4)), 1000))
                body = encode_gif(frames_iter(), delay_cs=delay)
                self._send_bytes(body, "image/gif")
                return
            buf = io.BytesIO()
            with zipfile.ZipFile(buf, "w", zipfile.ZIP_STORED) as zf:
                for i, data in enumerate(frames_iter()):
                    zf.writestr(f"frame_{i:03d}.png", encode_png(data))
            self._send_bytes(buf.getvalue(), "application/zip")

        def do_POST(self):
            url = urllib.parse.urlparse(self.path)
            q = dict(urllib.parse.parse_qsl(url.query))
            routes = {"/render": self._do_render,
                      "/aovs": self._do_aovs,
                      "/animate": self._do_animate}
            handler = routes.get(url.path)
            if handler is None:
                self._json(404, {"error": "unknown path"})
                return
            try:
                handler(q)
            except ValueError as e:
                self._json(400, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 — report, don't crash
                self._json(500, {"error": f"{type(e).__name__}: {e}"})

    return Handler


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="raymarching_tpu.serve")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--backend", default="auto")
    args = ap.parse_args(argv)
    from .utils.cache import setup_compile_cache
    setup_compile_cache()

    server = ThreadingHTTPServer((args.host, args.port),
                                 _make_handler(args.backend))
    print(f"raymarching_tpu serving on http://{args.host}:{args.port} "
          f"(backend={args.backend})")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
