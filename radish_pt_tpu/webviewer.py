"""Browser live preview — the graphical counterpart of the reference's GLFW +
ImGui window (``/root/reference/src/preview.cpp:137-367``, ``main.cpp:204-284``)
for a headless GPU host.

A single-file HTTP server (stdlib; Pillow for the JPEG encode) streams the display buffer as an
MJPEG ``multipart/x-mixed-replace`` stream — natively animated by every
browser, no websocket or client dependency — and accepts the interactive
commands the reference binds to keys/mouse:

* keyboard: w/s/a/d/q/e move, h/l yaw, j/k pitch, t/n/m/g/v cycle
  tracer/denoiser/tonemap/G-buffer view/denoiser AOV, r reset accumulation, p save PNG
* mouse: drag orbits the camera (preview.cpp ``mouseButtonCallback`` /
  ``cursorPosCallback``), wheel dollies

Threading model: JAX compute stays on the MAIN thread (render loop); HTTP
threads only read the latest encoded JPEG under a condition variable and
push key/drag events onto a queue the render loop drains between frames —
the same "events in, frames out" split as the reference's GLFW poll loop.

Run:  python -m radish_pt_tpu.viewer SCENE.txt --http 8000
"""

from __future__ import annotations

import io
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

_PAGE = """<!DOCTYPE html>
<html><head><title>radish_pt_tpu</title><style>
body { background:#111; color:#ddd; font:13px monospace; margin:0;
       display:flex; flex-direction:column; align-items:center }
#view { margin:12px; max-width:95vw; image-rendering:pixelated;
        cursor:grab; border:1px solid #333 }
#stats { white-space:pre; padding:4px 12px }
#help { color:#777; padding:0 12px 12px }
</style></head><body>
<img id="view" src="/stream" draggable="false">
<div id="stats"></div>
<div id="help">left-drag: orbit &middot; middle-drag: pan &middot;
right-drag: zoom &middot; wheel: dolly &middot; wasdqe: move
&middot; hjkl: yaw/pitch &middot; t/n/m/g/v: tracer/denoiser/tonemap/gview/aov
&middot; [/]: luminance sigma &middot; r: reset &middot; p: save png</div>
<script>
const send = (path, body) => fetch(path, {method:'POST',
  headers:{'Content-Type':'application/json'}, body:JSON.stringify(body)});
addEventListener('keydown', e => {
  if ('wsadqehjkltnmgvrp[]'.includes(e.key)) send('/key', {key:e.key});
});
const view = document.getElementById('view');
view.addEventListener('contextmenu', e => e.preventDefault());
let drag = null;
view.addEventListener('pointerdown', e => {
  drag = [e.clientX, e.clientY, e.button];
  view.setPointerCapture(e.pointerId); });
view.addEventListener('pointermove', e => {
  if (!drag) return;
  const [x0, y0, btn] = drag; drag = [e.clientX, e.clientY, btn];
  send('/drag', {dx: e.clientX - x0, dy: e.clientY - y0, button: btn});
});
view.addEventListener('pointerup', () => drag = null);
view.addEventListener('wheel', e => { e.preventDefault();
  send('/drag', {dolly: e.deltaY > 0 ? -1 : 1}); }, {passive:false});
setInterval(async () => {
  const r = await fetch('/stats');
  document.getElementById('stats').textContent = await r.text();
}, 1000);
</script></body></html>"""


class _Shared:
    """Latest encoded frame + input event queue, shared with HTTP threads."""

    def __init__(self):
        self.cond = threading.Condition()
        self.jpeg = b""
        self.seq = 0
        self.stats = "{}"
        self.events: queue.Queue = queue.Queue()

    def publish(self, jpeg: bytes, stats: str):
        with self.cond:
            self.jpeg = jpeg
            self.stats = stats
            self.seq += 1
            self.cond.notify_all()

    def wait_frame(self, seen: int, timeout: float = 5.0):
        with self.cond:
            self.cond.wait_for(lambda: self.seq != seen, timeout=timeout)
            return self.jpeg, self.seq


def _make_handler(shared: _Shared):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def do_GET(self):
            if self.path == "/":
                body = _PAGE.encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif self.path == "/stats":
                body = shared.stats.encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/plain")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif self.path.startswith("/stream"):
                self.send_response(200)
                self.send_header(
                    "Content-Type",
                    "multipart/x-mixed-replace; boundary=frame",
                )
                self.end_headers()
                seen = -1
                try:
                    while True:
                        jpeg, seen = shared.wait_frame(seen)
                        if not jpeg:
                            continue
                        self.wfile.write(
                            b"--frame\r\nContent-Type: image/jpeg\r\n"
                            + f"Content-Length: {len(jpeg)}\r\n\r\n".encode()
                        )
                        self.wfile.write(jpeg)
                        self.wfile.write(b"\r\n")
                except (BrokenPipeError, ConnectionResetError):
                    return
            else:
                self.send_error(404)

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            try:
                body = json.loads(self.rfile.read(n) or b"{}")
            except json.JSONDecodeError:
                body = {}
            if self.path == "/key":
                shared.events.put(("key", body.get("key", "")))
            elif self.path == "/drag":
                shared.events.put(("drag", body))
            self.send_response(204)
            self.end_headers()

    return Handler


def encode_jpeg(img_u8: np.ndarray, quality: int = 85) -> bytes:
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            "the web viewer encodes JPEG frames with Pillow: "
            "pip install pillow (or the 'webviewer' extra)"
        ) from e

    buf = io.BytesIO()
    Image.fromarray(img_u8).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


def serve(r, port: int = 8000, spp_per_frame: int = 1, quality: int = 85):
    """Serve ``Renderer`` ``r`` interactively until Ctrl-C.

    The render loop (main thread) drains input events, steps the renderer,
    and publishes JPEG frames; progressive accumulation continues while the
    camera is still, exactly like the reference's preview loop."""
    from .config import Denoiser, ToneMapping, Tracer

    shared = _Shared()
    httpd = ThreadingHTTPServer(("0.0.0.0", port), _make_handler(shared))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    print(f"[webviewer: http://localhost:{port}/  (Ctrl-C to stop)]")

    if getattr(r, "mesh", None) is not None:
        # mesh mode shards only the pt/restir tracers (renderer._step_sharded)
        tracers = [Tracer.STREAMED, Tracer.RESTIR_DI]
        tracer_names = ["pt", "restir"]
    else:
        tracers = [Tracer.STREAMED, Tracer.DIRECT_LIGHT, Tracer.RESTIR_DI,
                   Tracer.BVH_VISUALIZE, Tracer.GBUFFER_PREVIEW]
        tracer_names = ["pt", "direct", "restir", "bvh", "gbuffer"]
    denoisers = [Denoiser.NONE, Denoiser.GAUSSIAN, Denoiser.EA_WAVELET,
                 Denoiser.SVGF]
    denoiser_names = ["none", "gaussian", "eaw", "svgf"]
    tonemaps = [ToneMapping.NONE, ToneMapping.FILMIC, ToneMapping.ACES]
    tonemap_names = ["none", "filmic", "aces"]
    gviews = ["albedo", "normal", "depth", "motion"]

    move_step = float(
        np.linalg.norm(np.asarray(r.ds.bounds_max[0] - r.ds.bounds_min[0]))
    ) * 0.02 + 0.1

    def move(dx=0.0, dy=0.0, dz=0.0):
        cam = r.cam
        pos = (np.asarray(cam.position)
               + np.asarray(cam.right) * dx
               + np.asarray(cam.up) * dy
               + np.asarray(cam.view) * dz)
        r.update_camera(position=pos)

    def rotate(dyaw=0.0, dpitch=0.0):
        rot = np.asarray(r.cam.rotation) + np.array([dyaw, dpitch, 0.0])
        r.update_camera(rotation=rot)

    def apply(kind, data):
        s = r.settings
        if kind == "drag":
            if "dolly" in data:
                move(dz=move_step * 2.0 * float(data["dolly"]))
                return
            dx = float(data.get("dx", 0))
            dy = float(data.get("dy", 0))
            button = int(data.get("button", 0))
            if button == 1:
                # MIDDLE drag pans (main.cpp:249 GLFW_MOUSE_BUTTON_MIDDLE)
                move(dx=-dx * move_step * 0.05, dy=dy * move_step * 0.05)
            elif button == 2:
                # RIGHT drag zooms along the view axis (main.cpp:248)
                move(dz=-dy * move_step * 0.05)
            else:
                # LEFT drag orbits; cursorPosCallback pixels -> degrees
                rotate(dyaw=dx * 0.25, dpitch=-dy * 0.25)
            return
        key = data
        if key == "w":
            move(dz=move_step)
        elif key == "s":
            move(dz=-move_step)
        elif key == "a":
            move(dx=-move_step)
        elif key == "d":
            move(dx=move_step)
        elif key == "q":
            move(dy=-move_step)
        elif key == "e":
            move(dy=move_step)
        elif key == "h":
            rotate(dyaw=-5.0)
        elif key == "l":
            rotate(dyaw=5.0)
        elif key == "j":
            rotate(dpitch=-5.0)
        elif key == "k":
            rotate(dpitch=5.0)
        elif key == "t":
            s.tracer = tracers[(tracers.index(s.tracer) + 1) % len(tracers)]
            r.reset_accumulation()
        elif key == "n":
            s.denoiser = denoisers[
                (denoisers.index(s.denoiser) + 1) % len(denoisers)]
        elif key == "m":
            s.tone_mapping = tonemaps[
                (tonemaps.index(s.tone_mapping) + 1) % len(tonemaps)]
        elif key == "g":
            s.gbuffer_view = gviews[
                (gviews.index(s.gbuffer_view) + 1) % len(gviews)]
        elif key == "v":
            aovs = type(r).PREVIEW_AOVS
            s.preview_aov = aovs[
                (aovs.index(s.preview_aov) + 1) % len(aovs)]
            print(f"[preview aov: {s.preview_aov}]")
        elif key in "[]":
            # luminance-sigma slider analogue (preview.cpp:261-267)
            f = 0.8 if key == "[" else 1.25
            if s.denoiser == Denoiser.EA_WAVELET:
                s.eaw_sig_luminance *= f
            else:
                s.svgf_sig_luminance *= f
        elif key == "r":
            r.reset_accumulation()
        elif key == "p":
            print(f"[saved {r.save()}]")

    def compute_frame():
        """Submit one display frame's device computation (non-blocking).
        Returns (device image, frames advanced).  ReSTIR with
        spp_per_frame > 1 rides the BATCHED path: the temporal chain
        advances spp_per_frame frames in ONE dispatch (renderer.
        step_batched_restir), amortizing dispatch + G-buffer."""
        s = r.settings
        batchable = (
            s.tracer == Tracer.RESTIR_DI
            and spp_per_frame > 1
            and s.denoiser == Denoiser.NONE
            and getattr(r, "mesh", None) is None
        )
        if batchable:
            return r.step_batched_restir(spp_per_frame), spp_per_frame
        disp = None
        for _ in range(spp_per_frame):
            disp = r.step(return_device=getattr(r, "mesh", None) is None)
        return disp, spp_per_frame

    ema_ms = None
    ema_disp = None
    pending = None  # (device image, n frames, submit time) in flight
    try:
        while True:
            # drain all pending input between frames (GLFW pollEvents analogue)
            try:
                while True:
                    apply(*shared.events.get_nowait())
            except queue.Empty:
                pass
            t0 = time.time()
            # pipeline: submit frame k+1 BEFORE fetching/encoding frame k —
            # the device->host fetch and the host JPEG encode then overlap
            # the next frame's device compute
            nxt = compute_frame()
            if pending is None:
                pending = nxt
                nxt = compute_frame()
            disp, n_frames = pending
            disp = np.asarray(disp)
            if r.settings.preview_aov != "composed":
                # stream the selected denoiser AOV instead of the composed
                # frame (the reference Preview combo drives the display too)
                aov = r.preview_aov_image()
                if aov is not None:
                    disp = np.asarray(r._display_fn(r.settings.tone_mapping)(
                        aov.reshape(r.cam.height, r.cam.width, 3)))
            jpeg = encode_jpeg(disp[:, ::-1], quality)
            dt_frame = (time.time() - t0) * 1e3
            dt = dt_frame / n_frames
            ema_ms = dt if ema_ms is None else 0.9 * ema_ms + 0.1 * dt
            ema_disp = (dt_frame if ema_disp is None
                        else 0.9 * ema_disp + 0.1 * dt_frame)
            s = r.settings
            stats = (
                f"iter {r.state.iteration} | {1e3 / max(ema_ms, 1e-6):.1f} fps "
                f"({ema_ms:.1f} ms/frame, {ema_disp:.1f} ms/display) | "
                f"tracer {tracer_names[tracers.index(s.tracer)]} | "
                f"denoiser {denoiser_names[denoisers.index(s.denoiser)]} | "
                f"tonemap {tonemap_names[tonemaps.index(s.tone_mapping)]} | "
                f"{r.ds.num_triangles} tris | {r.ds.intersector}"
            )
            shared.publish(jpeg, stats)
            pending = nxt
    except KeyboardInterrupt:
        print("\n[webviewer: stopped]")
    finally:
        httpd.shutdown()
    return 0
