"""Live browser viewer — the headless counterpart of the reference's window.

The port of the JAX package's ``viz/server.py``. The reference opens a
1250x1250 winit window, presents every popped snapshot and handles input:
Escape/close quits, resize is handled (reference src/main.rs:83-99,
:145-162, :168-182). Headless, the interactive surface is a browser: a
stdlib HTTP server serves

- ``/``           the viewer page: live stream, telemetry, controls
- ``/stream``     multipart/x-mixed-replace PNG stream: frames are PUSHED
                  the moment the consumer pops them (no polling; fps is
                  bounded by the engine, not the poll rate)
- ``/frame.png``  the latest framebuffer as PNG (poll fallback)
- ``/stats``      JSON: step, fps, ups, Counting phase seconds, drop count,
                  and the energy once an ``EnergyMeter`` has sampled
- ``/control``    GET with query params, the window's input handling:
                  ``cmd=pause|resume|toggle|step|quit`` plus live
                  ``theta=``/``dt=``/``render_size=`` retuning (Space and
                  Escape on the page map to toggle and quit, like
                  src/main.rs:168-182)

A consumer thread pops snapshots from the engine queue at its own pace (the
render thread's role), encodes the latest as PNG (PIL, or the zlib encoder
of ``utils/pngio``) and keeps only it.

Threads: the HTTP threads and the consumer never touch the device. A
control only sets the engine's flags (pause, step, quit) or queues a
reconfigure, which the engine's producer thread applies between batches.
With a ``ControlBus`` attached (runtime/control.py), ``/control`` submits
the intent to the bus instead, and every process applies it at the same
step barrier. ``read_only=True`` is for watch-only surfaces: frames and
stats stay live, ``/control`` answers 409.
"""

from __future__ import annotations

import json
import math
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from nbody_simulation_tpu_torch.runtime.engine import Engine, Snapshot
from nbody_simulation_tpu_torch.utils.pngio import encode_png

_PAGE = b"""<!doctype html>
<html><head><title>nbody_simulation_tpu_torch</title>
<style>
 body { background:#111; color:#ddd; font-family: monospace; text-align:center }
 img  { image-rendering: pixelated; border: 1px solid #333; max-width: 88vmin }
 pre  { color:#8f8 }
 button, input { background:#222; color:#ddd; border:1px solid #444;
                 font-family: monospace; padding: 2px 8px; margin: 0 2px }
 input { width: 5em }
</style></head>
<body>
<h3>nbody_simulation_tpu_torch &mdash; live</h3>
<div>
 <button onclick="ctl('pause')">pause</button>
 <button onclick="ctl('resume')">resume</button>
 <button onclick="ctl('step')">step</button>
 <button onclick="ctl('quit')">quit</button>
 &theta; <input id="theta" onchange="tune()">
 dt <input id="dt" onchange="tune()">
</div>
<img id="f" src="/stream">
<pre id="s"></pre>
<script>
 async function ctl(cmd) { await fetch('/control?cmd=' + cmd); }
 async function tune() {
   const t = document.getElementById('theta').value;
   const d = document.getElementById('dt').value;
   await fetch('/control?' + (t ? 'theta=' + t + '&' : '') +
               (d ? 'dt=' + d : ''));
 }
 document.addEventListener('keydown', e => {
   if (e.code === 'Space') { ctl('toggle'); e.preventDefault(); }
   if (e.code === 'Escape') ctl('quit');
 });
 async function stats() {
   try {
     const r = await fetch('/stats');
     document.getElementById('s').textContent =
         JSON.stringify(await r.json(), null, 1);
   } catch (e) {}
 }
 setInterval(stats, 500);
</script>
</body></html>
"""


class ViewerServer:
    """Serves the engine's latest snapshot over HTTP."""

    READ_ONLY_MSG = (b"409: viewer is read-only on multi-process runs - "
                     b"controls cannot be broadcast across processes (they "
                     b"would desynchronize the mesh collectives); frames "
                     b"and stats remain live")

    def __init__(self, engine: Engine, port: int = 8000,
                 host: str = "127.0.0.1", energy_meter=None,
                 read_only: bool = False, control_bus=None):
        self.engine = engine
        self.read_only = read_only
        # Multi-process control path (runtime/control.ControlBus): /control
        # submits INTENT to the bus; every process's producer thread applies
        # it collectively at the same step barrier.
        self.control_bus = control_bus
        # Explicit handoff beats introspecting engine.on_batch: the hook may
        # be a composite callable, which would hide the meter from /stats.
        self.energy_meter = energy_meter
        self.latest: Snapshot | None = None
        self._png: bytes = b""
        self._frame_seq = 0
        self._lock = threading.Lock()
        self._new_frame = threading.Condition(self._lock)
        self._fps_counter = 0
        self._fps = 0.0
        self._ups = 0.0
        self._last_step = 0
        self._t0 = time.monotonic()
        self._stopped = threading.Event()
        self.quit_requested = threading.Event()

        viewer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):  # silence request logging
                pass

            def _reply(self, body: bytes, ctype: str) -> None:
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                url = urlparse(self.path)
                if url.path == "/stream":
                    return self._stream()
                if url.path == "/frame.png":
                    with viewer._lock:
                        body = viewer._png
                    return self._reply(body, "image/png")
                if url.path == "/stats":
                    return self._reply(json.dumps(viewer.stats()).encode(),
                                       "application/json")
                if url.path == "/control":
                    if viewer.read_only:
                        body = viewer.READ_ONLY_MSG
                        self.send_response(409)
                        self.send_header("Content-Type", "text/plain")
                        self.send_header("Content-Length", str(len(body)))
                        self.end_headers()
                        self.wfile.write(body)
                        return None
                    q = parse_qs(url.query)
                    viewer._control(q)
                    return self._reply(b'{"ok": true}', "application/json")
                page = _PAGE
                if viewer.read_only:
                    # Same page minus the control row; banner instead.
                    page = _PAGE.replace(
                        b"<div>", b"<div hidden>", 1).replace(
                        b"&mdash; live",
                        b"&mdash; live (read-only: multi-process run)", 1)
                return self._reply(page, "text/html")

            def _stream(self):
                """Push each new frame as one part of a
                multipart/x-mixed-replace response — the browser swaps the
                image in place. fps is engine-bound, not poll-bound."""
                self.send_response(200)
                self.send_header(
                    "Content-Type",
                    "multipart/x-mixed-replace; boundary=frame")
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                seen = -1
                try:
                    while not viewer._stopped.is_set():
                        with viewer._new_frame:
                            if viewer._frame_seq == seen:
                                viewer._new_frame.wait(timeout=1.0)
                            if viewer._frame_seq == seen:
                                continue
                            body = viewer._png
                            seen = viewer._frame_seq
                        if not body:
                            continue
                        self.wfile.write(
                            b"--frame\r\nContent-Type: image/png\r\n"
                            + f"Content-Length: {len(body)}\r\n\r\n".encode())
                        self.wfile.write(body)
                        self.wfile.write(b"\r\n")
                except (BrokenPipeError, ConnectionResetError):
                    pass  # client went away

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self.httpd.server_address[1]
        self._http_thread = threading.Thread(
            target=self.httpd.serve_forever, name="viewer-http", daemon=True)
        self._consumer = threading.Thread(
            target=self._consume, name="viewer-consumer", daemon=True)

    def start(self) -> None:
        self._http_thread.start()
        self._consumer.start()

    def _control(self, q: dict) -> None:
        """Apply a /control request — the reference's window input
        (src/main.rs:168-182), plus live θ/dt tuning it never had.

        With a ControlBus attached (multi-process runs) nothing touches the
        engine here: commands and validated changes are SUBMITTED and every
        process applies them at the same step barrier."""
        changes = {}
        # Validate before touching the running sim: a malformed or
        # non-finite value from this unauthenticated endpoint must not
        # crash the handler or inject NaN into the device state
        # (pos = pos + vel*nan destroys the run irrecoverably).
        # Bounds: θ ∈ [0, 1e3] (reference's own max is 50); dt must be
        # strictly positive (0 halts, negative reverses the run) and is
        # capped — huge dt NaNs the state within a step or two anyway.
        for key, lo, hi in (("theta", 0.0, 1.0e3), ("dt", 1e-6, 1.0e3)):
            if key in q:
                try:
                    v = float(q[key][0])
                except ValueError:
                    continue
                if not math.isfinite(v) or v < lo or v > hi:
                    continue
                changes[key] = v
        if "render_size" in q:
            # Live surface resize (the reference's window resize,
            # src/main.rs:176-181): the engine rebuilds the snapshot queue
            # at the next batch boundary.
            try:
                rs = int(q["render_size"][0])
            except ValueError:
                rs = 0
            if 64 <= rs <= 4096:
                changes["render_size"] = rs
        cmds = [c for c in q.get("cmd", [])
                if c in ("pause", "resume", "toggle", "step", "quit")]
        if "quit" in cmds:
            self.quit_requested.set()
        if self.control_bus is not None:
            for cmd in cmds:
                self.control_bus.submit(cmd)
            if changes:
                self.control_bus.submit(**changes)
            return
        for cmd in cmds:
            if cmd == "pause":
                self.engine.pause()
            elif cmd == "resume":
                self.engine.resume()
            elif cmd == "toggle":
                (self.engine.resume if self.engine.paused
                 else self.engine.pause)()
            elif cmd == "step":
                self.engine.step_once()
            elif cmd == "quit":
                self.engine._stop.set()
        if changes:
            self.engine.reconfigure(**changes)

    def _consume(self) -> None:
        while not self._stopped.is_set():
            snap = self.engine.next_snapshot(timeout=1.0)
            if snap is None:
                if len(self.engine.queue) == 0 and self.engine._thread and \
                        not self.engine._thread.is_alive():
                    return
                continue
            png = encode_png(snap.frame)
            with self._new_frame:
                self.latest = snap
                self._png = png
                self._frame_seq += 1
                self._fps_counter += 1
                now = time.monotonic()
                dt = now - self._t0
                if dt >= 1.0:
                    self._fps = self._fps_counter / dt
                    self._ups = (snap.step - self._last_step) / dt
                    self._fps_counter = 0
                    self._last_step = snap.step
                    self._t0 = now
                self._new_frame.notify_all()

    def stats(self) -> dict:
        with self._lock:
            s = self.latest
            out = {
                "step": 0 if s is None else s.step,
                "fps": round(self._fps, 2),
                "ups": round(self._ups, 2),
                "paused": self.engine.paused,
                "theta": self.engine.world.config.theta,
                "dt": self.engine.world.config.dt,
                "dropped": self.engine.dropped,
                "counting": None if s is None else {
                    "build_bvh": s.counting.build_bvh,
                    "sum_gravity": s.counting.sum_gravity,
                    "post_calculations": s.counting.post_calculations,
                },
            }
            # Live energy telemetry, if an EnergyMeter was handed over
            # (--energy-every): latest sample + drift. Falls back to a
            # bare meter sitting directly on the hook.
            meter = self.energy_meter or getattr(self.engine, "on_batch",
                                                 None)
            samples = getattr(meter, "samples", None)
            if samples:
                step, e = samples[-1]
                e0 = meter.e0
                out["energy"] = {
                    "step": step, "total": e,
                    "drift": abs(e - e0) / max(abs(e0), 1e-30)}
            return out

    def stop(self) -> None:
        self._stopped.set()
        with self._new_frame:
            self._new_frame.notify_all()
        self.httpd.shutdown()
