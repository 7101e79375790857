"""Interactive streaming viewer: a thin host window + input pump over the engine.

Port of ``mega_minecraft_tpu/app/viewer.py`` onto the port's ``Engine`` (its kernels run
on ``--device``, the card unless the caller asks for the CPU); host code only.  The
replacement for the reference's app-shell presentation/input layer
(the reference's main.cpp:110-160 mainLoop + FPS title bar,
212-487 Win32 key/mouse routing, 661-717 tick).  The Win32/D3D11 window is I/O, not
compute — here it becomes a tiny stdlib HTTP server pushing tonemapped frames to a
browser canvas and receiving key/mouse state back, plus a pure-terminal fallback
(ANSI half-block cells) for consoles.  All key bindings, movement sensitivities, and
modifier multipliers reproduce the reference exactly:

  WASD / Space|E / Q   move (sensitivity (10, 8, 10) blocks/s, main.cpp:175,692)
  Shift ×8, Alt ×0.25, Shift+Alt ×32                         (main.cpp:677-690)
  mouse drag           rotate, −0.0025 rad/px                (main.cpp:446-466)
  arrows               rotate ±0.1 rad                       (main.cpp:322-337)
  C (hold)             zoom (fov 47° → 20°)                  (main.cpp:359-381)
  Z                    toggle fly/walk cam mode*             (main.cpp:320-323)
  P                    pause day-night clock                 (main.cpp:383-394)
  [ / ]                sun time −5 s / +5 s                  (main.cpp:433-445)
  O / V / L / X        dump chunk / zone / layer / regather state (main.cpp:396-418)
  K                    print player position                 (main.cpp:424-431)
  F                    toggle freecam                        (main.cpp:420-423)

*the reference Player's cam-mode toggle only changes a camera offset; here Z is
accepted and ignored (the fly camera has no walk mode — parity noted, not needed).
"""

from __future__ import annotations

import json
import struct
import sys
import threading
import time
import zlib

import numpy as np

from .engine import Engine, EngineConfig

# reference movement constants (main.cpp:175, 292-490)
MOVE_SENSITIVITY = (10.0, 8.0, 10.0)
MOUSE_SENSITIVITY = -0.0025
ARROW_STEP = 0.1


def encode_png(img: np.ndarray) -> bytes:
    """Minimal RGB8 PNG encoder (stdlib zlib; fast filter-0 scanlines)."""
    h, w = img.shape[:2]
    raw = b"".join(b"\x00" + img[i].tobytes() for i in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (
            struct.pack(">I", len(data))
            + tag
            + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, 1))
        + chunk(b"IEND", b"")
    )


class InputState:
    """Thread-safe input aggregation: held keys + mouse deltas + one-shot events."""

    def __init__(self):
        self.lock = threading.Lock()
        self.held: set[str] = set()
        self.d_theta = 0.0
        self.d_phi = 0.0
        self.events: list[str] = []
        self.quit = False

    def update(self, msg: dict):
        with self.lock:
            if "held" in msg:
                self.held = {k.lower() for k in msg["held"]}
            self.d_theta += float(msg.get("dtheta", 0.0))
            self.d_phi += float(msg.get("dphi", 0.0))
            self.events.extend(str(e).lower() for e in msg.get("events", []))

    def drain(self):
        with self.lock:
            held = set(self.held)
            rot = (self.d_theta, self.d_phi)
            events = self.events
            self.d_theta = self.d_phi = 0.0
            self.events = []
            return held, rot, events


def routed_tick(eng: Engine, state: InputState, dt: float, log=print) -> None:
    """One input-routed engine tick — the tick(dt) + MsgProc equivalent."""
    held, (d_theta, d_phi), events = state.drain()

    mx = (1.0 if "a" in held else 0.0) + (-1.0 if "d" in held else 0.0)
    mz = (1.0 if "w" in held else 0.0) + (-1.0 if "s" in held else 0.0)
    my = (1.0 if ("e" in held or " " in held or "space" in held) else 0.0) + (
        -1.0 if "q" in held else 0.0
    )
    mult = 1.0
    if "shift" in held:
        mult = 32.0 if "alt" in held else 8.0
    elif "alt" in held:
        mult = 0.25
    move = (
        mx * MOVE_SENSITIVITY[0] * mult * dt,
        my * MOVE_SENSITIVITY[1] * mult * dt,
        mz * MOVE_SENSITIVITY[2] * mult * dt,
    )

    if "arrowright" in held:
        d_theta -= ARROW_STEP
    if "arrowleft" in held:
        d_theta += ARROW_STEP
    if "arrowup" in held:
        d_phi += ARROW_STEP
    if "arrowdown" in held:
        d_phi -= ARROW_STEP
    eng.set_zoomed("c" in held)
    for ev in events:
        if ev == "p":
            eng.toggle_time_paused()
        elif ev == "[":
            eng.add_time(-5.0)
        elif ev == "]":
            eng.add_time(5.0)
        elif ev == "o":
            log(json.dumps(eng.debug_chunk_info()))
        elif ev == "v":
            info = dict(eng.debug_zone_info())
            info.pop("state_grid", None)
            log(json.dumps(info))
        elif ev == "l":
            log("column layers: " + np.array2string(eng.debug_column_layers(), precision=1))
        elif ev == "x":
            log(json.dumps(eng.debug_force_regather()))
        elif ev == "k":
            p = eng.player.pos
            log(f"player position: ({p[0]:.2f}, {p[1]:.2f}, {p[2]:.2f})")
        elif ev == "f":
            eng.freecam = not eng.freecam
            log(f"freecam: {eng.freecam}")
        elif ev == "escape":
            state.quit = True

    eng.tick(dt, move=move, rotate=(d_theta, d_phi))


_PAGE = """<!doctype html><html><head><title>mega-minecraft-tpu</title><style>
body{margin:0;background:#111;display:flex;align-items:center;justify-content:center;height:100vh}
img{image-rendering:pixelated;max-width:100vw;max-height:100vh}</style></head><body>
<img id=v width=%W% height=%H%><script>
const img=document.getElementById('v');const held=new Set();let dth=0,dph=0,evs=[];
const ONESHOT=new Set(['p','o','v','l','x','k','f','[',']','escape']);
function key(e,down){let k=e.key.toLowerCase();
 if(k==='shift'||k==='alt'){e.preventDefault();}
 if(down&&ONESHOT.has(k)){evs.push(k);}
 if(down)held.add(k);else held.delete(k);send();}
document.addEventListener('keydown',e=>{if(!e.repeat)key(e,true);e.preventDefault();});
document.addEventListener('keyup',e=>key(e,false));
img.addEventListener('click',()=>img.requestPointerLock());
document.addEventListener('mousemove',e=>{if(document.pointerLockElement===img){
 dth+=e.movementX*-0.0025;dph+=e.movementY*-0.0025;}});
function send(){const m={held:[...held],dtheta:dth,dphi:dph,events:evs};dth=0;dph=0;evs=[];
 fetch('/input',{method:'POST',body:JSON.stringify(m)});}
setInterval(send,50);
async function loop(){try{const r=await fetch('/frame.png',{cache:'no-store'});
 const b=await r.blob();const u=URL.createObjectURL(b);
 const old=img.src;img.src=u;if(old)URL.revokeObjectURL(old);
 document.title=r.headers.get('x-fps')+' FPS | mega-minecraft-tpu';}catch(e){}
 requestAnimationFrame(loop);}loop();
</script></body></html>"""


def run_http_viewer(cfg: EngineConfig, host: str = "127.0.0.1", port: int = 8631,
                    max_frames: int | None = None):
    """Serve the interactive viewer; blocks driving the engine loop."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    eng = Engine(cfg)
    state = InputState()
    latest: dict = {
        "png": encode_png(np.zeros((cfg.height, cfg.width, 3), np.uint8)),
        "frame": 0,
    }

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def do_GET(self):
            if self.path.startswith("/frame.png"):
                body = latest["png"]
                self.send_response(200)
                self.send_header("content-type", "image/png")
                self.send_header("x-fps", f"{eng.fps.fps:.1f}")
                self.send_header("x-frame", str(latest["frame"]))
                self.send_header("content-length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                body = (
                    _PAGE.replace("%W%", str(cfg.width)).replace("%H%", str(cfg.height))
                ).encode()
                self.send_response(200)
                self.send_header("content-type", "text/html")
                self.send_header("content-length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        def do_POST(self):
            n = int(self.headers.get("content-length", 0))
            try:
                state.update(json.loads(self.rfile.read(n) or b"{}"))
            except Exception:
                pass
            self.send_response(204)
            self.end_headers()

    server = ThreadingHTTPServer((host, port), Handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    print(f"viewer: http://{host}:{port}/  (click the image for mouse-look; Esc quits)")

    last = time.time()
    frames = 0
    try:
        while not state.quit and (max_frames is None or frames < max_frames):
            now = time.time()
            dt, last = min(now - last, 0.1), now
            routed_tick(eng, state, dt)
            latest["png"] = encode_png(eng.present())
            frames += 1
            latest["frame"] = frames
    finally:
        server.shutdown()
    return eng


# ---------------------------------------------------------------------------
# Terminal fallback: ANSI half-block cells + raw-tty keys (no browser needed)
# ---------------------------------------------------------------------------


def _frame_to_ansi(img: np.ndarray, cols: int) -> str:
    h, w = img.shape[:2]
    rows = max(2, int(cols * h / w / 1.0)) & ~1
    ys = (np.arange(rows) * (h / rows)).astype(int)
    xs = (np.arange(cols) * (w / cols)).astype(int)
    small = img[ys][:, xs]
    out = ["\x1b[H"]
    for r in range(0, rows - 1, 2):
        line = []
        for c in range(cols):
            tr, tg, tb = small[r, c]
            br, bg, bb = small[r + 1, c]
            line.append(f"\x1b[38;2;{tr};{tg};{tb}m\x1b[48;2;{br};{bg};{bb}m▀")
        out.append("".join(line) + "\x1b[0m")
    return "\n".join(out)


def run_terminal_viewer(cfg: EngineConfig, cols: int = 100, max_frames: int | None = None):
    """Interactive terminal viewer: WASD/QE move, IJKL rotate, same one-shot keys."""
    import select
    import termios
    import tty

    eng = Engine(cfg)
    state = InputState()
    fd = sys.stdin.fileno()
    old = termios.tcgetattr(fd)
    tty.setcbreak(fd)
    sys.stdout.write("\x1b[2J")
    logs: list[str] = []
    try:
        last = time.time()
        frames = 0
        while not state.quit and (max_frames is None or frames < max_frames):
            held, events = set(), []
            while select.select([sys.stdin], [], [], 0)[0]:
                ch = sys.stdin.read(1).lower()
                if ch == "\x1b":
                    events.append("escape")
                elif ch in "wasdqe ":
                    held.add(ch)  # tap-to-step (no keyup events on a tty)
                elif ch == "i":
                    state.d_phi += ARROW_STEP
                elif ch == "k":
                    state.d_phi -= ARROW_STEP
                elif ch == "j":
                    state.d_theta += ARROW_STEP
                elif ch == "l":
                    state.d_theta -= ARROW_STEP
                elif ch in "povxf[]":
                    events.append(ch)
            state.held = held
            state.events.extend(events)
            now = time.time()
            dt, last = min(now - last, 0.25), now
            routed_tick(eng, state, dt, log=lambda m: logs.append(str(m)))
            sys.stdout.write(_frame_to_ansi(eng.present(), cols))
            sys.stdout.write(
                f"\n\x1b[0m{eng.fps.fps:5.1f} FPS  drawable={eng.drawable_chunks()}  "
                f"pos=({eng.player.pos[0]:.0f},{eng.player.pos[1]:.0f},{eng.player.pos[2]:.0f})"
                f"  [WASD/QE move, IJKL look, P pause, Esc quit]\x1b[K\n"
            )
            for m in logs[-3:]:
                sys.stdout.write(m[:200] + "\x1b[K\n")
            sys.stdout.flush()
            frames += 1
    finally:
        termios.tcsetattr(fd, termios.TCSADRAIN, old)
        sys.stdout.write("\x1b[0m\n")
    return eng


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=360)
    p.add_argument("--radius", type=int, default=8, help="generation spiral radius")
    p.add_argument("--view-chunks", type=int, default=17)
    p.add_argument("--upscale", action="store_true", help="render at half res, 2x upscale")
    p.add_argument("--term", action="store_true", help="terminal (ANSI) mode")
    p.add_argument("--cols", type=int, default=100, help="terminal columns")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8631)
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("--device", default="cuda", help="torch device of the engine (cuda or cpu)")
    args = p.parse_args(argv)

    cfg = EngineConfig(
        width=args.width,
        height=args.height,
        view_chunks=args.view_chunks,
        gen_radius=args.radius,
        use_upscaling=args.upscale,
        device=args.device,
    )
    if args.term:
        run_terminal_viewer(cfg, cols=args.cols, max_frames=args.max_frames)
    else:
        run_http_viewer(cfg, host=args.host, port=args.port, max_frames=args.max_frames)


if __name__ == "__main__":
    main()
