"""Interactive browser viewer on the standard library's http.server.

PyTorch port of deblur4dgs_tpu/vis/viewer.py (the reference's viser /
nerfview stack, flow3d/vis/viewer.py and playback_panel.py): one page with
orbit-drag camera controls, a time slider, playback, canonical and track
toggles, and keyframed camera paths; the browser POSTs a camera and gets
a frame rendered by the render_fn callback. DynamicViewer keeps the
pause / resume state and a lock the train loop holds around each step
(trainer.py:204-207, 265-269).

Deviation: frames go out as PNG (vis/png.py), where the JAX package
encodes JPEG with imageio; the card's machine has no JPEG encoder. Path
videos are animated PNGs (vis/utils.py::save_video).
"""

from __future__ import annotations

import inspect
import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from deblur4dgs_tpu_torch.vis.png import encode_png

_PAGE = """<!doctype html><html><head><title>deblur4dgs_tpu_torch viewer</title>
<style>body{margin:0;background:#111;color:#eee;font-family:sans-serif}
#bar{padding:8px}#img{display:block;margin:auto}</style></head><body>
<div id=bar>
 t: <input id=t type=range min=0 max=TMAX value=0 style="width:200px">
 <span id=tv>0</span>
 <label><input id=play type=checkbox>play</label>
 <label><input id=cano type=checkbox>canonical</label>
 <label><input id=trk type=checkbox>tracks</label>
 <span>drag to orbit, wheel to zoom</span>
</div>
<div id=bar>
 <b>path:</b>
 <button id=addkf>add keyframe</button>
 <button id=clearkf>clear</button>
 <span id=kfn>0 keyframes</span>
 frames: <input id=pn type=number value=60 min=2 style="width:60px">
 <label><input id=ploop type=checkbox>loop</label>
 tension: <input id=ptens type=number value=0 step=0.1 min=-1 max=1
  style="width:55px">
 <button id=preview>preview</button>
 <button id=savevid>render video</button>
 <span id=pmsg></span>
</div><img id=img width=WIDTH height=HEIGHT>
<script>
let az=0, el=0, dist=3, target=[0,0,0];
const img=document.getElementById('img');
let dragging=false, lx=0, ly=0;
img.onmousedown=e=>{dragging=true;lx=e.clientX;ly=e.clientY};
window.onmouseup=()=>dragging=false;
window.onmousemove=e=>{if(!dragging)return;az+=(e.clientX-lx)*0.01;
 el+=(e.clientY-ly)*0.01;el=Math.max(-1.5,Math.min(1.5,el));
 lx=e.clientX;ly=e.clientY};
img.onwheel=e=>{dist*=Math.exp(e.deltaY*0.001);e.preventDefault()};
function c2w(){
 const ca=Math.cos(az),sa=Math.sin(az),ce=Math.cos(el),se=Math.sin(el);
 const eye=[target[0]+dist*ce*sa, target[1]+dist*se, target[2]-dist*ce*ca];
 let f=[target[0]-eye[0],target[1]-eye[1],target[2]-eye[2]];
 const fn=Math.hypot(...f); f=f.map(v=>v/fn);
 let up=[0,-1,0];
 let r=[f[1]*up[2]-f[2]*up[1],f[2]*up[0]-f[0]*up[2],f[0]*up[1]-f[1]*up[0]];
 const rn=Math.hypot(...r); r=r.map(v=>v/rn);
 const d=[f[1]*r[2]-f[2]*r[1],f[2]*r[0]-f[0]*r[2],f[0]*r[1]-f[1]*r[0]];
 return [[r[0],d[0],f[0],eye[0]],[r[1],d[1],f[1],eye[1]],
         [r[2],d[2],f[2],eye[2]],[0,0,0,1]];
}
let inflight=false, previewing=null;
async function drawFrame(c2wv, t, cano){
 const res=await fetch('/render',{method:'POST',body:JSON.stringify({
  c2w:c2wv, t:t, canonical:cano,
  tracks:document.getElementById('trk').checked})});
 const blob=await res.blob();
 img.src=URL.createObjectURL(blob);
}
async function tick(){
 if(document.getElementById('play').checked){
  const s=document.getElementById('t');
  s.value=(parseInt(s.value)+1)%(parseInt(s.max)+1);
 }
 document.getElementById('tv').textContent=document.getElementById('t').value;
 if(!inflight && !previewing){
  inflight=true;
  try{
   await drawFrame(c2w(), parseInt(document.getElementById('t').value),
    document.getElementById('cano').checked);
  }finally{inflight=false;}
 }
 setTimeout(tick,100);
}
tick();
const msg=t=>document.getElementById('pmsg').textContent=t;
document.getElementById('addkf').onclick=async()=>{
 const r=await fetch('/keyframe',{method:'POST',body:JSON.stringify({
  c2w:c2w(), fov:Math.PI/3,
  time:document.getElementById('cano').checked?null:
   parseInt(document.getElementById('t').value)})});
 const j=await r.json();
 document.getElementById('kfn').textContent=j.num+' keyframes';
};
document.getElementById('clearkf').onclick=async()=>{
 await fetch('/keyframe_clear',{method:'POST',body:'{}'});
 document.getElementById('kfn').textContent='0 keyframes'; msg('');
};
function pathOpts(){return {
 num_frames:parseInt(document.getElementById('pn').value),
 loop:document.getElementById('ploop').checked,
 tension:parseFloat(document.getElementById('ptens').value)};}
document.getElementById('preview').onclick=async()=>{
 if(previewing){previewing=null;return;}
 const r=await fetch('/path_cameras',{method:'POST',
  body:JSON.stringify(pathOpts())});
 const j=await r.json();
 if(j.error){msg(j.error);return;}
 previewing=j; msg('previewing ('+j.c2ws.length+' frames)');
 for(let i=0;previewing&&i<j.c2ws.length;i++){
  await drawFrame(j.c2ws[i], j.times?Math.round(j.times[i]):null,
   !j.times);
 }
 previewing=null; msg('');
};
document.getElementById('savevid').onclick=async()=>{
 msg('rendering video...');
 const r=await fetch('/render_path',{method:'POST',
  body:JSON.stringify(pathOpts())});
 const j=await r.json();
 msg(j.error?j.error:('saved '+j.video));
};
</script></body></html>"""


class ViewerState:
    def __init__(self):
        self.status = "training"  # | "paused"
        self.num_train_rays_per_sec = 0.0


class DynamicViewer:
    """render_fn: (CameraState, img_wh, t | None) -> (H, W, 3) uint8.

    A render_fn that also takes a ``render_tracks`` keyword
    (vis/renderer.py) gets the page's "tracks" checkbox (the reference
    viewer's "Render tracks" toggle, flow3d/vis/viewer.py:62-63). The
    keyframe endpoints stand in for the viser render tab
    (flow3d/vis/render_panel.py:37-1165): the browser adds keyframes at
    the current camera and time, previews the interpolated path, and
    renders it to a video under work_dir/camera_paths."""

    def __init__(self, render_fn, num_frames: int, img_wh=(512, 288),
                 port: int = 8890, mode: str = "training",
                 work_dir: str | None = None):
        self.render_fn = render_fn
        self.num_frames = num_frames
        self.img_wh = img_wh
        self.mode = mode
        self.work_dir = work_dir
        self.state = ViewerState()
        self.lock = threading.Lock()
        self.keyframes = []
        self._server = None
        self._port = port
        try:
            params = inspect.signature(render_fn).parameters
            self._fn_takes_tracks = "render_tracks" in params
        except (TypeError, ValueError):
            self._fn_takes_tracks = False

    def update(self, step: int, num_rays: int):
        pass  # training-progress hook (kept for API parity)

    def add_keyframe(self, req: dict) -> dict:
        from deblur4dgs_tpu_torch.vis.render_panel import Keyframe

        t = req.get("time")
        self.keyframes.append(Keyframe(
            c2w=np.array(req["c2w"], np.float32),
            fov=float(req.get("fov", np.pi / 3)),
            time=None if t is None else float(t)))
        return {"num": len(self.keyframes)}

    def path_cameras(self, req: dict) -> dict:
        """Interpolated path cameras for the page's live preview."""
        if len(self.keyframes) < 2:
            return {"error": "need >= 2 keyframes"}
        from deblur4dgs_tpu_torch.vis.render_panel import (
            interpolate_camera_path,
        )

        w2cs, fovs, times = interpolate_camera_path(
            self.keyframes, int(req.get("num_frames", 60)),
            loop=bool(req.get("loop", False)),
            tension=float(req.get("tension", 0.0)))
        return {
            "c2ws": np.linalg.inv(w2cs.numpy()).tolist(),
            "fovs": fovs.numpy().tolist(),
            "times": None if times is None else times.numpy().tolist(),
        }

    def render_path(self, req: dict) -> dict:
        """Render the keyframed path to a video under work_dir/camera_paths
        (the render tab's output directory, flow3d/vis/viewer.py:68-69)."""
        if len(self.keyframes) < 2:
            return {"error": "need >= 2 keyframes"}
        if self.work_dir is None:
            return {"error": "no work_dir configured"}
        from deblur4dgs_tpu_torch.vis.render_panel import render_camera_path

        d = os.path.join(self.work_dir, "camera_paths")
        os.makedirs(d, exist_ok=True)
        out = os.path.join(d, f"path_{len(os.listdir(d))}.mp4")

        def fn(cam, wh, t):
            with self.lock:
                return self.render_fn(cam, wh, t)

        frames, video = render_camera_path(
            fn, self.keyframes, self.img_wh, int(req.get("num_frames", 60)),
            out_path=out, fps=float(req.get("fps", 30.0)),
            loop=bool(req.get("loop", False)),
            tension=float(req.get("tension", 0.0)),
            num_scene_frames=self.num_frames)
        return {"video": video, "num_frames": int(frames.shape[0])}

    def render_request(self, req: dict) -> np.ndarray:
        """The frame of one /render request body: {c2w, fov?, t?,
        canonical?, tracks?}, rendered under the lock."""
        from deblur4dgs_tpu_torch.vis.renderer import CameraState

        cam = CameraState(fov=float(req.get("fov", np.pi / 3)),
                          aspect=self.img_wh[0] / self.img_wh[1],
                          c2w=np.array(req["c2w"], np.float32))
        t = req.get("t", 0)
        t = None if (req.get("canonical") or t is None) else int(t)
        kw = {}
        if self._fn_takes_tracks and req.get("tracks"):
            kw["render_tracks"] = True
        with self.lock:
            return self.render_fn(cam, self.img_wh, t, **kw)

    @property
    def port(self) -> int:
        """The port served on (the one the OS chose when asked for 0)."""
        return self._server.server_address[1] if self._server else self._port

    def serve_forever(self, background: bool = True):
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _send(self, body: bytes, ctype: str, code: int = 200):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _json(self, obj, code=200):
                self._send(json.dumps(obj).encode(), "application/json",
                           code)

            def do_GET(self):
                if self.path.rstrip("/") == "/keyframes":
                    self._json({
                        "num": len(viewer.keyframes),
                        "keyframes": [
                            {"c2w": k.c2w.tolist(), "fov": k.fov,
                             "time": k.time}
                            for k in viewer.keyframes],
                    })
                    return
                W, H = viewer.img_wh
                page = (_PAGE.replace("TMAX", str(viewer.num_frames - 1))
                        .replace("WIDTH", str(W)).replace("HEIGHT", str(H)))
                self._send(page.encode(), "text/html")

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                route = self.path.rstrip("/") or "/render"
                if route == "/render":
                    img = viewer.render_request(req)
                    self._send(encode_png(img), "image/png")
                elif route == "/keyframe":
                    self._json(viewer.add_keyframe(req))
                elif route == "/keyframe_clear":
                    viewer.keyframes.clear()
                    self._json({"num": 0})
                elif route == "/path_cameras":
                    self._json(viewer.path_cameras(req))
                elif route == "/render_path":
                    self._json(viewer.render_path(req))
                else:
                    self._json({"error": f"unknown route {route}"}, 404)

        self._server = ThreadingHTTPServer(("0.0.0.0", self._port), Handler)
        if background:
            threading.Thread(target=self._server.serve_forever,
                             daemon=True).start()
        else:
            self._server.serve_forever()
        return self._server

    def close(self):
        """Stop serving and release the socket (a no-op when not serving)."""
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None


class TrainingViewer(DynamicViewer):
    """Live viewer attached to a running TrainLoop (trainer.py:180-207,
    :265-269): renders sharp mid-exposure views of the training scene under
    the viewer lock. The train loop holds the same lock through each step
    and density-control event (the port updates the scene in place), so a
    render never sees a half-updated scene; it waits while
    state.status == 'paused'."""

    def __init__(self, num_frames: int, img_wh=(512, 288), port: int = 8890,
                 num_exposure: int = 11, cap: int = 512,
                 use_pallas: bool = True, work_dir: str | None = None):
        from deblur4dgs_tpu_torch.vis.renderer import Renderer

        self._renderer = Renderer(None, num_frames,
                                  num_exposure=num_exposure, cap=cap,
                                  use_pallas=use_pallas)
        super().__init__(self._render, num_frames, img_wh, port,
                         mode="training", work_dir=work_dir)

    def set_scene(self, scene, num_frames: int | None = None):
        """Called by the train loop (holding self.lock) after each step."""
        if num_frames is not None:
            self.num_frames = num_frames
            self._renderer.num_frames = num_frames
        self._renderer.set_scene(scene)

    def _render(self, camera_state, img_wh, t, render_tracks=False):
        if self._renderer.scene is None:
            W, H = img_wh
            return np.zeros((H, W, 3), np.uint8)
        t = None if t is None else min(int(t), self.num_frames - 1)
        return self._renderer.render_fn(camera_state, img_wh, t,
                                        render_tracks=render_tracks)

    def update(self, step: int, num_rays_per_sec: float):
        self.state.num_train_rays_per_sec = num_rays_per_sec
