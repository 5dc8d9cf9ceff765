"""Async reconstruction visualization.

Reference parity: src/Visualization/Visualization.cpp runs a background
std::thread with a cv::viz::Viz3d window fed by copy-in + dirty flags
(AsyncVisualization, :17-126; cameras drawn as frusta, newest red).  A GUI
window is useless on a headless TPU pod, so the TPU-native equivalent keeps
the same producer API (update point cloud + camera poses, non-blocking) but
renders to artifacts instead: a rolling PLY snapshot plus a self-contained
HTML viewer (three.js-free, pure canvas point splatting) that can be opened
locally or served.

Thread-safety follows the reference's copy-in design, minus the benign race:
producers enqueue immutable snapshots; the worker thread drains the latest.
"""

from __future__ import annotations

import json
import pathlib
import queue
import threading


class AsyncVisualization:
    def __init__(self, out_dir: str, every_n_updates: int = 1):
        self.out_dir = pathlib.Path(out_dir)
        self.out_dir.mkdir(parents=True, exist_ok=True)
        self.every = every_n_updates
        self._q: queue.Queue = queue.Queue(maxsize=4)
        self._count = 0
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._started = False

    def start(self):
        if not self._started:
            self._thread.start()
            self._started = True
        return self

    def update(self, map_obj):
        """Non-blocking snapshot enqueue (drops frames when busy)."""
        self._count += 1
        if self._count % self.every:
            return
        snap = self._snapshot(map_obj)
        try:
            self._q.put_nowait(snap)
        except queue.Full:
            pass  # drop — visualization must never stall the pipeline

    def close(self):
        if self._started:
            self._q.put(None)
            self._thread.join(timeout=10)

    # -- internals -----------------------------------------------------------
    @staticmethod
    def _snapshot(map_obj):
        import numpy as np

        pids = map_obj.point_ids()
        xyz = (
            np.array([map_obj.xyz(int(p)) for p in pids])
            if len(pids) else np.zeros((0, 3))
        )
        bgr = (
            np.array([map_obj.color(int(p)) for p in pids])
            if len(pids) else np.zeros((0, 3))
        )
        cams = []
        for i in map_obj.registered_ids:
            im = map_obj.images[i]
            C = -im.R.T @ im.t
            cams.append({"id": int(i), "C": C.tolist(),
                         "R": im.R.reshape(-1).tolist()})
        return {"xyz": xyz, "rgb": bgr[:, ::-1] if len(bgr) else bgr,
                "cams": cams}

    def _worker(self):
        while True:
            snap = self._q.get()
            if snap is None:
                return
            # Drain to the newest pending snapshot.
            while True:
                try:
                    nxt = self._q.get_nowait()
                except queue.Empty:
                    break
                if nxt is None:
                    self._write(snap)
                    return
                snap = nxt
            self._write(snap)

    def _write(self, snap):
        xyz, rgb = snap["xyz"], snap["rgb"]
        with open(self.out_dir / "live.ply", "w") as f:
            f.write(
                "ply\nformat ascii 1.0\n"
                f"element vertex {len(xyz)}\n"
                "property float x\nproperty float y\nproperty float z\n"
                "property uchar red\nproperty uchar green\nproperty uchar blue\n"
                "end_header\n"
            )
            for p, c in zip(xyz, rgb):
                f.write(
                    f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f} "
                    f"{int(c[0])} {int(c[1])} {int(c[2])}\n"
                )
        state = {
            "num_points": int(len(xyz)),
            "cams": snap["cams"],
        }
        (self.out_dir / "state.json").write_text(json.dumps(state))
        self._write_viewer(snap)

    def _write_viewer(self, snap):
        """Self-contained HTML point-cloud viewer (canvas orbit renderer)."""
        pts = [
            [round(float(x), 3) for x in p] + [int(c[0]), int(c[1]), int(c[2])]
            for p, c in zip(snap["xyz"][::max(1, len(snap["xyz"]) // 20000)],
                            snap["rgb"][::max(1, len(snap["rgb"]) // 20000)])
        ]
        cams = [c["C"] for c in snap["cams"]]
        html = _VIEWER_TEMPLATE.replace(
            "__POINTS__", json.dumps(pts)
        ).replace("__CAMS__", json.dumps(cams))
        (self.out_dir / "viewer.html").write_text(html)


_VIEWER_TEMPLATE = """<!doctype html>
<html><head><meta charset="utf-8"><title>monocularsfm_torch live view</title>
<style>body{margin:0;background:#111;color:#ccc;font:12px monospace}
canvas{display:block}#hud{position:fixed;top:8px;left:8px}</style></head>
<body><div id="hud"></div><canvas id="c"></canvas><script>
const pts=__POINTS__, cams=__CAMS__;
const cv=document.getElementById('c'),ctx=cv.getContext('2d');
let yaw=0.6,pitch=0.3,dist=14,cx=0,cy=0,cz=0;
if(pts.length){let sx=0,sy=0,sz=0;for(const p of pts){sx+=p[0];sy+=p[1];sz+=p[2]}
cx=sx/pts.length;cy=sy/pts.length;cz=sz/pts.length;}
function draw(){cv.width=innerWidth;cv.height=innerHeight;
ctx.fillStyle='#111';ctx.fillRect(0,0,cv.width,cv.height);
const cyw=Math.cos(yaw),syw=Math.sin(yaw),cp=Math.cos(pitch),sp=Math.sin(pitch);
const f=0.9*Math.min(cv.width,cv.height);
function proj(x,y,z){x-=cx;y-=cy;z-=cz;
let X=cyw*x+syw*z, Z=-syw*x+cyw*z, Y=cp*y-sp*Z; Z=sp*y+cp*Z+dist;
if(Z<=0.05)return null;return [cv.width/2+f*X/Z,cv.height/2+f*Y/Z];}
for(const p of pts){const q=proj(p[0],p[1],p[2]);if(!q)continue;
ctx.fillStyle=`rgb(${p[3]},${p[4]},${p[5]})`;ctx.fillRect(q[0],q[1],2,2);}
ctx.fillStyle='#f33';
for(const c of cams){const q=proj(c[0],c[1],c[2]);if(!q)continue;
ctx.beginPath();ctx.arc(q[0],q[1],3,0,7);ctx.fill();}
document.getElementById('hud').textContent=
`${pts.length} pts (subsampled) | ${cams.length} cams | drag=orbit wheel=zoom`;}
let dragging=false,lx=0,ly=0;
cv.onmousedown=e=>{dragging=true;lx=e.clientX;ly=e.clientY};
window.onmouseup=()=>dragging=false;
window.onmousemove=e=>{if(!dragging)return;yaw+=(e.clientX-lx)*0.01;
pitch+=(e.clientY-ly)*0.01;lx=e.clientX;ly=e.clientY;draw()};
window.onwheel=e=>{dist*=e.deltaY>0?1.1:0.9;draw()};
window.onresize=draw;draw();
</script></body></html>
"""
