"""Interactive map viewer: self-contained HTML export (the qviz analog).

Counterpart of ``gslam_tpu/app/webviz.py``, the same viewer: a single
self-contained HTML file with the run's map and trajectory embedded as
JSON and a small dependency-free canvas renderer (orbit / pan / zoom,
layer toggles, a playback slider), openable anywhere, no server, no
network.  The template is the reference's, byte for byte.

Layers (qviz's SLAMVisualizer): map point cloud (landmark colour when
present, else height), estimated trajectory and current-pose marker,
ground truth, keyframe frusta (from Sim3 poses), covisibility edges
between keyframes (the heaviest).  A run's arena lives on its device:
:func:`export_run_html` copies the fields it draws to the host once.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Sequence

import numpy as np


def _quat_to_matrix(q: np.ndarray) -> np.ndarray:
    """(4,) wxyz -> (3,3), host numpy (tiny, per keyframe)."""
    w, x, y, z = q / max(np.linalg.norm(q), 1e-12)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def frustum_segments(pose: np.ndarray, size: float = 0.3,
                     aspect: float = 4.0 / 3.0) -> np.ndarray:
    """(16, 3) line-segment endpoints (8 segments) for one camera pose.

    pose: (7,) [t, q wxyz] or (8,) Sim3 [t, q, s]; camera->world.
    """
    t = np.asarray(pose[:3], np.float64)
    R = _quat_to_matrix(np.asarray(pose[3:7], np.float64))
    s = float(pose[7]) if len(pose) >= 8 else 1.0
    d = size * max(s, 1e-6)
    w, h = d * aspect * 0.5, d * 0.5
    corners = np.array([[-w, -h, d], [w, -h, d], [w, h, d], [-w, h, d]])
    cw = corners @ R.T + t  # camera->world
    segs = []
    for c in cw:  # apex to corners
        segs += [t, c]
    for i in range(4):  # image-plane rectangle
        segs += [cw[i], cw[(i + 1) % 4]]
    return np.asarray(segs)


def _covis_edges(C: np.ndarray, valid: np.ndarray, pos: np.ndarray,
                 min_common: int, max_edges: int) -> np.ndarray:
    iu = np.triu_indices_from(C, k=1)
    w = C[iu]
    keep = (w >= min_common) & valid[iu[0]] & valid[iu[1]]
    ii, jj, w = iu[0][keep], iu[1][keep], w[keep]
    if len(w) > max_edges:  # heaviest edges only
        order = np.argsort(-w)[:max_edges]
        ii, jj = ii[order], jj[order]
    segs = np.empty((2 * len(ii), 3), np.float64)
    segs[0::2] = pos[ii]
    segs[1::2] = pos[jj]
    return segs


def covis_segments(arena, min_common: int = 15,
                   max_edges: int = 400) -> np.ndarray:
    """(2E, 3) covisibility edge endpoints between keyframe centres (the
    covisibility matrix computed on the arena's device, then one copy of
    it, the valid flags and the poses to the host)."""
    from gslam_tpu_torch.map.arena import covisibility_matrix

    C = covisibility_matrix(arena).cpu().numpy()
    return _covis_edges(C, arena.frame_valid.cpu().numpy(),
                        arena.frame_pose[:, :3].cpu().numpy(), min_common,
                        max_edges)


def _round(a: Optional[np.ndarray], nd: int = 4):
    if a is None or len(a) == 0:
        return []
    return np.round(np.asarray(a, np.float64), nd).tolist()


def export_html(out_path: str,
                traj: np.ndarray,
                gt: Optional[np.ndarray] = None,
                points: Optional[np.ndarray] = None,
                point_colors: Optional[np.ndarray] = None,
                kf_poses: Optional[Sequence[np.ndarray]] = None,
                covis: Optional[np.ndarray] = None,
                title: str = "gslam_tpu run",
                refresh_s: float = 0.0) -> str:
    """Write the self-contained viewer; returns out_path.

    traj/gt: (N,3) positions; points: (P,3); point_colors: (P,3) in
    [0,1]; kf_poses: iterable of (7,)/(8,) camera->world poses; covis:
    (2E,3) precomputed edge endpoints (``covis_segments``).  All numpy.
    """
    frusta = []
    if kf_poses is not None:
        for p in kf_poses:
            frusta.append(_round(frustum_segments(np.asarray(p)), 3))
    data = {
        "title": title,
        "traj": _round(traj),
        "gt": _round(gt),
        "points": _round(points, 3),
        "colors": _round(point_colors, 3),
        "frusta": frusta,
        "covis": _round(covis, 3),
    }
    html = _TEMPLATE.replace("__DATA__", json.dumps(data)) \
                    .replace("__TITLE__", title) \
                    .replace("__REFRESH_S__", repr(float(refresh_s)))
    # atomic replace: live mode re-emits while a browser polls the file
    tmp = out_path + ".tmp"
    with open(tmp, "w") as f:
        f.write(html)
    os.replace(tmp, out_path)
    return out_path


def export_run_html(out_path: str, slam, gt: Optional[np.ndarray] = None,
                    title: str = "gslam_tpu run",
                    refresh_s: float = 0.0) -> str:
    """Export a SLAM run (any system with ``.positions()``).

    ``refresh_s > 0`` embeds an auto-reload timer (the camera view and
    playback position survive the reload via localStorage), which turns
    the file into a live view of a run in progress when the app
    re-emits it (``play -viz.live K``).  The arena's point and frame
    fields are copied to the host once."""
    from gslam_tpu_torch.map.arena import covisibility_matrix

    traj = np.asarray(slam.positions())
    points = colors = covis = None
    kf_poses = None
    arena = getattr(slam, "arena", None)
    if arena is not None:
        ok, xyz, col, fok, fpose, C = (t.cpu().numpy() for t in (
            arena.point_valid, arena.point_xyz, arena.point_color,
            arena.frame_valid, arena.frame_pose, covisibility_matrix(arena)))
        points = xyz[ok]
        col = col[ok]
        colors = col if np.any(col > 0) else None
        kf_poses = fpose[fok]
        covis = _covis_edges(C, fok, fpose[:, :3], 15, 400)
    return export_html(out_path, traj, gt=gt, points=points,
                       point_colors=colors, kf_poses=kf_poses,
                       covis=covis, title=title, refresh_s=refresh_s)


def overview_png(out_path: str, traj: np.ndarray,
                 gt: Optional[np.ndarray] = None,
                 points: Optional[np.ndarray] = None) -> str:
    """A 960 x 720 top-down overview (x to the right, z up, one scale for
    both) as an RGB PNG: map points grey, ground truth green, the
    estimate blue, on white; returns out_path.  Rasterized here and
    written by the standard-library writer, so no plotting package is
    needed."""
    from gslam_tpu_torch.utils.png import write_png

    width, height = 960, 720

    layers = [(points, (150, 150, 150), False), (gt, (40, 170, 80), True),
              (traj, (30, 90, 220), True)]
    xz = [np.asarray(a, np.float64)[:, [0, 2]] for a, _, _ in layers
          if a is not None and len(a)]
    xz = [a[np.isfinite(a).all(1)] for a in xz]
    allp = np.concatenate(xz) if xz else np.zeros((0, 2))
    lo = allp.min(0) if len(allp) else np.zeros(2)
    hi = allp.max(0) if len(allp) else np.ones(2)
    margin = 20
    scale = min((width - 2 * margin) / max(hi[0] - lo[0], 1e-6),
                (height - 2 * margin) / max(hi[1] - lo[1], 1e-6))
    img = np.full((height, width, 3), 255, np.uint8)
    for a, color, line in layers:
        if a is None or not len(a):
            continue
        p = np.asarray(a, np.float64)[:, [0, 2]]
        p = p[np.isfinite(p).all(1)]
        px = np.stack([margin + (p[:, 0] - lo[0]) * scale,
                       height - 1 - margin - (p[:, 1] - lo[1]) * scale], 1)
        if line and len(px) > 1:        # a dot every pixel along each step
            d = np.diff(px, axis=0)
            steps = np.ceil(np.abs(d).max(1)).astype(int) + 1
            px = np.concatenate([px[i] + d[i] * np.linspace(0, 1, k)[:, None]
                                 for i, k in enumerate(steps)])
        u = np.round(px[:, 0]).astype(int)
        v = np.round(px[:, 1]).astype(int)
        for du in (0, 1):                 # 2 x 2 pixels a dot
            for dv in (0, 1):
                img[np.clip(v + dv, 0, height - 1),
                    np.clip(u + du, 0, width - 1)] = color
    write_png(out_path, img)
    return out_path


_TEMPLATE = r"""<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>__TITLE__</title>
<style>
 body{margin:0;background:#101014;color:#cfd2d8;font:13px sans-serif;
      overflow:hidden}
 #hud{position:absolute;top:8px;left:10px;background:#181a20cc;
      padding:8px 12px;border-radius:6px;line-height:1.7;user-select:none}
 #hud label{margin-right:10px;cursor:pointer}
 #play{position:absolute;bottom:10px;left:10px;right:10px;
       background:#181a20cc;padding:6px 12px;border-radius:6px;
       display:flex;align-items:center;gap:10px}
 #frame{flex:1}
 canvas{display:block}
 .sw{display:inline-block;width:10px;height:10px;border-radius:2px;
     margin-right:4px;vertical-align:-1px}
</style></head><body>
<canvas id="c"></canvas>
<div id="hud"><b>__TITLE__</b> &nbsp;<span id="stats"></span><br>
 <label><input type="checkbox" id="Lpts" checked>
  <span class="sw" style="background:#9aa0a8"></span>map</label>
 <label><input type="checkbox" id="Ltraj" checked>
  <span class="sw" style="background:#4da3ff"></span>trajectory</label>
 <label><input type="checkbox" id="Lgt" checked>
  <span class="sw" style="background:#58d68d"></span>ground truth</label>
 <label><input type="checkbox" id="Lkf" checked>
  <span class="sw" style="background:#e5c07b"></span>keyframes</label>
 <label><input type="checkbox" id="Lcv">
  <span class="sw" style="background:#c678dd"></span>covisibility</label>
 <br><span style="opacity:.6">drag: orbit &middot; shift-drag: pan
 &middot; wheel: zoom</span></div>
<div id="play"><button id="pp">&#9654;</button>
 <input type="range" id="frame" min="0" max="0" value="0">
 <span id="fno"></span></div>
<script>
const D = __DATA__;
const cv = document.getElementById('c'), ctx = cv.getContext('2d');
let W, H; function rs(){W=cv.width=innerWidth;H=cv.height=innerHeight;}
rs(); addEventListener('resize', ()=>{rs(); draw();});

// ---- fit view to data ----
let all = D.traj.concat(D.gt||[], D.points||[]);
if(!all.length) all=[[0,0,0]];
let lo=[1e9,1e9,1e9], hi=[-1e9,-1e9,-1e9];
for(const p of all) for(let k=0;k<3;k++){
  lo[k]=Math.min(lo[k],p[k]); hi[k]=Math.max(hi[k],p[k]);}
const ctr=[0,1,2].map(k=>(lo[k]+hi[k])/2);
const ext=Math.max(hi[0]-lo[0],hi[1]-lo[1],hi[2]-lo[2],1e-3);

// ---- orbit camera ----
let yaw=-0.6, pitch=-0.45, dist=ext*1.8, pan=[0,0,0];
// live mode: restore the view across auto-reloads
const REFRESH_S = __REFRESH_S__;
try { const v = JSON.parse(localStorage.getItem('gslam_view')||'null');
  if (REFRESH_S > 0 && v) { yaw=v.yaw; pitch=v.pitch; dist=v.dist;
    pan=v.pan; } } catch(e) {}
function saveView(){ if (REFRESH_S > 0) try { localStorage.setItem(
  'gslam_view', JSON.stringify({yaw,pitch,dist,pan})); } catch(e) {} }
if (REFRESH_S > 0) setTimeout(()=>{ saveView();
  location.reload(); }, REFRESH_S*1000);
function cam(){
  const cy=Math.cos(yaw), sy=Math.sin(yaw),
        cp=Math.cos(pitch), sp=Math.sin(pitch);
  // rows of R (world->cam): right, up, fwd
  const R=[[cy,0,sy],[sy*sp,cp,-cy*sp],[-sy*cp,sp,cy*cp]];
  return R;
}
const f=()=>0.9*Math.min(W,H);
function project(p, R){
  const q=[p[0]-ctr[0]-pan[0], p[1]-ctr[1]-pan[1], p[2]-ctr[2]-pan[2]];
  const x=R[0][0]*q[0]+R[0][1]*q[1]+R[0][2]*q[2];
  const y=R[1][0]*q[0]+R[1][1]*q[1]+R[1][2]*q[2];
  const z=R[2][0]*q[0]+R[2][1]*q[1]+R[2][2]*q[2]+dist;
  if(z<1e-3) return null;
  return [W/2+f()*x/z, H/2-f()*y/z, z];
}
function polyline(P, R, n, style, w){
  ctx.strokeStyle=style; ctx.lineWidth=w; ctx.beginPath();
  let pen=false;
  for(let i=0;i<n;i++){
    const s=project(P[i],R);
    if(!s){pen=false;continue;}
    if(pen) ctx.lineTo(s[0],s[1]); else ctx.moveTo(s[0],s[1]);
    pen=true;}
  ctx.stroke();
}
function segments(S, R, style, w){
  ctx.strokeStyle=style; ctx.lineWidth=w; ctx.beginPath();
  for(let i=0;i+1<S.length;i+=2){
    const a=project(S[i],R), b=project(S[i+1],R);
    if(a&&b){ctx.moveTo(a[0],a[1]);ctx.lineTo(b[0],b[1]);}}
  ctx.stroke();
}
const on=id=>document.getElementById(id).checked;
const fr=document.getElementById('frame');
fr.max=Math.max(D.traj.length-1,0); fr.value=fr.max;
function heightColor(y){
  const t=Math.max(0,Math.min(1,(y-lo[1])/Math.max(hi[1]-lo[1],1e-6)));
  return `rgb(${120+100*t|0},${140+60*(1-t)|0},${170-60*t|0})`;
}
function draw(){
  ctx.fillStyle='#101014'; ctx.fillRect(0,0,W,H);
  const R=cam(), nF=+fr.value+1;
  if(on('Lpts')&&D.points.length){
    for(let i=0;i<D.points.length;i++){
      const s=project(D.points[i],R); if(!s)continue;
      const r=Math.max(1,Math.min(3,90/s[2]*ext/10));
      ctx.fillStyle=D.colors.length?
        `rgb(${D.colors[i].map(c=>c*255|0)})`:heightColor(D.points[i][1]);
      ctx.fillRect(s[0],s[1],r,r);}}
  if(on('Lcv')&&D.covis.length) segments(D.covis,R,'#c678dd55',1);
  if(on('Lgt')&&D.gt.length) polyline(D.gt,R,nF,'#58d68d',1.5);
  if(on('Ltraj')&&D.traj.length){
    polyline(D.traj,R,nF,'#4da3ff',2);
    const s=project(D.traj[nF-1],R);
    if(s){ctx.fillStyle='#ff6b6b';ctx.beginPath();
      ctx.arc(s[0],s[1],5,0,7);ctx.fill();}}
  if(on('Lkf')) for(const F of D.frusta) segments(F,R,'#e5c07b',1);
  document.getElementById('stats').textContent =
    `${D.points.length} pts · ${D.frusta.length} KFs · `+
    `${D.traj.length} poses`;
  document.getElementById('fno').textContent=`${nF}/${D.traj.length}`;
}
// ---- interaction ----
let drag=null;
cv.onmousedown=e=>drag=[e.clientX,e.clientY,e.shiftKey];
addEventListener('mouseup',()=>drag=null);
addEventListener('mousemove',e=>{
  if(!drag)return;
  const dx=e.clientX-drag[0], dy=e.clientY-drag[1];
  if(drag[2]){ // pan in camera plane
    const R=cam(), s=dist/f();
    pan[0]-=s*(dx*R[0][0]-dy*R[1][0]);
    pan[1]-=s*(dx*R[0][1]-dy*R[1][1]);
    pan[2]-=s*(dx*R[0][2]-dy*R[1][2]);
  } else {yaw+=dx*0.008; pitch+=dy*0.008;
    pitch=Math.max(-1.55,Math.min(1.55,pitch));}
  drag=[e.clientX,e.clientY,drag[2]]; draw();});
cv.onwheel=e=>{dist*=Math.exp(e.deltaY*0.001); draw();
               e.preventDefault();};
fr.oninput=draw;
for(const id of ['Lpts','Ltraj','Lgt','Lkf','Lcv'])
  document.getElementById(id).onchange=draw;
// ---- playback ----
let playing=false, tm=null;
document.getElementById('pp').onclick=()=>{
  playing=!playing;
  document.getElementById('pp').innerHTML=playing?'&#10074;&#10074;':'&#9654;';
  if(playing){ if(+fr.value>=+fr.max) fr.value=0;
    tm=setInterval(()=>{ if(+fr.value>=+fr.max){clearInterval(tm);
        playing=false;
        document.getElementById('pp').innerHTML='&#9654;'; return;}
      fr.value=+fr.value+1; draw();},50);
  } else clearInterval(tm);};
draw();
</script></body></html>
"""
