"""Interactive camera-pose / point-cloud alignment viewer (the port's copy
of ``deepearth_tpu/reconstruction/interactive.py``).

TPU-native re-design of the reference's open3d debugging tool
(reference: reconstruction/interactive_visualizer.py) for a zero-egress,
headless-host environment: instead of an open3d desktop window, the scene is
baked into a single self-contained HTML file (no CDN assets) rendered by a
vanilla-JS canvas orbit viewer, served by the dashboard at ``/visualizer``
or opened from disk. The controls match the reference tool:

    T    cycle candidate body→camera transforms
    C    toggle point colors (image colors vs view-index colors)
    X/x  ±rotation adjustment around X          (shift = negative)
    Y/y  ±rotation adjustment around Y
    Z/z  ±rotation adjustment around Z
    R    reset adjustments for the current candidate
    drag orbit  ·  wheel zoom

The transform model is the reference's: for each view,
``p_world = R_body2world @ (R_adjust @ R_candidate @ p_cam) + t`` where
``R_candidate`` is one of the 24 proper axis-aligned rotations and
``R_adjust`` a fine Euler correction. :func:`apply_view_transform` is the
NumPy twin of the JS math so alignment can be unit-tested headlessly.
"""

from __future__ import annotations

import base64
import dataclasses
import html as html_mod
import itertools
import json
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np


# --------------------------------------------------------------------------- #
# Candidate transforms
# --------------------------------------------------------------------------- #


def candidate_transforms() -> List[Tuple[str, np.ndarray]]:
    """All 24 proper (det=+1) axis-aligned rotations, deterministically ordered.

    The reference hand-lists a few likely body→camera candidates; generating
    the full proper-rotation group subsumes that list (every hand candidate
    is one of the 24) while staying cycle-able with the same ``T`` key.
    """
    out = []
    axes = [np.array(v, np.float64) for v in
            [(1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1)]]

    def label(v):
        i = int(np.argmax(np.abs(v)))
        return ("-" if v[i] < 0 else "+") + "xyz"[i]

    for x, y in itertools.product(axes, axes):
        if abs(float(x @ y)) > 1e-9:
            continue
        z = np.cross(x, y)
        r = np.stack([x, y, z], axis=1)  # columns = images of e_x, e_y, e_z
        out.append((f"x→{label(x)} y→{label(y)} z→{label(z)}", r))
    assert len(out) == 24
    return out


def euler_adjust_matrix(rx_deg: float, ry_deg: float, rz_deg: float) -> np.ndarray:
    """Fine-adjustment rotation, applied as Rz @ Ry @ Rx (degrees)."""
    rx, ry, rz = (math.radians(a) for a in (rx_deg, ry_deg, rz_deg))
    cx, sx = math.cos(rx), math.sin(rx)
    cy, sy = math.cos(ry), math.sin(ry)
    cz, sz = math.cos(rz), math.sin(rz)
    mx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    my = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    mz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return mz @ my @ mx


def apply_view_transform(
    points_cam: np.ndarray,
    rotation_body_to_world: np.ndarray,
    translation: np.ndarray,
    candidate: np.ndarray,
    adjust: Optional[np.ndarray] = None,
) -> np.ndarray:
    """NumPy twin of the viewer's JS: camera points → world frame."""
    r = np.asarray(rotation_body_to_world, np.float64)
    c = np.asarray(candidate, np.float64)
    a = np.eye(3) if adjust is None else np.asarray(adjust, np.float64)
    full = r @ a @ c
    return points_cam @ full.T + np.asarray(translation, np.float64)


# --------------------------------------------------------------------------- #
# Scene assembly
# --------------------------------------------------------------------------- #


@dataclasses.dataclass
class ViewCloud:
    """One view's camera-frame points + pose."""

    points_cam: np.ndarray  # (M, 3) float32
    colors: Optional[np.ndarray]  # (M, 3) uint8 or None
    rotation_body_to_world: np.ndarray  # (3, 3)
    translation: np.ndarray  # (3,)
    name: str = ""


def build_scene(
    dataset,
    indices: Optional[Sequence[int]] = None,
    stride: int = 4,
    max_depth: Optional[float] = None,
    max_points_per_view: int = 20000,
    use_norm_positions: bool = True,
) -> List[ViewCloud]:
    """GeoFusionDataset → per-view clouds for the viewer.

    Depth maps are unprojected with the dataset intrinsics; colors are
    sampled from the RGB image when present. Positions use the normalized
    bbox frame by default (metres-scale ECEF coordinates overflow float32
    in the JS renderer).
    """
    from .point_cloud import unproject_depth

    views: List[ViewCloud] = []
    idxs = list(indices) if indices is not None else list(range(len(dataset)))
    for i in idxs:
        frame = dataset[i]
        depth = dataset.load_depth(i)
        if depth is None:
            continue
        pts = unproject_depth(depth, dataset.intrinsics, stride=stride,
                              max_depth=max_depth)
        colors = None
        img = dataset.load_image(i)
        if img is not None:
            h, w = depth.shape[:2]
            ih, iw = img.shape[:2]
            ys, xs = np.mgrid[0:h:stride, 0:w:stride]
            d = depth[::stride, ::stride]
            valid = d > 0
            if max_depth is not None:
                valid &= d <= max_depth
            ys, xs = ys[valid], xs[valid]
            colors = img[
                np.clip(ys * ih // h, 0, ih - 1), np.clip(xs * iw // w, 0, iw - 1)
            ][:, :3].astype(np.uint8)
        if len(pts) > max_points_per_view:
            sel = np.random.default_rng(0).choice(
                len(pts), max_points_per_view, replace=False
            )
            pts = pts[sel]
            colors = colors[sel] if colors is not None else None
        t = frame.position_norm if use_norm_positions else frame.position_ecef
        views.append(
            ViewCloud(
                points_cam=pts.astype(np.float32),
                colors=colors,
                rotation_body_to_world=np.asarray(
                    frame.rotation_cam_to_ecef, np.float64
                ),
                translation=np.asarray(t, np.float64),
                name=frame.image_name,
            )
        )
    return views


def _b64(a: np.ndarray) -> str:
    return base64.b64encode(np.ascontiguousarray(a).tobytes()).decode()


def scene_to_json(views: Sequence[ViewCloud]) -> str:
    """Compact JSON payload: float32/uint8 buffers as base64."""
    payload = {
        "views": [
            {
                "name": v.name,
                "n": int(len(v.points_cam)),
                "points": _b64(v.points_cam.astype(np.float32)),
                "colors": _b64(v.colors) if v.colors is not None else None,
                "rotation": np.asarray(
                    v.rotation_body_to_world, np.float64
                ).reshape(-1).tolist(),
                "translation": np.asarray(v.translation, np.float64).tolist(),
            }
            for v in views
        ],
        "candidates": [
            {"label": lbl, "m": m.reshape(-1).tolist()}
            for lbl, m in candidate_transforms()
        ],
    }
    # '<' escaped so a hostile frame name containing '</script>' cannot
    # break out of the <script type="application/json"> block (ADVICE r2)
    return json.dumps(payload).replace("<", "\\u003c")


# --------------------------------------------------------------------------- #
# HTML viewer
# --------------------------------------------------------------------------- #

_VIEWER_JS = r"""
'use strict';
const DATA = JSON.parse(document.getElementById('scene-data').textContent);
function f32(b64){const s=atob(b64);const a=new Uint8Array(s.length);
  for(let i=0;i<s.length;i++)a[i]=s.charCodeAt(i);return new Float32Array(a.buffer);}
function u8(b64){const s=atob(b64);const a=new Uint8Array(s.length);
  for(let i=0;i<s.length;i++)a[i]=s.charCodeAt(i);return a;}
const VIEW_PALETTE=[[230,70,70],[70,160,230],[90,200,120],[240,180,60],
  [180,110,220],[90,210,210],[240,120,180],[150,150,150]];
const views=DATA.views.map((v,i)=>({name:v.name,n:v.n,pts:f32(v.points),
  col:v.colors?u8(v.colors):null,R:v.rotation,t:v.translation,
  vcol:VIEW_PALETTE[i%VIEW_PALETTE.length]}));
let candIdx=0,useImageColors=true;
const adjust=DATA.candidates.map(()=>[0,0,0]);   // per-candidate euler degrees
const STEP=5.0;
function matmul(a,b){const r=new Array(9).fill(0);
  for(let i=0;i<3;i++)for(let j=0;j<3;j++)for(let k=0;k<3;k++)
    r[3*i+j]+=a[3*i+k]*b[3*k+j];return r;}
function euler(rx,ry,rz){const d=Math.PI/180;
  const [cx,sx]=[Math.cos(rx*d),Math.sin(rx*d)];
  const [cy,sy]=[Math.cos(ry*d),Math.sin(ry*d)];
  const [cz,sz]=[Math.cos(rz*d),Math.sin(rz*d)];
  const mx=[1,0,0, 0,cx,-sx, 0,sx,cx];
  const my=[cy,0,sy, 0,1,0, -sy,0,cy];
  const mz=[cz,-sz,0, sz,cz,0, 0,0,1];
  return matmul(mz,matmul(my,mx));}
// world-space point assembly (redone when candidate/adjust changes)
let world=[],center=[0,0,0],radius=1;
function rebuild(){
  const cand=DATA.candidates[candIdx].m;
  const adj=euler(...adjust[candIdx]);
  world=[];let lo=[1e30,1e30,1e30],hi=[-1e30,-1e30,-1e30];
  for(const v of views){
    const full=matmul(v.R,matmul(adj,cand));
    const out=new Float32Array(v.n*3);
    for(let i=0;i<v.n;i++){
      const x=v.pts[3*i],y=v.pts[3*i+1],z=v.pts[3*i+2];
      for(let r=0;r<3;r++){
        const w=full[3*r]*x+full[3*r+1]*y+full[3*r+2]*z+v.t[r];
        out[3*i+r]=w;
        if(w<lo[r])lo[r]=w; if(w>hi[r])hi[r]=w;}}
    world.push(out);}
  center=[(lo[0]+hi[0])/2,(lo[1]+hi[1])/2,(lo[2]+hi[2])/2];
  radius=Math.max(hi[0]-lo[0],hi[1]-lo[1],hi[2]-lo[2],1e-9)/2;
  hud();draw();}
let yaw=0.6,pitch=0.4,zoom=1.0,drag=null;
const canvas=document.getElementById('c'),ctx=canvas.getContext('2d');
function draw(){
  const W=canvas.width=canvas.clientWidth,H=canvas.height=canvas.clientHeight;
  ctx.fillStyle='#101014';ctx.fillRect(0,0,W,H);
  const cy=Math.cos(yaw),sy=Math.sin(yaw),cp=Math.cos(pitch),sp=Math.sin(pitch);
  const s=Math.min(W,H)/(2.2*radius)*zoom;
  for(let vi=0;vi<world.length;vi++){
    const pts=world[vi],v=views[vi];
    const col=(useImageColors&&v.col)?v.col:null;
    if(!col){const c=v.vcol;ctx.fillStyle=`rgb(${c[0]},${c[1]},${c[2]})`;}
    for(let i=0;i<pts.length;i+=3){
      const x=pts[i]-center[0],y=pts[i+1]-center[1],z=pts[i+2]-center[2];
      const rx=cy*x+sy*y, ry0=-sy*x+cy*y;
      const ry=cp*ry0+sp*z;
      const px=W/2+rx*s, py=H/2-ry*s;
      if(px<0||px>=W||py<0||py>=H)continue;
      if(col){const j=i; ctx.fillStyle=`rgb(${col[j]},${col[j+1]},${col[j+2]})`;}
      ctx.fillRect(px,py,2,2);}}}
function hud(){
  const a=adjust[candIdx];
  document.getElementById('hud').textContent=
    `[T] candidate ${candIdx+1}/24: ${DATA.candidates[candIdx].label}   `+
    `adjust XYZ: ${a[0]}°/${a[1]}°/${a[2]}°   [C] colors: `+
    `${useImageColors?'image':'view-index'}   views: ${views.length}`;}
window.addEventListener('keydown',e=>{
  const k=e.key;
  if(k==='t'||k==='T'){candIdx=(candIdx+1)%DATA.candidates.length;rebuild();}
  else if(k==='c'||k==='C'){useImageColors=!useImageColors;hud();draw();}
  else if(k.toLowerCase()==='x'){adjust[candIdx][0]+=(k==='x'?STEP:-STEP);rebuild();}
  else if(k.toLowerCase()==='y'){adjust[candIdx][1]+=(k==='y'?STEP:-STEP);rebuild();}
  else if(k.toLowerCase()==='z'){adjust[candIdx][2]+=(k==='z'?STEP:-STEP);rebuild();}
  else if(k==='r'||k==='R'){adjust[candIdx]=[0,0,0];rebuild();}});
canvas.addEventListener('mousedown',e=>drag=[e.clientX,e.clientY]);
window.addEventListener('mouseup',()=>drag=null);
window.addEventListener('mousemove',e=>{if(!drag)return;
  yaw+=(e.clientX-drag[0])*0.008;pitch+=(e.clientY-drag[1])*0.008;
  pitch=Math.max(-1.55,Math.min(1.55,pitch));drag=[e.clientX,e.clientY];draw();});
canvas.addEventListener('wheel',e=>{e.preventDefault();
  zoom*=Math.exp(-e.deltaY*0.001);draw();},{passive:false});
window.addEventListener('resize',draw);
rebuild();
"""


def render_viewer_html(views: Sequence[ViewCloud], title: str = "DeepEarth viewer") -> str:
    """Self-contained HTML page (no external assets) for the scene."""
    title = html_mod.escape(title)
    return f"""<!doctype html>
<html><head><meta charset="utf-8"><title>{title}</title><style>
html,body{{margin:0;height:100%;background:#101014;color:#ddd;
  font:13px monospace;overflow:hidden}}
#c{{width:100%;height:calc(100% - 28px);display:block;cursor:grab}}
#hud{{height:28px;line-height:28px;padding:0 10px;background:#1a1a22;
  white-space:nowrap;overflow:hidden}}
</style></head><body>
<div id="hud"></div><canvas id="c"></canvas>
<script type="application/json" id="scene-data">{scene_to_json(views)}</script>
<script>{_VIEWER_JS}</script>
</body></html>"""


def write_viewer(views: Sequence[ViewCloud], path: str,
                 title: str = "DeepEarth viewer") -> str:
    with open(path, "w") as f:
        f.write(render_viewer_html(views, title))
    return path
