"""Interactive 3-D viewer — the live Pangolin/rviz equivalent.

The reference opens a Pangolin OpenGL window on the server host: per-client
camera frusta and trajectories color-coded, loop-closure edges, a live frame
mosaic, and an `s` key that exports per-agent TUM trajectories + triggers
the mesh save (`/root/reference/server_pose_graph/include/server_plotter.h:
158-273,286-600`) plus rviz marker topics (`utility/server_visualization.cpp`)
and the Chisel mesh/chunk-box topics (`chisel_ros/src/ChiselServer.cpp:
49-108`). A headless server has no display, so the equivalent here is browser-based:

- `export_viewer_html` writes ONE self-contained HTML file (no external
  assets, pure WebGL) with orbit/pan/zoom, per-agent trajectories + frusta,
  loop edges (intra/inter + PCM-rejected), the TSDF mesh with SDF-gradient
  normal shading, a keyframe playback slider, and the reference's `s`-key
  TUM export (downloads pose1..N.txt in the Pangolin format).
- `LiveViewer` serves the same app over a stdlib HTTP server with a
  /state.json endpoint the page re-polls — a live view of a running
  `CollaborativeServer`, the rviz role, with zero dependencies.
"""

from __future__ import annotations

import base64
import json
import threading

import numpy as np

__all__ = ["collect_state", "export_viewer_html", "LiveViewer"]

# matches utils.visualization._CLIENT_COLORS (tab palette) as hex
_AGENT_HEX = ["#1f77b4", "#ff7f0e", "#2ca02c", "#d62728", "#9467bd",
              "#8c564b", "#e377c2", "#7f7f7f", "#bcbd22", "#17becf"]


def _b64(a: np.ndarray) -> str:
    return base64.b64encode(np.ascontiguousarray(a, np.float32).tobytes()
                            ).decode("ascii")


def collect_state(server, volume=None, max_tris: int = 60000,
                  rev: int = 0) -> dict:
    """Snapshot a CollaborativePoseGraph (or pipeline.CollaborativeServer)
    + optional TsdfVolume into the viewer's JSON state.

    Array payloads are base64 float32 (compact and exact); the page decodes
    them straight into WebGL buffers.
    """
    from ..geometry.hostmath import matrix_to_quat_np, rot_z_np, ypr_to_r_np

    g = getattr(server, "graph", server)
    vol = volume if volume is not None else getattr(server, "volume", None)
    st = g.store
    n = st.count
    agents = []
    for cid in range(int(st.client[:n].max()) + 1 if n else 0):
        sel = np.nonzero(st.client[:n] == cid)[0]
        if len(sel) == 0:
            continue
        ypr = np.stack([st.world_yaw[sel], st.world_pr[sel, 0],
                        st.world_pr[sel, 1]], -1)
        rot = ypr_to_r_np(ypr).astype(np.float32)       # (N, 3, 3) world<-imu
        quat = matrix_to_quat_np(rot)                    # (w, x, y, z)
        ts = st.timestamp[sel]
        ts0 = float(ts[0]) if len(ts) else 0.0
        agents.append({
            "id": int(cid),
            "n": int(len(sel)),
            "color": _AGENT_HEX[cid % len(_AGENT_HEX)],
            "pos": _b64(st.world_p[sel]),
            "rot": _b64(rot.reshape(-1, 9)),
            "quat": _b64(quat),
            # epoch base + float32 offsets keep TUM stamps exact to ~30 µs
            "ts0": ts0,
            "ts": _b64(ts - ts0),
        })
    loops = {"n": 0, "seg": "", "inter": "", "ok": ""}
    if g.loop_count:
        li = g.loop_i[:g.loop_count]
        lj = g.loop_j[:g.loop_count]
        keep = g.loop_valid[:g.loop_count]
        li, lj = li[keep], lj[keep]
        seg = np.stack([st.world_p[li], st.world_p[lj]], 1)   # (E, 2, 3)
        loops = {"n": int(len(li)),
                 "seg": _b64(seg),
                 "inter": _b64(g.loop_inter[:g.loop_count][keep]),
                 "ok": _b64(g.loop_pcm_ok[:g.loop_count][keep])}
    vstate = collect_volume_state(vol, max_tris=max_tris)
    return {"rev": int(rev), "agents": agents, "loops": loops, **vstate}


def collect_volume_state(vol, max_tris: int = 60000) -> dict:
    """Mesh + chunk-box part of the viewer state. Split out so callers can
    run the (expensive) marching-cubes extraction OUTSIDE any pose-graph
    lock — the TSDF volume is not guarded by it."""
    mesh = {"n": 0, "pos": "", "col": "", "nrm": ""}
    chunks = {"n": 0, "seg": "", "size": 0.0}
    if vol is not None and getattr(vol, "slot_of", None):
        from ..mapping.mesh import extract_mesh
        verts, cols, nrms = extract_mesh(vol)
        if len(verts) > max_tris:    # decimate deterministically for the page
            pick = np.random.default_rng(0).choice(len(verts), max_tris,
                                                   replace=False)
            verts, cols, nrms = verts[pick], cols[pick], nrms[pick]
        mesh = {"n": int(len(verts)), "pos": _b64(verts.reshape(-1, 9)),
                "col": _b64(cols.reshape(-1, 9) / 255.0
                            if cols.max(initial=0) > 1.5
                            else cols.reshape(-1, 9)),
                "nrm": _b64(nrms.reshape(-1, 9))}
        # chunk boxes (the rviz chunk_boxes topic): one min-corner per chunk
        side = float(vol.cfg.chunk_size * vol.cfg.voxel_size)
        corners = np.asarray(list(vol.slot_of.keys()), np.float32) * side
        chunks = {"n": int(len(corners)), "seg": _b64(corners), "size": side}
    return {"mesh": mesh, "chunks": chunks}


def export_viewer_html(path: str, server=None, volume=None,
                       state: dict | None = None,
                       title: str = "cvids viewer") -> str:
    """Write the self-contained interactive viewer to `path`.

    Pass either a server (+ optional volume) or a pre-collected `state`.
    Returns the path.
    """
    if state is None:
        state = collect_state(server, volume)
    html = (_HTML.replace("__TITLE__", _html_escape(title))
            .replace("__LIVE__", "false")
            .replace("__STATE__", json.dumps(state)))
    with open(path, "w") as f:
        f.write(html)
    return path


def _html_escape(title: str) -> str:
    """Escape a user-supplied title for interpolation into the page — a
    '</script>'-bearing title must not break or inject into the HTML."""
    import html as _html
    return _html.escape(title).replace("/", "&#47;")


class LiveViewer:
    """Serve the viewer over HTTP with a re-polled /state.json — the live
    Pangolin-window / rviz role for a running server.

    state_fn() -> dict must return a fresh `collect_state` snapshot; bump
    its `rev` when content changed so the page rebuilds buffers.
    """

    def __init__(self, state_fn, host: str = "127.0.0.1", port: int = 0,
                 title: str = "cvids live viewer"):
        import http.server

        html = (_HTML.replace("__TITLE__", _html_escape(title))
                .replace("__LIVE__", "true")
                .replace("__STATE__", "null"))

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):                          # noqa: N802 (stdlib)
                if self.path.split("?")[0] == "/state.json":
                    st = state_fn()
                    # state_fn may return a pre-serialized JSON string
                    # (cached by the server when rev is unchanged)
                    body = (st.encode() if isinstance(st, str)
                            else st if isinstance(st, bytes)
                            else json.dumps(st).encode())
                    ctype = "application/json"
                else:
                    body = html.encode()
                    ctype = "text/html"
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):                 # quiet
                pass

        self._srv = http.server.ThreadingHTTPServer((host, port), Handler)
        self.port = self._srv.server_address[1]
        self.url = f"http://{host}:{self.port}/"
        self._thread = threading.Thread(target=self._srv.serve_forever,
                                        daemon=True)
        self._thread.start()

    def close(self):
        self._srv.shutdown()
        self._srv.server_close()
        self._thread.join(timeout=5)


_HTML = r"""<!doctype html>
<html><head><meta charset="utf-8"><title>__TITLE__</title><style>
 html,body{margin:0;height:100%;overflow:hidden;background:#101014;
   font:12px system-ui,sans-serif;color:#ddd}
 #c{width:100%;height:100%;display:block}
 #hud{position:fixed;top:8px;left:10px;pointer-events:none;line-height:1.5}
 #hud b{color:#fff}
 #help{position:fixed;bottom:8px;left:10px;color:#888}
 #play{position:fixed;bottom:10px;right:12px;width:30%;pointer-events:auto}
</style></head><body>
<canvas id="c"></canvas>
<div id="hud"><b>__TITLE__</b><br><span id="stats"></span></div>
<div id="help">drag orbit &middot; shift/right-drag pan &middot; wheel zoom
 &middot; [s] TUM export &middot; [f] frusta &middot; [l] loops &middot;
 [g] mesh &middot; [b] chunk boxes</div>
<input id="play" type="range" min="0" max="1000" value="1000">
<script>
"use strict";
let STATE=__STATE__; const LIVE=__LIVE__;
const cv=document.getElementById("c"),gl=cv.getContext("webgl");
function f32(b64){const s=atob(b64),a=new Uint8Array(s.length);
  for(let i=0;i<s.length;i++)a[i]=s.charCodeAt(i);
  return new Float32Array(a.buffer);}
function sh(type,src){const s=gl.createShader(type);gl.shaderSource(s,src);
  gl.compileShader(s);return s;}
function prog(vs,fs){const p=gl.createProgram();
  gl.attachShader(p,sh(gl.VERTEX_SHADER,vs));
  gl.attachShader(p,sh(gl.FRAGMENT_SHADER,fs));gl.linkProgram(p);return p;}
const PL=prog(
 "attribute vec3 p;uniform mat4 mvp;void main(){gl_Position=mvp*vec4(p,1.);}",
 "precision mediump float;uniform vec4 col;void main(){gl_FragColor=col;}");
const PM=prog(
 "attribute vec3 p;attribute vec3 c;attribute vec3 n;uniform mat4 mvp;"+
 "varying vec3 vc;varying vec3 vn;void main(){vc=c;vn=n;"+
 "gl_Position=mvp*vec4(p,1.);}",
 "precision mediump float;varying vec3 vc;varying vec3 vn;uniform vec3 lit;"+
 "void main(){float d=.35+.65*max(dot(normalize(vn),lit),0.);"+
 "gl_FragColor=vec4(vc*d,1.);}");
// ---- tiny mat4 ----
function mul(a,b){const o=new Float32Array(16);
 for(let i=0;i<4;i++)for(let j=0;j<4;j++){let s=0;
  for(let k=0;k<4;k++)s+=a[k*4+j]*b[i*4+k];o[i*4+j]=s;}return o;}
function persp(fov,asp,n,f){const t=1/Math.tan(fov/2);
 return new Float32Array([t/asp,0,0,0, 0,t,0,0, 0,0,(f+n)/(n-f),-1,
  0,0,2*f*n/(n-f),0]);}
function lookAt(e,c,u){const z=norm3(sub3(e,c)),x=norm3(cross(u,z)),
 y=cross(z,x);return new Float32Array([x[0],y[0],z[0],0, x[1],y[1],z[1],0,
  x[2],y[2],z[2],0, -dot3(x,e),-dot3(y,e),-dot3(z,e),1]);}
function sub3(a,b){return [a[0]-b[0],a[1]-b[1],a[2]-b[2]];}
function dot3(a,b){return a[0]*b[0]+a[1]*b[1]+a[2]*b[2];}
function cross(a,b){return [a[1]*b[2]-a[2]*b[1],a[2]*b[0]-a[0]*b[2],
 a[0]*b[1]-a[1]*b[0]];}
function norm3(a){const l=Math.hypot(a[0],a[1],a[2])||1;
 return [a[0]/l,a[1]/l,a[2]/l];}
function hex(h){return [parseInt(h.slice(1,3),16)/255,
 parseInt(h.slice(3,5),16)/255,parseInt(h.slice(5,7),16)/255];}
// ---- scene ----
let scene=null;
function buf(arr){const b=gl.createBuffer();gl.bindBuffer(gl.ARRAY_BUFFER,b);
 gl.bufferData(gl.ARRAY_BUFFER,arr,gl.STATIC_DRAW);return b;}
function frustumSegs(pos,rot,n,step){const out=[];const s=0.12;
 const cs=[[ s, s*0.6,s*1.6],[-s, s*0.6,s*1.6],[-s,-s*0.6,s*1.6],
  [ s,-s*0.6,s*1.6]];
 for(let i=0;i<n;i+=step){const p=[pos[3*i],pos[3*i+1],pos[3*i+2]];
  const R=rot.subarray(9*i,9*i+9);const w=[];
  for(const c of cs)w.push([p[0]+R[0]*c[0]+R[1]*c[1]+R[2]*c[2],
   p[1]+R[3]*c[0]+R[4]*c[1]+R[5]*c[2],p[2]+R[6]*c[0]+R[7]*c[1]+R[8]*c[2]]);
  for(let k=0;k<4;k++){out.push(...p,...w[k]);
   out.push(...w[k],...w[(k+1)%4]);}}
 return new Float32Array(out);}
function build(st){const sc={agents:[],bbox:[[1e9,1e9,1e9],[-1e9,-1e9,-1e9]]};
 for(const a of st.agents){const pos=f32(a.pos),rot=f32(a.rot);
  for(let i=0;i<a.n;i++)for(let k=0;k<3;k++){
   sc.bbox[0][k]=Math.min(sc.bbox[0][k],pos[3*i+k]);
   sc.bbox[1][k]=Math.max(sc.bbox[1][k],pos[3*i+k]);}
  const step=Math.max(1,Math.floor(a.n/60));
  const fr=frustumSegs(pos,rot,a.n,step);
  sc.agents.push({n:a.n,color:hex(a.color),traj:buf(pos),
   fr:buf(fr),frN:fr.length/3,pos:pos,quat:f32(a.quat),ts:f32(a.ts),
   ts0:a.ts0,id:a.id});}
 sc.loops=[];
 if(st.loops.n){const seg=f32(st.loops.seg),inter=f32(st.loops.inter),
   ok=f32(st.loops.ok);
  const g=[],r=[],x=[];
  for(let e=0;e<st.loops.n;e++){const s6=seg.subarray(6*e,6*e+6);
   (ok[e]<0.5?x:(inter[e]>0.5?r:g)).push(...s6);}
  sc.loops=[[buf(new Float32Array(g)),g.length/3,[0.2,0.9,0.3,1]],
   [buf(new Float32Array(r)),r.length/3,[0.95,0.3,0.2,1]],
   [buf(new Float32Array(x)),x.length/3,[0.5,0.5,0.5,0.5]]];}
 sc.mesh=null;
 if(st.mesh.n){sc.mesh={n:st.mesh.n*3,pos:buf(f32(st.mesh.pos)),
  col:buf(f32(st.mesh.col)),nrm:buf(f32(st.mesh.nrm))};}
 sc.chunks=null;
 if(st.chunks.n){const c=f32(st.chunks.seg),s=st.chunks.size,out=[];
  const E=[[0,0,0,1,0,0],[0,0,0,0,1,0],[0,0,0,0,0,1],[1,1,1,0,1,1],
   [1,1,1,1,0,1],[1,1,1,1,1,0],[1,0,0,1,1,0],[1,0,0,1,0,1],
   [0,1,0,1,1,0],[0,1,0,0,1,1],[0,0,1,1,0,1],[0,0,1,0,1,1]];
  for(let i=0;i<st.chunks.n;i++){const o=[c[3*i],c[3*i+1],c[3*i+2]];
   for(const e of E)out.push(o[0]+e[0]*s,o[1]+e[1]*s,o[2]+e[2]*s,
    o[0]+e[3]*s,o[1]+e[4]*s,o[2]+e[5]*s);}
  sc.chunks=[buf(new Float32Array(out)),out.length/3];}
 const n=st.agents.reduce((s,a)=>s+a.n,0);
 document.getElementById("stats").textContent=
  st.agents.length+" agents / "+n+" keyframes / "+st.loops.n+" loops / "+
  st.mesh.n+" tris";
 return sc;}
// ---- camera ----
let az=-0.8,el=0.55,dist=0,ctr=[0,0,0];
let show={f:true,l:true,g:true,b:false},playT=1.0;
function fit(){if(!scene)return;const b=scene.bbox;
 ctr=[(b[0][0]+b[1][0])/2,(b[0][1]+b[1][1])/2,(b[0][2]+b[1][2])/2];
 const d=Math.hypot(b[1][0]-b[0][0],b[1][1]-b[0][1],b[1][2]-b[0][2]);
 if(dist===0)dist=Math.max(2,d*1.4);}
function draw(){const w=cv.clientWidth,h=cv.clientHeight;
 if(cv.width!==w||cv.height!==h){cv.width=w;cv.height=h;}
 gl.viewport(0,0,w,h);gl.clearColor(0.063,0.063,0.078,1);
 gl.enable(gl.DEPTH_TEST);
 gl.clear(gl.COLOR_BUFFER_BIT|gl.DEPTH_BUFFER_BIT);
 if(!scene){requestAnimationFrame(draw);return;}
 const eye=[ctr[0]+dist*Math.cos(el)*Math.cos(az),
  ctr[1]+dist*Math.cos(el)*Math.sin(az),ctr[2]+dist*Math.sin(el)];
 const mvp=mul(persp(0.9,w/h,0.05,dist*20),lookAt(eye,ctr,[0,0,1]));
 const ap=gl.getAttribLocation(PL,"p");
 gl.useProgram(PL);gl.uniformMatrix4fv(gl.getUniformLocation(PL,"mvp"),
  false,mvp);gl.enableVertexAttribArray(ap);
 for(const a of scene.agents){const k=Math.max(2,Math.round(a.n*playT));
  gl.bindBuffer(gl.ARRAY_BUFFER,a.traj);
  gl.vertexAttribPointer(ap,3,gl.FLOAT,false,0,0);
  gl.uniform4f(gl.getUniformLocation(PL,"col"),...a.color,1);
  gl.drawArrays(gl.LINE_STRIP,0,Math.min(k,a.n));
  if(show.f){gl.bindBuffer(gl.ARRAY_BUFFER,a.fr);
   gl.vertexAttribPointer(ap,3,gl.FLOAT,false,0,0);
   gl.drawArrays(gl.LINES,0,a.frN);}}
 if(show.l)for(const[b,n,c]of scene.loops){if(!n)continue;
  gl.bindBuffer(gl.ARRAY_BUFFER,b);
  gl.vertexAttribPointer(ap,3,gl.FLOAT,false,0,0);
  gl.uniform4f(gl.getUniformLocation(PL,"col"),...c);
  gl.drawArrays(gl.LINES,0,n);}
 if(show.b&&scene.chunks){gl.bindBuffer(gl.ARRAY_BUFFER,scene.chunks[0]);
  gl.vertexAttribPointer(ap,3,gl.FLOAT,false,0,0);
  gl.uniform4f(gl.getUniformLocation(PL,"col"),0.3,0.5,0.8,0.5);
  gl.drawArrays(gl.LINES,0,scene.chunks[1]);}
 if(show.g&&scene.mesh){gl.useProgram(PM);
  gl.uniformMatrix4fv(gl.getUniformLocation(PM,"mvp"),false,mvp);
  const l=norm3(sub3(eye,ctr));
  gl.uniform3f(gl.getUniformLocation(PM,"lit"),l[0],l[1],l[2]);
  const pp=gl.getAttribLocation(PM,"p"),pc=gl.getAttribLocation(PM,"c"),
   pn=gl.getAttribLocation(PM,"n");
  gl.enableVertexAttribArray(pp);gl.enableVertexAttribArray(pc);
  gl.enableVertexAttribArray(pn);
  gl.bindBuffer(gl.ARRAY_BUFFER,scene.mesh.pos);
  gl.vertexAttribPointer(pp,3,gl.FLOAT,false,0,0);
  gl.bindBuffer(gl.ARRAY_BUFFER,scene.mesh.col);
  gl.vertexAttribPointer(pc,3,gl.FLOAT,false,0,0);
  gl.bindBuffer(gl.ARRAY_BUFFER,scene.mesh.nrm);
  gl.vertexAttribPointer(pn,3,gl.FLOAT,false,0,0);
  gl.drawArrays(gl.TRIANGLES,0,scene.mesh.n);
  gl.disableVertexAttribArray(pc);gl.disableVertexAttribArray(pn);}
 requestAnimationFrame(draw);}
// ---- input ----
let drag=null;
cv.addEventListener("mousedown",e=>{drag={x:e.clientX,y:e.clientY,
 pan:e.button===2||e.shiftKey};});
window.addEventListener("mouseup",()=>drag=null);
cv.addEventListener("contextmenu",e=>e.preventDefault());
window.addEventListener("mousemove",e=>{if(!drag)return;
 const dx=e.clientX-drag.x,dy=e.clientY-drag.y;drag.x=e.clientX;
 drag.y=e.clientY;
 if(drag.pan){const s=dist*0.0015;
  const r=[Math.sin(az)*s*dx,-Math.cos(az)*s*dx,s*dy];
  ctr=[ctr[0]+r[0],ctr[1]+r[1],ctr[2]+r[2]];}
 else{az-=dx*0.008;el=Math.min(1.5,Math.max(-1.5,el+dy*0.008));}});
cv.addEventListener("wheel",e=>{e.preventDefault();
 dist*=Math.exp(e.deltaY*0.001);});
document.getElementById("play").addEventListener("input",e=>{
 playT=e.target.value/1000;});
function dl(name,text){const a=document.createElement("a");
 a.href=URL.createObjectURL(new Blob([text],{type:"text/plain"}));
 a.download=name;a.click();}
window.addEventListener("keydown",e=>{const k=e.key.toLowerCase();
 if(k==="f")show.f=!show.f;if(k==="l")show.l=!show.l;
 if(k==="g")show.g=!show.g;if(k==="b")show.b=!show.b;
 if(k==="s"&&scene){ // the reference plotter's `s` key: TUM export
  for(const a of scene.agents){let t="";
   for(let i=0;i<a.n;i++){const q=a.quat.subarray(4*i,4*i+4);
    t+=(a.ts0+a.ts[i]).toFixed(6)+" "+a.pos[3*i].toFixed(6)+" "+
     a.pos[3*i+1].toFixed(6)+" "+a.pos[3*i+2].toFixed(6)+" "+
     q[1].toFixed(6)+" "+q[2].toFixed(6)+" "+q[3].toFixed(6)+" "+
     q[0].toFixed(6)+"\n";}
   dl("pose"+(a.id+1)+".txt",t);}}});
// ---- boot / live poll ----
function adopt(st){STATE=st;scene=build(st);fit();}
if(STATE)adopt(STATE);
if(LIVE){let rev=-1;
 setInterval(()=>fetch("/state.json").then(r=>r.json()).then(st=>{
  if(st.rev!==rev){rev=st.rev;adopt(st);}}).catch(()=>{}),1000);}
requestAnimationFrame(draw);
</script></body></html>
"""
