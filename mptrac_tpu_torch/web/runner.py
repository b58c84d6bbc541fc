"""Web runner — browser front end for simulation runs.

Rebuild of the reference Flask app
(projects/web_runner/app.py), as the JAX package's runner: an HTML form collects a
met data source (from a server-side catalog with access probing,
app.py:226-264), release location/time, physics options and plot
settings (projection, region, z color range, app.py:265-361); the
server seeds parcels (atm_init/atm_split), runs the simulation,
renders per-output trajectory maps and serves a zip of all outputs
plus the setup files (app.py:367-812: /, /run, /download,
/download_setup, /runs images, /logs).  Uses only the Python standard
library (http.server), no Flask dependency; plotting uses
matplotlib with numpy-implemented Robinson/orthographic projections
instead of cartopy.  Each stage runs the port's tool
(``python -m mptrac_tpu_torch.tools.<name>``) in a subprocess;
``--device`` (default cuda) goes to every tool that builds tensors, here
``trac``.  A tool that fails fails the run.  ``/logs`` lists each run's
stages with their seconds.

Run:  python -m mptrac_tpu_torch.web.runner --port 8080 --metbase <path>
      [--met NAME=PATH[:DT_MET] ...] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import html
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.parse
import uuid
import zipfile
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

RUNS = {}
CONFIG = {}
LOG = []
MAX_RUN_AGE = 3600.0

FORM = """<!doctype html>
<html><head><title>mptrac-tpu web runner</title>
<style>body{{font-family:sans-serif;max-width:720px;margin:2em auto}}
label{{display:block;margin-top:.6em}}
fieldset{{margin-top:1em}}</style></head><body>
<h2>mptrac-tpu simulation runner (PyTorch)</h2>
<form method="post" action="/run">
<fieldset><legend>Meteo data</legend>
<label>Source <select name="met">{met_options}</select></label>
</fieldset>
<fieldset><legend>Release</legend>
<label>Start time (jsec) <input name="t0" value="{t0}"></label>
<label>Duration [h] <input name="hours" value="12"></label>
<label>Longitude [deg] <input name="lon" value="-72.117"></label>
<label>Latitude [deg] <input name="lat" value="-40.59"></label>
<label>Altitude [km] <input name="z" value="7.5"></label>
<label>Parcels <input name="n" value="2000"></label>
<label>Mass [kg] <input name="mass" value="1e9"></label>
</fieldset>
<fieldset><legend>Physics</legend>
<label><input type="checkbox" name="diffusion" checked> turbulent
diffusion</label>
<label><input type="checkbox" name="meso" checked> mesoscale wind
fluctuations</label>
<label><input type="checkbox" name="conv"> convection (CAPE)</label>
<label>Model timestep [s] <input name="dt_mod" value="600"></label>
</fieldset>
<fieldset><legend>Plots</legend>
<label>Projection <select name="proj">
<option value="cartesian">cartesian</option>
<option value="robinson">robinson</option>
<option value="orthographic">orthographic</option>
</select></label>
<label>Region <select name="region">
<option value="global">global</option>
<option value="custom">custom bounds</option>
</select></label>
<label>lon min/max <input name="lon_min" value="-180" size=6>
<input name="lon_max" value="180" size=6></label>
<label>lat min/max <input name="lat_min" value="-90" size=6>
<input name="lat_max" value="90" size=6></label>
<label>z color range [km] <input name="z_min" value="-999" size=6>
<input name="z_max" value="-999" size=6></label>
</fieldset>
<button type="submit">Run</button>
</form>
<p><a href="/logs">server logs</a></p></body></html>"""


def log(msg):
    stamp = time.strftime("%Y-%m-%d %H:%M:%S")
    LOG.append(f"{stamp} {msg}")
    del LOG[:-500]


def probe_met_access(path, timeout_sec=2.0):
    """Check a met directory is reachable (reference
    check_directory_access, app.py:238-264: probes in a thread so a hung
    network mount cannot stall the server)."""
    result = {}

    def probe():
        try:
            result["ok"] = os.path.isdir(path) and bool(
                os.listdir(path) if os.path.isdir(path) else [])
        except Exception:
            result["ok"] = False

    th = threading.Thread(target=probe, daemon=True)
    th.start()
    th.join(timeout_sec)
    return result.get("ok", False)


def clean_old_runs():
    """Drop working dirs older than MAX_RUN_AGE (app.py:47-63)."""
    now = time.time()
    for run_id, run in list(RUNS.items()):
        if now - run.get("t_created", now) > MAX_RUN_AGE:
            try:
                import shutil
                shutil.rmtree(run["dir"], ignore_errors=True)
            except Exception:
                pass
            RUNS.pop(run_id, None)


#: the tools of a run that build tensors, and so take ``--device``
DEVICE_TOOLS = ("trac",)


def _run_simulation(run_id, params):
    workdir = RUNS[run_id]["dir"]
    try:
        env = dict(os.environ, PYTHONPATH=CONFIG["repo"])

        def tool(*args, timeout=1800):
            device = (("--device", CONFIG["device"])
                      if args[0] in DEVICE_TOOLS else ())
            t_start = time.time()
            r = subprocess.run(
                [sys.executable, "-m", f"mptrac_tpu_torch.tools.{args[0]}",
                 *[str(a) for a in args[1:]], *device],
                env=env, cwd=workdir, capture_output=True, text=True,
                timeout=timeout)
            if r.returncode != 0:
                raise RuntimeError(f"{args[0]}: {r.stderr[-2000:]}")
            log(f"run {run_id} stage {args[0]} "
                f"{time.time() - t_start:.3f} s")

        met = CONFIG["catalog"].get(params.get("met", ""),
                                    CONFIG["catalog"]["default"])
        if not probe_met_access(os.path.dirname(met["path"]) or "."):
            raise RuntimeError(
                f"met source '{params.get('met')}' is not accessible")
        t0 = float(params["t0"])
        t1 = t0 + 3600.0 * float(params["hours"])
        with open(os.path.join(workdir, "trac.ctl"), "w") as f:
            f.write(f"""NQ = 1
QNT_NAME[0] = m
METBASE = {met['path']}
DT_MET = {met['dt']}
MET_TROPO = 0
MET_CAPE = {1 if params.get('conv') else 0}
T_STOP = {t1}
DIFFUSION = {1 if params.get('diffusion') else 0}
TURB_MESOX = {0.16 if params.get('meso') else 0}
TURB_MESOZ = {0.4 if params.get('meso') else 0}
CONV_CAPE = {0 if params.get('conv') else -999}
""")
        tool("atm_init", "trac.ctl", "init.tab",
             "INIT_T0", t0, "INIT_T1", t0,
             "INIT_Z0", params["z"], "INIT_Z1", params["z"],
             "INIT_LON0", params["lon"], "INIT_LON1", params["lon"],
             "INIT_LAT0", params["lat"], "INIT_LAT1", params["lat"])
        tool("atm_split", "trac.ctl", "init.tab", "split.tab",
             "SPLIT_N", params["n"], "SPLIT_M", params["mass"],
             "SPLIT_DX", "30", "SPLIT_DZ", "1")
        with open(os.path.join(workdir, "dirlist"), "w") as f:
            f.write(".\n")
        tool("trac", "dirlist", "trac.ctl", "split.tab",
             "ATM_BASENAME", "atm", "DT_MOD", params["dt_mod"],
             "ATM_DT_OUT", 3600)
        tabs = sorted(f for f in os.listdir(workdir)
                      if f.startswith("atm_") and f.endswith(".tab"))
        plot_args = ["plot", "atm", "map_{}.png", *tabs,
                     "--proj", params.get("proj", "cartesian"),
                     "--mark", params["lon"], params["lat"]]
        if params.get("region") == "custom":
            plot_args += ["--bounds", params["lon_min"],
                          params["lon_max"], params["lat_min"],
                          params["lat_max"]]
        if float(params.get("z_max", -999)) > float(
                params.get("z_min", -999)):
            plot_args += ["--zrange", params["z_min"],
                          params["z_max"]]
        tool(*plot_args)
        zpath = os.path.join(workdir, "results.zip")
        with zipfile.ZipFile(zpath, "w") as z:
            for f in os.listdir(workdir):
                if f.endswith((".tab", ".png", ".ctl")):
                    z.write(os.path.join(workdir, f), f)
        spath = os.path.join(workdir, "setup.zip")
        with zipfile.ZipFile(spath, "w") as z:
            for f in ("trac.ctl", "init.tab", "dirlist"):
                fp = os.path.join(workdir, f)
                if os.path.exists(fp):
                    z.write(fp, f)
            z.writestr("params.json", json.dumps(params, indent=2))
        RUNS[run_id].update(status="done",
                            files=[f for f in os.listdir(workdir)
                                   if f.endswith(".png")])
        log(f"run {run_id} done ({len(tabs)} outputs)")
    except Exception as exc:
        RUNS[run_id].update(status="error", error=str(exc))
        log(f"run {run_id} failed: {exc}")


class Handler(BaseHTTPRequestHandler):
    def log_message(self, fmt, *args):
        pass

    def _send(self, body, ctype="text/html", code=200):
        data = body if isinstance(body, bytes) else body.encode()
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):
        parts = self.path.split("?")[0].strip("/").split("/")
        if self.path == "/" or not parts[0]:
            opts = "".join(
                f'<option value="{html.escape(k)}"'
                + (" disabled" if not v.get("ok", True) else "")
                + f'>{html.escape(k)}'
                + ("" if v.get("ok", True) else " (unavailable)")
                + "</option>"
                for k, v in CONFIG["catalog"].items())
            self._send(FORM.format(
                t0=CONFIG.get("default_t0", 0.0), met_options=opts))
        elif parts[0] == "status" and len(parts) > 1:
            run = RUNS.get(parts[1])
            if run is None:
                self._send("unknown run", code=404)
                return
            if run["status"] == "running":
                self._send("<html><head><meta http-equiv=refresh "
                           "content=2></head><body>running...</body>"
                           "</html>")
            elif run["status"] == "error":
                self._send("<pre>" + html.escape(run["error"])
                           + "</pre>", code=500)
            else:
                links = "".join(
                    f'<div><img src="/file/{parts[1]}/{f}" '
                    'style="max-width:100%"></div>'
                    for f in sorted(run["files"]))
                self._send(
                    f'<a href="/file/{parts[1]}/results.zip">'
                    "download results.zip</a> | "
                    f'<a href="/file/{parts[1]}/setup.zip">'
                    f"download setup.zip</a>{links}")
        elif parts[0] == "file" and len(parts) > 2:
            run = RUNS.get(parts[1])
            fn = os.path.join(run["dir"], parts[2]) if run else None
            if fn and os.path.exists(fn):
                ctype = ("image/png" if fn.endswith(".png")
                         else "application/zip")
                with open(fn, "rb") as f:
                    self._send(f.read(), ctype)
            else:
                self._send("not found", code=404)
        elif parts[0] == "logs":
            self._send("<pre>" + html.escape("\n".join(LOG[-200:]))
                       + "</pre>")
        else:
            self._send("not found", code=404)

    def do_POST(self):
        if self.path != "/run":
            self._send("not found", code=404)
            return
        clean_old_runs()
        length = int(self.headers.get("Content-Length", 0))
        params = dict(urllib.parse.parse_qsl(
            self.rfile.read(length).decode()))
        run_id = uuid.uuid4().hex[:12]
        workdir = tempfile.mkdtemp(prefix=f"webrun_{run_id}_")
        RUNS[run_id] = dict(status="running", dir=workdir,
                            t_created=time.time())
        log(f"run {run_id} started: {params}")
        threading.Thread(target=_run_simulation,
                         args=(run_id, params), daemon=True).start()
        self.send_response(303)
        self.send_header("Location", f"/status/{run_id}")
        self.end_headers()


def build_catalog(metbase, dt_met, extra):
    """Met source catalog with access probing (app.py:79-101)."""
    catalog = {"default": {"path": metbase, "dt": dt_met}}
    for spec in extra or []:
        name, _, rest = spec.partition("=")
        path, _, dt = rest.partition(":")
        catalog[name] = {"path": path,
                         "dt": float(dt) if dt else dt_met}
    for v in catalog.values():
        v["ok"] = probe_met_access(os.path.dirname(v["path"]) or ".")
    return catalog


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--metbase", required=True)
    ap.add_argument("--met", action="append", metavar="NAME=PATH[:DT]",
                    help="additional met catalog entries")
    ap.add_argument("--dt-met", type=float, default=86400.0)
    ap.add_argument("--default-t0", type=float, default=0.0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where trac runs (cuda raises without a GPU)")
    args = ap.parse_args(argv)
    CONFIG.update(default_t0=args.default_t0, device=args.device,
                  catalog=build_catalog(args.metbase, args.dt_met,
                                        args.met),
                  repo=os.path.dirname(os.path.dirname(
                      os.path.dirname(os.path.abspath(__file__)))))
    srv = ThreadingHTTPServer(("127.0.0.1", args.port), Handler)
    print(f"web runner listening on http://127.0.0.1:{args.port}")
    srv.serve_forever()


if __name__ == "__main__":
    main()
