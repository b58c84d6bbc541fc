"""The port's web runner (``mptrac_tpu_torch.web.runner``) end to end,
as ``tests/test_web.py`` runs the JAX package's: the form with its met
catalog, a run submitted with ``--device cpu`` and polled to its
results, the plot images, the results and setup downloads and the logs
with each stage's seconds; and the port's plot tool in every projection
(``mptrac_tpu_torch.tools.plot``)."""

import os
import socket
import subprocess
import sys
import time
import urllib.parse
import urllib.request
import zipfile

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def metdir(tmp_path_factory):
    """tests/test_web.py's met: the solid-body wind at 36x19x8, two files
    six hours apart, written by the port."""
    from mptrac_tpu_torch.met.synthetic import make_wind_met
    from mptrac_tpu_torch.met.write_nc import write_met_nc
    d = tmp_path_factory.mktemp("met")
    for t0, name in ((0.0, "wind_2000_01_01_00.nc"),
                     (21600.0, "wind_2000_01_01_06.nc")):
        write_met_nc(str(d / name), make_wind_met(
            t0=t0, nx=36, ny=19, nz=8, device="cpu"),
            drop_wrap_column=True)
    return d


def _get(url, timeout=30):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.status, r.read().decode(errors="replace")


def test_web_runner_end_to_end(metdir, tmp_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1",
               LOGLEV="0")
    proc = subprocess.Popen(
        [sys.executable, "-m", "mptrac_tpu_torch.web.runner",
         "--port", str(port), "--metbase", str(metdir / "wind"),
         "--dt-met", "21600", "--device", "cpu",
         "--met", f"era5-alias={metdir / 'wind'}:21600",
         "--met", "broken=/nonexistent/met"],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    base = f"http://127.0.0.1:{port}"
    try:
        for _ in range(100):
            try:
                code, body = _get(base + "/")
                break
            except Exception:
                time.sleep(0.2)
        else:
            raise RuntimeError("server did not start")
        # catalog rendered; broken source disabled
        assert "era5-alias" in body and "(PyTorch)" in body
        assert "broken (unavailable)" in body.replace("&gt;", ">")

        data = urllib.parse.urlencode({
            "met": "default", "t0": "0", "hours": "2",
            "lon": "10", "lat": "20", "z": "5", "n": "200",
            "mass": "1e9", "dt_mod": "600", "proj": "robinson",
            "region": "global", "lon_min": "-180", "lon_max": "180",
            "lat_min": "-90", "lat_max": "90", "z_min": "-999",
            "z_max": "-999", "diffusion": "on"}).encode()
        req = urllib.request.Request(base + "/run", data=data)
        with urllib.request.urlopen(req, timeout=30) as r:
            run_url = r.url          # redirected to /status/<id>
        run_id = run_url.rstrip("/").split("/")[-1]

        for _ in range(600):
            code, body = _get(run_url)
            if "running" not in body:
                break
            time.sleep(1.0)
        assert "results.zip" in body, body[:2000]
        assert "setup.zip" in body

        zf = tmp_path / "results.zip"
        with urllib.request.urlopen(
                f"{base}/file/{run_id}/results.zip", timeout=30) as r:
            zf.write_bytes(r.read())
        names = zipfile.ZipFile(zf).namelist()
        assert any(n.endswith(".png") for n in names)
        assert any(n.startswith("atm_") for n in names)
        rows = np.loadtxt(zipfile.ZipFile(zf).open(
            "atm_2000_01_01_02_00_00.tab"))
        assert rows.shape == (200, 5) and np.isfinite(rows).all()

        with urllib.request.urlopen(
                f"{base}/file/{run_id}/setup.zip", timeout=30) as r:
            sz = tmp_path / "setup.zip"
            sz.write_bytes(r.read())
        snames = zipfile.ZipFile(sz).namelist()
        assert "trac.ctl" in snames and "params.json" in snames

        code, logs = _get(base + "/logs")
        assert "started" in logs and "done" in logs
        for stage in ("atm_init", "atm_split", "trac", "plot"):
            assert f"run {run_id} stage {stage} " in logs, stage
    finally:
        proc.kill()
        proc.wait()


@pytest.mark.parametrize("what", ["tool", "met"])
def test_runner_fails_a_run_whose_stage_fails(what, metdir, tmp_path,
                                              monkeypatch):
    """A tool that exits non-zero (atm_init on a height that is no
    number) fails the run with its error, as in the JAX runner; so does
    a met source that is not there."""
    from mptrac_tpu_torch.web import runner
    metbase = (str(metdir / "wind") if what == "tool"
               else "/nonexistent/met/wind")
    monkeypatch.setitem(runner.CONFIG, "repo", ROOT)
    monkeypatch.setitem(runner.CONFIG, "device", "cpu")
    monkeypatch.setitem(runner.CONFIG, "catalog", runner.build_catalog(
        metbase, 21600.0, []))
    monkeypatch.setitem(runner.RUNS, "r1", dict(
        status="running", dir=str(tmp_path), t_created=time.time()))
    runner._run_simulation("r1", {
        "met": "default", "t0": "0", "hours": "1", "z": "high",
        "lon": "0", "lat": "0", "n": "10", "mass": "1"})
    assert runner.RUNS["r1"]["status"] == "error"
    assert (runner.RUNS["r1"]["error"].startswith("atm_init: ")
            if what == "tool" else
            "not accessible" in runner.RUNS["r1"]["error"])


def test_plot_projections(tmp_path):
    """Projection plot modes render (numpy Robinson/orthographic)."""
    from mptrac_tpu_torch.tools import plot
    from mptrac_tpu_torch.tools._cli import run_tool
    tab = tmp_path / "atm_2000_01_01_00_00_00.tab"
    rng = np.random.default_rng(0)
    rows = np.column_stack([
        np.zeros(100), rng.uniform(5, 12, 100),
        rng.uniform(-180, 180, 100), rng.uniform(-85, 85, 100)])
    np.savetxt(tab, rows)
    for proj in ("cartesian", "robinson", "orthographic"):
        out = tmp_path / f"m_{proj}.png"
        rc = run_tool(plot.main, [
            "plot", "atm", str(out), str(tab), "--proj", proj,
            "--mark", "10", "20", "--zrange", "5", "12"])
        assert rc == 0 and out.exists() and out.stat().st_size > 5000
    out = tmp_path / "m_b.png"
    rc = run_tool(plot.main, [
        "plot", "atm", str(out), str(tab), "--bounds", "-30", "30",
        "-40", "40"])
    assert rc == 0 and out.exists()
