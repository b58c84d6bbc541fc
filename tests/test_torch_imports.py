"""The port stands alone: importing every module of mptrac_tpu_torch
pulls in neither jax nor the JAX package, and chip_smoke.py imports
neither."""

import os
import pkgutil
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_RE = re.compile(r"^\s*(import|from)\s+(jax|mptrac_tpu)(\.|\s|$)",
                        re.M)


def _port_modules():
    import mptrac_tpu_torch
    return sorted(m.name for m in pkgutil.walk_packages(
        mptrac_tpu_torch.__path__, "mptrac_tpu_torch."))


def test_port_imports_no_jax():
    mods = _port_modules()
    for name in ("rk_fused", "slab_interp", "fast_interp", "lane_interp",
                 "pallas_interp"):
        assert "mptrac_tpu_torch.ops." + name in mods
    for name in ("sim", "timeutil", "climatology", "io.hdf5", "io.atm_io",
                 "io.output", "met.read_nc", "met.process", "met.cape",
                 "met.build", "met.write_nc", "physics.chem",
                 "utils.timers", "tools._cli", "tools.trac", "perf.probe",
                 "perf.rk_errors", "perf.lane_sigma", "physics.convection",
                 "physics.bound", "physics.mixing", "physics.depo",
                 "io.writers", "io.obs", "io.kernel", "physics.pbl",
                 "physics.sedi", "physics.isosurf", "physics.kpp",
                 "checkpoint", "met.bin_io", "met.lossy", "met.lz4",
                 "met.read_grib", "io.grib1", "io.grib2", "native_loader",
                 "capi", "parallel", "parallel.dd", "parallel.mesh",
                 "parallel.multihost"):
        assert "mptrac_tpu_torch." + name in mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'mptrac_tpu' or "
            "m.startswith('mptrac_tpu.')]\n"
            "print('BAD', bad)\n")
    env = dict(os.environ, PYTHONPATH=ROOT, LOGLEV="0")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


def test_sources_import_no_jax():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "mptrac_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    for f in files:
        with open(f) as fh:
            m = _IMPORT_RE.search(fh.read())
        assert m is None, f"{f}: {m.group(0) if m else ''}"


def test_host_sources_live_in_the_package():
    """The decode-ahead's C++ sources and the C shim are the port's own
    copies inside the package; the shim drives the port's ``capi``.
    Nothing is built from or loaded out of the JAX package's ``native/``
    or ``bindings/``."""
    from mptrac_tpu_torch import capi, native_loader
    pkg = os.path.join(ROOT, "mptrac_tpu_torch")
    for d in (native_loader.HOST_SRC, capi.BINDINGS):
        assert os.path.dirname(os.path.dirname(d)) == pkg or \
            os.path.dirname(d) == pkg, d
    for name in native_loader.SOURCES:
        assert os.path.isfile(os.path.join(native_loader.HOST_SRC, name))
    with open(os.path.join(capi.BINDINGS, "mptrac_c.c")) as f:
        shim = f.read()
    assert '"mptrac_tpu_torch.capi"' in shim
    assert '"mptrac_tpu.capi"' not in shim
    build = os.path.join(ROOT, "build", "mptrac_tpu_torch")
    assert os.path.dirname(os.path.dirname(
        native_loader.library_path())) == build
    assert os.path.dirname(capi.shim_dir()) == build
