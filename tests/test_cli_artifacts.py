"""CLI pipeline, artifact schemas, flag parity, Euler cross-check."""
import os

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest

PHOTON_COLUMNS = ["i", "j", "final_r", "final_th", "final_ph", "collision",
                  "h_r", "h_theta", "h_phi", "p0_t", "p0_r", "p0_th",
                  "p0_ph", "alpha0"]
SAMPLED_COLUMNS = ["ray_id", "point_idx", "x", "y", "z", "r", "h_r",
                   "h_theta", "h_phi"]


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("cli")
    bg_dir = out / "bg"
    bg_dir.mkdir()
    from PIL import Image
    tex = np.random.default_rng(0).integers(0, 255, (32, 32, 3),
                                            dtype=np.uint8)
    Image.fromarray(tex).save(bg_dir / "sky.png")

    from grtrace.cli.main import main
    res = main(["--size", "24", "--steps", "3000", "--delta", "0.1",
                "--background", str(bg_dir / "sky.png"),
                "--out-dir", str(out), "--n-samples", "4",
                "--dtype", "float64", "--backend", "xla"])
    return out, res


def test_cli_artifacts_exist(cli_run):
    out, _ = cli_run
    for f in ["photon_data.csv", "sampled_rays.csv",
              "images/manual_output.png", "images/no_gravity.png",
              "images/scene_full.png", "images/scene_topdown.png",
              "images/scene_closeup_3d.png",
              "images/scene_topdown_3d_azim0.png",
              "images/scene_topdown_3d_azim315.png"]:
        assert os.path.exists(out / f), f


def test_photon_data_schema(cli_run):
    out, res = cli_run
    df = pd.read_csv(out / "photon_data.csv")
    assert df.columns.tolist() == PHOTON_COLUMNS
    assert len(df) == 24 * 24
    assert set(df["collision"]).issubset(
        {"bh", "numerical error", "escape_bg", "escape_no_patch",
         "in_domain"})
    # counts in CSV match the device summary
    assert (df["collision"] == "bh").sum() == res.counts["captured"]
    assert (df["collision"] == "escape_bg").sum() == res.counts["background"]
    # i/j enumerate the image grid row-major
    assert df["i"].iloc[0] == 0 and df["j"].iloc[1] == 1


def test_sampled_rays_schema(cli_run):
    out, _ = cli_run
    df = pd.read_csv(out / "sampled_rays.csv")
    assert df.columns.tolist() == SAMPLED_COLUMNS
    assert df["ray_id"].nunique() == 4
    # r column is the norm of (x, y, z)
    np.testing.assert_allclose(
        df["r"], np.linalg.norm(df[["x", "y", "z"]].values, axis=1),
        atol=1e-8)


def test_flag_parity_defaults():
    """Every reference flag name must parse, with the reference default."""
    from grtrace.cli.args import parse_args
    a = parse_args([])
    assert a.size == 200 and a.fov == 80.0 and a.steps == 200000
    assert a.delta == 0.01 and a.omega == 0.01 and a.order == 2
    assert a.bh_mass == 1.0 and a.boundary_radius == 31
    assert a.observer_distance == 30
    assert a.bg_patch_center_theta == 90 and a.bg_patch_center_phi == 180
    assert a.bg_patch_size_theta == 180 and a.bg_patch_size_phi == 360
    assert not a.bg_flip_theta and not a.bg_flip_phi
    assert a.cuda is True  # compatibility no-op
    # reference quirk preserved: omega NOT forwarded unless --fix-omega
    from grtrace.cli.args import scene_from_args
    assert scene_from_args(a).integrator.omega == 1.0
    a2 = parse_args(["--fix-omega", "--omega", "0.5"])
    assert scene_from_args(a2).integrator.omega == 0.5


def test_single_ray_cli(tmp_path):
    from grtrace.cli.single_ray import main
    csv = tmp_path / "ray.csv"
    png = tmp_path / "ray.png"
    traj = main(["--steps", "5000", "--delta", "0.05",
                 "--out-csv", str(csv), "--out-png", str(png),
                 "--plot-step", "50"])
    assert csv.exists() and png.exists()
    df = pd.read_csv(csv)
    assert df.columns.tolist() == ["t", "r", "theta", "phi"]
    # angles exported in degrees (single_ray_cuda_test.py:320)
    assert df["theta"].iloc[0] == pytest.approx(90.0)


def test_band_sweep_cli(tmp_path):
    from grtrace.cli.band_sweep import main
    res = main(["--size", "16", "--steps", "1200", "--delta", "0.1",
                "--n-rays", "6", "--out-dir", str(tmp_path),
                "--backend", "xla"])
    assert (tmp_path / "theta_band_image.png").exists()
    assert (tmp_path / "theta_band_trajectories.png").exists()


def test_euler_vs_fantasy_short_arc():
    """Independent integrator designs agree to O(delta) on a short arc."""
    from grtrace.engine.euler import euler_integrate_batch, raise_index
    from grtrace.engine.integrate import integrate_batch
    from grtrace.physics.camera import camera_rays
    q0, p0, *_ = camera_rays(np.array([30.0, 0.0, 0.0]), np.radians(40.0),
                             3, 3, dtype=jnp.float64)
    q0 = jnp.asarray(q0).reshape(-1, 4)
    p0 = jnp.asarray(p0).reshape(-1, 4)
    steps, delta = 400, 0.01
    # the Euler kernel advances contravariant momenta; pipeline momenta are
    # FANTASY-convention (see euler.raise_index docstring)
    qe, pe = euler_integrate_batch(q0, raise_index(q0, p0, 2.0), steps,
                                   delta, 2.0)
    qf, pf, _, _ = integrate_batch(q0, p0, steps, delta, 2.0, 1e9, 1.0)
    np.testing.assert_allclose(np.asarray(qe)[:, 1:], np.asarray(qf)[:, 1:],
                               atol=2e-2)


def test_load_background_resize(tmp_path):
    from grtrace.io.artifacts import load_background
    from PIL import Image
    tex = np.zeros((64, 128, 3), np.uint8)
    Image.fromarray(tex).save(tmp_path / "t.png")
    full = load_background(str(tmp_path / "t.png"))
    assert full.shape == (64, 128, 3)
    small = load_background(str(tmp_path / "t.png"), size=(20, 10))
    assert small.shape == (10, 20, 3)  # PIL size is (w, h)


def test_main_path_imports_only_core_packages(tmp_path):
    """The main path (`cli.main --no-plots`, procedural background, CSV and
    PNG artifacts) needs nothing beyond JAX, numpy and scipy: Pillow,
    pandas and matplotlib are optional (image-file backgrounds, GIFs,
    plots) and must not be imported.  Runs in a fresh interpreter so the
    suite's own imports do not count."""
    import subprocess
    import sys
    code = (
        "import sys, jax\n"
        "jax.config.update('jax_platforms', 'cpu')\n"
        "from grtrace.cli.main import main\n"
        "main(['--size', '8', '--steps', '300', '--delta', '0.1',\n"
        "      '--background', 'procedural:starfield', '--n-samples', '2',\n"
        f"      '--out-dir', {str(tmp_path)!r}, '--no-plots'])\n"
        "top = {m.split('.')[0] for m in sys.modules}\n"
        "bad = top & {'PIL', 'pandas', 'matplotlib'}\n"
        "assert not bad, bad\n"
        "print('OK')\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300,
                       cwd=os.path.dirname(os.path.dirname(__file__)))
    assert r.returncode == 0, r.stderr[-2000:]
    assert "OK" in r.stdout
    for name in ("images/manual_output.png", "photon_data.csv",
                 "sampled_rays.csv"):
        assert (tmp_path / name).stat().st_size > 0
