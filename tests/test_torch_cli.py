"""The port's CLI and its utilities on the CPU against the JAX package's:
metrics, grayscale loading and PGM conversion, the CLI's engines against
the golden streams and recons, its printed block, and the evaluation
harness's rows.
"""
import contextlib
import io
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from hevce_tpu import cli as jcli
from hevce_tpu.utils import evaluate as jevaluate
from hevce_tpu.utils import imageio as jimageio
from hevce_tpu.utils import metrics as jmetrics
from hevce_tpu_torch import cli
from hevce_tpu_torch.runtime import native
from hevce_tpu_torch.utils import evaluate, imageio, metrics

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent


def test_metrics_equal_jax(golden):
    g = golden("images")
    rng = np.random.default_rng(4)
    pairs = [(g["img_2"], g["rcon_2"]), (g["img_2"], g["img_2"]),
             (g["img_15"], g["rcon_15"]),          # 50x70 against 64x96
             (rng.integers(0, 256, (40, 9)).astype(np.uint8),
              rng.integers(0, 256, (41, 9)).astype(np.uint8))]
    for a, b in pairs:
        assert metrics.mse_psnr(a, b) == jmetrics.mse_psnr(a, b)
        assert metrics.ssim(a, b) == jmetrics.ssim(a, b)
    assert metrics.mse_psnr(g["img_2"], g["img_2"]) == (0.0, 99.0)


def test_to_grayscale_and_convert_to_pgm_equal_jax(tmp_path, golden):
    rng = np.random.default_rng(5)
    rgb = rng.integers(0, 256, (37, 53, 3)).astype(np.uint8)
    png = tmp_path / "in.png"
    Image.fromarray(rgb).save(png)
    pgm = tmp_path / "in.pgm"
    imageio.write_pgm(pgm, golden("images")["img_15"])
    for src in (png, pgm):
        got = imageio.to_grayscale(src)
        np.testing.assert_array_equal(got, jimageio.to_grayscale(src))
        assert got.dtype == np.uint8 and got.ndim == 2
        a, b = tmp_path / "port.pgm", tmp_path / "jax.pgm"
        imageio.convert_to_pgm(src, a)
        jimageio.convert_to_pgm(src, b)
        assert a.read_bytes() == b.read_bytes()


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


def _labels(text):
    return [ln.split(":")[0].split("=")[0].strip()
            for ln in text.splitlines() if ln.strip()]


@pytest.mark.parametrize("engine", ["native", "python"])
def test_cli_engines_write_the_golden_stream(engine, tmp_path, golden):
    g = golden("images")
    src = tmp_path / "img.pgm"
    imageio.write_pgm(src, g["img_2"])
    out, rcon = tmp_path / "out.h265", tmp_path / "rcon.pgm"
    rc, text = _run(cli.main, [str(src), str(out), "2", str(rcon),
                               f"--engine={engine}", "--device=cpu"])
    assert rc == 0, text
    assert out.read_bytes() == bytes(g["stream_2"])
    np.testing.assert_array_equal(imageio.read_pgm(rcon), g["rcon_2"])
    # the JAX CLI's block: every label, in order, and the same numbers
    jrc, jtext = _run(jcli.main, [str(src), str(tmp_path / "j.h265"), "2"])
    assert jrc == 0
    want = _labels(jtext)
    got = [lb for lb in _labels(text) if lb != "device"]
    assert got == want
    for key in ("stream length", "compression ratio", "bits per pixel",
                "mean square error (MSE)", "peak signal/noise ratio (PSNR)"):
        line = [ln for ln in text.splitlines() if key in ln]
        jline = [ln for ln in jtext.splitlines() if key in ln]
        assert line == jline


def test_cli_fast_on_cpu_writes_a_stream_that_decodes(tmp_path, golden):
    src = tmp_path / "img.pgm"
    imageio.write_pgm(src, golden("images")["img_15"])
    out, rcon = tmp_path / "out.h265", tmp_path / "rcon.pgm"
    rc, text = _run(cli.main, ["--fast", str(src), str(out), str(rcon),
                               "--device=cpu", "4"])
    assert rc == 0, text
    assert "engine          : fast" in text and "qpd6            : 4" in text
    np.testing.assert_array_equal(native.decode_stream(out.read_bytes()),
                                  imageio.read_pgm(rcon))


def test_cli_without_cuda_exits_nonzero_unless_cpu(tmp_path, golden,
                                                   monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    src = tmp_path / "img.pgm"
    imageio.write_pgm(src, golden("images")["img_2"])
    for engine in ("--engine=python", "--fast"):
        rc, text = _run(cli.main, [str(src), str(tmp_path / "o.h265"),
                                   engine])
        assert rc != 0 and "CUDA is not available" in text
        assert not (tmp_path / "o.h265").exists()
    rc, text = _run(cli.main, [str(src), str(tmp_path / "o.h265")])
    assert rc == 0                 # the native engine runs on the host
    rc, text = _run(cli.main, [])
    assert rc == 1 and "python -m hevce_tpu_torch" in text
    rc, text = _run(cli.main, [str(tmp_path / "missing.pgm"), "x.h265",
                               "--device=cpu", "--engine=python"])
    assert rc == 1 and "cannot read input image" in text


def test_python_dash_m_runs_the_cli(tmp_path, golden):
    g = golden("images")
    src = tmp_path / "img.pgm"
    imageio.write_pgm(src, g["img_4"])
    out = tmp_path / "out.h265"
    res = subprocess.run([sys.executable, "-m", "hevce_tpu_torch", str(src),
                          str(out), "4"], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert out.read_bytes() == bytes(g["stream_4"])
    assert "peak signal/noise ratio (PSNR)" in res.stdout


def test_evaluate_equals_jax(tmp_path, golden):
    imageio.write_pgm(tmp_path / "a.pgm", golden("images")["img_2"])
    (tmp_path / "notes.txt").write_text("not an image")
    rows, summary = evaluate.evaluate(tmp_path, 2, verbose=False)
    jrows, jsummary = jevaluate.evaluate(tmp_path, 2, verbose=False)
    assert rows == jrows and summary == jsummary
    assert [r["file"] for r in rows] == ["a.pgm"]
    assert set(summary) == {"JPEG", "JPEG2000", "WEBP"}
