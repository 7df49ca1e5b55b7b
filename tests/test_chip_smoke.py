"""chip_smoke.py / bench.py helpers and their refusal to run without a GPU
(the card-side phases themselves run only on the card)."""

import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from raytpu.utils.device import parse_nvidia_smi, require_gpu  # noqa: E402


def _run(args, cwd, timeout=240):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable] + args, cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_result_line_format():
    line = chip_smoke.result_line("gpu", "NVIDIA H100 80GB HBM3", 1)
    assert line == ('{"ok": true, "device": {"platform": "gpu", '
                    '"kind": "NVIDIA H100 80GB HBM3", "count": 1}}')
    assert json.loads(line)["device"]["count"] == 1


@pytest.mark.parametrize("text, cards", [
    ("NVIDIA H100 80GB HBM3, 700.00 W\n",
     [("NVIDIA H100 80GB HBM3", "700.00 W")]),
    ("NVIDIA H100 80GB HBM3, 500.00 W\nNVIDIA H100 80GB HBM3, 700.00 W\n",
     [("NVIDIA H100 80GB HBM3", "500.00 W"),
      ("NVIDIA H100 80GB HBM3", "700.00 W")]),
    ("  NVIDIA H100 PCIe, [N/A]  \n\n", [("NVIDIA H100 PCIe", "[N/A]")]),
])
def test_parse_nvidia_smi(text, cards):
    assert parse_nvidia_smi(text) == cards


@pytest.mark.parametrize("text", ["", "no comma here\n", ", 700 W\n"])
def test_parse_nvidia_smi_rejects_malformed(text):
    with pytest.raises(ValueError):
        parse_nvidia_smi(text)


def test_require_gpu_refuses_cpu():
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(RuntimeError, match="no GPU found"):
        require_gpu()


def test_chip_smoke_refuses_cpu():
    r = _run(["chip_smoke.py"], ROOT)
    assert r.returncode != 0
    assert "no GPU found" in r.stderr
    assert '"ok"' not in r.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """In a directory with chip_smoke.py and nothing else of the repo."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    r = _run(["chip_smoke.py"], str(tmp_path))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_bench_refuses_cpu():
    r = _run(["bench.py", "--size", "16"], ROOT)
    assert r.returncode != 0
    assert "no GPU found" in r.stderr
    assert r.stdout.strip() == ""


def test_u8_stats_counts_differing_pixels():
    a = np.zeros((4, 5, 3), np.float32)
    b = a.copy()
    b[0, 0, 1] = 1.0          # one pixel off by 255 steps
    b[1, 2, 0] = 1.0 / 255.0  # one pixel off by one step
    st = chip_smoke.u8_stats(a, b)
    assert st["pixels"] == 20 and st["over1"] == 1
    assert st["max_diff"] == 255
    assert st["equal"] == pytest.approx(18 / 20)
    assert st["within1"] == pytest.approx(19 / 20)


def test_tree_rel_err_is_leaf_relative():
    ref = {"a": np.array([1.0, -2.0]), "b": np.array([100.0])}
    got = {"a": np.array([1.0, -2.002]), "b": np.array([100.5])}
    err, where = chip_smoke.tree_rel_err(got, ref)
    assert err == pytest.approx(0.005) and where == "['b']"
    with pytest.raises(chip_smoke.PhaseError):
        chip_smoke.tree_rel_err({"a": np.array([np.nan])},
                                {"a": np.array([1.0])})


def test_cli_platform_choices():
    """--platform takes the two backends the program runs on."""
    from raytpu.cli.main import main

    with pytest.raises(SystemExit):
        main(["--platform", "rocm", "starfield"])
