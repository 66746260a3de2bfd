"""chip_smoke.py's host side: what it reads from ``nvidia-smi``, the form
of its last line, and that it refuses to run anywhere but on a GPU (the
phases themselves need the card)."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402


@pytest.mark.parametrize(
    "text, rows",
    [
        ("NVIDIA H100 80GB HBM3, 700.00 W\n",
         [("NVIDIA H100 80GB HBM3", "700.00 W")]),
        ("NVIDIA H100 80GB HBM3, 500.00 W\n" * 4,
         [("NVIDIA H100 80GB HBM3", "500.00 W")] * 4),
        ("Card, with comma, 350.00 W", [("Card, with comma", "350.00 W")]),
    ],
)
def test_parse_nvidia_smi(text, rows):
    assert chip_smoke.parse_nvidia_smi(text) == rows


@pytest.mark.parametrize("text", ["", "\n", "no comma here", ", 700 W"])
def test_parse_nvidia_smi_rejects(text):
    with pytest.raises(ValueError):
        chip_smoke.parse_nvidia_smi(text)


def test_result_line():
    line = chip_smoke.result_line("gpu", "NVIDIA H100 80GB HBM3", 1)
    assert json.loads(line) == {
        "ok": True,
        "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                   "count": 1},
    }
    assert "\n" not in line


@pytest.mark.parametrize("platform", ["cpu", "METAL", None])
def test_require_gpu_refuses_other_platforms(platform):
    devices = [] if platform is None else [SimpleNamespace(platform=platform)]
    with pytest.raises(SystemExit) as e:
        chip_smoke.require_gpu(devices)
    assert e.value.code not in (0, None)


def test_require_gpu_accepts_gpu():
    assert chip_smoke.require_gpu([SimpleNamespace(platform="gpu")]) is None


def _run(args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, *args], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=300,
    )


def test_exits_nonzero_on_cpu_without_result():
    r = _run(["chip_smoke.py"], REPO)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "needs an NVIDIA GPU" in r.stderr


def test_script_alone_cannot_import_the_solver(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _run(["-c", "import chip_smoke; chip_smoke.import_repo()"], tmp_path)
    assert r.returncode != 0
    assert "dpilqr_tpu" in r.stderr
