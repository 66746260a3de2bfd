"""Where the persistent compilation cache lives (dpilqr_tpu/config.py)."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

from dpilqr_tpu import config

REPO = Path(__file__).resolve().parent.parent

_PROBE = (
    "import jax, dpilqr_tpu; "
    "print(jax.config.jax_compilation_cache_dir)"
)


def _probe(env_dir):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_dir
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120, check=True,
    )
    return out.stdout.strip().splitlines()[-1]


@pytest.mark.parametrize(
    "environ, expected",
    [
        ({"JAX_COMPILATION_CACHE_DIR": "/somewhere/cache"}, "/somewhere/cache"),
        ({}, str(REPO / ".jax_cache")),
        ({"JAX_COMPILATION_CACHE_DIR": ""}, str(REPO / ".jax_cache")),
    ],
)
def test_compilation_cache_dir(environ, expected):
    assert config.compilation_cache_dir(environ) == expected


def test_env_variable_is_used_as_is(tmp_path):
    """JAX_COMPILATION_CACHE_DIR set: the package configures nothing, and
    JAX uses the variable's directory."""
    assert _probe(str(tmp_path / "c")) == str(tmp_path / "c")


def test_default_is_inside_the_checkout():
    """Unset: a fixed directory inside the checkout, which .gitignore
    lists (a fixed path is what lets a later process find the cache)."""
    assert _probe(None) == str(REPO / ".jax_cache")
    ignored = (REPO / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored
