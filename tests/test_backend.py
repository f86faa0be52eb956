"""core/backend.py's per-platform choices, the compile-cache directory
rule, and the float32 precision the CellNet forward asks for."""

import os
import subprocess
import sys

import pytest

from bbtools_tpu.core import backend

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize(
    "platform,field,want",
    [("cpu", "device_kmer62", False), ("cpu", "device_merge", False),
     ("cpu", "msa_kernel", False), ("gpu", "device_kmer62", True),
     ("gpu", "device_merge", True), ("gpu", "msa_kernel", True)],
)
def test_choices_per_platform(platform, field, want):
    assert getattr(backend.choices(platform), field) is want


@pytest.mark.parametrize("name", ["xpu", "rocm", "METAL", ""])
def test_unknown_platform_raises(name):
    with pytest.raises(RuntimeError, match="unsupported JAX platform"):
        backend.choices(name)


def test_running_platform_is_cpu_here():
    assert backend.platform() == "cpu"
    assert backend.choices() == backend.CHOICES["cpu"]


def test_override_restores():
    before = backend.choices()
    with backend.override(device_kmer62=True, msa_kernel=True) as c:
        assert c.device_kmer62 and c.msa_kernel
        assert backend.choices() == c
    assert backend.choices() == before
    with pytest.raises(ValueError):
        with backend.override(device_merge=True):
            raise ValueError("propagates")
    assert backend.choices() == before


@pytest.mark.parametrize("name", ["sort_join", "mm_match",
                                  "device_spectrum"])
def test_removed_choices_are_gone(name):
    """The choices that lost on the GPU were removed with the code they
    selected: overriding one is an error, not a silent no-op."""
    assert not hasattr(backend.choices("gpu"), name)
    with pytest.raises(TypeError):
        with backend.override(**{name: True}):
            pass
    assert backend.choices() == backend.CHOICES["cpu"]


@pytest.mark.parametrize(
    "env,want",
    [({"JAX_COMPILATION_CACHE_DIR": "/elsewhere/cache"}, "/elsewhere/cache"),
     ({}, os.path.join(ROOT, ".jax_cache")),
     ({"JAX_COMPILATION_CACHE_DIR": ""}, os.path.join(ROOT, ".jax_cache"))],
)
def test_compile_cache_dir_rule(env, want):
    from bbtools_tpu import compile_cache_dir

    assert compile_cache_dir(env) == want


@pytest.mark.parametrize("set_env", [True, False])
def test_compile_cache_lands_there(tmp_path, set_env):
    """A fresh process caches its compiled programs in
    JAX_COMPILATION_CACHE_DIR when set, else in <checkout>/.jax_cache,
    and configures no other directory."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if set_env:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "cache")
    code = (
        "import sys; sys.path.insert(0, sys.argv[1]); import bbtools_tpu, jax;"
        " import jax.numpy as jnp;"
        " jax.config.update('jax_persistent_cache_min_compile_time_secs', 0);"
        " jax.jit(lambda x: jnp.sort(x * 3 + 1))(jnp.arange(4096.0)"
        ").block_until_ready();"
        " print(jax.config.jax_compilation_cache_dir)"
    )
    res = subprocess.run([sys.executable, "-c", code, ROOT], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    where = res.stdout.strip().splitlines()[-1]
    want = str(tmp_path / "cache") if set_env else os.path.join(ROOT, ".jax_cache")
    assert where == want
    if set_env:
        assert os.listdir(want)


def test_cellnet_forward_asks_for_full_float32():
    """Every layer's matmul carries precision=HIGHEST, so a GPU cannot
    run it in TF32."""
    import jax
    import numpy as np

    from bbtools_tpu.ml import CellNet

    net = CellNet(
        dims=[3, 2, 1],
        weights=[np.ones((2, 3), np.float32), np.ones((1, 2), np.float32)],
        biases=[np.zeros(2, np.float32), np.zeros(1, np.float32)],
        types=[np.zeros(2, np.int32), np.zeros(1, np.int32)],
    )
    jaxpr = jax.make_jaxpr(net.forward)(np.ones((4, 3), np.float32))
    dots = [e for e in jaxpr.eqns if e.primitive.name == "dot_general"]
    assert len(dots) == 2
    highest = (jax.lax.Precision.HIGHEST,) * 2
    assert all(e.params["precision"] == highest for e in dots)
