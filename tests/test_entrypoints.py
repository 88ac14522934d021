"""Entry-point rules: the compile-cache path, and the GPU-only scripts
refusing any other backend."""

import os
import shutil
import subprocess
import sys
import tempfile

import jax
import pytest

from multimodalmusig_tpu.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = "JAX_COMPILATION_CACHE_DIR"


def test_cache_dir_env_set(monkeypatch, tmp_path):
    """With the variable set, that directory is used and nothing is set."""
    monkeypatch.setenv(ENV, str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.cache_dir() == str(tmp_path)
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_cache_dir_env_unset(monkeypatch):
    """Unset: a fixed, git-ignored directory inside the checkout."""
    monkeypatch.delenv(ENV, raising=False)
    path = compile_cache.cache_dir()
    assert path == os.path.join(REPO, ".jax_cache")
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
    before = jax.config.jax_compilation_cache_dir
    try:
        assert compile_cache.enable_compile_cache() == path
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_cache_dir_never_tmp(monkeypatch):
    """Never the temporary directory, a pid or a time: the same path every
    call, so a cache written by one run is found by the next."""
    monkeypatch.delenv(ENV, raising=False)
    paths = {compile_cache.cache_dir() for _ in range(3)}
    assert len(paths) == 1
    path = paths.pop()
    for tmp in {"/tmp", tempfile.gettempdir()}:
        assert not path.startswith(tmp)
    assert str(os.getpid()) not in path


def _run(script, cwd, env_extra=None):
    env = dict(os.environ, JAX_PLATFORMS="cpu", **(env_extra or {}))
    return subprocess.run(
        [sys.executable, script], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=300,
    )


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py", "tools/lambda_sweep.py"])
def test_gpu_scripts_refuse_cpu(script):
    out = _run(os.path.join(REPO, script), REPO)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert '"metric"' not in out.stdout
    assert "needs a GPU" in out.stderr


def test_chip_smoke_alone_fails(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = _run(str(tmp_path / "chip_smoke.py"), str(tmp_path), {"PYTHONPATH": ""})
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_tf32_control_rewrites_every_dot():
    """chip_smoke's negative control sets the precision of every dot_general,
    inside loops too, and leaves the program otherwise the same."""
    import importlib.util

    import jax.numpy as jnp
    import numpy as np

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    hi = jax.lax.Precision.HIGHEST

    def f(x):
        y = jnp.matmul(x, x, precision=hi)
        return jax.lax.fori_loop(0, 2, lambda i, z: jnp.matmul(z, x, precision=hi), y)

    x = jnp.eye(3) * 0.5 + 0.1
    closed = jax.make_jaxpr(f)(x)
    want = (jax.lax.Precision.DEFAULT, jax.lax.Precision.DEFAULT)
    loose = smoke.with_dot_precision(closed.jaxpr, want)

    def dots(jaxpr):
        for e in jaxpr.eqns:
            if e.primitive.name == "dot_general":
                yield e.params["precision"]
            for v in e.params.values():
                for item in v if isinstance(v, tuple) else (v,):
                    if hasattr(item, "jaxpr"):
                        yield from dots(item.jaxpr)

    assert list(dots(closed.jaxpr)) == [(hi, hi)] * 2
    assert list(dots(loose)) == [want] * 2
    got = jax.core.eval_jaxpr(loose, closed.consts, x)[0]
    np.testing.assert_allclose(np.asarray(got), np.asarray(f(x)), rtol=1e-6)
