"""Entry-point plumbing: the compile-cache helper and the GPU-only
scripts' refusal to run anywhere else."""

import os

import jax
import pytest

from online_convex_optimization.utils import compile_cache


@pytest.fixture
def _restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_honours_env(monkeypatch, tmp_path, _restore_cache_dir):
    """With JAX_COMPILATION_CACHE_DIR set, the helper uses it and sets
    nothing in code."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_repo_dir(monkeypatch, _restore_cache_dir):
    """Without the variable, the cache is the fixed <repo>/.jax_cache."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    want = os.path.join(repo, ".jax_cache")
    assert compile_cache.enable() == want
    assert jax.config.jax_compilation_cache_dir == want


def test_chip_smoke_refuses_cpu(capsys):
    """chip_smoke's device check refuses the CPU: non-zero exit and no
    result line, with no fallback."""
    import chip_smoke

    with pytest.raises(SystemExit) as exc:
        chip_smoke.require_gpu()
    assert "needs 1 GPU" in str(exc.value.code)
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main([])
    assert exc.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out
    with pytest.raises(SystemExit):
        chip_smoke.main(["--four-cards"])


def test_bench_refuses_cpu():
    import bench

    with pytest.raises(SystemExit, match="needs a GPU"):
        bench.main()
