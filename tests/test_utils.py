import os

import numpy as np

from mcmc_colorer_tpu.models.base import Coloring
from mcmc_colorer_tpu.models.greedy_ff import GreedyFFColorer
from mcmc_colorer_tpu.utils import term
from mcmc_colorer_tpu.utils.memtrack import (
    device_memory_stats,
    estimate_run_bytes,
)
from mcmc_colorer_tpu.utils.timer import Timer


def test_timer():
    with Timer() as t:
        sum(range(10000))
    assert t.duration_ms >= 0


def test_logger_conf_roundtrip(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    path = term.check_logger_conf()
    assert os.path.exists(path)
    assert not term.trace_enabled(path)
    conf = open(path).read().replace(
        "* TRACE:\n   ENABLED              =  false",
        "* TRACE:\n   ENABLED              =  true",
    )
    open(path, "w").write(conf)
    assert term.trace_enabled(path)
    monkeypatch.setenv("MCMC_COLORER_TRACE", "1")
    assert term.trace_enabled("nonexistent.conf")


def test_memtrack():
    est = estimate_run_bytes(1000, 50, 50)
    assert est["total_bytes"] > 0
    assert est["reference_colors_checker_bytes"] == 1000 * 50
    stats = device_memory_stats()
    assert isinstance(stats, dict)


def test_class_degree_stats_and_ascii(medium_er):
    r = GreedyFFColorer(medium_er).run()
    mean, std = r.class_degree_stats(medium_er)
    assert mean.shape == (r.n_colors,)
    # overall degree mean is a weighted average of class means
    total = float(
        (mean * r.histogram).sum() / max(r.histogram.sum(), 1)
    )
    assert abs(total - medium_er.mean_degree) < 1e-6
    art = r.ascii_histogram()
    assert art.count("\n") == r.n_colors
    assert "Every * is" in art


def test_analysis_plots(tmp_path):
    from mcmc_colorer_tpu.analysis.log_parser import (
        plot_balance_index,
        plot_speedup,
        plot_var_col_3d,
        var_col_surface,
    )

    fake = {
        "MCMC_GPU": [
            {
                "nodes": 100,
                "prob": 0.1,
                "color_ratio": r,
                "histogram": [20, 30, 25, 25],
                "execution_time_s": 0.1 / r,
            }
            for r in (1.0, 2.0, 4.0)
        ],
        "MCMC_CPU": [
            {
                "nodes": 100,
                "prob": 0.1,
                "histogram": [25, 25, 25, 25],
                "execution_time_s": 1.0,
            }
        ],
    }
    surf = var_col_surface(fake)
    assert (2.0, 0.1) in surf
    # plots return bool (False only when matplotlib missing)
    for fn, name in [
        (lambda: plot_balance_index(fake, str(tmp_path / "b.png"), 0.1), "b"),
        (lambda: plot_speedup(fake, str(tmp_path / "s.png")), "s"),
        (lambda: plot_var_col_3d(fake, str(tmp_path / "v.png")), "v"),
    ]:
        ok = fn()
        assert ok in (True, False)
        if ok:
            assert (tmp_path / f"{name}.png").exists()


def test_compcache_enable(monkeypatch):
    """Without JAX_COMPILATION_CACHE_DIR the cache goes to one fixed
    path inside the checkout."""
    import os

    import jax

    from mcmc_colorer_tpu.utils import compcache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    old = jax.config.jax_compilation_cache_dir
    try:
        got = compcache.enable()
        assert got == compcache.DEFAULT_DIR
        assert jax.config.jax_compilation_cache_dir == got
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert got == os.path.join(repo, ".jax_cache")
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


def test_compcache_boolean_env(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, the cache is JAX's own at that
    path: enable() reports it and sets no directory of its own."""
    import jax

    from mcmc_colorer_tpu.utils import compcache

    env_dir = str(tmp_path / "xc")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env_dir)
    old = jax.config.jax_compilation_cache_dir
    assert compcache.enable() == env_dir
    assert jax.config.jax_compilation_cache_dir == old
