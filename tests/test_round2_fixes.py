"""Round-2 hardening: rewritten plotting/logger utilities, compile-cache
platform detection, `save_in_wandb_dir` wiring, plot-free eval mode."""
import sys
import types
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent

from ecnf_jax.targets.data import FullGraphSample
from ecnf_jax.training.config import load_config
from ecnf_jax.training.loggers import ListLogger
from ecnf_jax.utils.plotting import (
    bin_samples_by_dist,
    get_counts,
    plot_history,
)


class TestGetCounts:
    def test_matches_naive_interval_semantics(self):
        """searchsorted/bincount formulation == per-bin [lower, upper) sums
        (the reference's histogram semantics, `plotting.py:50-63`)."""
        rng = np.random.default_rng(0)
        d = jnp.asarray(rng.uniform(-1.0, 9.0, size=500))
        bins = jnp.asarray(np.sort(rng.uniform(0.0, 8.0, size=13)))
        got = get_counts(d, bins, normalize=False)
        want = np.array(
            [np.sum((np.asarray(d) >= lo) & (np.asarray(d) < hi))
             for lo, hi in zip(bins[:-1], bins[1:])]
        )
        np.testing.assert_array_equal(np.asarray(got), want)

    def test_edge_values(self):
        # A value exactly on an interior edge belongs to the bin it opens;
        # values at/above the last edge or below the first are excluded.
        bins = jnp.array([0.0, 1.0, 2.0])
        d = jnp.array([0.0, 1.0, 2.0, -0.5, 1.5])
        got = np.asarray(get_counts(d, bins, normalize=False))
        np.testing.assert_array_equal(got, [1, 2])  # {0.0} ; {1.0, 1.5}

    def test_normalization_uses_total_count(self):
        bins = jnp.array([0.0, 1.0])
        d = jnp.array([0.5, 5.0, 5.0, 5.0])  # 3 of 4 out of range
        assert float(get_counts(d, bins, normalize=True)[0]) == pytest.approx(0.25)


class TestBinSamplesByDist:
    def test_nonfinite_excluded_from_bins(self):
        x = np.random.default_rng(1).normal(size=(8, 4, 3)).astype(np.float32)
        x_bad = x.copy()
        x_bad[0, 0, 0] = np.nan
        bins, (counts,) = bin_samples_by_dist([jnp.asarray(x_bad)])
        assert np.isfinite(np.asarray(bins)).all()
        # NaN-contaminated pairs vanish from every bin but stay in the
        # denominator, so the total mass drops below 1.
        total = float(np.asarray(counts).sum())
        assert 0.0 < total < 1.0

    def test_shared_bins_cover_both_arrays(self):
        a = jnp.asarray(np.random.default_rng(2).normal(size=(4, 3, 2)))
        b = jnp.asarray(5.0 * np.random.default_rng(3).normal(size=(4, 3, 2)))
        bins, counts = bin_samples_by_dist([a, b])
        assert len(counts) == 2
        # Wider array sets the top edge; both mass totals are ~1.
        for c in counts:
            assert float(np.asarray(c).sum()) == pytest.approx(1.0, abs=1e-6)


class TestPlotHistory:
    def test_handles_nan_and_non_scalar(self):
        import matplotlib

        matplotlib.use("Agg")
        hist = {
            "loss": [1.0, np.nan, 3.0],
            "weird": [np.zeros(3), 1.0],  # non-scalar entry
        }
        fig = plot_history(hist)
        assert fig is not None
        import matplotlib.pyplot as plt

        plt.close(fig)

    def test_empty_history(self):
        assert plot_history({}) is None


class TestListLogger:
    def test_non_scalar_warns_once_and_stores(self):
        lg = ListLogger()
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            lg.write({"vec": np.arange(3), "loss": 1.0})
            lg.write({"vec": np.arange(3)})
        assert len([x for x in w if "not a scalar" in str(x.message)]) == 1
        assert len(lg.history["vec"]) == 2
        assert lg.history["loss"] == [1.0]

    def test_snapshot_roundtrip(self, tmp_path):
        import pickle

        p = tmp_path / "hist.pkl"
        lg = ListLogger(save=True, save_path=str(p), save_period=2)
        for i in range(5):
            lg.write({"loss": float(i)})
        lg.close()
        with open(p, "rb") as f:
            assert pickle.load(f)["loss"] == [0.0, 1.0, 2.0, 3.0, 4.0]


class TestCompileCacheLocation:
    def _reset(self, prev):
        jax.config.update("jax_compilation_cache_dir", prev)

    def test_env_var_set(self, tmp_path, monkeypatch):
        from ecnf_jax.utils.compile_cache import enable_persistent_compilation_cache

        prev = jax.config.jax_compilation_cache_dir
        try:
            jax.config.update("jax_compilation_cache_dir", None)
            monkeypatch.delenv("ECNF_COMPILE_CACHE", raising=False)
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
            assert enable_persistent_compilation_cache() == str(tmp_path / "c")
            assert jax.config.jax_compilation_cache_dir == str(tmp_path / "c")
        finally:
            self._reset(prev)

    def test_env_var_unset_uses_fixed_repo_dir(self, monkeypatch):
        from ecnf_jax.utils.compile_cache import (
            REPO_CACHE_DIR,
            enable_persistent_compilation_cache,
        )

        prev = jax.config.jax_compilation_cache_dir
        try:
            jax.config.update("jax_compilation_cache_dir", None)
            monkeypatch.delenv("ECNF_COMPILE_CACHE", raising=False)
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            got = enable_persistent_compilation_cache()
            repo = Path(__file__).resolve().parents[1]
            assert got == str(REPO_CACHE_DIR) == str(repo / ".jax_cache")
            # Same path on every call: it is part of the cache key.
            jax.config.update("jax_compilation_cache_dir", None)
            assert enable_persistent_compilation_cache() == got
        finally:
            self._reset(prev)


def _tiny_dataset(n=24, n_nodes=4, dim=2, seed=0):
    rng = np.random.default_rng(seed)
    pos = jnp.asarray(rng.normal(size=(n, n_nodes, dim)).astype(np.float32))
    feats = jnp.zeros((n, n_nodes), dtype=jnp.int32)
    data = FullGraphSample(positions=pos, features=feats)
    return lambda train_size, test_size: (data, data[:8])


def _tiny_cfg(tmp_path, extra=()):
    return load_config(
        str(REPO / "examples/configs/dw4.yaml"),
        overrides=[
            "training.save=true",
            f"training.save_dir={tmp_path}",
            "training.batch_size=8",
            "training.eval_batch_size=8",
            "training.n_training_iter=1",
            "training.plot_batch_size=8",
            "training.n_checkpoints=1",
            "training.n_eval=1",
            "training.use_fixed_step_size=true",
            "flow.network.mlp_units=[4]",
            "flow.network.n_blocks_egnn=1",
            "flow.network.n_invariant_feat_hidden=4",
            "flow.network.time_embedding_dim=4",
            *extra,
        ],
    )


class TestSaveInWandbDir:
    def test_rejected_without_wandb_logger(self, tmp_path):
        from ecnf_jax.training.setup import setup_training

        cfg = _tiny_cfg(tmp_path, extra=("training.save_in_wandb_dir=true",))
        with pytest.raises(ValueError, match="save_in_wandb_dir"):
            setup_training(cfg, _tiny_dataset())

    def test_reroots_under_live_run_dir(self, tmp_path, monkeypatch):
        from ecnf_jax.training.setup import setup_training

        run_dir = tmp_path / "wandb_run"
        run_dir.mkdir()

        fake = types.ModuleType("wandb")

        class _Run:
            dir = str(run_dir)

            def log(self, *a, **k):
                pass

            def finish(self):
                pass

        fake.init = lambda **kw: _Run()
        monkeypatch.setitem(sys.modules, "wandb", fake)

        cfg = _tiny_cfg(
            tmp_path / "out", extra=("training.save_in_wandb_dir=true",)
        )
        cfg.logger.clear()
        cfg.logger["wandb"] = {}
        tc = setup_training(cfg, _tiny_dataset())
        assert tc.save_dir.startswith(str(run_dir))
        assert Path(tc.save_dir).exists()


class TestEvalPlots:
    def test_eval_plots_false_skips_sampling_and_figures(self, tmp_path, monkeypatch):
        import ecnf_jax.training.setup as setup_mod

        def _boom(*a, **k):
            raise AssertionError("plotter sampling solve ran despite eval_plots=false")

        monkeypatch.setattr(setup_mod, "sample_cnf", _boom)

        cfg = _tiny_cfg(tmp_path, extra=("training.eval_plots=false",))
        tc = setup_mod.setup_training(cfg, _tiny_dataset())
        state = tc.init_state(jax.random.PRNGKey(0))
        plots_dir = tmp_path / "plots"
        plots_dir.mkdir(exist_ok=True)
        info = tc.eval_and_plot_fn(state, jax.random.PRNGKey(1), 0, True, str(plots_dir))
        assert np.isfinite(info["test_log_lik"])
        assert list(plots_dir.iterdir()) == []

    def test_eval_plots_default_draws_figures(self, tmp_path):
        from ecnf_jax.training.setup import setup_training

        cfg = _tiny_cfg(tmp_path)
        tc = setup_training(cfg, _tiny_dataset())
        state = tc.init_state(jax.random.PRNGKey(0))
        plots_dir = tmp_path / "plots"
        plots_dir.mkdir(exist_ok=True)
        tc.eval_and_plot_fn(state, jax.random.PRNGKey(1), 0, True, str(plots_dir))
        assert list(plots_dir.iterdir())


class TestWandbOnlinePaths:
    """Exercise the online WandbLogger code paths against a stub wandb
    module (no network in this container): init kwargs, per-write
    `run.log(step=i, commit=False)`, `finish()` at close, and the
    artifact upload of checkpoints/plots at loop exit
    (reference `loop.py:176-178`)."""

    def _stub(self, monkeypatch):
        calls = {"log": [], "save": [], "finished": []}

        class _Run:
            dir = "/tmp/stub_run"

            def log(self, data, step=None, commit=None):
                calls["log"].append((dict(data), step, commit))

            def finish(self):
                calls["finished"].append(True)

        fake = types.ModuleType("wandb")

        def _init(**kw):
            calls["init"] = kw
            return _Run()

        fake.init = _init
        fake.save = lambda pattern, base_path=None, policy=None: calls["save"].append(
            (pattern, base_path, policy)
        )
        monkeypatch.setitem(sys.modules, "wandb", fake)
        return calls

    def test_logger_online_write_and_close(self, monkeypatch):
        calls = self._stub(monkeypatch)
        from ecnf_jax.training.loggers import WandbLogger

        lg = WandbLogger(project="p", tags=["t"])
        assert calls["init"]["project"] == "p"
        lg.write({"loss": 1.0})
        lg.write({"loss": 0.5})
        lg.close()
        steps = [s for (_, s, _) in calls["log"]]
        commits = {c for (_, _, c) in calls["log"]}
        assert steps == [0, 1]  # own monotone step counter
        assert commits == {False}  # reference semantics: commit=False
        assert calls["finished"]

    def test_run_records_full_experiment_config(self, tmp_path, monkeypatch):
        """VERDICT r3 item 8 / reference `setup_train_objects.py:7`: the
        wandb run must carry the FULL experiment config, not just the
        logger section's kwargs."""
        calls = self._stub(monkeypatch)
        from ecnf_jax.training.setup import setup_training

        cfg = _tiny_cfg(tmp_path)
        cfg.logger.clear()
        cfg.logger["wandb"] = {"project": "p"}
        setup_training(cfg, _tiny_dataset())
        recorded = calls["init"]["config"]
        assert recorded["flow"]["sigma_min"] == cfg.flow.sigma_min
        assert recorded["training"]["batch_size"] == 8
        assert calls["init"]["project"] == "p"

    def test_setup_logger_forwards_config_without_clobbering(self, monkeypatch):
        calls = self._stub(monkeypatch)
        from ecnf_jax.training.loggers import setup_logger

        setup_logger({"wandb": {"project": "p"}},
                     experiment_config={"flow": {"sigma_min": 0.01}})
        assert calls["init"]["config"] == {"flow": {"sigma_min": 0.01}}
        # A user-provided `config` in the wandb section wins.
        setup_logger({"wandb": {"config": {"mine": 1}}},
                     experiment_config={"flow": {}})
        assert calls["init"]["config"] == {"mine": 1}

    def test_loop_uploads_artifacts_at_exit(self, tmp_path, monkeypatch):
        calls = self._stub(monkeypatch)
        import jax.numpy as jnp

        from ecnf_jax.training.loggers import WandbLogger
        from ecnf_jax.training.loop import TrainConfig, run_training

        cfg = TrainConfig(
            n_iteration=2,
            logger=WandbLogger(project="p"),
            seed=0,
            n_checkpoints=1,
            n_eval=0,
            init_state=lambda key: {"w": jnp.zeros(1)},
            update_state=lambda st: ({"w": st["w"] + 1}, {"loss": 0.0}),
            eval_and_plot_fn=None,
            save=True,
            save_dir=str(tmp_path),
        )
        run_training(cfg)
        patterns = [p for (p, _, _) in calls["save"]]
        assert any("model_checkpoints" in p for p in patterns)
        assert any("plots" in p for p in patterns)
        assert all(bp == str(tmp_path) for (_, bp, _) in calls["save"])
