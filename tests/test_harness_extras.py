"""Additional harness coverage: runtime limit, 64-bit, logger fallback,
profiler hook."""
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ecnf_jax.training.loggers import ListLogger, WandbLogger
from ecnf_jax.training.loop import TrainConfig, run_training


def _mk_config(tmp_path, **kw):
    def init_state(key):
        return {"w": jnp.zeros(1)}

    def update_state(state):
        time.sleep(kw.pop("_step_sleep", 0.0) if "_step_sleep" in kw else 0.0)
        return {"w": state["w"] + 1}, {"loss": 0.0}

    base = dict(
        n_iteration=kw.pop("n_iteration", 4),
        logger=ListLogger(),
        seed=0,
        n_checkpoints=kw.pop("n_checkpoints", 2),
        n_eval=0,
        init_state=init_state,
        update_state=kw.pop("update_state", update_state),
        eval_and_plot_fn=None,
        save=True,
        save_dir=str(tmp_path),
    )
    base.update(kw)
    return TrainConfig(**base)


class TestRuntimeLimit:
    def test_early_stop(self, tmp_path):
        """With a tiny runtime limit and slow steps, training must break at
        a checkpoint instead of running all iterations (reference
        loop.py:155-170 semantics)."""
        calls = {"n": 0}

        def slow_update(state):
            calls["n"] += 1
            time.sleep(0.3)
            return {"w": state["w"] + 1}, {"loss": 0.0}

        cfg = _mk_config(
            tmp_path,
            n_iteration=40,
            n_checkpoints=20,
            update_state=slow_update,
            runtime_limit=0.5 / 3600.0,  # 0.5 s in hours
        )
        run_training(cfg)
        assert calls["n"] < 40, "runtime limit did not stop training early"


class TestUse64Bit:
    def test_enables_x64(self, tmp_path):
        seen = {}

        def update_state(state):
            seen["dtype"] = jnp.asarray(1.0).dtype
            return state, {"loss": 0.0}

        cfg = _mk_config(
            tmp_path, n_iteration=1, n_checkpoints=0,
            update_state=update_state, use_64_bit=True,
        )
        try:
            run_training(cfg)
            assert seen["dtype"] == jnp.float64
        finally:
            jax.config.update("jax_enable_x64", False)


class TestWandbFallback:
    def test_falls_back_without_wandb(self):
        lg = WandbLogger(project="nope")
        assert lg._wandb is None  # package absent in this env
        lg.write({"a": 1.0})
        lg.close()
        assert lg._fallback.history["a"] == [1.0]


class TestProfileDir:
    def test_trace_files_written(self, tmp_path):
        prof = tmp_path / "prof"
        cfg = _mk_config(
            tmp_path, n_iteration=4, n_checkpoints=0, profile_dir=str(prof)
        )
        run_training(cfg)
        # jax.profiler writes a plugins/profile tree.
        found = list(prof.rglob("*"))
        assert found, "no profiler output written"


class TestCompileCache:
    def _reset(self, prev):
        jax.config.update("jax_compilation_cache_dir", prev)

    def test_enable_sets_config_and_caches_to_disk(self, tmp_path, monkeypatch):
        from ecnf_jax.utils.compile_cache import enable_persistent_compilation_cache

        prev = jax.config.jax_compilation_cache_dir
        try:
            monkeypatch.delenv("ECNF_COMPILE_CACHE", raising=False)
            jax.config.update("jax_compilation_cache_dir", None)
            cache = tmp_path / "xla"
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(cache))
            got = enable_persistent_compilation_cache(min_compile_time_secs=0.0)
            assert got == str(cache)
            assert jax.config.jax_compilation_cache_dir == str(cache)
            # A fresh (per-run-unique) jitted program must land on disk.
            import uuid

            salt = float(int(uuid.uuid4().int % 97))
            jax.jit(lambda x: x * salt + 1.0)(jnp.arange(8.0)).block_until_ready()
            assert list(cache.iterdir()), "no cache entry written"
        finally:
            self._reset(prev)

    def test_env_opt_out(self, tmp_path, monkeypatch):
        from ecnf_jax.utils.compile_cache import enable_persistent_compilation_cache

        prev = jax.config.jax_compilation_cache_dir
        try:
            jax.config.update("jax_compilation_cache_dir", None)
            monkeypatch.setenv("ECNF_COMPILE_CACHE", "0")
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
            assert enable_persistent_compilation_cache() is None
            assert jax.config.jax_compilation_cache_dir is None
        finally:
            self._reset(prev)

    def test_user_setting_respected(self, tmp_path, monkeypatch):
        from ecnf_jax.utils.compile_cache import enable_persistent_compilation_cache

        prev = jax.config.jax_compilation_cache_dir
        try:
            monkeypatch.delenv("ECNF_COMPILE_CACHE", raising=False)
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            mine = str(tmp_path / "mine")
            jax.config.update("jax_compilation_cache_dir", mine)
            assert enable_persistent_compilation_cache() == mine
            assert jax.config.jax_compilation_cache_dir == mine
        finally:
            self._reset(prev)

    def test_env_dir_wins_over_config(self, tmp_path, monkeypatch):
        # JAX_COMPILATION_CACHE_DIR is the one directory used when set; no
        # other directory is set in code.
        from ecnf_jax.utils.compile_cache import enable_persistent_compilation_cache

        prev = jax.config.jax_compilation_cache_dir
        try:
            monkeypatch.delenv("ECNF_COMPILE_CACHE", raising=False)
            env_dir = str(tmp_path / "env")
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env_dir)
            jax.config.update("jax_compilation_cache_dir", str(tmp_path / "cfg"))
            assert enable_persistent_compilation_cache() == env_dir
            assert jax.config.jax_compilation_cache_dir == env_dir
        finally:
            self._reset(prev)

    def test_empty_env_value_means_unset(self, tmp_path, monkeypatch):
        # `ECNF_COMPILE_CACHE= cmd` does not opt out.
        from ecnf_jax.utils.compile_cache import enable_persistent_compilation_cache

        prev = jax.config.jax_compilation_cache_dir
        try:
            jax.config.update("jax_compilation_cache_dir", None)
            monkeypatch.setenv("ECNF_COMPILE_CACHE", "")
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
            assert enable_persistent_compilation_cache() == str(tmp_path)
        finally:
            self._reset(prev)


class TestEpochsPerDispatch:
    def test_grouped_loop_schedule_parity(self, tmp_path):
        # The grouped loop must run every iteration exactly once, keep the
        # eval/checkpoint schedule, and fan per-epoch infos out in order.
        def init_state(key):
            return {"w": jnp.zeros(1)}

        def update_state(state):
            return {"w": state["w"] + 1}, {"loss": float(state["w"][0])}

        def update_state_multi(state, k):
            w0 = float(state["w"][0])
            infos = {"loss": np.arange(w0, w0 + k, dtype=np.float32)}
            return {"w": state["w"] + k}, infos

        evals = []
        cfg = _mk_config(
            tmp_path,
            n_iteration=10,
            n_checkpoints=2,
            update_state=update_state,
            update_state_multi=update_state_multi,
            epochs_per_dispatch=4,
            n_eval=2,
            eval_and_plot_fn=lambda state, key, it, save, pdir: evals.append(it) or {},
        )
        logger, state = run_training(cfg)
        assert float(state["w"][0]) == 10.0
        # history interleaves eval rows (iteration -1, 4, 9) with the 10
        # training rows; the training losses must be 0..9 in order.
        assert sorted(logger.history["iteration"]) == sorted(
            list(range(10)) + [-1, 4, 9]
        )
        np.testing.assert_allclose(logger.history["loss"], np.arange(10.0))
        # evals fire exactly at the scheduled iterations (linspace incl. last)
        assert evals == [-1, 4, 9]
        assert (tmp_path / "model_checkpoints" / "state_00000009").exists()
