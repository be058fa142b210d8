"""Harness tests: config loading/overrides, checkpoints, loggers, loop."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ecnf_jax.training.config import (
    ExperimentConfig,
    load_config,
    apply_overrides,
    config_to_dict,
)
from ecnf_jax.training.checkpoints import (
    get_latest_checkpoint,
    parse_checkpoint_iteration,
    save_checkpoint,
    restore_checkpoint,
)
from ecnf_jax.training.loggers import ListLogger, CSVLogger, setup_logger
from ecnf_jax.training.loop import TrainConfig, run_training, _schedule


class TestConfig:
    def test_defaults(self):
        cfg = load_config()
        assert cfg.training.batch_size == 64
        assert cfg.flow.network.mlp_units == (128, 128, 128)

    def test_yaml_roundtrip(self, tmp_path):
        p = tmp_path / "cfg.yaml"
        p.write_text(
            """
flow:
  sigma_min: 0.05
  network:
    mlp_units: [32, 32]
training:
  batch_size: 16
  eval_batch_size: ${training.batch_size}
"""
        )
        cfg = load_config(str(p))
        assert cfg.flow.sigma_min == 0.05
        assert cfg.flow.network.mlp_units == (32, 32)
        assert cfg.training.batch_size == 16
        # Interpolation (reference `config/qm9.yaml:28` style).
        assert cfg.training.eval_batch_size == 16

    def test_overrides(self):
        cfg = load_config(overrides=["training.batch_size=128", "flow.sigma_min=0.1"])
        assert cfg.training.batch_size == 128
        assert cfg.flow.sigma_min == 0.1

    def test_nested_override(self):
        cfg = load_config(overrides=["flow.network.n_blocks_egnn=7"])
        assert cfg.flow.network.n_blocks_egnn == 7

    def test_hutchinson_probes_override(self):
        # Eval knob with no reference analogue (reference is fixed at one probe,
        # `ecnf/cnf/sample_and_log_prob.py:55`).
        cfg = load_config(overrides=["training.hutchinson_probes=4"])
        assert cfg.training.hutchinson_probes == 4
        assert load_config().training.hutchinson_probes == 1

    def test_ode_method_override(self):
        cfg = load_config(overrides=["training.ode_method=rk4"])
        assert cfg.training.ode_method == "rk4"
        assert load_config().training.ode_method == "dopri5"

    def test_unknown_override_rejected(self):
        with pytest.raises(ValueError, match="unknown config field"):
            load_config(overrides=["training.batch_sizee=128"])
        with pytest.raises(ValueError, match="unknown config section"):
            load_config(overrides=["trainin.batch_size=128"])

    def test_config_to_dict(self):
        d = config_to_dict(load_config())
        assert d["training"]["optimizer"]["init_lr"] == 1e-4


class TestCheckpoints:
    def test_save_restore_roundtrip(self, tmp_path):
        state = {
            "params": {"w": jnp.arange(6.0).reshape(2, 3), "b": jnp.zeros(3)},
            "step": jnp.asarray(7),
        }
        path = save_checkpoint(str(tmp_path), 42, state)
        assert "state_00000042" in path
        restored = restore_checkpoint(path, jax.tree_util.tree_map(jnp.zeros_like, state))
        np.testing.assert_array_equal(restored["params"]["w"], state["params"]["w"])
        assert int(restored["step"]) == 7

    def test_latest_and_parse(self, tmp_path):
        for it in (3, 11, 7):
            save_checkpoint(str(tmp_path), it, {"x": jnp.zeros(2)})
        latest = get_latest_checkpoint(str(tmp_path), key="state_")
        assert parse_checkpoint_iteration(latest) == 11

    def test_no_checkpoints(self, tmp_path):
        assert get_latest_checkpoint(str(tmp_path / "nothing")) is None


class TestLoggers:
    def test_list_logger(self):
        lg = ListLogger()
        lg.write({"loss": 1.0})
        lg.write({"loss": 0.5, "extra": 2})
        assert lg.history["loss"] == [1.0, 0.5]
        assert lg.history["extra"] == [2.0]
        lg.close()

    def test_csv_logger(self, tmp_path):
        lg = CSVLogger(save=True, save_path=str(tmp_path), save_period=2)
        lg.write({"a": 1.0})
        lg.write({"a": 2.0, "b": 3.0})
        lg.close()
        import pandas as pd

        df = pd.read_csv(os.path.join(str(tmp_path), "logging_history.csv"), index_col=0)
        assert len(df) == 2

    def test_csv_logger_append_mode_matches_full_rewrite(self, tmp_path):
        """Incremental flushes (append-only once columns stabilize, one
        rewrite when a new key appears) must read back exactly like a
        single end-of-run write — long soaks rely on the O(rows) path."""
        import pandas as pd

        rows = (
            [{"loss": float(i)} for i in range(5)]
            + [{"loss": 5.0, "eval_nll": -1.0}]  # widens the column set
            + [{"loss": float(i), "eval_nll": float(-i)} for i in range(6, 12)]
            + [{"loss": 12.0}]  # missing key -> NaN, still appendable
        )
        a = tmp_path / "a"
        lg = CSVLogger(save=True, save_path=str(a), save_period=3)
        for r in rows:
            lg.write(r)
        lg.close()
        b = tmp_path / "b"
        ref = CSVLogger(save=True, save_path=str(b), save_period=10_000)
        for r in rows:
            ref.write(r)
        ref.close()
        da = pd.read_csv(a / "logging_history.csv", index_col=0)
        db = pd.read_csv(b / "logging_history.csv", index_col=0)
        pd.testing.assert_frame_equal(da, db)
        assert len(da) == len(rows)

        # Resume: a new logger on the same file appends, keeping columns.
        lg2 = CSVLogger(save=True, save_path=str(a), save_period=1)
        lg2.write({"loss": 13.0})
        lg2.close()
        da2 = pd.read_csv(a / "logging_history.csv", index_col=0)
        assert len(da2) == len(rows) + 1
        assert list(da2.columns) == list(da.columns)

    def test_setup_logger_selection(self):
        assert isinstance(setup_logger({"list_logger": None}), ListLogger)
        with pytest.raises(ValueError):
            setup_logger({"bogus": None})


class TestLoop:
    def test_schedule_matches_reference_semantics(self):
        # np.flip(np.linspace(n-1, 0, k, endpoint=False)) — reference
        # loop.py:77-89.
        s = _schedule(200, 5)
        expected = np.flip(np.linspace(199, 0, 5, dtype="int", endpoint=False))
        np.testing.assert_array_equal(s, expected)
        assert s[-1] == 199  # always fires on the final iteration

    def test_run_training_minimal(self, tmp_path):
        """Tiny synthetic loop: init/update/eval wiring + checkpoint files."""
        calls = {"update": 0, "eval": 0}

        def init_state(key):
            return {"w": jnp.zeros(2), "key": key}

        def update_state(state):
            calls["update"] += 1
            return {"w": state["w"] + 1, "key": state["key"]}, {"loss": 1.0}

        def eval_and_plot(state, key, iteration_n, save, plots_dir):
            calls["eval"] += 1
            return {"metric": float(state["w"][0])}

        logger = ListLogger()
        cfg = TrainConfig(
            n_iteration=6,
            logger=logger,
            seed=0,
            n_checkpoints=2,
            n_eval=2,
            init_state=init_state,
            update_state=update_state,
            eval_and_plot_fn=eval_and_plot,
            save=True,
            save_dir=str(tmp_path),
        )
        _, state = run_training(cfg)
        assert calls["update"] == 6
        assert calls["eval"] == 3  # initial + 2 scheduled
        assert float(state["w"][0]) == 6.0
        cks = os.listdir(os.path.join(str(tmp_path), "model_checkpoints"))
        assert len([c for c in cks if "state_" in c]) == 2

    def test_resume_skips_completed(self, tmp_path):
        def init_state(key):
            return {"w": jnp.zeros(1)}

        def update_state(state):
            return {"w": state["w"] + 1}, {"loss": 0.0}

        logger = ListLogger()
        base = dict(
            n_iteration=4,
            seed=0,
            n_checkpoints=2,
            n_eval=1,
            init_state=init_state,
            update_state=update_state,
            eval_and_plot_fn=None,
            save=True,
            save_dir=str(tmp_path),
        )
        run_training(TrainConfig(logger=ListLogger(), **base))
        # Resume: latest checkpoint is at iteration 3 (final) -> 0 updates.
        _, state = run_training(TrainConfig(logger=ListLogger(), resume=True, **base))
        assert float(state["w"][0]) == 4.0  # restored, not re-run


@pytest.mark.skipif(
    not os.path.isdir("/root/reference/examples/config"),
    reason="reference repo not mounted",
)
def test_reference_yaml_configs_parse_verbatim():
    """A reference user's own hydra YAMLs load unchanged (SURVEY §2 configs)."""
    import glob

    files = sorted(glob.glob("/root/reference/examples/config/*.yaml"))
    assert len(files) == 4
    for f in files:
        cfg = load_config(f)
        assert cfg.training.batch_size > 0
        assert len(cfg.flow.network.mlp_units) >= 1
    # interpolation resolved (qm9.yaml: eval_batch_size: ${training.batch_size})
    qm9 = load_config([f for f in files if f.endswith("qm9.yaml")][0])
    assert qm9.training.eval_batch_size == qm9.training.batch_size == 256
