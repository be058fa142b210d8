"""End-to-end example integration tests (debug scale, CPU mesh).

Drives the actual experiment entry points (setup_training + run_training)
for DW4 (energies + forward ESS path) and ALDP (h5 loading, per-atom-index
features, EMA path) at tiny scale.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent

from ecnf_jax.targets.data import load_dw4, load_aldp
from ecnf_jax.targets.energies import double_well_log_prob
from ecnf_jax.training.config import load_config
from ecnf_jax.training.loop import run_training
from ecnf_jax.training.setup import setup_training


def _tiny_overrides(tmp_path, extra=()):
    return [
        "training.save=true",
        f"training.save_dir={tmp_path}",
        "training.batch_size=8",
        "training.eval_batch_size=9",
        "training.n_training_iter=2",
        "training.train_set_size=40",
        "training.test_set_size=16",
        "training.plot_batch_size=8",
        "training.n_checkpoints=1",
        "training.n_eval=1",
        "flow.network.mlp_units=[8]",
        "flow.network.n_blocks_egnn=1",
        "flow.network.n_invariant_feat_hidden=4",
        "flow.network.time_embedding_dim=4",
        *extra,
    ]


@pytest.mark.slow
class TestExamplesE2E:
    def test_dw4_end_to_end(self, tmp_path):
        cfg = load_config(
            str(REPO / "examples/configs/dw4.yaml"),
            overrides=_tiny_overrides(tmp_path),
        )

        def load_dataset(train_size, test_size):
            train, valid, test = load_dw4(train_size)
            return train, test[:test_size]

        tc = setup_training(cfg, load_dataset, target_log_prob_fn=double_well_log_prob)
        logger, state = run_training(tc)
        hist = logger.history if hasattr(logger, "history") else None
        assert hist is not None
        assert np.isfinite(hist["loss"]).all()
        assert "forward_ess" in hist
        assert (tmp_path / "model_checkpoints").exists()
        assert any((tmp_path / "plots").iterdir())

    def test_epochs_per_dispatch_equivalence(self, tmp_path):
        """Grouping epochs into one device dispatch must not change the
        training trajectory: same RNG flows through the scanned state, so
        losses and logged iterations are identical to the per-epoch loop."""

        def load_dataset(train_size, test_size):
            train, valid, test = load_dw4(train_size)
            return train, test[:test_size]

        hists = {}
        for k in (1, 3):
            cfg = load_config(
                str(REPO / "examples/configs/dw4.yaml"),
                overrides=_tiny_overrides(
                    tmp_path / f"d{k}",
                    extra=(
                        "training.n_training_iter=7",
                        f"training.epochs_per_dispatch={k}",
                        "training.n_eval=1",
                        "training.n_checkpoints=1",
                    ),
                ),
            )
            tc = setup_training(
                cfg, load_dataset, target_log_prob_fn=double_well_log_prob
            )
            logger, _ = run_training(tc)
            hists[k] = logger.history
        np.testing.assert_allclose(hists[3]["loss"], hists[1]["loss"], rtol=1e-6)
        assert hists[3]["iteration"] == hists[1]["iteration"]

    def test_lj13_end_to_end(self, tmp_path):
        """LJ13 path: 13-node EGNN, LJ energies, reverse-ESS model samples.

        Uses a synthetic low-energy dataset (noisy icosahedra — the LJ13
        ground-state geometry) written in the `lj13_generated.npy` layout so
        the loader's regenerated-data branch is exercised without running
        HMC in the test.
        """
        from ecnf_jax.targets.data import load_lj13
        from ecnf_jax.targets.energies import lennard_jones_log_prob
        from ecnf_jax.targets.mcmc import icosahedron_with_center

        data_dir = tmp_path / "data"
        data_dir.mkdir()
        confs = icosahedron_with_center(
            2040, jax.random.PRNGKey(0), noise=0.02
        )
        np.save(data_dir / "lj13_generated.npy", np.asarray(confs, np.float64))

        cfg = load_config(
            str(REPO / "examples/configs/lj13.yaml"),
            overrides=_tiny_overrides(
                tmp_path / "run",
                extra=(
                    "flow.network.compute_dtype=null",
                    "training.eval_n_model_samples=4",
                    "training.final_run=true",
                ),
            ),
        )

        def load_dataset(train_size, test_size):
            train, valid, test = load_lj13(train_size, path=data_dir)
            return train, test[:test_size]

        tc = setup_training(
            cfg, load_dataset, target_log_prob_fn=lennard_jones_log_prob
        )
        logger, state = run_training(tc)
        hist = logger.history
        assert np.isfinite(hist["loss"]).all()
        # Reverse-ESS path ran against the LJ energy.
        assert "rv_ess" in hist
        # 13-node exact trace (D=39) produced finite test log-liks.
        assert np.isfinite(hist["test_log_lik"]).all()

    def test_qm9_end_to_end_synthetic(self, tmp_path):
        """QM9 path: 19-atom padded data, EMA, Hutchinson eval, no energy.

        Synthetic `qm9pos_{train,valid,test}.npy` files of the real shapes
        stand in for the (egress-requiring) figshare download.
        """
        from ecnf_jax.targets.data import load_qm9

        data_dir = tmp_path / "data"
        data_dir.mkdir()
        rng = np.random.default_rng(0)
        for name, n in [("train", 48), ("valid", 16), ("test", 16)]:
            pos = rng.normal(size=(n, 19, 3)).astype(np.float64)
            np.save(data_dir / f"qm9pos_{name}.npy", pos)

        cfg = load_config(
            str(REPO / "examples/configs/qm9.yaml"),
            overrides=_tiny_overrides(
                tmp_path / "run",
                extra=(
                    "flow.network.compute_dtype=null",
                    "training.train_set_size=32",
                    "training.test_set_size=16",
                    "training.eval_batch_size=8",
                    "training.use_ema=true",
                    "training.eval_exact_log_prob=false",
                    "training.hutchinson_probes=4",
                ),
            ),
        )
        assert cfg.training.eval_n_model_samples is None  # no QM9 energy

        def load_dataset(train_size, test_size):
            train, valid, test = load_qm9(train_size, path=data_dir)
            return train, test[:test_size]

        tc = setup_training(cfg, load_dataset)
        logger, state = run_training(tc)
        assert state.ema_params is not None
        hist = logger.history
        assert np.isfinite(hist["loss"]).all()
        # Hutchinson (approx) eval produced finite test log-liks; no
        # reverse-ESS metrics without an energy function.
        assert np.isfinite(hist["test_log_lik"]).all()
        assert "rv_ess" not in hist

    def test_aldp_end_to_end_with_ema(self, tmp_path):
        h5 = REPO / "data" / "aldp_500K_train_mini.h5"
        if not h5.exists():
            pytest.skip("aldp h5 missing")
        cfg = load_config(
            str(REPO / "examples/configs/aldp.yaml"),
            overrides=_tiny_overrides(
                tmp_path,
                extra=(
                    "training.use_ema=true",
                    "training.eval_exact_log_prob=false",
                    "training.train_set_size=32",
                    "training.test_set_size=8",
                    "training.eval_batch_size=4",
                ),
            ),
        )

        def load_dataset(train_size, test_size):
            train, valid, test = load_aldp(
                train_path=str(h5), val_path=str(h5), test_path=str(h5),
                train_n_points=train_size,
            )
            return train, test[:test_size]

        tc = setup_training(cfg, load_dataset)
        logger, state = run_training(tc)
        assert state.ema_params is not None
        # EMA params must differ from raw params after training.
        p = jax.tree_util.tree_leaves(state.params)[0]
        e = jax.tree_util.tree_leaves(state.ema_params)[0]
        assert not np.allclose(np.asarray(p), np.asarray(e))
        assert np.isfinite(logger.history["loss"]).all()
        # 22-atom per-index features drove a 22-entry embedding.
        emb = state.params["params"]["Embed_0"]["embedding"]
        assert emb.shape[0] == 22


@pytest.mark.slow
def test_score_cli_subprocess(tmp_path):
    """Serving surface: save a checkpoint, then score a .npy of
    configurations through `examples/score.py` in a fresh process."""
    from ecnf_jax.cnf.build import build_cnf
    from ecnf_jax.training.checkpoints import save_checkpoint
    from ecnf_jax.training.config import load_config
    from ecnf_jax.training.optim import build_optimizer
    from ecnf_jax.training.state import init_training_state

    overrides = [
        "flow.network.mlp_units=[8]",
        "flow.network.n_blocks_egnn=1",
        "flow.network.n_invariant_feat_hidden=4",
        "flow.network.time_embedding_dim=4",
        "flow.network.compute_dtype=null",
        "training.use_fixed_step_size=true",
    ]
    cfg = load_config(str(REPO / "examples/configs/dw4.yaml"), overrides=overrides)
    net = cfg.flow.network
    cnf = build_cnf(
        n_frames=4, dim=2, sigma_min=cfg.flow.sigma_min,
        base_scale=cfg.flow.base_scale, n_blocks_egnn=net.n_blocks_egnn,
        mlp_units=tuple(net.mlp_units),
        n_invariant_feat_hidden=net.n_invariant_feat_hidden,
        time_embedding_dim=net.time_embedding_dim, n_features=1,
    )
    x_ex = jax.random.normal(jax.random.PRNGKey(0), (2, 8))
    feats_ex = np.zeros((2, 4), np.int32)
    state = init_training_state(
        cnf, build_optimizer(1e-4, use_schedule=False), jax.random.PRNGKey(1),
        x_ex, jnp.asarray(feats_ex),
    )
    ckpt_dir = tmp_path / "model_checkpoints"
    save_checkpoint(str(ckpt_dir), 7, state)

    data = np.random.default_rng(0).normal(size=(6, 4, 2))
    np.save(tmp_path / "pos.npy", data)

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    result = subprocess.run(
        [
            sys.executable, "score.py",
            "--config", "configs/dw4.yaml",
            "--checkpoint-dir", str(ckpt_dir),
            "--data", str(tmp_path / "pos.npy"),
            "--output", str(tmp_path / "lp.npy"),
            "--batch-size", "4",
            *overrides,
        ],
        cwd=str(REPO / "examples"),
        env=env, capture_output=True, text=True, timeout=600,
    )
    assert result.returncode == 0, result.stderr[-4000:]
    lp = np.load(tmp_path / "lp.npy")
    assert lp.shape == (6,) and np.isfinite(lp).all()
    assert "mean log-prob" in result.stdout

    # --freeze-params (weights as XLA constants, the long-lived-serving
    # option) must score identically to the runtime-argument default.
    result = subprocess.run(
        [
            sys.executable, "score.py", "--freeze-params",
            "--config", "configs/dw4.yaml",
            "--checkpoint-dir", str(ckpt_dir),
            "--data", str(tmp_path / "pos.npy"),
            "--output", str(tmp_path / "lp_frozen.npy"),
            "--batch-size", "4",
            *overrides,
        ],
        cwd=str(REPO / "examples"),
        env=env, capture_output=True, text=True, timeout=600,
    )
    assert result.returncode == 0, result.stderr[-4000:]
    lp_frozen = np.load(tmp_path / "lp_frozen.npy")
    np.testing.assert_allclose(lp_frozen, lp, rtol=1e-5, atol=1e-5)

    # --ema on an EMA-less checkpoint must fail with a clear message ...
    result = subprocess.run(
        [
            sys.executable, "score.py", "--ema",
            "--config", "configs/dw4.yaml",
            "--checkpoint-dir", str(ckpt_dir),
            "--data", str(tmp_path / "pos.npy"),
            *overrides,
        ],
        cwd=str(REPO / "examples"), env=env,
        capture_output=True, text=True, timeout=600,
    )
    assert result.returncode != 0
    assert "no EMA parameters" in result.stderr

    # ... and serve the EMA weights when the checkpoint has them (the
    # reference's final-eval semantics, `setup_training.py:229-230`).
    # Perturb raw params so the two parameter sets give different scores.
    state_ema = init_training_state(
        cnf, build_optimizer(1e-4, use_schedule=False), jax.random.PRNGKey(1),
        x_ex, jnp.asarray(feats_ex), use_ema=True,
    )
    state_ema = state_ema._replace(
        params=jax.tree_util.tree_map(lambda p: p + 1.0, state_ema.params)
    )
    ckpt_ema = tmp_path / "ema_checkpoints"
    save_checkpoint(str(ckpt_ema), 3, state_ema)
    for flag, out_name in ((["--ema"], "lp_ema.npy"), ([], "lp_raw.npy")):
        result = subprocess.run(
            [
                sys.executable, "score.py", *flag,
                "--config", "configs/dw4.yaml",
                "--checkpoint-dir", str(ckpt_ema),
                "--data", str(tmp_path / "pos.npy"),
                "--output", str(tmp_path / out_name),
                *overrides,
            ],
            cwd=str(REPO / "examples"), env=env,
            capture_output=True, text=True, timeout=600,
        )
        assert result.returncode == 0, result.stderr[-4000:]
    lp_ema = np.load(tmp_path / "lp_ema.npy")
    lp_raw = np.load(tmp_path / "lp_raw.npy")
    assert np.isfinite(lp_ema).all()
    assert not np.allclose(lp_ema, lp_raw)  # actually used different weights

    # The serving pair's other half: draw samples (+ exact log q) from the
    # same checkpoint through `examples/sample.py` in a fresh process.
    result = subprocess.run(
        [
            sys.executable, "sample.py",
            "--config", "configs/dw4.yaml",
            "--checkpoint-dir", str(ckpt_dir),
            "--n-nodes", "4", "--dim", "2",
            "--n-samples", "6", "--batch-size", "4",
            "--with-log-prob",
            "--output", str(tmp_path / "samples.npy"),
            "--log-prob-output", str(tmp_path / "logq.npy"),
            *overrides,
        ],
        cwd=str(REPO / "examples"),
        env=env, capture_output=True, text=True, timeout=600,
    )
    assert result.returncode == 0, result.stderr[-4000:]
    s = np.load(tmp_path / "samples.npy")
    lq = np.load(tmp_path / "logq.npy")
    assert s.shape == (6, 4, 2) and np.isfinite(s).all()
    assert lq.shape == (6,) and np.isfinite(lq).all()
    # Flow samples live on the zero-CoM hyperplane (base + equivariant field).
    np.testing.assert_allclose(s.mean(axis=1), 0.0, atol=1e-4)


@pytest.mark.slow
def test_dw4_cli_subprocess(tmp_path):
    """Drive the actual `examples/dw4.py` CLI as a user would: `--local`
    debug block + dotted overrides winning over it (reference
    `examples/dw4.py:22-38` semantics), in a fresh process."""
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    result = subprocess.run(
        [
            sys.executable,
            "dw4.py",
            "--local",
            "training.n_training_iter=1",
            "training.test_set_size=16",
            "training.train_set_size=24",
            "training.eval_batch_size=8",
            "training.plot_batch_size=8",
            "training.eval_n_model_samples=4",
            "flow.network.mlp_units=[8]",
            "flow.network.n_blocks_egnn=1",
            "flow.network.n_invariant_feat_hidden=4",
            f"training.save_dir={tmp_path}",
        ],
        cwd=str(REPO / "examples"),
        env=env,
        capture_output=True,
        text=True,
        timeout=900,
    )
    assert result.returncode == 0, result.stderr[-4000:]
    # The list logger prints eval info dicts; training must have evaluated.
    assert "test_log_lik" in result.stdout + result.stderr, result.stdout[-2000:]


def test_sample_cli_rejects_zero_samples(tmp_path):
    """--n-samples < 1 must fail at argument parsing (not crash later in
    the timing math)."""
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    result = subprocess.run(
        [
            sys.executable, "sample.py",
            "--checkpoint-dir", str(tmp_path),  # never reached
            "--n-nodes", "4", "--dim", "2",
            "--n-samples", "0",
        ],
        cwd=str(REPO / "examples"),
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert result.returncode == 2  # argparse usage error
    assert "must be >= 1" in result.stderr


class TestEssDispatchChunk:
    """`training.eval_dispatch_chunk` groups reverse-ESS sample batches
    into one scanned device program (docs/PERF.md "ESS-eval dispatch
    tax").  The chunked form must use the SAME split-key sequence as the
    per-batch host loop, so rv_ess is identical for any chunk size."""

    def _eval_info(self, tmp_path, chunk, subdir):
        cfg = load_config(
            str(REPO / "examples/configs/dw4.yaml"),
            overrides=_tiny_overrides(
                tmp_path / subdir,
                extra=(
                    "flow.network.compute_dtype=null",
                    "training.use_fixed_step_size=true",
                    "training.eval_n_model_samples=40",
                    "training.eval_batch_size=8",
                    "training.eval_plots=false",
                    "training.test_set_size=8",
                    f"training.eval_dispatch_chunk={chunk}",
                ),
            ),
        )

        def load_dataset(train_size, test_size):
            train, valid, test = load_dw4(train_size)
            return train, test[:test_size]

        tc = setup_training(
            cfg, load_dataset, target_log_prob_fn=double_well_log_prob
        )
        state = tc.init_state(jax.random.PRNGKey(0))
        return tc.eval_and_plot_fn(
            state, jax.random.PRNGKey(7), 0, False, str(tmp_path / subdir)
        )

    def test_chunked_equals_host_loop(self, tmp_path):
        # 40 samples / batch 8 = 5 batches; chunk=2 exercises 2 scanned
        # dispatches + 1 per-batch remainder against the pure host loop.
        info_loop = self._eval_info(tmp_path, chunk=1, subdir="loop")
        info_chunk = self._eval_info(tmp_path, chunk=2, subdir="chunk")
        assert np.isfinite(info_loop["rv_ess"])
        np.testing.assert_allclose(
            info_chunk["rv_ess"], info_loop["rv_ess"], rtol=1e-6
        )

    def test_oversized_chunk_clamps(self, tmp_path):
        info = self._eval_info(tmp_path, chunk=100, subdir="big")
        assert np.isfinite(info["rv_ess"])
