"""Experiment orchestration: config + data + CNF + mesh -> TrainConfig.

Behavioral parity with the reference's `ecnf/setup_training.py:68-269`
(zero-CoM the data, optimizer schedule over total minibatch steps, flatten
coordinates, build the CNF with ``n_features = max + 1``, epoch runner,
reverse-ESS / test-NLL evaluation, EMA swap on the final eval, distance-
histogram plotting) — re-architected for batched, sharded programs:

- **Whole-epoch jit.**  The reference dispatches one jitted step per
  minibatch from Python (`setup_training.py:150-161`).  Here the full epoch
  (permute -> reshape to ``[n_batches, B, D]`` -> `lax.scan` of the update)
  is a single jit-compiled program; host round-trips per epoch: one.
- **Sharded by construction.**  Steps are compiled against the data mesh:
  params replicated, batch axis sharded; gradient reductions become
  all-reduces.  The same program runs on 1 device or N.
- **Batched eval.**  Reverse-ESS sampling runs `lax.scan` over *batches* of
  ODE solves (the reference scans 10k single-sample solves,
  `setup_training.py:166-185`); test NLL uses the batched log-prob
  (`ecnf_jax/cnf/sampling.py`) instead of per-sample vmap.
"""
import os
import pathlib
from functools import partial
from typing import Callable, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ecnf_jax.cnf.build import build_cnf
from ecnf_jax.cnf.core import FlowMatchingCNF
from ecnf_jax.cnf.sampling import (
    SolveConfig,
    sample_cnf,
    get_log_prob,
    sample_and_log_prob_cnf,
)
from ecnf_jax.ops.numerics import maybe_masked_mean
from ecnf_jax.parallel.mesh import get_mesh, replicated, data_sharded
from ecnf_jax.targets.data import FullGraphSample
from ecnf_jax.training.config import ExperimentConfig, config_to_dict
from ecnf_jax.training.evaluation import eval_fn, calculate_forward_ess, calculate_reverse_ess
from ecnf_jax.training.loggers import setup_logger
from ecnf_jax.training.loop import TrainConfig
from ecnf_jax.training.optim import build_optimizer
from ecnf_jax.training.state import TrainingState, init_training_state, make_update_fn
from ecnf_jax.utils.optional import require

LoadDatasetFn = Callable[[Optional[int], Optional[int]], Tuple[FullGraphSample, FullGraphSample]]
Plotter = Callable[[TrainingState, FullGraphSample, jax.Array], Sequence]


def setup_default_plotter(
    cnf: FlowMatchingCNF,
    n_nodes: int,
    dim: int,
    n_samples_plotting: int,
    solve_cfg: SolveConfig,
) -> Plotter:
    """Distance-histogram plot of flow samples vs train data.

    Parity: reference `setup_training.py:32-65`, with one batched solve
    instead of a vmap of per-sample solves.
    """

    def default_plotter(state: TrainingState, train_data_: FullGraphSample, key: jax.Array):
        plt = require("matplotlib.pyplot", "eval plots (training.eval_plots)")

        from ecnf_jax.utils.plotting import (
            bin_samples_by_dist,
            get_counts,
            get_pairwise_distances_for_plotting,
        )

        features_flat = train_data_.features[0].flatten()
        feats = jnp.repeat(features_flat[None], n_samples_plotting, axis=0)
        flow_samples_flat = sample_cnf(
            cnf, state.params, key, n_samples_plotting, feats, solve_cfg
        )
        flow_samples = jnp.reshape(flow_samples_flat, (n_samples_plotting, n_nodes, dim))

        bins_x, count_list = bin_samples_by_dist(
            [train_data_.positions[:n_samples_plotting]], max_distance=10.0
        )
        plotting_n_nodes = train_data_.positions.shape[1]
        pairwise_distances_flow = get_pairwise_distances_for_plotting(
            flow_samples, plotting_n_nodes, max_distance=10.0
        )
        counts_flow = get_counts(pairwise_distances_flow, bins_x)

        fig1, ax = plt.subplots(1, figsize=(5, 5))
        ax.stairs(count_list[0], bins_x, label="train samples", alpha=0.4, fill=True)
        ax.stairs(counts_flow, bins_x, label="flow samples", alpha=0.4, fill=True)
        ax.legend()
        return [fig1]

    return default_plotter


def setup_training(
    cfg: ExperimentConfig,
    load_dataset: LoadDatasetFn,
    target_log_prob_fn: Optional[Callable[[jax.Array], jax.Array]] = None,
    plotter: Optional[Plotter] = None,
    mesh=None,
) -> TrainConfig:
    """Build the full TrainConfig from a typed config (reference
    `setup_training.py:68-269`)."""
    tcfg = cfg.training
    batch_size = tcfg.batch_size

    if tcfg.precision not in ("float32", "tensorfloat32", "bfloat16"):
        raise ValueError(
            f"training.precision={tcfg.precision!r}: expected float32, "
            "tensorfloat32 or bfloat16"
        )
    # Scoped to the training and eval programs (their traces and compile
    # cache keys), not set process-wide.
    precision = partial(jax.default_matmul_precision, tcfg.precision)

    if tcfg.compile_cache:
        from ecnf_jax.utils.compile_cache import enable_persistent_compilation_cache

        enable_persistent_compilation_cache()

    if mesh is None:
        mesh = get_mesh()

    # The FULL experiment config rides into the run record (wandb `config=`;
    # reference `setup_train_objects.py:7`), not just the logger section.
    logger = setup_logger(
        cfg.logger,
        save_dir=tcfg.save_dir or ".",
        save=tcfg.save,
        experiment_config=config_to_dict(cfg),
    )
    save_path = tcfg.save_dir or "."

    # Re-root outputs under the live wandb run directory so checkpoints and
    # plots ride along with the run's files (reference
    # `setup_training.py:80-82`).  Loud failure beats a silent no-op when
    # there is no wandb run to root under.
    if tcfg.save_in_wandb_dir:
        from ecnf_jax.training.loggers import WandbLogger

        run = getattr(logger, "run", None)
        if (
            isinstance(logger, WandbLogger)
            and getattr(logger, "_wandb", None) is not None
            and run is not None
        ):
            # Always nest under the run dir — unlike a bare os.path.join
            # (the reference's idiom), which silently discards the run dir
            # when save_dir is absolute.
            save_path = os.path.join(str(run.dir), save_path.lstrip(os.sep))
        else:
            raise ValueError(
                "training.save_in_wandb_dir=true requires the wandb logger "
                "with a live run (logger: {wandb: {...}} and the wandb "
                "package installed); got "
                f"{type(logger).__name__}."
            )
    pathlib.Path(save_path).mkdir(exist_ok=True, parents=True)

    train_data_, test_data_ = load_dataset(tcfg.train_set_size, tcfg.test_set_size)

    # Zero-CoM the data (reference `setup_training.py:91-94`).
    train_data_ = train_data_._replace(
        positions=train_data_.positions
        - jnp.mean(train_data_.positions, axis=1, keepdims=True)
    )
    test_data_ = test_data_._replace(
        positions=test_data_.positions
        - jnp.mean(test_data_.positions, axis=1, keepdims=True)
    )

    n_train, n_nodes, dim = train_data_.positions.shape
    ds_size = n_train

    ocfg = tcfg.optimizer
    n_batches_per_epoch = max(ds_size // batch_size, 1)
    optimizer = build_optimizer(
        init_lr=ocfg.init_lr,
        use_schedule=ocfg.use_schedule,
        peak_lr=ocfg.peak_lr,
        end_lr=ocfg.end_lr,
        n_iter_warmup=ocfg.n_iter_warmup,
        n_iter_total=tcfg.n_training_iter * n_batches_per_epoch,
        optimizer_name=ocfg.optimizer,
    )

    # Flatten to [B, N*D] coordinates and [B, N] integer features.
    flat = lambda a: jnp.reshape(a, (a.shape[0], -1))
    train_pos_flat = flat(train_data_.positions)
    train_features_flat = flat(train_data_.features)
    test_pos_flat = flat(test_data_.positions)
    test_features_flat = flat(test_data_.features)

    net_cfg = cfg.flow.network
    cnf = build_cnf(
        n_frames=n_nodes,
        dim=dim,
        sigma_min=cfg.flow.sigma_min,
        base_scale=cfg.flow.base_scale,
        n_blocks_egnn=net_cfg.n_blocks_egnn,
        mlp_units=net_cfg.mlp_units,
        n_invariant_feat_hidden=net_cfg.n_invariant_feat_hidden,
        time_embedding_dim=net_cfg.time_embedding_dim,
        n_features=int(jnp.max(train_features_flat)) + 1,
        stable_mlp=net_cfg.stable_mlp,
        compute_dtype=net_cfg.compute_dtype,
    )

    solve_cfg = SolveConfig(
        use_fixed_step_size=tcfg.use_fixed_step_size,
        trace_column_chunk=tcfg.trace_column_chunk,
        hutchinson_probes=tcfg.hutchinson_probes,
        method=tcfg.ode_method,
    )

    update_fn = make_update_fn(
        cnf,
        optimizer,
        use_ema=tcfg.use_ema,
        ema_beta=tcfg.ema_beta,
        mesh=None,  # the epoch runner below is sharded as a whole
        microbatch=tcfg.microbatch,
    )

    def init_state(key: jax.Array) -> TrainingState:
        return init_training_state(
            cnf,
            optimizer,
            key,
            example_x=train_pos_flat[:2],
            example_features=train_features_flat[:2],
            use_ema=tcfg.use_ema,
        )

    n_batches = ds_size // batch_size

    def _epoch(state: TrainingState, pos, feats):
        """One epoch: permute, reshape to minibatches, scan the update."""
        key, subkey = jax.random.split(state.key)
        perm = jax.random.permutation(subkey, ds_size)[: n_batches * batch_size]
        state = state._replace(key=key)
        pos_b = pos[perm].reshape(n_batches, batch_size, -1)
        feat_b = feats[perm].reshape(n_batches, batch_size, -1)

        def scan_body(st, xs):
            xb, fb = xs
            st, info = update_fn(st, xb, fb)
            return st, info

        state, infos = jax.lax.scan(scan_body, state, (pos_b, feat_b))
        return state, infos

    rep = replicated(mesh)
    data_shard = data_sharded(mesh)
    epoch_jit = jax.jit(
        _epoch,
        in_shardings=(rep, data_shard, data_shard),
        out_shardings=(rep, rep),
        donate_argnums=(0,),
    )

    train_pos_dev = jax.device_put(train_pos_flat, data_shard)
    train_feat_dev = jax.device_put(train_features_flat, data_shard)

    def run_epoch(state: TrainingState):
        with precision():
            state, infos = epoch_jit(state, train_pos_dev, train_feat_dev)
        return state, jax.device_get(infos)

    # Multi-epoch dispatch (`training.epochs_per_dispatch`): scan k epochs in
    # ONE device program.  Short-epoch configs are otherwise dominated by
    # per-dispatch host latency (thousands of ~ms round-trips); the loop caps
    # k so groups never cross an eval/checkpoint iteration, which bounds the
    # number of distinct-k compiles to a handful.
    _epochs_jit_cache = {}

    def run_epochs(state: TrainingState, k: int):
        fn = _epochs_jit_cache.get(k)
        if fn is None:

            def _k_epochs(st, pos, feats):
                return jax.lax.scan(
                    lambda s, _: _epoch(s, pos, feats), st, None, length=k
                )

            fn = jax.jit(
                _k_epochs,
                in_shardings=(rep, data_shard, data_shard),
                out_shardings=(rep, rep),
                donate_argnums=(0,),
            )
            _epochs_jit_cache[k] = fn
        with precision():
            state, infos = fn(state, train_pos_dev, train_feat_dev)
        return state, jax.device_get(infos)  # infos: [k, n_batches, ...]

    # --- Evaluation --------------------------------------------------------

    # Explicit shardings need the batch divisible by the mesh; round the
    # eval batch up (padded entries are masked, so metrics are unchanged).
    from ecnf_jax.parallel.mesh import pad_to_multiple

    n_mesh_devices = int(mesh.devices.size)
    eval_batch_size = pad_to_multiple(tcfg.eval_batch_size, n_mesh_devices)
    if eval_batch_size != tcfg.eval_batch_size:
        print(
            f"eval_batch_size {tcfg.eval_batch_size} -> {eval_batch_size} "
            f"(rounded up to the {n_mesh_devices}-device mesh)"
        )

    if target_log_prob_fn is not None and tcfg.eval_n_model_samples is not None:
        eval_sample_batch = min(eval_batch_size, tcfg.eval_n_model_samples)
        n_eval_batches = max(tcfg.eval_n_model_samples // eval_sample_batch, 1)

        # Sharded like the train step: params replicated, the sampled batch
        # (internal to the solve) distributed by GSPMD; outputs replicated.
        def _ess_batch_impl(params, k: jax.Array) -> jax.Array:
            feats = jnp.repeat(train_features_flat[:1], eval_sample_batch, axis=0)
            # NOTE: the reference passes `eval_exact_log_prob` directly as
            # `approx` here (`setup_training.py:171`), inverting its own
            # flag; we implement the intended semantics (exact when the
            # flag says exact) — divergence documented.
            samples, log_q = sample_and_log_prob_cnf(
                cnf,
                params,
                k,
                eval_sample_batch,
                features=feats,
                approx=not tcfg.eval_exact_log_prob,
                cfg=solve_cfg,
            )
            samples = jnp.reshape(samples, (-1, n_nodes, dim))
            log_p = target_log_prob_fn(samples)
            return log_p - log_q

        _ess_batch = partial(
            jax.jit, in_shardings=(rep, rep), out_shardings=rep
        )(_ess_batch_impl)

        # Scan a bounded number of sample batches per device dispatch
        # rather than one giant scanned program.  The chunk scans over the
        # SAME split keys the host loop would use, so the log-weight
        # sequence (hence rv_ess) is bitwise-identical for any chunk size.
        chunk = max(1, min(int(tcfg.eval_dispatch_chunk), n_eval_batches))

        @partial(jax.jit, in_shardings=(rep, rep), out_shardings=rep)
        def _ess_chunk(params, ks):  # ks: [chunk, key]
            return jax.lax.map(lambda k: _ess_batch_impl(params, k), ks)

        def eval_batch_free_fn(key: jax.Array, state: TrainingState) -> dict:
            keys = jax.random.split(key, n_eval_batches)
            log_ws = []
            full = (n_eval_batches // chunk) * chunk
            for start in range(0, full, chunk):
                log_ws.append(_ess_chunk(state.params, keys[start:start + chunk]))
            for i in range(full, n_eval_batches):  # remainder: per-batch jit
                log_ws.append(_ess_batch(state.params, keys[i])[None])
            log_w = jnp.concatenate(log_ws).flatten()
            return {"rv_ess": calculate_reverse_ess(log_w)}

    else:
        eval_batch_free_fn = None

    # Test batches sharded over the data axis; masked means reduce globally
    # (exact across devices/hosts), state replicated.  (jit sharding specs
    # require positional args; the kwarg-friendly wrapper is below.)
    def _eval_data_batch_impl(data, key: jax.Array, mask, state: TrainingState):
        pos_b, feat_b = data
        log_q, log_prob_base, delta_log_lik, stats = get_log_prob(
            cnf,
            state.params,
            pos_b,
            key,
            features=feat_b,
            approx=not tcfg.eval_exact_log_prob,
            cfg=solve_cfg,
            return_stats=True,
        )
        # Diverged / budget-exhausted ODE samples come back NaN
        # (`ops/ode.py`); exclude them from the means like the reference's
        # non-finite log-weight masking (`evaluation.py:15`).
        mask = mask * jnp.isfinite(log_q).astype(mask.dtype)
        info = {
            "test_log_lik": maybe_masked_mean(log_q, mask),
            "test_log_prob_base": maybe_masked_mean(log_prob_base, mask),
            "test_delta_log_lik": maybe_masked_mean(delta_log_lik, mask),
            # Solver telemetry: accepted ODE steps for this batch (max over
            # samples) — surfaces eval cost drift as the model trains.
            "eval_ode_steps": stats.num_steps.astype(jnp.float32),
        }
        if target_log_prob_fn is not None:
            pos = jnp.reshape(pos_b, (-1, n_nodes, dim))
            log_p = target_log_prob_fn(pos)
            log_w = log_p - log_q
        else:
            log_w = None
        return log_w, info

    _eval_data_batch = partial(
        jax.jit,
        in_shardings=(data_shard, rep, data_shard, rep),
        out_shardings=(data_shard, rep),
    )(_eval_data_batch_impl)

    def eval_on_data_batch_fn(data, key, mask, state):
        return _eval_data_batch(data, key, mask, state)

    # Chunked test-NLL eval: scan G batches per device dispatch.  Built
    # ONCE here with `state` as a runtime ARGUMENT — a per-eval jit closing
    # over the live state would embed the weights as XLA constants and
    # retrace+recompile the whole G-batch program at every eval.
    from jax.sharding import NamedSharding, PartitionSpec as P

    chunk_data_shard = NamedSharding(mesh, P(None, "data"))  # [G, batch, ...]

    @partial(
        jax.jit,
        in_shardings=(chunk_data_shard, rep, chunk_data_shard, rep),
    )
    def _eval_data_chunk(data_g, keys_g, mask_g, state: TrainingState):
        def body(_, xs):
            d, k, m = xs
            return None, _eval_data_batch_impl(d, k, m, state)

        _, outs = jax.lax.scan(body, None, (data_g, keys_g, mask_g))
        return outs

    # `training.eval_plots: false` skips plotting entirely — the default
    # plotter costs a full ODE sampling solve per eval even when the figures
    # are discarded (save=False); pure-throughput runs want neither.
    if not tcfg.eval_plots:
        plotter = None
    elif plotter is None:
        plotter = setup_default_plotter(
            cnf=cnf,
            n_nodes=n_nodes,
            dim=dim,
            n_samples_plotting=tcfg.plot_batch_size,
            solve_cfg=solve_cfg,
        )

    def eval_and_plot(
        state: TrainingState, key: jax.Array, iteration_n: int, save: bool, plots_dir: str
    ) -> dict:
        with precision():
            return _eval_and_plot(state, key, iteration_n, save, plots_dir)

    def _eval_and_plot(
        state: TrainingState, key: jax.Array, iteration_n: int, save: bool, plots_dir: str
    ) -> dict:
        # EMA swap on the final eval (reference `setup_training.py:229-230`).
        if tcfg.use_ema and (tcfg.n_training_iter - 1) == iteration_n:
            state = state._replace(params=state.ema_params)

        info, log_w_fwd, flat_mask = eval_fn(
            x=(test_pos_flat, test_features_flat),
            key=key,
            eval_on_test_batch_fn=partial(eval_on_data_batch_fn, state=state),
            eval_batch_free_fn=(
                partial(eval_batch_free_fn, state=state)
                if eval_batch_free_fn is not None
                else None
            ),
            batch_size=eval_batch_size,
            # Bounded-chunk dispatch for the test-NLL loop too.
            # `state` rides as a runtime argument into
            # the once-jitted chunk program — only the lambda is fresh.
            scan_chunk=tcfg.eval_dispatch_chunk,
            eval_on_test_chunk_fn=(
                lambda xg, kg, mg: _eval_data_chunk(xg, kg, mg, state)
            ),
        )

        if target_log_prob_fn is not None and log_w_fwd is not None:
            info.update(calculate_forward_ess(log_w_fwd, mask=flat_mask))

        if plotter is not None:
            require("matplotlib", "eval plots (training.eval_plots)").use("Agg")
            plt = require("matplotlib.pyplot", "eval plots (training.eval_plots)")
            for j, figure in enumerate(plotter(state, train_data_, key)):
                if save and plots_dir is not None:
                    figure.savefig(os.path.join(
                        plots_dir, "plot_%03i_iter_%08i.png" % (j, iteration_n)
                    ))
                plt.close(figure)

        return {k: np.asarray(v) for k, v in info.items()}

    return TrainConfig(
        n_iteration=tcfg.n_training_iter,
        logger=logger,
        seed=tcfg.seed,
        n_checkpoints=tcfg.n_checkpoints,
        n_eval=tcfg.n_eval,
        init_state=init_state,
        update_state=run_epoch,
        eval_and_plot_fn=eval_and_plot,
        save=tcfg.save,
        save_dir=save_path,
        resume=tcfg.resume,
        use_64_bit=tcfg.use_64_bit,
        runtime_limit=tcfg.runtime_limit,
        profile_dir=tcfg.profile_dir,
        update_state_multi=run_epochs,
        epochs_per_dispatch=tcfg.epochs_per_dispatch,
    )
