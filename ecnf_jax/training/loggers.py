"""Metric loggers: in-memory, CSV (pandas), and optional wandb.

Covers the logger roles of the reference (`ecnf/utils/loggers.py:14-143`:
an ABC plus in-memory / pandas-CSV / wandb backends, selected by config
key).  The implementations here are this framework's own: `ListLogger`
accumulates a columnar history with numpy-based scalar coercion and
snapshot-style persistence; `CSVLogger` buffers rows and flushes with a
growing column set; `WandbLogger` degrades to the in-memory backend when
the wandb package is absent (it is an optional dependency).
"""
import abc
import os
import pathlib
import pickle
import warnings
from typing import Any, Dict, List, Mapping, Optional

import numpy as np

from ecnf_jax.utils.optional import require

LoggingData = Mapping[str, Any]


class Logger(abc.ABC):
    @abc.abstractmethod
    def write(self, data: LoggingData) -> None:
        """Write `data` to the destination."""

    @abc.abstractmethod
    def close(self) -> None:
        """Close the logger; no further writes expected."""


def _to_scalar(value: Any) -> Optional[float]:
    """Coerce a metric value to a python float; None if it isn't scalar."""
    try:
        arr = np.asarray(value)
    except Exception:
        return None
    if arr.shape != () or not np.issubdtype(arr.dtype, np.number):
        return None
    return float(arr)


class ListLogger(Logger):
    """Columnar in-memory history (`{metric: [values...]}`) with optional
    pickle snapshots every `save_period` writes and at close.

    Fills the role of the reference's in-memory logger
    (`ecnf/utils/loggers.py:27-76`); the `.history` attribute is the public
    surface (read by `training/loop.py` for the exit metric panel).
    """

    def __init__(
        self,
        save: bool = False,
        save_path: str = "/tmp/logging_hist.pkl",
        save_period: int = 100,
    ):
        self.save = save
        self.save_path = save_path
        self.save_period = save_period
        self.history: Dict[str, List[Any]] = {}
        self._writes = 0
        self._warned_non_scalar = False
        if save:
            pathlib.Path(save_path).parent.mkdir(exist_ok=True, parents=True)

    def write(self, data: LoggingData) -> None:
        for key, value in data.items():
            scalar = _to_scalar(value)
            if scalar is None:
                if not self._warned_non_scalar:
                    warnings.warn(
                        f"ListLogger: metric {key!r} is not a scalar; storing it "
                        "as-is (history pickles may be large)."
                    )
                    self._warned_non_scalar = True
                self.history.setdefault(key, []).append(value)
            else:
                self.history.setdefault(key, []).append(scalar)
        self._writes += 1
        if self.save and (self._writes + 1) % self.save_period == 0:
            self._snapshot()

    def _snapshot(self) -> None:
        with open(self.save_path, "wb") as f:
            pickle.dump(self.history, f)

    def close(self) -> None:
        if self.save:
            self._snapshot()


class CSVLogger(Logger):
    """Append metric rows to a CSV, resume-aware.

    Functional equivalent of the reference `PandasLogger`
    (`loggers.py:92-143`) without requiring pandas at write time: rows are
    buffered and written with a stable, growing column set.
    """

    def __init__(
        self,
        save: bool = True,
        save_path: Optional[str] = None,
        save_period: int = 100,
    ):
        save_dir = save_path or "."
        self.save_path = os.path.join(save_dir, "logging_history.csv")
        self.save = save
        self.save_period = save_period
        self.rows: List[Dict[str, Any]] = []
        self.buffer: List[Dict[str, Any]] = []
        self.iter = 0
        # Columns currently present in the on-disk file (None until the
        # first rewrite).  Flushes whose rows fit this set are appended in
        # place; a row with a new key triggers one full rewrite with the
        # widened column set.  Long runs (e.g. 400k-step soaks) therefore
        # pay O(rows) total IO, not O(rows^2) of whole-file rewrites.
        self._file_columns: Optional[List[str]] = None
        if os.path.exists(self.save_path):
            pd = require("pandas", "the CSV logger")
            df = pd.read_csv(self.save_path, index_col=0)
            self.rows = df.to_dict("records")
            self.iter = len(self.rows)
            self._file_columns = list(df.columns)

    def write(self, data: LoggingData) -> None:
        row = {}
        for k, v in data.items():
            scalar = _to_scalar(v)
            row[k] = v if scalar is None else scalar
        self.buffer.append(row)
        self.iter += 1
        if self.save and (self.iter + 1) % self.save_period == 0:
            self._flush()

    def _flush(self) -> None:
        pd = require("pandas", "the CSV logger")

        if not self.buffer:
            return
        buffered, self.buffer = self.buffer, []
        start = len(self.rows)
        self.rows.extend(buffered)
        pathlib.Path(self.save_path).parent.mkdir(exist_ok=True, parents=True)
        cols = self._file_columns
        if cols is not None and all(set(r) <= set(cols) for r in buffered):
            pd.DataFrame(buffered, columns=cols, index=range(start, len(self.rows))).to_csv(
                self.save_path, mode="a", header=False
            )
        else:
            df = pd.DataFrame(self.rows)
            df.to_csv(self.save_path)
            self._file_columns = list(df.columns)

    def close(self) -> None:
        if self.save:
            self._flush()


class WandbLogger(Logger):
    """wandb-backed logger; degrades to ListLogger when wandb is missing.

    Parity: reference `loggers.py:79-89` (own monotone step, commit=False).
    """

    def __init__(self, **kwargs: Any):
        try:
            import wandb  # noqa: F401

            self._wandb = wandb
            self.run = wandb.init(**kwargs, reinit=True)
        except ImportError:
            print("wandb not available; WandbLogger falling back to in-memory history")
            self._wandb = None
            self._fallback = ListLogger()
        self.iter = 0

    def write(self, data: LoggingData) -> None:
        if self._wandb is None:
            self._fallback.write(data)
        else:
            self.run.log(data, step=self.iter, commit=False)
        self.iter += 1

    def close(self) -> None:
        if self._wandb is None:
            self._fallback.close()
        else:
            self.run.finish()


def setup_logger(
    logger_cfg: Mapping[str, Any],
    save_dir: str = ".",
    save: bool = True,
    experiment_config: Optional[Mapping[str, Any]] = None,
) -> Logger:
    """Select a logger by which key is present in the config section.

    Parity: reference `ecnf/utils/setup_train_objects.py:5-17`.  When
    `experiment_config` is given (the full experiment dict) it is recorded
    into the wandb run's config — reference `setup_train_objects.py:7`:
    ``WandbLogger(**cfg.logger.wandb, config=dict(cfg))``.
    """
    if logger_cfg is None:
        return ListLogger()
    if "wandb" in logger_cfg:
        kwargs = dict(logger_cfg["wandb"] or {})
        if experiment_config is not None and "config" not in kwargs:
            kwargs["config"] = dict(experiment_config)
        return WandbLogger(**kwargs)
    if "list_logger" in logger_cfg:
        return ListLogger()
    if "pandas_logger" in logger_cfg or "csv_logger" in logger_cfg:
        section = logger_cfg.get("pandas_logger") or logger_cfg.get("csv_logger") or {}
        return CSVLogger(
            save=save,
            save_path=save_dir,
            save_period=int(section.get("save_period", 100)),
        )
    raise ValueError(
        "No logger specified: add one of wandb / list_logger / pandas_logger "
        "to the logger config section."
    )
