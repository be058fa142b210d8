"""The stdlib YAML-subset config loader against PyYAML's ``safe_load``."""
import math
from pathlib import Path

import pytest

from ecnf_jax.training.config import load_config
from ecnf_jax.training.yaml_subset import YAMLSubsetError, loads, parse_value

yaml = pytest.importorskip("yaml")

CONFIGS = sorted((Path(__file__).resolve().parents[1] / "examples" / "configs").glob("*.yaml"))

# A config in the reference's own layout (hydra section, block sequence,
# interpolations, flow maps, YAML 1.1 scalar forms).
REFERENCE_STYLE = """
defaults:
  - _self_
hydra:
  job:
    chdir: false
  run:
    dir: ./outputs/${now:%Y-%m-%d}
flow:
  n_frames: 13
  network:
    mlp_units: [128, 128, 128]   # inline list
    empty: []
    nested: {a: 1, b: [1, 2, {c: null}], 'q': "x: y"}
training:
  init_lr: 1e-4
  peak_lr: 1.0e-4
  eval_n_model_samples: 10_000
  octal: 017
  hexa: 0x1F
  neg: -3
  negf: -0.5
  dotf: .5
  big: .inf
  flag: yes
  off: off
  tilde: ~
  nothing:
  s1: 'it''s'
  s2: "tab\\tquote\\""
  path: data/file.h5  # comment
  hash: a#b
  eval_batch_size: ${training.batch_size}
list_of_maps:
  - a: 1
    b: 2
  - c: 3
seq_same_indent:
- 1
- two
"""


def _same(a, b):
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return list(a) == list(b) and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and math.isnan(a):
        return math.isnan(b)
    return a == b


@pytest.mark.parametrize(
    "text",
    [p.read_text() for p in CONFIGS] + [REFERENCE_STYLE],
    ids=[p.name for p in CONFIGS] + ["reference_style"],
)
def test_matches_pyyaml(text):
    assert _same(loads(text), yaml.safe_load(text))


@pytest.mark.parametrize(
    "value",
    ["{list_logger: null}", "[1, 2]", "1e-3", "0.5", "true", "null", "",
     "abc", "'q'", "{csv_logger: {save_period: 5}}", "256", "-1", "no"],
)
def test_override_values_match_pyyaml(value):
    assert _same(parse_value(value), yaml.safe_load(value))


def test_unsupported_constructs_raise():
    with pytest.raises(YAMLSubsetError):
        loads("a: &anchor 1\nb: *anchor\n")
    with pytest.raises(YAMLSubsetError):
        loads("a: |\n  text\n")


def test_qm9_config_loads():
    cfg = load_config(str([p for p in CONFIGS if p.name == "qm9.yaml"][0]))
    assert cfg.flow.network.mlp_units == (256, 256, 256, 256)
    assert cfg.training.eval_batch_size == cfg.training.batch_size == 256
    assert cfg.training.microbatch == 4
    assert cfg.training.optimizer.init_lr == "1e-4"  # as PyYAML reads it
