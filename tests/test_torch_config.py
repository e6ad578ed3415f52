"""The port's YAML reader (facesr_torch.yaml_lite) against PyYAML's
``safe_load``, and its config loader against the JAX package's."""

import math
from pathlib import Path

import pytest
import yaml

from facesr.config import config as jconfig
from facesr_torch import config as tconfig
from facesr_torch.yaml_lite import YamlError, safe_load

ROOT = Path(__file__).resolve().parent.parent
CONFIGS = sorted((ROOT / "configs").rglob("*.yaml"))


def _same(a, b):
    """Equal values of equal types (1 == 1.0 == True in Python; YAML
    resolution is about the type)."""
    if isinstance(a, dict):
        return isinstance(b, dict) and list(a) == list(b) and all(
            _same(k, kb) and _same(a[k], b[kb]) for k, kb in zip(a, b))
    if isinstance(a, list):
        return isinstance(b, list) and len(a) == len(b) and all(map(_same, a, b))
    if isinstance(a, float) and math.isnan(a):
        return isinstance(b, float) and math.isnan(b)
    return type(a) is type(b) and a == b


def test_every_config_file_is_seen():
    assert len(CONFIGS) >= 13 and any(p.name == "stage1_psnr_config.yaml" for p in CONFIGS)


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: str(p.relative_to(ROOT)))
def test_reader_equals_safe_load_on_the_repo_configs(path):
    text = path.read_text()
    assert _same(safe_load(text, str(path)), yaml.safe_load(text))


EDGE_CASES = [
    "a: 1e-4",            # no dot: a string in YAML 1.1
    "a: 1.0e-07",         # a float
    "a: 1.0e5",           # exponent without a sign: a string
    "a: 1.e+5",
    "a: ~", "a: null", "a: Null", "a: nUll", "a:",
    "a: [conv3_4]", "a: [0.9, 0.999]", "a: [1, [2, 3], 'x, y']", "a: []", "a: {}",
    "a: 1  # a trailing comment", "a: b#c", "a: 'x # y'",
    "a: true", "a: False", "a: yes", "a: Off", "a: ON",
    "a: 0x1F", "a: 017", "a: 08", "a: 0b101", "a: 1_000", "a: -1", "a: +5", "a: 0", "a: 00",
    "a: 1:30", "a: 1.5:30", "a: .inf", "a: -.inf", "a: .nan", "a: 3.", "a: .5", "a: -.5e-3",
    "a: 'it''s'", 'a: "tab\\there \\u00e9"', "'k': v", "1: 2", "true: 3",
    "a:\n- 1\n- 2", "a:\n  - x: 1\n    y: [2]\n  - z", "- - 1\n  - 2\n- 3",
    "# only a comment\na:\n  b:\n    c: 1\n  d: 2\ne: 3",
]


@pytest.mark.parametrize("text", EDGE_CASES)
def test_reader_resolves_scalars_as_safe_load(text):
    assert _same(safe_load(text), yaml.safe_load(text))


def test_the_yaml11_floats_the_stage_configs_rely_on():
    assert safe_load("a: 1e-4") == {"a": "1e-4"}
    assert safe_load("a: 1.0e-07") == {"a": 1e-07}
    assert safe_load("a: ~\nb: [0.9, 0.999] # c") == {"a": None, "b": [0.9, 0.999]}


OUTSIDE = [
    ("a: &x 1", 1), ("a: *x", 1), ("a: !!str 1", 1), ("a: |\n  x", 1), ("a: {b: 1}", 1),
    ("a: b: c", 1), ("a: 1\nb:\n\tc: 1", 3), ("---\na: 1", 1), ("a: 2001-12-14", 1),
    ("a: 'x", 1), ("a: 1\nb: x\n  y", 3), ("a: 1\n  b: 2", 2), ("a: [1, 2", 1),
]


@pytest.mark.parametrize("text,line", OUTSIDE)
def test_outside_the_subset_raises_and_names_the_line(text, line):
    with pytest.raises(YamlError, match=rf"<yaml>:{line}:"):
        safe_load(text)


def test_load_config_matches_the_jax_package(tmp_path):
    for path in CONFIGS:
        assert _same(tconfig.load_config(str(path)), jconfig.load_config(str(path))), path
    empty = tmp_path / "empty.yaml"
    empty.write_text("# nothing\n")
    assert tconfig.load_config(str(empty)) == jconfig.load_config(str(empty)) == {}
